"""The port's continuous batching (omni_tpu_torch.runtime.slots) against
omni_tpu's SlotScheduler, each on its own package's Context over the same
tiny file (2 layers, d_model 64, a 300-token byte-level BPE vocabulary,
F32 weights), case by case as tests/test_slots.py runs them: interleaved
greedy slots whose steps mix prompt rows with decode rows, a context shift
past the slot's budget, a grammar slot, a lazy trigger, infill and n_probs.
Greedy token streams must be equal; n_probs ids equal and logprobs within
LOGPROB_ATOL (the JAX reference runs op by op there: XLA's fused compile
moves this fixture's logits by ~0.05, test_torch_model.JIT_LOGITS_ATOL,
where the port and the op-by-op forward agree to ~1e-6). The two packages'
random draws differ, so a stochastic slot is held to its seeding rule: a
generator seeded with seed + slot id, as the JAX slot's PRNGKey. Also
`apply_infill_host` against the JAX function on the same logits."""

import jax
import numpy as np
import pytest
import torch

from jax._src import compilation_cache
from omni_tpu.core import GGMLType
from omni_tpu.core import GGUFReader as JaxReader
from omni_tpu.grammar import VocabTrie as JaxTrie
from omni_tpu.grammar import parse_gbnf as jax_gbnf
from omni_tpu.models import qwen3 as jq
from omni_tpu.runtime import Context as JaxContext
from omni_tpu.runtime import SamplerParams as JaxSP
from omni_tpu.runtime import sampler as jsampler
from omni_tpu.runtime.slots import SlotScheduler as JaxScheduler
from omni_tpu.testing import write_tiny_qwen3
from omni_tpu.tokenizer import build_tokenizer as jax_tokenizer
from omni_tpu_torch.core.gguf import GGUFReader
from omni_tpu_torch.grammar import VocabTrie, parse_gbnf
from omni_tpu_torch.models import qwen3 as tq
import omni_tpu_torch.runtime.slots as slots_mod
from omni_tpu_torch.runtime import Context, SamplerParams
from omni_tpu_torch.runtime import sampler as tsampler
from omni_tpu_torch.runtime.slots import (SlotScheduler, SlotState,
                                          check_lazy_trigger)
from omni_tpu_torch.tokenizer import build_tokenizer
from test_torch_model import JIT_LOGITS_ATOL

LOGPROB_ATOL = 2e-2
EOS = 256  # <|endoftext|> of the byte vocabulary


@pytest.fixture(scope="module", autouse=True)
def no_compile_cache():
    """Keep the JAX reference calls from writing compile-cache entries into
    the tracked omni_tpu/_warmcache/."""
    old = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", old)
    compilation_cache.reset_cache()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """One Context of each package per pool size (the JAX Context compiles
    its steps per instance), cleared before each case."""
    torch.set_num_threads(1)
    path = tmp_path_factory.mktemp("torch_slots") / "llm.gguf"
    write_tiny_qwen3(path, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     head_dim=16, d_ff=64, n_vocab=300, qtype=GGMLType.F32,
                     byte_tokenizer=True)
    jr = JaxReader(path)
    jcfg, jparams = jq.Qwen3Config.from_gguf(jr.kv), jq.load_params(jr)
    tr = GGUFReader(path)
    tcfg, tparams = tq.Qwen3Config.from_gguf(tr.kv), tq.load_params(tr, device="cpu")
    tok = build_tokenizer(tr.kv)
    tr.close()
    ctxs = {n: (JaxContext(jcfg, jparams, jq.forward, jq.embed, n_ctx=n),
                Context(tcfg, tparams, tq.forward, tq.embed, n_ctx=n, device="cpu"))
            for n in (64, 256)}
    return ctxs, tok, jax_tokenizer(jr.kv)


def _pair(tiny, n_ctx=256, **kw):
    (jctx, tctx), tok, _ = tiny[0][n_ctx], tiny[1], tiny[2]
    jctx.clear_kv()
    tctx.clear_kv()
    return JaxScheduler(jctx, **kw), SlotScheduler(tctx, **kw)


PROMPTS = [np.array([104, 105, 32, 116, 104, 101, 114, 101], np.int32),
           np.array([9, 2, 6], np.int32),
           np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3], np.int32)]


def test_interleaved_greedy_slots(tiny):
    """Three slots launched a step apart, so that steps mix a prompt's rows
    with other slots' decode rows: every stream equals the JAX one."""
    jsched, tsched = _pair(tiny, n_slots=3, n_batch=64)
    rows = []
    tdecode = tsched.ctx.decode

    def counting(batch, **kw):
        rows.append(len(batch))
        return tdecode(batch, **kw)

    tsched.ctx.decode = counting
    try:
        outs = []
        for sched, sp in ((jsched, JaxSP(greedy=True)),
                          (tsched, SamplerParams(greedy=True))):
            slots = []
            for p in PROMPTS:
                slots.append(sched.launch(p, max_new=8, sampler=sp,
                                          stop_tokens=(EOS,)))
                sched.step()
            sched.run_until_done()
            outs.append([list(s.out_tokens) for s in slots])
    finally:
        del tsched.ctx.decode
    assert outs[1] == outs[0]
    assert all(len(o) == 8 for o in outs[1])
    # step 2 carries slot 1's prompt and slot 0's decode row, step 3 slot
    # 2's prompt and two decode rows; later steps three decode rows
    assert rows[:4] == [8, 4, 20, 3]


def test_context_shift(tiny, monkeypatch):
    """A generation past its slot's budget (n_ctx 64 / 2 slots) shifts its
    context (seq_rm + seq_add, K re-rotated) and keeps generating, as the
    JAX scheduler does: the same shifts, positions and cells. The port is
    teacher-forced with the JAX tokens (XLA's jitted steps part from the
    op-by-op law at a near tie past the first shift, where the op-by-op
    JAX run and the port agree token for token); where the port's own
    argmax differs from the forced token, its logits hold the two within
    JIT_LOGITS_ATOL: a rounding flip."""
    jsched, tsched = _pair(tiny, n_ctx=64, n_slots=2)
    s = jsched.launch(PROMPTS[1], max_new=40, sampler=JaxSP(greedy=True))
    jsched.run_until_done()
    want = (list(s.out_tokens), s.n_shifted, s.n_past, jsched.ctx.cells_used,
            dict(jsched.ctx.n_past))
    forced, gaps = list(want[0]), []

    def teacher(logits, *a, **kw):
        tok = forced.pop(0)
        own = int(torch.argmax(logits))
        if own != tok:
            gaps.append(float(logits[own] - logits[tok]))
        return torch.tensor(tok)

    monkeypatch.setattr(slots_mod, "sample", teacher)
    s = tsched.launch(PROMPTS[1], max_new=40, sampler=SamplerParams(greedy=True))
    tsched.run_until_done()
    got = (list(s.out_tokens), s.n_shifted, s.n_past, tsched.ctx.cells_used,
           dict(tsched.ctx.n_past))
    assert got == want and not forced
    assert got[1] > 0 and got[2] <= tsched.n_ctx_slot
    assert len(gaps) <= 3 and all(g <= JIT_LOGITS_ATOL for g in gaps), gaps


def _byte_tries(tok):
    texts = [(i, tok.decode([i])) for i in range(tok.vocab.n_tokens)]
    return JaxTrie(texts), VocabTrie(texts)


def test_grammar_slot(tiny):
    tok = tiny[1]
    jtrie, ttrie = _byte_tries(tok)
    text = 'root ::= ("yes" | "no") " " [a-z]{2,5}'
    got = []
    for (sched, sp), trie, gbnf in zip(
            ((_pair(tiny, n_slots=2)[0], JaxSP(greedy=True)),
             (_pair(tiny, n_slots=2)[1], SamplerParams(greedy=True))),
            (jtrie, ttrie), (jax_gbnf, parse_gbnf)):
        sched.vocab_trie, sched.token_text = trie, lambda t: tok.decode([t])
        s = sched.launch(PROMPTS[0], max_new=12, sampler=sp, stop_tokens=(EOS,),
                         grammar=gbnf(text))
        sched.run_until_done()
        got.append((list(s.out_tokens), s.grammar.eos_allowed, s.grammar.exhausted))
    assert got[1] == got[0]
    out = tok.decode(got[1][0])
    assert out.split(" ")[0] in ("yes", "no"), out


def test_lazy_trigger(tiny):
    """A lazy grammar stays dormant until its trigger appears, then
    constrains from the trigger on (the letters mapping of test_slots.py)."""
    assert check_lazy_trigger("say <tool_call>{", ("<tool_call>",)) == 4
    assert check_lazy_trigger("b then a", ("a", "then")) == 2
    assert check_lazy_trigger("", ()) is None
    letters = ["a", "b", "c", "d"]
    token_text = lambda t: letters[t % 4]  # noqa: E731
    pairs = [(i, letters[i % 4]) for i in range(299)]
    got = []
    for sched, sp, trie, gbnf in (
            (_pair(tiny)[0], JaxSP(greedy=True), JaxTrie(pairs), jax_gbnf),
            (_pair(tiny)[1], SamplerParams(greedy=True), VocabTrie(pairs),
             parse_gbnf)):
        sched.vocab_trie, sched.token_text = trie, token_text
        s = sched.launch(PROMPTS[2], max_new=10, sampler=sp, stop_tokens=(299,),
                         grammar=gbnf('root ::= "b" "a"*\n'), grammar_lazy=True,
                         grammar_triggers=("b",))
        assert not s.grammar_active
        sched.run_until_done()
        got.append((list(s.out_tokens), s.grammar_active, s.grammar_buf))
    assert got[1] == got[0]
    text = "".join(token_text(t) for t in got[1][0])
    if "b" in text:
        assert set(text[text.index("b") + 1:]) <= {"a"} and got[1][1]


def test_infill_slot(tiny):
    tok = tiny[1]
    got = []
    for sched, sp in ((_pair(tiny)[0], JaxSP(greedy=True)),
                      (_pair(tiny)[1], SamplerParams(greedy=True))):
        sched.token_text = lambda t: tok.decode([t])
        s = sched.launch(PROMPTS[0], max_new=6, sampler=sp,
                         stop_tokens=(EOS, 258), infill=True)
        sched.run_until_done()
        got.append(list(s.out_tokens))
    assert got[1] == got[0] and got[1]


@pytest.mark.parametrize("seed", range(4))
def test_apply_infill_host_matches_jax(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(300) * (1 + 3 * seed)).astype(np.float32)
    logits[256] += 2.0 * seed  # the EOG's weight grows with the seed
    texts = {i: "ab"[: 1 + i % 2] * (1 + i % 3) for i in range(300)}
    for top_k in (5, 40):
        want = jsampler.apply_infill_host(logits, {256}, texts.get, top_k=top_k)
        got = tsampler.apply_infill_host(logits, {256}, texts.get, top_k=top_k)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_n_probs_slot(tiny):
    """A slot with n_probs 4: the same tokens, the same top ids, logprobs
    within LOGPROB_ATOL of the op-by-op JAX run, sorted and <= 0."""
    got = []
    for sched, sp in ((_pair(tiny)[0], JaxSP(greedy=True)),
                      (_pair(tiny)[1], SamplerParams(greedy=True))):
        s = sched.launch(PROMPTS[1], max_new=4, sampler=sp, stop_tokens=(EOS,),
                         n_probs=4)
        with jax.disable_jit(isinstance(sched, JaxScheduler)):
            sched.run_until_done()
        got.append((list(s.out_tokens), s.probs_out))
    (tt, tp), (jt, jp) = got
    assert tt == jt and len(tp) == len(tt) == 4
    assert [[i for i, _ in row] for row in tp] == [[i for i, _ in row] for row in jp]
    d = max(abs(a - b) for rt, rj in zip(tp, jp) for (_, a), (_, b) in zip(rt, rj))
    assert d <= LOGPROB_ATOL, d
    assert all(v <= 0 and row == sorted(row, key=lambda r: -r[1])
               for row in tp for _, v in row)


def test_stochastic_slot_seeding_rule(tiny):
    """Slot i draws from a generator seeded with seed + i (the JAX slot's
    PRNGKey(seed + i)); the same launch repeats its stream; slots keep
    their own penalty rings."""
    jsched, tsched = _pair(tiny, n_slots=2)
    sp = SamplerParams(temp=0.9, seed=7, penalty_repeat=1.3, penalty_last_n=8)
    js = [jsched.launch(PROMPTS[0], sampler=JaxSP(temp=0.9, seed=7)) for _ in range(2)]
    assert [np.asarray(s.key).tolist() for s in js] == [
        np.asarray(jax.random.PRNGKey(7 + i)).tolist() for i in range(2)]
    streams = []
    for _ in range(2):
        tsched.ctx.clear_kv()
        slots = [tsched.launch(p, max_new=8, sampler=sp) for p in PROMPTS[:2]]
        for i, s in enumerate(slots):
            ref = torch.Generator().manual_seed(7 + i)
            assert torch.equal(s.generator.get_state(), ref.get_state())
        tsched.run_until_done()
        streams.append([list(s.out_tokens) for s in slots])
        assert [s.prev_tokens.tolist() for s in slots] == [
            s.out_tokens[-8:] for s in slots]
        for s in slots:
            tsched.release(s)
    assert streams[0] == streams[1]


def test_release_free_kv_and_metrics(tiny):
    _, tsched = _pair(tiny, n_slots=1, n_batch=32)
    s = tsched.launch(PROMPTS[1], max_new=3, sampler=SamplerParams(greedy=True))
    assert tsched.launch(PROMPTS[1]) is None  # no free slot
    tsched.run_until_done()
    assert s.state == SlotState.DONE
    used = tsched.metrics()["kv_cells_used"]
    assert used == tsched.ctx.cells_used > 0
    tsched.release(s)
    assert tsched.metrics()["kv_cells_used"] == 0
    with pytest.raises(ValueError):
        tsched.launch(np.zeros(300, np.int32))  # past the slot's budget
