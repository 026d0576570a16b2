"""A text session of the port's OmniPipeline against omni_tpu's on the tiny
Q4_K fixture with its byte-level BPE vocabulary: each package's own GGUF
tokenizer, four ChatML turns past max_preserved_context, so whole rounds
are evicted and the later cells re-rotated (`_slide_window_if_needed`),
then the session state carried across the packages both ways. The session
runs on the fused loop, on the host loop (`fused_decode=False`) with a
break (`stop_speak`) at the second turn's first text chunk, and on the
fused loop with the same break. `Context.generate`, `loop.fused_generate`
and `loop.decode_scan` are held against omni_tpu's on the same fixture.

The rounds, n_keep, n_past, the host shadows and every cell's position and
owner must equal omni_tpu's after each turn. Both sample greedily; the
port is teacher-forced with omni_tpu's tokens (its `sample` patched to
return them, in omni_tpu's draw order), since a near tie can part two
greedy streams (test_torch_model.py's rounding-flip test). Where the
port's own argmax differs from the forced token, its logits must hold the
two within JIT_LOGITS_ATOL: a rounding flip; such steps are counted."""

import dataclasses
import queue
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omni_tpu.runtime.loop as jloop
import omni_tpu_torch.runtime.context as tcontext
import omni_tpu_torch.runtime.loop as tloop
from jax._src import compilation_cache
from omni_tpu.core import GGMLType
from omni_tpu.core import GGUFReader as JaxReader
from omni_tpu.models import qwen3 as jq
from omni_tpu.omni.pipeline import OmniPipeline as JaxPipeline
from omni_tpu.omni.pipeline import SessionConfig as JaxSessionConfig
from omni_tpu.runtime import Context as JaxContext
from omni_tpu.runtime import SamplerParams as JaxSamplerParams
from omni_tpu.testing import write_tiny_qwen3
from omni_tpu.tokenizer import build_tokenizer as jax_build_tokenizer
from omni_tpu_torch.convert import from_jax_params
from omni_tpu_torch.core.gguf import GGUFReader
from omni_tpu_torch.models import qwen3 as tq
from omni_tpu_torch.omni.pipeline import OmniPipeline, SessionConfig
from omni_tpu_torch.runtime import Context, SamplerParams
from omni_tpu_torch.tokenizer import build_tokenizer
from test_torch_model import JIT_LOGITS_ATOL

N_CTX = 512
WINDOW = 120  # max_preserved_context
SYSTEM = "You are a tiny test model."
USER = ["Hi there!", "What's 2+2?", "Tell me more.", "一二三 ok"]


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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: as fast at these tiny shapes, and no contention
    with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_session") / "tiny_q4k.gguf"
    write_tiny_qwen3(path, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                     head_dim=64, d_ff=512, n_vocab=320, qtype=GGMLType.Q4_K,
                     tied_head=False, byte_tokenizer=True)
    jr = JaxReader(path)
    jcfg = jq.Qwen3Config.from_gguf(jr.kv)
    jparams = jq.load_params(jr, fuse=True)
    tcfg = tq.Qwen3Config(**{f: getattr(jcfg, f)
                             for f in tq.Qwen3Config.__dataclass_fields__})
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tr = GGUFReader(path)
    ttok = build_tokenizer(tr.kv)
    tr.close()
    return jcfg, jparams, jax_build_tokenizer(jr.kv), tcfg, tparams, ttok


def _drain(pipe):
    out = []
    while True:
        try:
            out.append(pipe.text_out.get_nowait())
        except queue.Empty:
            return out


def _books(pipe):
    """Everything of the round window that must match, as plain values."""
    llm = pipe.llm
    return {"rounds": [(r.start_pos, r.end_pos) for r in pipe.rounds],
            "n_keep": pipe.n_keep, "n_past": dict(llm.n_past),
            "cells_used": llm.cells_used, "kv_high": llm.kv_high,
            "pos": np.asarray(llm.cache.pos).astype(np.int64).tolist(),
            "seq_mask": np.asarray(llm.cache.seq_mask).astype(np.int64).tolist()}


def _teacher(forced: list[int], flips: list[float]):
    """A stand-in for the port's `sample`: the next of omni_tpu's tokens;
    where the port's own argmax differs, the logit gap is recorded."""
    def sample(logits, *a, **kw):
        want = forced.pop(0)
        own = int(torch.argmax(logits))
        if own != want:
            flips.append(float(logits[own] - logits[want]))
        return torch.tensor(want)
    return sample


def _check_flips(flips):
    print(f"forced steps where the port's own argmax differed: {len(flips)}, "
          f"logit gaps {flips}")
    assert all(0 <= g <= JIT_LOGITS_ATOL for g in flips)


def _stop_at(pipe, turn, r, stopped):
    """At turn `turn`, a break (`stop_speak`) right after the turn's first
    text chunk is emitted, as another thread would call it."""
    if r != turn:
        pipe.__dict__.pop("_emit_chunk", None)
        return
    emit = pipe._emit_chunk

    def stopping(*a):
        emit(*a)
        if not stopped:
            stopped.append(r)
            pipe.stop_speak()
    pipe._emit_chunk = stopping


def _jax_session(tiny, fused, stop_at):
    """omni_tpu's pipeline over the four turns; returns its books after
    each turn, its sampled tokens in draw order, and the turns it broke."""
    jcfg, jparams, jtok, *_ = tiny
    drawn, stopped = [], []
    real = jloop.omni_decode_scan

    def recording(*a, **kw):
        out = real(*a, **kw)
        drawn.extend(np.asarray(out[0][0]).tolist())
        return out

    jctx = JaxContext(jcfg, jparams, jq.forward, jq.embed, n_ctx=N_CTX,
                      sampler=JaxSamplerParams(greedy=True))
    sample_token = jctx.sample_token

    def recording_token(row):
        drawn.append(sample_token(row))
        return drawn[-1]

    jctx.sample_token = recording_token
    pipe = JaxPipeline(llm=jctx, tokenizer=jtok, config=JaxSessionConfig(
        duplex=False, use_tts=False, max_preserved_context=WINDOW,
        fused_decode=fused))
    books = []
    try:
        with mock.patch.object(jloop, "omni_decode_scan", recording):
            pipe.stream_prefill(index=0, system_prompt=SYSTEM)
            for r, text in enumerate(USER):
                pipe._eval_text(text)
                _stop_at(pipe, stop_at, r, stopped)
                pipe.stream_decode(round_idx=r, max_new_tokens=16)
                _drain(pipe)
                books.append(_books(pipe))
    finally:
        pipe.shutdown()
    return pipe, books, drawn, stopped


# (fused_decode, the turn broken at its first chunk)
VARIANTS = {"fused": (True, None), "host_stop": (False, 1),
            "fused_stop": (True, 1)}


@pytest.fixture(scope="module", params=list(VARIANTS))
def sessions(request, tiny):
    """Both sessions of a VARIANTS entry: omni_tpu's, and the port's
    teacher-forced with its tokens. Returns (JAX pipeline, its books, port
    pipeline, its books, the forced steps where the port's own argmax
    differed)."""
    fused, stop_at = VARIANTS[request.param]
    jpipe, jbooks, forced, jstopped = _jax_session(tiny, fused, stop_at)
    *_, tcfg, tparams, ttok = tiny
    flips, tstopped = [], []
    teacher = _teacher(forced, flips)

    llm = Context(tcfg, tparams, tq.forward, tq.embed, n_ctx=N_CTX,
                  sampler=SamplerParams(greedy=True), device="cpu")
    tpipe = OmniPipeline(llm, ttok, SessionConfig(max_preserved_context=WINDOW,
                                                  fused_decode=fused))
    tbooks = []
    with mock.patch.object(tloop, "sample", teacher), \
            mock.patch.object(tcontext, "sample", teacher):
        tpipe.stream_prefill(index=0, system_prompt=SYSTEM)
        for r, text in enumerate(USER):
            tpipe.prefill_text(text)
            _stop_at(tpipe, stop_at, r, tstopped)
            tpipe.stream_decode(round_idx=r, max_new_tokens=16)
            _drain(tpipe)
            tbooks.append(_books(tpipe))
    assert not forced, "the port drew fewer tokens than omni_tpu"
    assert tstopped == jstopped == ([stop_at] if stop_at is not None else [])
    return jpipe, jbooks, tpipe, tbooks, flips


def test_round_window_matches_jax(sessions):
    jpipe, jbooks, tpipe, tbooks, flips = sessions
    _check_flips(flips)
    for turn, (j, t) in enumerate(zip(jbooks, tbooks)):
        assert t == j, turn
    # the slide fired: whole rounds went, the rest is contiguous from 0
    assert len(tbooks[-1]["rounds"]) < len(USER)
    n_past = tbooks[-1]["n_past"][0]
    pos = sorted(p for p, m in zip(tbooks[-1]["pos"], tbooks[-1]["seq_mask"]) if m)
    assert pos == list(range(n_past)) and n_past <= WINDOW + 60
    assert tpipe.n_keep == jpipe.n_keep > 0


def test_rerotated_cells_match_jax(sessions):
    """The live cells' K after the slides: omni_tpu's jitted steps round
    otherwise than its op-by-op forward, which the port follows, by up to
    JIT_LOGITS_ATOL on logits; K takes the same noise (0.0625 at most on
    this session, about 1 % of the values past LOGITS_ATOL). The rotation
    itself is bit-exact (test_torch_kv_shift.py)."""
    jpipe, _, tpipe, _, _ = sessions
    jc, tc = jpipe.llm.cache, tpipe.llm.cache
    live = np.asarray(jc.seq_mask) != 0
    np.testing.assert_allclose(
        tc.k.float().numpy()[:, :, live],
        np.asarray(jc.k.astype(jnp.float32))[:, :, live], rtol=0,
        atol=JIT_LOGITS_ATOL)


def _same_pool(jctx, tctx):
    for nm in ("k", "v", "k_scale", "v_scale"):
        j = getattr(jctx.cache, nm)
        if j is None:
            assert getattr(tctx.cache, nm) is None
            continue
        j = np.asarray(j)
        t = getattr(tctx.cache, nm)
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), j.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(tctx.cache.pos.numpy(), np.asarray(jctx.cache.pos))
    np.testing.assert_array_equal(tctx.cache.seq_mask.numpy(),
                                  np.asarray(jctx.cache.seq_mask).astype(np.int64))
    assert tctx.n_past == jctx.n_past
    assert (tctx.cells_used, tctx.kv_high) == (jctx.cells_used, jctx.kv_high)


def test_session_state_loads_across_packages(sessions, tiny):
    jpipe, _, tpipe, _, _ = sessions
    jcfg, jparams, jtok, tcfg, tparams, ttok = tiny
    # omni_tpu's session into a fresh port pipeline
    t2 = OmniPipeline(Context(tcfg, tparams, tq.forward, tq.embed, n_ctx=N_CTX,
                              device="cpu"), ttok, SessionConfig())
    t2.load_session_state_bytes(jpipe.session_state_bytes())
    _same_pool(jpipe.llm, t2.llm)
    assert _books(t2) == _books(jpipe)
    assert t2.cfg.max_preserved_context == WINDOW
    # the port's session into a fresh omni_tpu pipeline
    j2 = JaxPipeline(llm=JaxContext(jcfg, jparams, jq.forward, jq.embed, n_ctx=N_CTX),
                     tokenizer=jtok, config=JaxSessionConfig(duplex=False, use_tts=False))
    try:
        j2.load_session_state_bytes(tpipe.session_state_bytes())
    finally:
        j2.shutdown()
    _same_pool(j2.llm, tpipe.llm)
    assert _books(j2) == _books(tpipe)


@pytest.mark.parametrize("kv", ["bf16", "q8_0", "q4_0"])
def test_context_state_loads_across_packages(kv, tiny):
    """Whole-pool and per-sequence states of every pool type, written by
    one package and loaded by the other."""
    jcfg, _, _, tcfg, _, _ = tiny
    jdt = {"bf16": jnp.bfloat16, "q8_0": jnp.int8, "q4_0": "q4_0"}[kv]
    jctx = JaxContext(jcfg, None, jq.forward, jq.embed, n_ctx=64, kv_dtype=jdt)
    rng = np.random.default_rng(4)
    c = jctx.cache
    for li in range(jcfg.n_layers):
        k = jnp.asarray(rng.standard_normal((40, 2, 64)), jnp.bfloat16)
        c = c.write(li, jnp.arange(40, dtype=jnp.int32), k, -k)
    mask = np.where(np.arange(64) < 25, 1, np.where(np.arange(64) < 40, 2, 0))
    pos = np.where(mask > 0, np.arange(64) % 25, -1).astype(np.int32)
    jctx.cache = dataclasses.replace(c, pos=jnp.asarray(pos),
                                     seq_mask=jnp.asarray(mask, jnp.uint32))
    jctx.n_past = {0: 25, 1: 15}
    jctx.sync_cells_used()
    tctx = Context(tcfg, None, None, None, n_ctx=64, device="cpu", kv_dtype=kv)
    tctx.load_state_bytes(jctx.state_bytes())
    _same_pool(jctx, tctx)
    seq1 = tctx.seq_state_bytes(1)
    assert seq1 == jctx.seq_state_bytes(1)
    # drop seq 1 on both, restore it from the other package's bytes
    jctx.seq_rm(1)
    tctx.seq_rm(1)
    assert tctx.load_seq_state_bytes(1, jctx.seq_state_bytes(0)) == 25
    assert jctx.load_seq_state_bytes(1, tctx.seq_state_bytes(0)) == 25
    _same_pool(jctx, tctx)
    j2 = JaxContext(jcfg, None, jq.forward, jq.embed, n_ctx=64, kv_dtype=jdt)
    j2.load_state_bytes(tctx.state_bytes())
    _same_pool(j2, tctx)
    with pytest.raises(ValueError):
        Context(tcfg, None, None, None, n_ctx=32, device="cpu",
                kv_dtype=kv).load_state_bytes(tctx.state_bytes())


def _port_session(tiny, sampler, fused=True, turns=2, stop_at=None,
                  window=WINDOW, budget=20):
    *_, tcfg, tparams, ttok = tiny
    llm = Context(tcfg, tparams, tq.forward, tq.embed, n_ctx=N_CTX,
                  sampler=sampler, device="cpu")
    pipe = OmniPipeline(llm, ttok, SessionConfig(max_preserved_context=window,
                                                 fused_decode=fused))
    pipe.stream_prefill(index=0, system_prompt=SYSTEM)
    texts = []
    for r in range(turns):
        pipe.prefill_text(USER[r])
        if stop_at == r:  # a break from another thread at the first chunk
            emit = pipe._emit_chunk

            def stopping(*a, _emit=emit):
                _emit(*a)
                pipe.stop_speak()
            pipe._emit_chunk = stopping
        pipe.stream_decode(round_idx=r, max_new_tokens=budget)
        pipe._emit_chunk = OmniPipeline._emit_chunk.__get__(pipe)
        texts.append("".join(e["content"] for e in _drain(pipe)))
    return pipe, texts


@pytest.mark.parametrize("sampler,fused", [
    (SamplerParams(), True),
    (SamplerParams(penalty_repeat=1.3, dry_multiplier=0.8), True),
    (SamplerParams(mirostat=2), True),  # mirostat takes the host loop
    (SamplerParams(), False)])
def test_stochastic_sessions_slide_and_repeat(tiny, sampler, fused):
    """The server's default sampler (and the rest of the chain) drives
    sessions past the window on both loops: positions stay contiguous from
    0, kv_high bounds the occupied cells, and a second run from the same
    seed gives the same text."""
    a, ta = _port_session(tiny, sampler, fused)
    b, tb = _port_session(tiny, sampler, fused)
    assert ta == tb and any(ta)
    llm = a.llm
    occ = np.nonzero(llm.cache.seq_mask.numpy())[0]
    assert sorted(llm.cache.pos.numpy()[occ].tolist()) == list(range(llm.n_past[0]))
    assert occ.max() < max(llm.kv_high, llm.cells_used) == llm.kv_high
    assert llm.cells_used == len(occ)


def test_stop_speak_and_clean_kvcache(tiny):
    """A break at the second turn's first chunk ends it early with its
    cells accounted; clean_kvcache forgets the session."""
    greedy = SamplerParams(greedy=True)
    full, _ = _port_session(tiny, greedy, window=N_CTX, budget=40)
    pipe, _ = _port_session(tiny, greedy, stop_at=1, window=N_CTX, budget=40)
    span = [r.end_pos - r.start_pos for r in pipe.rounds]
    assert span[0] == full.rounds[0].end_pos - full.rounds[0].start_pos
    assert span[1] < full.rounds[1].end_pos - full.rounds[1].start_pos
    llm = pipe.llm
    used, high = llm.cells_used, llm.kv_high
    assert llm.sync_cells_used() == used and llm.kv_high <= high
    pipe.clean_kvcache()
    assert (pipe.n_keep, pipe.rounds, llm.n_past, llm.cells_used) == (0, [], {}, 0)
    assert not (llm.cache.seq_mask != 0).any()


def test_generate_loops(tiny):
    """Context.generate, fused_generate (chunks of omni_decode_scan) and
    decode_scan against omni_tpu's on the tiny model, greedy and
    teacher-forced with omni_tpu's draws: the same tokens, the stop token
    left out, on_token's (token, finished) stream, and n_past, cells_used,
    kv_high and the cells' positions after each."""
    jcfg, jparams, _, tcfg, tparams, ttok = tiny
    prompt = ttok.encode("Hello there", add_special=False)
    flips = []

    def ctx():
        return Context(tcfg, tparams, tq.forward, tq.embed, n_ctx=128,
                       sampler=SamplerParams(greedy=True), device="cpu")

    def jctx_recording():
        j = JaxContext(jcfg, jparams, jq.forward, jq.embed, n_ctx=128,
                       sampler=JaxSamplerParams(greedy=True))
        drawn, sample_token = [], j.sample_token

        def recording(row):
            drawn.append(sample_token(row))
            return drawn[-1]
        j.sample_token = recording
        return j, drawn

    def same_books(j, t):
        assert (t.n_past, t.cells_used, t.kv_high) == (j.n_past, j.cells_used,
                                                       j.kv_high)
        np.testing.assert_array_equal(t.cache.pos.numpy(), np.asarray(j.cache.pos))

    # generate, to the budget and to a stop token
    j, drawn = jctx_recording()
    want = j.generate(prompt, max_new=12)
    a = ctx()
    with mock.patch.object(tcontext, "sample", _teacher(drawn, flips)):
        assert a.generate(prompt, max_new=12) == want
    assert not drawn and len(want) == 12 and a.n_past[0] == len(prompt) + 12
    same_books(j, a)
    stop = want[4]
    j, drawn = jctx_recording()
    want_stop = j.generate(prompt, max_new=12, stop_tokens=(stop,))
    c = ctx()
    with mock.patch.object(tcontext, "sample", _teacher(drawn, flips)):
        assert c.generate(prompt, max_new=12, stop_tokens=(stop,)) == want_stop
    assert want_stop == want[:want.index(stop)]
    same_books(j, c)

    # fused_generate in chunks of 5, streaming
    j = JaxContext(jcfg, jparams, jq.forward, jq.embed, n_ctx=128,
                   sampler=JaxSamplerParams(greedy=True))
    drawn, real = [], jloop.omni_decode_scan

    def recording(*a, **kw):
        out = real(*a, **kw)
        drawn.extend(np.asarray(out[0][0]).tolist())
        return out

    jstream, tstream = [], []
    with mock.patch.object(jloop, "omni_decode_scan", recording):
        jgot = jloop.fused_generate(j, j.prefill(prompt), 0, 12, chunk=5,
                                    on_token=lambda t, f: jstream.append((t, f)))
    b = ctx()
    with mock.patch.object(tloop, "sample", _teacher(drawn, flips)):
        got = tloop.fused_generate(b, b.prefill(prompt), 0, 12, chunk=5,
                                   on_token=lambda t, f: tstream.append((t, f)))
    assert not drawn and got == jgot and tstream == jstream
    assert [f for _, f in tstream] == [False] * (len(got) - 1) + [True]
    same_books(j, b)

    # decode_scan: six steps from the prompt's first greedy token
    j = JaxContext(jcfg, jparams, jq.forward, jq.embed, n_ctx=128)
    first = int(np.argmax(np.asarray(j.prefill(prompt))))
    jfed, jnxt, jhid, j.cache, _ = jloop.decode_scan(
        j._forward, j._embed, j.cfg, j.params, j.cache, jnp.int32(first),
        jnp.int32(len(prompt)), jnp.int32(0), jax.random.PRNGKey(0), n_steps=6)
    d = ctx()
    d.prefill(prompt)
    forced = np.asarray(jnxt).tolist()
    with mock.patch.object(tloop, "sample", _teacher(forced, flips)):
        fed, nxt, hid, d.cache = tloop.decode_scan(
            d._forward, d._embed, d.cfg, d.params, d.cache, torch.tensor(first),
            torch.tensor(len(prompt)), 0, None, n_steps=6)
    assert fed.tolist() == np.asarray(jfed).tolist()
    assert nxt.tolist() == np.asarray(jnxt).tolist()
    assert tuple(hid.shape) == tuple(jhid.shape) == (6, tcfg.d_model)
    np.testing.assert_array_equal(d.cache.pos.numpy(), np.asarray(j.cache.pos))
    _check_flips(flips)
