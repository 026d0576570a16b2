"""The port's model path (omni_tpu_torch) against the JAX package: norms,
RoPE, attention, the KV cell pool, the sampler, the Qwen3 forward and a
served greedy turn, on the same numpy-seeded inputs and on the same tiny
Q4_K GGUF model. Everything here runs on the CPU."""

import queue
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax._src import compilation_cache
from omni_tpu.core import GGMLType, GGUFReader
from omni_tpu.kernels.attention import cache_attention as jax_cache_attention
from omni_tpu.kernels.attention import mixed_attention as jax_mixed_attention
from omni_tpu.kernels.norms import rms_norm as jax_rms_norm
from omni_tpu.kernels.rope import apply_rope as jax_apply_rope
from omni_tpu.models import qwen3 as jq
from omni_tpu.omni.pipeline import OmniPipeline as JaxPipeline
from omni_tpu.omni.pipeline import SessionConfig as JaxSessionConfig
from omni_tpu.runtime import Batch as JaxBatch
from omni_tpu.runtime import Context as JaxContext
from omni_tpu.runtime import SamplerParams as JaxSamplerParams
from omni_tpu.runtime.kv_cache import KVCache as JaxKVCache
from omni_tpu.runtime.sampler import sample as jax_sample
from omni_tpu.testing import write_tiny_qwen3
import omni_tpu_torch
from omni_tpu_torch.convert import from_jax_params
from omni_tpu_torch.kernels.attention import cache_attention, mixed_attention
from omni_tpu_torch.kernels.norms import rms_norm
from omni_tpu_torch.kernels.qformats import QTensor
from omni_tpu_torch.kernels.rope import apply_rope
from omni_tpu_torch.models import qwen3 as tq
from omni_tpu_torch.omni.pipeline import (SIMPLEX_ASSISTANT_PROMPT,
                                          SIMPLEX_TURN_END, OmniPipeline,
                                          SessionConfig)
from omni_tpu_torch.runtime import Batch, Context, KVCache, SamplerParams
from omni_tpu_torch.runtime.sampler import sample
from omni_tpu_torch.testing_synth import synth_qwen3_params


@pytest.fixture(scope="module", autouse=True)
def no_compile_cache():
    """Keep the JAX reference calls from writing compile-cache entries into
    the tracked omni_tpu/_warmcache/. JAX decides once per process whether
    the cache is in use, so that decision is reset on the way in and out."""
    old = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", old)
    compilation_cache.reset_cache()


def _np(a):
    return np.asarray(a, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- kernels

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 64), dtype=np.float32) * 3
    w = rng.standard_normal(64, dtype=np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = _np(jax_rms_norm(jnp.asarray(x, jd), jnp.asarray(w), 1e-6)
               .astype(jnp.float32))
    got = rms_norm(_t(x).to(td), _t(w), 1e-6).float().numpy()
    # f32 statistics on both sides; rsqrt may differ in the last ulp, which
    # a bf16 result rounds away except at a rounding boundary
    tol = 1e-6 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("neox", [True, False], ids=["neox", "norm"])
def test_apply_rope_matches_jax(neox):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 4, 16), dtype=np.float32)
    pos = rng.integers(0, 4000, 6).astype(np.int32)
    want = _np(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                              neox=neox))
    got = apply_rope(_t(x), _t(pos), 1e6, neox=neox).numpy()
    # f32 sin/cos of angles up to 4000 rad: the two libraries' range
    # reductions agree to a few ulp of the angle
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _attn_inputs(seed, t=5, hq=4, hkv=2, d=16, s=12):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh, dtype=np.float32)  # noqa: E731
    mask_pool = rng.random((t, s)) < 0.6
    mask_cur = np.tril(np.ones((t, t), bool))
    return (f(t, hq, d), f(hkv, s, d), f(hkv, s, d), f(t, hkv, d),
            f(t, hkv, d), mask_pool, mask_cur)


@pytest.mark.parametrize("t", [1, 5])
def test_mixed_attention_matches_jax(t):
    ins = _attn_inputs(t, t=t)
    want = _np(jax_mixed_attention(*map(jnp.asarray, ins)))
    got = mixed_attention(*map(_t, ins)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_cache_attention_matches_jax():
    q, k, v, _, _, mask, _ = _attn_inputs(7)
    mask[:, 0] = True  # every query sees at least one cell
    want = _np(jax_cache_attention(*map(jnp.asarray, (q, k, v, mask))))
    got = cache_attention(*map(_t, (q, k, v, mask))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_kv_cache_cells_and_masks_match_jax():
    """find_slots, commit (with padding rows and multi-membership),
    write_all, seq_rm and attn_mask pick the same cells as the JAX cache."""
    L, S, H, D = 2, 16, 2, 8
    jc = JaxKVCache.create(L, S, H, D)
    tc = KVCache.create(L, S, H, D, "cpu")
    rng = np.random.default_rng(2)
    steps = [  # (pos, seq, valid)
        (np.arange(6), np.zeros(6, int), np.ones(6, bool)),
        (np.arange(4), np.array([1, 1, -3, 1]), np.array([1, 1, 1, 0], bool)),
        (np.arange(6, 9), np.zeros(3, int), np.ones(3, bool)),
    ]
    for i, (pos, seq, valid) in enumerate(steps):
        n = len(pos)
        js = jc.find_slots(n)
        ts = tc.find_slots(n)
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())
        kv = rng.standard_normal((L, n, H, D), dtype=np.float32)
        jc = jc.write_all(js, jnp.asarray(kv), jnp.asarray(kv))
        tc.write_all(ts, _t(kv), _t(kv))
        jc = jc.commit(js, jnp.asarray(pos, jnp.int32),
                       jnp.asarray(seq, jnp.int32), jnp.asarray(valid))
        tc.commit(ts, _t(pos), _t(seq), _t(valid))
        if i == 1:
            jc = jc.seq_rm(0, 2, 4)
            tc.seq_rm(0, 2, 4)
    np.testing.assert_array_equal(np.asarray(jc.pos), tc.pos.numpy())
    np.testing.assert_array_equal(np.asarray(jc.seq_mask).astype(np.int64),
                                  tc.seq_mask.numpy())
    np.testing.assert_array_equal(_np(jc.k.astype(jnp.float32)),
                                  tc.k.float().numpy())
    q_pos, q_seq = np.array([3, 9, 2]), np.array([0, 0, 1])
    for limit in (None, 12):
        np.testing.assert_array_equal(
            np.asarray(jc.attn_mask(jnp.asarray(q_pos, jnp.int32),
                                    jnp.asarray(q_seq, jnp.int32),
                                    limit=limit)),
            tc.attn_mask(_t(q_pos), _t(q_seq), limit=limit).numpy())


@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_greedy_sample_matches_jax(penalty):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal(300, dtype=np.float32)
    prev = np.full(16, -1, np.int32)
    prev[-4:] = np.argsort(-logits)[:4]  # penalise the current leaders
    kw = dict(greedy=True, penalty_repeat=penalty, logit_bias=((7, 0.5),))
    want = int(jax_sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                          JaxSamplerParams(**kw), jnp.asarray(prev)))
    got = int(sample(_t(logits), SamplerParams(**kw), _t(prev)))
    assert got == want


def test_stochastic_sampling_is_not_ported():
    """Stochastic sampling is ported now (the name is kept): the default
    SamplerParams draw omni_tpu's token when fed its Gumbel noise."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal(300, dtype=np.float32) * 3
    key = jax.random.PRNGKey(9)
    want = int(jax_sample(jnp.asarray(logits), key, JaxSamplerParams()))
    noise = np.array(jax.random.gumbel(jax.random.split(key)[1], (300,)))
    got = int(sample(_t(logits), SamplerParams(), gumbel=torch.from_numpy(noise)))
    assert got == want


# ------------------------------------------------------------------ model

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A tiny Qwen3 GGUF in Q4_K (dims multiples of 256, separate Q4_K head)
    loaded by the JAX package, and the same weights in the port."""
    path = tmp_path_factory.mktemp("torch_port") / "tiny_q4k.gguf"
    write_tiny_qwen3(path, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                     head_dim=64, d_ff=512, n_vocab=320, qtype=GGMLType.Q4_K,
                     tied_head=False)
    reader = GGUFReader(path)
    jcfg = jq.Qwen3Config.from_gguf(reader.kv)
    jparams = jq.load_params(reader, fuse=True)
    tcfg = tq.Qwen3Config(**{f: getattr(jcfg, f)
                             for f in tq.Qwen3Config.__dataclass_fields__})
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    assert isinstance(tparams["layers"][0]["wqkv"], QTensor)
    assert isinstance(tparams["output"], QTensor)
    return jcfg, jparams, tcfg, tparams


# logits tolerance: both sides run the same laws (bf16 dequant, f32 dots)
# in different f32 summation orders; now and then that flips the bf16
# rounding of an activation (0.4 %), which moves logits of magnitude ~5 by
# up to ~1e-2
LOGITS_ATOL = 2e-2


def test_forward_matches_jax(tiny):
    """Prefill (padded ubatch with write_mask) then single-token decode:
    logits and the hidden tap agree, and the KV pools hold the same cells."""
    jcfg, jparams, tcfg, tparams = tiny
    jc = JaxKVCache.create(2, 64, 2, 64, rope_base=jcfg.rope_base)
    tc = KVCache.create(2, 64, 2, 64, "cpu")
    rng = np.random.default_rng(4)
    t, tb = 7, 8
    toks = np.pad(rng.integers(0, 320, t), (0, tb - t))
    pos = np.pad(np.arange(t), (0, tb - t))
    wmask = np.arange(tb) < t
    for step in range(4):
        js, ts = jc.find_slots(tb), tc.find_slots(tb)
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())
        jl, jh, jc = jq.forward(
            jparams, jcfg, jq.embed(jparams, jnp.asarray(toks)),
            jnp.asarray(pos, jnp.int32), jnp.zeros(tb, jnp.int32), jc, js,
            jnp.asarray(wmask))
        tl, th, tc = tq.forward(
            tparams, tcfg, tq.embed(tparams, _t(toks)), _t(pos),
            torch.zeros(tb, dtype=torch.int64), tc, ts, _t(wmask))
        np.testing.assert_allclose(tl.numpy()[:t], _np(jl)[:t], rtol=0,
                                   atol=LOGITS_ATOL)
        np.testing.assert_allclose(th.numpy()[:t], _np(jh)[:t], rtol=0,
                                   atol=LOGITS_ATOL)
        nxt = int(np.argmax(_np(jl)[t - 1]))
        toks, pos = np.array([nxt]), np.array([pos[t - 1] + 1])
        t, tb, wmask = 1, 1, np.ones(1, bool)
    np.testing.assert_array_equal(np.asarray(jc.pos), tc.pos.numpy())
    np.testing.assert_allclose(tc.k.float().numpy(),
                               _np(jc.k.astype(jnp.float32)), atol=LOGITS_ATOL)


class WordTokenizer:
    """Specials and whitespace-separated words, one id each. Every prompt
    of the simplex protocol then fits a ubatch of at most 8 rows."""

    SPECIALS = ["<|im_end|>", "<|im_start|>", "<|tts_bos|>", "<|audio_start|>",
                "<|audio_end|>", "<think>", "</think>", "<|turn_eos|>", "</s>",
                "<|listen|>"]

    def __init__(self):
        names = {s: 300 + i for i, s in enumerate(self.SPECIALS)}

        class V:
            token_to_id = names
            eos_id = None

            @staticmethod
            def is_eog(tid):
                return tid == names["</s>"]

        self.vocab = V()
        self._split = re.compile("(" + "|".join(map(re.escape, names)) + ")")

    def encode(self, text, add_special=False, parse_special=True):
        ids = []
        for part in self._split.split(text):
            if part in self.vocab.token_to_id:
                ids.append(self.vocab.token_to_id[part])
            else:
                ids += [sum(w.encode()) % 256 for w in part.split()]
        return ids

    def decode(self, ids):
        return "".join(f"{int(i)} " for i in ids)


def _serve(pipe, turns):
    pipe.stream_prefill(index=0, system_prompt="you are a tiny test model")
    out = []
    for r in range(turns):
        pipe.stream_decode(round_idx=r, max_new_tokens=16)
        while True:
            try:
                out.append(pipe.text_out.get_nowait())
            except queue.Empty:
                break
    return out


def test_greedy_turn_token_identical(tiny):
    """A 16-token greedy stream_decode turn of the port emits exactly the
    token stream of omni_tpu's pipeline on the same weights.

    Identity holds while every greedy choice has a top-2 margin above the
    logit noise of LOGITS_ATOL; on this fixture a second turn meets a
    closer call (its 4th token), so the test serves the one turn the
    JAX-package parity contract asks for."""
    jcfg, jparams, tcfg, tparams = tiny
    jctx = JaxContext(jcfg, jparams, jq.forward, jq.embed, n_ctx=512,
                      sampler=JaxSamplerParams(greedy=True))
    jpipe = JaxPipeline(llm=jctx, tokenizer=WordTokenizer(),
                        config=JaxSessionConfig(duplex=False, use_tts=False,
                                                max_preserved_context=512))
    try:
        want = _serve(jpipe, 1)
    finally:
        jpipe.shutdown()
    tctx = Context(tcfg, tparams, tq.forward, tq.embed, n_ctx=512,
                   sampler=SamplerParams(greedy=True), device="cpu")
    tpipe = OmniPipeline(tctx, WordTokenizer(),
                         SessionConfig(max_preserved_context=512))
    got = _serve(tpipe, 1)
    # 16 sampled; the budget-stop token is never fed or emitted
    assert sum(len(e["content"].split()) for e in got) >= 10
    assert got == want
    assert tctx.n_past == jctx.n_past and tctx.cells_used == jctx.cells_used


# the JAX package serves through jitted steps, and XLA's fused compile of
# the forward moves its logits by up to ~0.05 against its own op-by-op
# forward (measured 0.042 on the first prefill of the fixture below, where
# the port and the op-by-op forward agree to 1.2e-6); over two turns the
# port stays within 0.052 of the jitted steps
JIT_LOGITS_ATOL = 0.1
SYSTEM_PROMPT = "you are a tiny test model"


def _turn_tokens(events):
    """Each turn's fed tokens, from the events of a pipeline whose text
    filter passes every token."""
    turns, cur = [], []
    for e in events:
        cur += [int(t) for t in e["content"].split()]
        if e.get("stop"):
            turns.append(cur)
            cur = []
    return turns


def test_second_turn_divergence_is_a_rounding_flip(tiny):
    """A second greedy turn of the port departs from omni_tpu's where
    omni_tpu's top-2 margin is smaller than the logit noise between the
    two: a rounding flip, not a fault.

    Both pipelines serve two 16-token turns. Then both contexts are fed
    omni_tpu's own token stream (teacher-forced, the pipeline's feed order)
    and their logits compared row by row: they agree within JIT_LOGITS_ATOL,
    and at the first token where the free-running turns differ (the 4th of
    the second turn on this fixture), omni_tpu's margin between its top two
    logits is below the logit difference measured there. The first prefill
    also goes through omni_tpu's forward op by op, which the port matches to
    1e-4: the noise is the jitted compile's, not the port's."""
    jcfg, jparams, tcfg, tparams = tiny
    pass_all = mock.patch.object(JaxPipeline, "is_valid_tts_token",
                                 lambda self, t: True)
    with pass_all, mock.patch.object(OmniPipeline, "is_valid_tts_token",
                                     lambda self, t: True):
        jctx = JaxContext(jcfg, jparams, jq.forward, jq.embed, n_ctx=512,
                          sampler=JaxSamplerParams(greedy=True))
        jpipe = JaxPipeline(llm=jctx, tokenizer=WordTokenizer(),
                            config=JaxSessionConfig(duplex=False, use_tts=False,
                                                    max_preserved_context=512))
        try:
            want = _turn_tokens(_serve(jpipe, 2))
        finally:
            jpipe.shutdown()
        tpipe = OmniPipeline(
            Context(tcfg, tparams, tq.forward, tq.embed, n_ctx=512,
                    sampler=SamplerParams(greedy=True), device="cpu"),
            WordTokenizer(), SessionConfig(max_preserved_context=512))
        got = _turn_tokens(_serve(tpipe, 2))
    assert len(want) == len(got) == 2 and got[0] == want[0]

    tok = WordTokenizer()
    feeds = [tok.encode("<|im_start|>system\n" + SYSTEM_PROMPT
                        + "\n<|audio_start|>"),
             tok.encode("<|audio_end|><|im_end|>\n<|im_start|>user\n")]
    rows = {}  # (turn, index) -> feed whose last logits sample that token
    for r, turn in enumerate(want):
        feeds.append(tok.encode(SIMPLEX_ASSISTANT_PROMPT))
        for i, t in enumerate(turn):
            rows[(r, i)] = len(feeds) - 1
            feeds.append([t])
        feeds.append(tok.encode(SIMPLEX_TURN_END))
    jctx = JaxContext(jcfg, jparams, jq.forward, jq.embed, n_ctx=512,
                      sampler=JaxSamplerParams(greedy=True))
    tctx = Context(tcfg, tparams, tq.forward, tq.embed, n_ctx=512,
                   sampler=SamplerParams(greedy=True), device="cpu")
    jl, tl = [], []
    for ids in feeds:
        jl.append(_np(jctx.decode(JaxBatch(tokens=np.asarray(ids)))[0])[-1])
        tl.append(tctx.decode(Batch(tokens=np.asarray(ids)))[0][-1].numpy())
    jl, tl = np.stack(jl), np.stack(tl)
    diff = np.abs(jl - tl).max(-1)
    assert diff.max() <= JIT_LOGITS_ATOL

    diverged = [i for i, (a, b) in enumerate(zip(want[1], got[1])) if a != b]
    if diverged:
        row = rows[(1, diverged[0])]
        top2 = np.sort(jl[row])[-2:]
        assert int(np.argmax(jl[row])) == want[1][diverged[0]]
        assert int(np.argmax(tl[row])) == got[1][diverged[0]]
        assert top2[1] - top2[0] < diff[row] <= JIT_LOGITS_ATOL

    # the first prefill, op by op through omni_tpu's forward
    ids = np.asarray(feeds[0])
    n, tb = len(ids), 16
    toks = np.pad(ids, (0, tb - n))
    pos, wmask = np.pad(np.arange(n), (0, tb - n)), np.arange(tb) < n
    jc = JaxKVCache.create(jcfg.n_layers, 64, jcfg.n_kv_heads, jcfg.head_dim,
                           rope_base=jcfg.rope_base)
    eager, _, _ = jq.forward(jparams, jcfg, jq.embed(jparams, jnp.asarray(toks)),
                             jnp.asarray(pos, jnp.int32), jnp.zeros(tb, jnp.int32),
                             jc, jc.find_slots(tb), jnp.asarray(wmask))
    np.testing.assert_allclose(tl[0], _np(eager)[n - 1], rtol=0, atol=1e-4)


def test_synth_params_layout():
    cfg = tq.Qwen3Config(n_layers=2, d_model=256, n_heads=2, n_kv_heads=1,
                         head_dim=128, d_ff=512, n_vocab=100)
    gen = torch.Generator().manual_seed(0)
    p = synth_qwen3_params(cfg, "cpu", gen, fuse=True)
    lp = p["layers"][1]
    assert set(lp) >= {"wqkv", "wo", "w_gateup", "w_down"} and "wq" not in lp
    assert lp["wqkv"].shape == (256 + 2 * 128, 256)
    assert lp["w_gateup"].q.shape == (1024, 128)
    assert p["output"].shape == (100, 256)
    assert p["token_embd"].dtype == torch.bfloat16
    assert 20 <= int(lp["wo"].sc.min()) and int(lp["wo"].sc.max()) < 64
    assert 0 <= int(lp["wo"].mn.min()) and int(lp["wo"].mn.max()) < 40
    assert 1e-5 <= float(lp["wo"].d.min()) and float(lp["wo"].d.max()) < 1.1e-4
    ctx = Context(cfg, p, tq.forward, tq.embed, n_ctx=64, device="cpu")
    logits = ctx.prefill(np.arange(5))
    assert logits.shape == (100,) and torch.isfinite(logits).all()


def test_entry_points_need_cuda_or_an_explicit_device():
    cfg = tq.Qwen3Config(n_layers=1, d_model=256, n_heads=2, n_kv_heads=1,
                         head_dim=128, d_ff=256, n_vocab=8)
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="CUDA"):
            omni_tpu_torch.resolve_device()
        with pytest.raises(RuntimeError, match="CUDA"):
            Context(cfg, {}, tq.forward, tq.embed, n_ctx=8)
        with pytest.raises(RuntimeError, match="CUDA"):
            synth_qwen3_params(cfg)
    assert omni_tpu_torch.resolve_device("cpu") == torch.device("cpu")
