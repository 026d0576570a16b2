"""The port's quantized KV cache (q8_0 and q4_0 cells) against omni_tpu's:
the codecs and planes bit for bit, the write-then-read forward with every
layer's attention in the flash law, and a served greedy turn over a q8_0
Context. On the CPU the JAX package attends a quantized pool through
`read_layer` + `cache_attention`; where the test wants the flash law on
both sides it routes omni_tpu's `pool_attention` to its Pallas
`flash_decode` in interpret mode from here (nothing in omni_tpu changes)."""

import queue
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax._src import compilation_cache
from omni_tpu.core import GGMLType, GGUFReader
from omni_tpu.kernels.flash_attention import flash_decode as jax_flash_decode
from omni_tpu.models import qwen3 as jq
from omni_tpu.omni.pipeline import OmniPipeline as JaxPipeline
from omni_tpu.omni.pipeline import SessionConfig as JaxSessionConfig
from omni_tpu.runtime import Context as JaxContext
from omni_tpu.runtime import SamplerParams as JaxSamplerParams
from omni_tpu.runtime import kv_cache as jkv
from omni_tpu.testing import write_tiny_qwen3
from omni_tpu_torch.convert import from_jax_params
from omni_tpu_torch.kernels import attention
from omni_tpu_torch.kernels import flash_attention as fa
from omni_tpu_torch.models import qwen3 as tq
from omni_tpu_torch.omni.pipeline import OmniPipeline, SessionConfig
from omni_tpu_torch.runtime import Context, KVCache, SamplerParams
from omni_tpu_torch.runtime import kv_cache as tkv
from test_torch_model import JIT_LOGITS_ATOL, LOGITS_ATOL, WordTokenizer


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


def _np(a):
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _t(a):
    """A JAX or numpy array as a torch tensor (bf16 kept bf16)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _rows(seed, shape=(3, 2, 64)):
    """K/V rows with a zero row, exact .5 ties under both codecs (amax 127
    or 7 gives scale 1.0, so x/scale = x), extreme values and random rows,
    exact in bf16."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 2.0
    x[0, 0] = 0.0
    x[0, 1, :] = rng.choice([-2.5, -0.5, 0.5, 1.5, 2.5, 3.5, -126.5], shape[-1])
    x[0, 1, 0] = 127.0
    x[1, 0, :] = rng.choice([-6.5, -0.5, 0.5, 2.5, -3.5, 4.5], shape[-1])
    x[1, 0, 0] = -7.0
    return jnp.asarray(x, jnp.bfloat16)


@pytest.mark.parametrize("seed", [0, 1])
def test_codecs_bit_exact(seed):
    x = _rows(seed)
    for jf, tf in ((jkv._quant_rows, tkv.quant_rows),
                   (jkv._quant_rows4, tkv.quant_rows4)):
        js, jq_ = jf(x)
        ts, tq_ = tf(_t(x))
        np.testing.assert_array_equal(_np(js), ts.numpy())
        assert tq_.dtype == {jnp.int8: torch.int8, jnp.uint8: torch.uint8}[jq_.dtype.type]
        np.testing.assert_array_equal(np.asarray(jq_), tq_.numpy())
    js, jq4 = jkv._quant_rows4(x)
    np.testing.assert_array_equal(
        _np(jkv._dequant4(jq4, js)),
        tkv.dequant4(_t(jq4), _t(js)).float().numpy())
    # the ties rounded half to even, the zero row's scale is 1
    s8, q8 = tkv.quant_rows(_t(x))
    assert s8[0, 0] == 1.0 and not q8[0, 0].any()
    assert set(q8[0, 1].tolist()) <= {-2, 0, 2, 4, -126, 127}


@pytest.mark.parametrize("kv", ["q8_0", "q4_0"])
def test_create_matches_jax(kv):
    jdt = {"q8_0": jnp.int8, "q4_0": "q4_0"}[kv]
    jc = jkv.KVCache.create(3, 32, 2, 64, dtype=jdt)
    tc = KVCache.create(3, 32, 2, 64, "cpu", dtype=kv)
    assert tc.bits == jc.bits and tc.quantized and jc.quantized
    for nm in ("k", "v", "k_scale", "v_scale"):
        j, t = getattr(jc, nm), getattr(tc, nm)
        assert tuple(j.shape) == tuple(t.shape)
        assert str(j.dtype) == str(t.dtype).removeprefix("torch.")
    assert KVCache.create(1, 4, 1, 8, "cpu", dtype=torch.int8).bits == 8
    assert KVCache.create(1, 4, 1, 8, "cpu", dtype="int4").bits == 4
    assert not KVCache.create(1, 4, 1, 8, "cpu", dtype="bf16").quantized


@pytest.mark.parametrize("dtype", ["f16", torch.float16, "q5_0"])
def test_create_refuses_other_cell_types(dtype):
    with pytest.raises(ValueError, match="KV dtype"):
        KVCache.create(1, 4, 1, 8, "cpu", dtype=dtype)


@pytest.mark.parametrize("kv", ["q8_0", "q4_0"])
def test_write_read_planes_bit_exact(kv):
    """Per-layer writes of token-major K/V into scattered slots leave the
    same planes and scales as the JAX cache's, and read_layer (bf16
    dequant) and layer_planes (with a ragged limit) return the same."""
    L, S, H, D = 3, 24, 2, 64
    jc = jkv.KVCache.create(L, S, H, D, dtype={"q8_0": jnp.int8, "q4_0": "q4_0"}[kv])
    tc = KVCache.create(L, S, H, D, "cpu", dtype=kv)
    rng = np.random.default_rng(5)
    for layer, slots in ((0, [3, 7, 1]), (2, [0, 23, 5, 6]), (0, [7, 8])):
        k = _rows(layer + len(slots), (len(slots), H, D))
        v = jnp.asarray(rng.standard_normal((len(slots), H, D)), jnp.bfloat16)
        js = jnp.asarray(slots, jnp.int32)
        jc = jc.write(layer, js, k, v)
        assert tc.write(layer, torch.tensor(slots), _t(k), _t(v)) is tc
    for nm in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, nm)),
                                      getattr(tc, nm).numpy())
    for layer in range(L):
        for limit in (None, 16):
            for j, t in zip(jc.read_layer(layer, limit=limit),
                            tc.read_layer(layer, limit=limit)):
                assert t.dtype == torch.bfloat16
                np.testing.assert_array_equal(_np(j), t.float().numpy())
            for j, t in zip(jc.layer_planes(layer, limit=limit),
                            tc.layer_planes(layer, limit=limit)):
                np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_write_all_on_a_quantized_pool_is_per_layer_writes():
    rng = np.random.default_rng(1)
    k = torch.from_numpy(rng.standard_normal((2, 3, 2, 64), dtype=np.float32))
    slots = torch.tensor([4, 0, 9])
    a = KVCache.create(2, 12, 2, 64, "cpu", dtype="q4_0").write_all(slots, k, -k)
    b = KVCache.create(2, 12, 2, 64, "cpu", dtype="q4_0")
    for li in range(2):
        b.write(li, slots, k[li], -k[li])
    for nm in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(a, nm), getattr(b, nm))


def test_context_takes_the_server_cache_types():
    cfg = tq.Qwen3Config(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                         head_dim=64, d_ff=512, n_vocab=320)
    for kv, bits in (("q8_0", 8), ("q4_0", 4), (torch.bfloat16, 16), ("bf16", 16)):
        ctx = Context(cfg, {}, tq.forward, tq.embed, n_ctx=64, device="cpu",
                      kv_dtype=kv)
        assert ctx.cache.bits == bits and ctx.cache.quantized == (bits < 16)


def test_pool_attention_routes_by_cell_type():
    """A quantized pool goes to the flash wrapper on its raw planes, a bf16
    one to read_layer + cache_attention."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((3, 4, 64), dtype=np.float32))
    mask = torch.ones((3, 16), dtype=torch.bool)
    for kv in ("q8_0", "bf16"):
        c = KVCache.create(2, 20, 2, 64, "cpu", dtype=kv)
        kv_rows = torch.from_numpy(rng.standard_normal((2, 20, 2, 64), dtype=np.float32))
        c.write(1, torch.arange(20), kv_rows[0], kv_rows[1])
        with mock.patch.object(attention, "flash_decode", wraps=fa.flash_decode) as fd, \
                mock.patch.object(attention, "cache_attention",
                                  wraps=attention.cache_attention) as ca:
            out = attention.pool_attention(q, c, 1, mask, kv_limit=16)
        assert out.shape == (3, 4, 64) and out.dtype == torch.float32
        assert (fd.called, ca.called) == ((True, False) if kv == "q8_0" else (False, True))
        if kv == "q8_0":
            k, v, mk = fd.call_args.args[1:4]
            assert k.shape == v.shape == (2, 16, 64) and k.dtype == torch.int8
            assert fd.call_args.kwargs["k_scale"].shape == (2, 16)


# ------------------------------------------------------------------ model

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A tiny Q4_K Qwen3 GGUF (dims multiples of 256, D = 64) loaded by the
    JAX package, and the same weights in the port."""
    path = tmp_path_factory.mktemp("torch_kvq") / "tiny_q4k.gguf"
    write_tiny_qwen3(path, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                     head_dim=64, d_ff=512, n_vocab=320, qtype=GGMLType.Q4_K,
                     tied_head=False)
    reader = GGUFReader(path)
    jcfg = jq.Qwen3Config.from_gguf(reader.kv)
    jparams = jq.load_params(reader, fuse=True)
    tcfg = tq.Qwen3Config(**{f: getattr(jcfg, f)
                             for f in tq.Qwen3Config.__dataclass_fields__})
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _jax_flash_pool_attention(q, cache, layer, mask, scale=None, kv_limit=None,
                              **unused):
    """omni_tpu's pool_attention as it runs on the TPU: the Pallas flash
    kernel on the layer's raw planes (here in interpret mode)."""
    k, v, ks, vs = cache.layer_planes(layer, limit=kv_limit)
    return jax_flash_decode(q, k, v, mask, k_scale=ks, v_scale=vs, scale=scale,
                            interpret=True)


JAX_KV = {"q8_0": jnp.int8, "q4_0": "q4_0"}


def _forwards(tiny, kv, steps=4):
    """The same prefill (7 tokens padded to 8) and greedy single-token steps
    through omni_tpu's forward (op by op) and the port's, each over its own
    quantized cache. Yields (jax logits, port logits, jax cache, port cache)
    per step."""
    jcfg, jparams, tcfg, tparams = tiny
    jc = jkv.KVCache.create(2, 64, 2, 64, dtype=JAX_KV[kv], rope_base=jcfg.rope_base)
    tc = KVCache.create(2, 64, 2, 64, "cpu", dtype=kv)
    rng = np.random.default_rng(4)
    t, tb = 7, 8
    toks = np.pad(rng.integers(0, 320, t), (0, tb - t))
    pos = np.pad(np.arange(t), (0, tb - t))
    wmask = np.arange(tb) < t
    for _ in range(steps):
        js, ts = jc.find_slots(tb), tc.find_slots(tb)
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())
        jl, _, jc = jq.forward(
            jparams, jcfg, jq.embed(jparams, jnp.asarray(toks)),
            jnp.asarray(pos, jnp.int32), jnp.zeros(tb, jnp.int32), jc, js,
            jnp.asarray(wmask))
        tl, _, tc = tq.forward(
            tparams, tcfg, tq.embed(tparams, torch.from_numpy(toks)),
            torch.from_numpy(pos), torch.zeros(tb, dtype=torch.int64), tc, ts,
            torch.from_numpy(wmask))
        yield _np(jl)[:t], tl.numpy()[:t], jc, tc
        nxt = int(np.argmax(_np(jl)[t - 1]))
        toks, pos = np.array([nxt]), np.array([pos[t - 1] + 1])
        t, tb, wmask = 1, 1, np.ones(1, bool)


@pytest.mark.parametrize("kv", ["q8_0", "q4_0"])
def test_forward_matches_jax_flash_route(tiny, kv):
    """With omni_tpu's attention routed to its flash kernel (the TPU route),
    the port's write-then-read forward gives the same logits within
    test_torch_model's LOGITS_ATOL (the same laws summed in another f32
    order, which now and then flips a bf16 rounding), launches no kernel on the CPU, and leaves the same cell
    metadata and nearly the same cells (a K/V row may quantize one step
    apart where its bf16 inputs differ by an ulp)."""
    fa.reset_launches()
    with mock.patch.object(jq, "pool_attention", _jax_flash_pool_attention):
        for jl, tl, jc, tc in _forwards(tiny, kv):
            np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGITS_ATOL)
    assert fa.launches == {"flash_decode": 0, "flash_decode4": 0}
    np.testing.assert_array_equal(np.asarray(jc.pos), tc.pos.numpy())
    for j, t in zip(jc.read_layer(1), tc.read_layer(1)):
        np.testing.assert_allclose(t.float().numpy(), _np(j), rtol=0,
                                   atol=0.05 * float(np.abs(_np(j)).max()))


@pytest.mark.parametrize("kv", ["q8_0", "q4_0"])
def test_forward_vs_jax_cpu_route_is_a_rounding_flip(tiny, kv):
    """omni_tpu on the CPU attends a quantized pool through read_layer +
    cache_attention (bf16 dequant, f32 p), the port through the flash law
    (bf16 p·vs): the greedy tokens agree, or the first that differs is a
    near tie of omni_tpu's, its top-2 margin below the two logits'
    distance there."""
    diffs, tokens = [], []
    for jl, tl, _, _ in _forwards(tiny, kv, steps=10):
        diffs.append(np.abs(jl - tl).max())
        tokens.append((int(np.argmax(jl[-1])), int(np.argmax(tl[-1])), np.sort(jl[-1])[-2:]))
    # bf16-rounded cells and f32 p against exact int·scale cells and bf16
    # p·vs: measured up to 0.133 (q4_0, 10 steps) on logits of ~5
    assert max(diffs) <= 0.25
    for want, got, top2 in tokens:
        if want != got:
            assert top2[1] - top2[0] < max(diffs)
            break


def _serve(pipe):
    pipe.stream_prefill(index=0, system_prompt="you are a tiny test model")
    pipe.stream_decode(round_idx=0, max_new_tokens=16)
    out = []
    while True:
        try:
            out.append(pipe.text_out.get_nowait())
        except queue.Empty:
            return out


def test_greedy_turn_over_q8_0_kv_is_omni_tpus_up_to_a_rounding_flip(tiny):
    """A 16-token greedy stream_decode turn of the port over a q8_0 Context
    against omni_tpu's pipeline over its int8 cache, omni_tpu's attention
    routed to its flash kernel. The streams are identical up to the first
    token where omni_tpu's top-2 margin is below the logit distance between
    the two (on this fixture the 11th: margin 0.0020 against 0.0515), a
    rounding flip: both contexts, fed omni_tpu's tokens, pick the same
    token on every other row and lie within test_torch_model's
    JIT_LOGITS_ATOL (the noise of omni_tpu's jitted steps)."""
    from omni_tpu.runtime import Batch as JaxBatch
    from omni_tpu_torch.omni.pipeline import SIMPLEX_ASSISTANT_PROMPT
    from omni_tpu_torch.runtime import Batch

    jcfg, jparams, tcfg, tparams = tiny

    def jax_ctx():
        return JaxContext(jcfg, jparams, jq.forward, jq.embed, n_ctx=512,
                          kv_dtype=jnp.int8, sampler=JaxSamplerParams(greedy=True))

    def port_ctx():
        return Context(tcfg, tparams, tq.forward, tq.embed, n_ctx=512,
                       sampler=SamplerParams(greedy=True), device="cpu",
                       kv_dtype="q8_0")

    def tokens(events):
        return [int(x) for e in events for x in e["content"].split()]

    with mock.patch.object(jq, "pool_attention", _jax_flash_pool_attention):
        jctx = jax_ctx()
        jpipe = JaxPipeline(llm=jctx, tokenizer=WordTokenizer(),
                            config=JaxSessionConfig(duplex=False, use_tts=False,
                                                    max_preserved_context=512))
        try:
            want = tokens(_serve(jpipe))
        finally:
            jpipe.shutdown()
        tctx = port_ctx()
        got = tokens(_serve(OmniPipeline(tctx, WordTokenizer(),
                                         SessionConfig(max_preserved_context=512))))
        assert len(want) == len(got) >= 10
        assert tctx.cells_used == jctx.cells_used
        if got == want:
            return
        first = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
        tok = WordTokenizer()
        feeds = [tok.encode("<|im_start|>system\nyou are a tiny test model"
                            "\n<|audio_start|>"),
                 tok.encode("<|audio_end|><|im_end|>\n<|im_start|>user\n"),
                 tok.encode(SIMPLEX_ASSISTANT_PROMPT)] + [[t] for t in want]
        jc, tc = jax_ctx(), port_ctx()
        rows = []  # (jax logits, port logits) whose last row samples token i
        for ids in feeds[:3 + first]:
            rows.append((_np(jc.decode(JaxBatch(tokens=np.asarray(ids)))[0])[-1],
                         tc.decode(Batch(tokens=np.asarray(ids)))[0][-1].numpy()))
    rows = rows[2:]
    for i, (jl, tl) in enumerate(rows):
        assert np.abs(jl - tl).max() <= JIT_LOGITS_ATOL
        assert int(np.argmax(jl)) == want[i]
        assert int(np.argmax(tl)) == (want[i] if i < first else got[i])
    jl, tl = rows[first]
    top2 = np.sort(jl)[-2:]
    assert top2[1] - top2[0] < np.abs(jl - tl).max()
