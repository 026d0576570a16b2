"""The port's Q8_0 slice and F16 load path (omni_tpu_torch) against the JAX
package: the Q8_0 codec and planes, the plain laws of kernel E and of
kernel D's Q8_0 branch against the Pallas kernels in interpret mode, tiny
Q8_0 and F16 GGUF files served greedily by both packages, and the two
repairs that came with the slice: chip_smoke.py's flip-share limit, and the
dense dots' f32-output overload on the card. Everything here runs on the
CPU; the CUDA kernels are held against their plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_tpu.cli import quantize as jax_quantize
from omni_tpu.core import GGMLType, quants
from omni_tpu.core.gguf import GGUFReader as JaxReader
from omni_tpu.kernels import dequant as jax_dequant
from omni_tpu.kernels.dequant_matmul import qmatmul_gp_pallas, qmatmul_pallas
from omni_tpu.models import qwen3 as jq
from omni_tpu.omni.pipeline import OmniPipeline as JaxPipeline
from omni_tpu.omni.pipeline import SessionConfig as JaxSessionConfig
from omni_tpu.runtime import Context as JaxContext
from omni_tpu.runtime import SamplerParams as JaxSamplerParams
from omni_tpu.testing import write_tiny_qwen3
from omni_tpu_torch import testing_synth
from omni_tpu_torch.core import quants as port_quants
from omni_tpu_torch.core.gguf import GGUFReader
from omni_tpu_torch.kernels import attention
from omni_tpu_torch.kernels import dequant_matmul as dm
from omni_tpu_torch.kernels import qformats
from omni_tpu_torch.models import qwen3 as tq
from omni_tpu_torch.omni.pipeline import OmniPipeline, SessionConfig
from omni_tpu_torch.runtime import Context, SamplerParams
from test_torch_gguf import _assert_same_params
# the module's autouse fixture: no JAX compile-cache writes from this file
from test_torch_kernels import ATOL, ORDER_ATOL, RTOL, _x, no_compile_cache  # noqa: F401
from test_torch_kernels import _pair as _any_pair
from test_torch_model import WordTokenizer, _serve

Q8_0 = GGMLType.Q8_0


def _pair(seed, n=24, k=4096):
    """(JAX Q8_0 QTensor, the port's QTensor on the CPU, the blocks)."""
    return _any_pair(seed, qtype=Q8_0, n=n, k=k)


# ---------------------------------------------------------------- the codec

@pytest.mark.parametrize("n,k", [(16, 512), (24, 1280), (7, 96)])
def test_q8_0_dequant_bit_exact(n, k):
    """The port's numpy oracle, its torch dequant of the converted planes
    and the JAX dequant all equal omni_tpu's block dequantiser bit for
    bit, at K that are no multiple of 256 too."""
    jqt, pqt, blocks = _pair(n + k, n=n, k=k)
    ref = quants.dequantize(blocks, Q8_0, (n, k))
    np.testing.assert_array_equal(port_quants.dequantize(blocks, Q8_0, (n, k)), ref)
    np.testing.assert_array_equal(qformats.dequant(pqt).numpy(), ref)
    np.testing.assert_array_equal(np.asarray(jax_dequant(jqt)), ref)


@pytest.mark.parametrize("n,k", [(5, 32), (24, 1280), (8, 4096)])
def test_q8_0_repack_is_the_transpose_of_jax_repack(n, k):
    """The port's torch repack of the 34-byte blocks gives the transposes
    of the JAX package's planes (q int8 [N, K], d f32 [N, K/32]) and
    dequantises to the reference bit for bit."""
    jqt, _, blocks = _pair(3 * n + k, n=n, k=k)
    pqt = qformats.repack(torch.from_numpy(blocks.copy()), Q8_0, (n, k))
    qformats.check_qtensor(pqt, Q8_0)
    assert set(pqt.planes()) == set(jqt.planes()) == {"q", "d"}
    for nm, a in pqt.planes().items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jqt, nm)).T)
    np.testing.assert_array_equal(qformats.dequant(pqt).numpy(),
                                  quants.dequantize(blocks, Q8_0, (n, k)))


def test_from_jax_params_carries_q8_0():
    jqt, pqt, _ = _pair(7, n=16, k=1280)
    assert pqt.ggml_type == Q8_0 and pqt.shape == (16, 1280)
    assert pqt.q.dtype == torch.int8 and tuple(pqt.q.shape) == (16, 1280)
    assert pqt.d.dtype == torch.float32 and tuple(pqt.d.shape) == (16, 40)
    assert pqt.sc is None and pqt.mn is None and pqt.dm is None and pqt.qh is None
    qformats.check_qtensor(pqt, Q8_0)
    np.testing.assert_array_equal(qformats.dequant(pqt).numpy(),
                                  np.asarray(jax_dequant(jqt)))


def test_q8_0_load_policy_matches_jax():
    """A 2-D Q8_0 tensor stays quantized (the JAX planes, transposed); with
    keep_quantized=False, or 1-D, it dequantises to the JAX values."""
    from omni_tpu.kernels.qformats import load_quantized as jax_load

    x = np.random.default_rng(2).standard_normal((4, 96), dtype=np.float32)
    blocks = quants.quantize(x, Q8_0)
    kept = qformats.load_quantized(blocks, Q8_0, (4, 96), device="cpu")
    assert isinstance(kept, qformats.QTensor)
    jkept = jax_load(blocks, Q8_0, (4, 96))
    for nm, a in kept.planes().items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jkept, nm)).T)
    for shape, keep in (((4, 96), False), ((384,), True)):
        got = qformats.load_quantized(blocks, Q8_0, shape, keep, "cpu")
        want = np.asarray(jax_load(blocks, Q8_0, shape, keep).astype(np.float32))
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_check_qtensor_takes_q8_0_granule():
    _, pqt, _ = _pair(1, n=4, k=96)
    qformats.check_qtensor(pqt, Q8_0)
    pqt.shape = (4, 100)
    with pytest.raises(ValueError, match="multiple of 32"):
        qformats.check_qtensor(pqt, Q8_0)


# ------------------------------------------------------------ the kernels' laws

@pytest.mark.parametrize("k", [256, 1280, 4096], ids=lambda k: f"k{k}")
@pytest.mark.parametrize("m", [1, 2, 3, 8], ids=lambda m: f"m{m}")
def test_plain_q8_0_gemv_matches_gp_pallas(m, k):
    """Kernel E's plain law == qmatmul_gp_pallas (interpret) for Q8_0 on a
    ragged N, within tests/test_qkernels.py's tolerance and ORDER_ATOL."""
    jqt, pqt, _ = _pair(10 * m + k, k=k)
    x = _x(m + 3, m, k)
    want = np.asarray(qmatmul_gp_pallas(jnp.asarray(x), jqt, block_n=16,
                                        out_dtype=jnp.float32, interpret=True))
    got = dm.q8_0_gemv(torch.from_numpy(x).to(torch.bfloat16), pqt,
                       torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ORDER_ATOL)


@pytest.mark.parametrize("k", [1280, 800, 4096], ids=lambda k: f"k{k}")
@pytest.mark.parametrize("m", [1, 64], ids=lambda m: f"m{m}")
def test_plain_qgemm_q8_0_matches_qmatmul_pallas(m, k):
    """Kernel D's plain Q8_0 law (w = bf16(q·d), then a dot in f32) ==
    qmatmul_pallas (interpret) on a ragged N, at K = 1280 (the odd-divisor
    shape of test_qmatmul_gp_odd_k_divisor), 800 (25 blocks, no multiple
    of 256) and 4096."""
    jqt, pqt, _ = _pair(10 * m + k + 2, k=k)
    x = _x(m + 11, m, k)
    want = np.asarray(qmatmul_pallas(jnp.asarray(x), jqt, block_m=64,
                                     block_n=16, out_dtype=jnp.float32,
                                     interpret=True))
    got = dm.qgemm(torch.from_numpy(x).to(torch.bfloat16), pqt,
                   torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ORDER_ATOL)


def test_q8_0_plain_laws_round_the_weights_as_the_reference():
    """D's plain Q8_0 law rounds each weight once, f32(q·d) to bf16: its
    bf16 weights equal the JAX bf16 dequant bit for bit."""
    from omni_tpu.kernels.qformats import dequant_tile

    jqt, pqt, _ = _pair(4, n=16, k=1280)
    want = np.asarray(dequant_tile(Q8_0, jqt.planes(), jnp.bfloat16)
                      .astype(jnp.float32)).T
    got = qformats.dequant(pqt, torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["q8_0_gemv", "qgemm"])
def test_chip_smoke_f64_law_is_the_q8_0_kernels_law(name):
    """chip_smoke.py's f64 law of E and D-Q8_0 equals the plain version to
    f32 noise (the reference of the Q8_0 teacher-forced check)."""
    from chip_smoke import law_f64

    _, pqt, _ = _pair(9, n=40, k=1280)
    x = torch.from_numpy(_x(3, 3, 1280)).to(torch.bfloat16)
    want = getattr(dm, name + "_plain")(x, pqt, torch.float32)
    got = law_f64(name, x, pqt, torch.float32)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


# ------------------------------------------------------ the tiny GGUF files

@pytest.fixture(scope="module")
def q8_0_file(tmp_path_factory):
    """The tiny Qwen3 of the JAX package's tools, quantized Q8_0 by
    `omni-quantize`: every weight Q8_0 but the head, which the JAX
    quantizer makes Q6_K under every recipe."""
    d = tmp_path_factory.mktemp("q8_0")
    src, dst = d / "f32.gguf", d / "q8_0.gguf"
    write_tiny_qwen3(src, qtype=GGMLType.F32, n_layers=2, d_model=256,
                     n_heads=2, n_kv_heads=1, head_dim=128, d_ff=512,
                     n_vocab=512, tied_head=False)
    jax_quantize.quantize_file(str(src), str(dst), "Q8_0")
    return dst


@pytest.fixture(scope="module")
def f16_file(tmp_path_factory):
    """The tiny Qwen3 with F16 weights (every 2-D tensor with K % 256 == 0)
    and a head tied to the embedding."""
    path = tmp_path_factory.mktemp("f16") / "f16.gguf"
    write_tiny_qwen3(path, qtype=GGMLType.F16, n_layers=2, d_model=256,
                     n_heads=2, n_kv_heads=1, head_dim=128, d_ff=512,
                     n_vocab=512)
    return path


def test_load_params_q8_0_matches_jax(q8_0_file):
    tparams = tq.load_params(GGUFReader(q8_0_file), device="cpu")
    _assert_same_params(jq.load_params(JaxReader(q8_0_file)), tparams)
    types = {w.ggml_type for lp in tparams["layers"] for w in lp.values()
             if isinstance(w, qformats.QTensor)}
    assert types == {Q8_0}
    assert tparams["output"].ggml_type == GGMLType.Q6_K
    assert tparams["token_embd"].dtype == torch.bfloat16


def test_load_params_f16_matches_jax(f16_file):
    """F16 weights load as dense bf16 (the JAX package's rounding), the
    head is tied (None)."""
    tparams = tq.load_params(GGUFReader(f16_file), device="cpu")
    _assert_same_params(jq.load_params(JaxReader(f16_file)), tparams)
    lp = tparams["layers"][0]
    assert lp["wq"].dtype == torch.bfloat16 and lp["w_down"].dtype == torch.bfloat16
    assert tparams["output"] is None


@pytest.mark.parametrize("which", ["q8_0_file", "f16_file"])
def test_greedy_turn_from_the_file_token_identical(which, request):
    """A 16-token greedy turn served from the tiny Q8_0 (or F16) file,
    loaded by each package's own reader and loader, emits the same tokens
    in both."""
    path = request.getfixturevalue(which)
    jr = JaxReader(path)
    jctx = JaxContext(jq.Qwen3Config.from_gguf(jr.kv), jq.load_params(jr),
                      jq.forward, jq.embed, n_ctx=512,
                      sampler=JaxSamplerParams(greedy=True))
    jpipe = JaxPipeline(llm=jctx, tokenizer=WordTokenizer(),
                        config=JaxSessionConfig(duplex=False, use_tts=False,
                                                max_preserved_context=512))
    try:
        want = _serve(jpipe, 1)
    finally:
        jpipe.shutdown()
    tr = GGUFReader(path)
    tctx = Context(tq.Qwen3Config.from_gguf(tr.kv),
                   tq.load_params(tr, device="cpu"), tq.forward, tq.embed,
                   n_ctx=512, sampler=SamplerParams(greedy=True), device="cpu")
    tpipe = OmniPipeline(tctx, WordTokenizer(),
                         SessionConfig(max_preserved_context=512))
    got = _serve(tpipe, 1)
    assert sum(len(e["content"].split()) for e in got) >= 10
    assert got == want
    assert tctx.n_past == jctx.n_past


# ------------------------------------------------- the port's synthetic files

def test_q8_0_recipe_keeps_a_q8_0_head():
    """llama.cpp's rule: the head becomes Q6_K only when the recipe's type
    is not Q8_0 (the JAX quantizer makes it Q6_K under every recipe)."""
    pick = testing_synth.pick_type
    assert pick("output.weight", "Q8_0", Q8_0, 36) == Q8_0
    assert jax_quantize.pick_type("output.weight", "Q8_0", Q8_0, 36) == GGMLType.Q6_K
    for name in ("token_embd.weight", "blk.0.attn_v.weight", "blk.3.ffn_down.weight"):
        assert pick(name, "Q8_0", Q8_0, 36) == Q8_0
    assert pick("output.weight", "Q4_K_M", GGMLType.Q4_K, 36) == GGMLType.Q6_K


def test_write_qwen3_gguf_q8_0_loads_the_same_in_both_packages(tmp_path):
    """The port's random Q8_0 writer: every 2-D tensor Q8_0, read the same
    by both packages, values over -127..127 with the other weights' RMS
    and no common part."""
    cfg = tq.Qwen3Config(n_layers=2, d_model=256, n_heads=2, n_kv_heads=1,
                         head_dim=128, d_ff=512, n_vocab=300)
    path = tmp_path / "synth_q8_0.gguf"
    types = testing_synth.write_qwen3_gguf(path, cfg, "Q8_0",
                                           torch.Generator().manual_seed(0))
    assert {t for n, t in types.items() if not n.endswith("norm.weight")} == {Q8_0}
    tparams = tq.load_params(GGUFReader(path), device="cpu")
    _assert_same_params(jq.load_params(JaxReader(path)), tparams)
    w = tparams["layers"][1]["w_gate"]
    assert int(w.q.min()) == -127 and int(w.q.max()) == 127
    deq = qformats.dequant(w)
    assert 0.02 < deq.pow(2).mean().sqrt() < 0.03 and abs(deq.mean()) < 0.002


def test_synth_qwen3_dense_params_round_through_f16():
    """The F16 path's weights are bf16 values of F16 draws (load_quantized
    on an F16 tensor), unfused, with a separate head."""
    cfg = tq.Qwen3Config(n_layers=1, d_model=256, n_heads=2, n_kv_heads=1,
                         head_dim=128, d_ff=512, n_vocab=300)
    p = testing_synth.synth_qwen3_dense_params(cfg, "cpu",
                                               torch.Generator().manual_seed(0))
    lp = p["layers"][0]
    assert set(lp) >= {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}
    for w in (lp["wq"], lp["w_down"], p["output"], p["token_embd"]):
        assert w.dtype == torch.bfloat16
        assert torch.equal(w.float().to(torch.float16).float().to(torch.bfloat16), w)
    assert 0.02 < lp["w_gate"].float().pow(2).mean().sqrt() < 0.03


# ------------------------------------------- repair: the held flip limit

@pytest.mark.parametrize("plain,kernel,n,held", [
    (2.94e-4, 7.11e-3, 64 * 4096, False),  # the unsplit kernel B at down
    (1.91e-4, 2.22e-3, 64 * 6144, False),  # ... and at wqkv
    (2.94e-4, 1.91e-4, 64 * 4096, True),  # the split B at down
    (3.20e-4, 2.29e-4, 64 * 4096, True),  # kernel D, its worst reading
    (0.0, 6.51e-4, 3 * 1024, True),  # 2 of 3072 outputs, plain 0
    (0.0, 9.77e-4, 1024, True),  # one flip at M = 1, N = 1024
], ids=["b_unsplit_down", "b_unsplit_wqkv", "b_split_down", "d_worst",
        "two_flips_wv", "one_flip_m1"])
def test_flip_limit_holds_the_measured_shares(plain, kernel, n, held):
    """The limit rejects the unsplit accumulation's measured shares at
    both shapes and passes every share measured on correct kernels."""
    from chip_smoke import flip_limit

    assert (kernel <= flip_limit(plain, n)) == held


def _standin_flips(got: torch.Tensor, share: float, seed: int) -> torch.Tensor:
    """`got` (bf16) with `share` of its outputs moved one bf16 ulp."""
    bits = got.view(torch.int16).clone()
    pick = torch.rand(got.shape, generator=torch.Generator().manual_seed(seed)) < share
    bits[pick] += 1  # the next bf16 away from zero
    return bits.view(torch.bfloat16)


def test_check_kernel_rejects_a_kernel_that_flips_more():
    """chip_smoke.check_kernel fails a stand-in kernel that rounds ~1 % of
    its bf16 outputs otherwise (the plain law, moved one ulp), though it
    passes the kernel-vs-plain limit, and passes the plain version against
    itself."""
    from chip_smoke import check_kernel, limit_ratio

    qt = testing_synth.synth_q8_0(256, 4096, "cpu", torch.Generator().manual_seed(0))

    def standin(x, w, out_dtype):
        return _standin_flips(dm.q8_0_gemv_plain(x, w, out_dtype), 0.01, 1)

    x = torch.randn((8, 4096), generator=torch.Generator().manual_seed(2))
    plain = dm.q8_0_gemv_plain(x.bfloat16(), qt).float()
    assert limit_ratio(standin(x.bfloat16(), qt, torch.bfloat16).float(), plain) <= 1.0
    max_err = {}
    check_kernel("q8_0_gemv", dm.q8_0_gemv_plain, dm.q8_0_gemv_plain, qt, "wq",
                 8, torch.bfloat16, torch.Generator().manual_seed(3), max_err)
    with pytest.raises(SystemExit, match="flip_limit"):
        check_kernel("q8_0_gemv", standin, dm.q8_0_gemv_plain, qt, "wq", 8,
                     torch.bfloat16, torch.Generator().manual_seed(3), max_err)


# -------------------------------- repair: dense dots with no f32 weight copy

class _Spy:
    """Records every dtype conversion of a tensor that shares `watched`'s
    storage to f32, and stands in for the card's f32-output overloads (no
    CPU kernel) with the widened product, checking their operands."""

    def __init__(self, watched):
        self.ptrs = {w.untyped_storage().data_ptr() for w in watched}
        self.widened, self.calls = [], []
        self._to, self._float = torch.Tensor.to, torch.Tensor.float
        self._mm, self._bmm = torch.mm, torch.bmm

    def _watch(self, src, out):
        if (out.dtype == torch.float32 and src.dtype != torch.float32
                and src.untyped_storage().data_ptr() in self.ptrs):
            self.widened.append(tuple(src.shape))
        return out

    def to(self, t, *a, **k):
        return self._watch(t, self._to(t, *a, **k))

    def float(self, t, *a, **k):
        return self._watch(t, self._float(t, *a, **k))

    def overload(self, name, fn):
        def call(a, b, *args, out_dtype=None, **kw):
            if out_dtype is None:
                return fn(a, b, *args, **kw)
            self.calls.append((name, a.dtype, b.dtype, out_dtype, tuple(a.shape)))
            return fn(self._to(a, torch.float32), self._to(b, torch.float32))
        return call

    def patches(self):
        return [mock.patch.object(torch.Tensor, "to", lambda t, *a, **k: self.to(t, *a, **k)),
                mock.patch.object(torch.Tensor, "float",
                                  lambda t, *a, **k: self.float(t, *a, **k)),
                mock.patch.object(torch, "mm", self.overload("mm", self._mm)),
                mock.patch.object(torch, "bmm", self.overload("bmm", self._bmm))]


def _on_mocked_card(module, spy, fn, *args):
    with mock.patch.object(module, "_on_cuda", return_value=True):
        for p in spy.patches():
            p.start()
        try:
            return fn(*args)
        finally:
            mock.patch.stopall()


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_dense_matmul_on_a_mocked_card_uses_the_f32_output_overload(out_dtype):
    """On the card the dense branch of `matmul` makes one torch.bmm(bf16,
    bf16, out_dtype=float32) call whose batch is the SPLIT_K-element chunks
    of K (views of x and w), and never widens the weight; its result is the
    CPU law's, summed in another order (at most one bf16 ulp apart)."""
    rng = np.random.default_rng(0)
    k = 3 * dm.SPLIT_K
    w = torch.from_numpy(rng.standard_normal((48, k), dtype=np.float32)).bfloat16()
    x = torch.from_numpy(rng.standard_normal((3, k), dtype=np.float32))
    want = dm.matmul(x, w, out_dtype)
    spy = _Spy([w])
    got = _on_mocked_card(dm, spy, dm.matmul, x, w, out_dtype)
    assert spy.calls == [("bmm", torch.bfloat16, torch.bfloat16, torch.float32,
                          (3, 3, dm.SPLIT_K))]
    assert spy.widened == []
    assert got.dtype == out_dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=1e-6)


def test_bmm_f32_sums_each_chunk_of_k_on_its_own():
    """Where the chunks cannot be the batch (B > 1, or a K that SPLIT_K
    does not divide) bmm_f32 makes one product per chunk, the last one
    ragged, each into a fresh f32 output; the sum is the f32 law's."""
    rng = np.random.default_rng(2)
    k = 2 * dm.SPLIT_K + 88
    a = torch.from_numpy(rng.standard_normal((2, 5, k), dtype=np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((2, k, 7), dtype=np.float32)).bfloat16()
    spy = _Spy([b])
    got = _on_mocked_card(dm, spy, dm.bmm_f32, a, b)
    assert [c[-1][-1] for c in spy.calls] == [dm.SPLIT_K, dm.SPLIT_K, 88]
    assert spy.widened == []
    want = a.double() @ b.double()
    torch.testing.assert_close(got, want.float(), rtol=1e-5, atol=1e-5)


def test_attention_mm_on_a_mocked_card_uses_the_f32_output_overload():
    """On the card attention's products call torch.bmm(bf16, bf16,
    out_dtype=float32), the one over a 600-cell pool in SPLIT_K-cell
    chunks, and never widen the bf16 K/V pool."""
    rng = np.random.default_rng(1)
    t, hq, hkv, d, s = 3, 4, 2, 16, 600

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    q, k_cur, v_cur = arr(t, hq, d), arr(t, hkv, d), arr(t, hkv, d)
    k_pool, v_pool = arr(hkv, s, d).bfloat16(), arr(hkv, s, d).bfloat16()
    mask_pool = torch.ones((t, s), dtype=torch.bool)
    mask_cur = torch.tril(torch.ones((t, t), dtype=torch.bool))
    want = attention.mixed_attention(q.bfloat16(), k_pool, v_pool, k_cur.bfloat16(),
                                     v_cur.bfloat16(), mask_pool, mask_cur)
    spy = _Spy([k_pool, v_pool])
    got = _on_mocked_card(attention, spy, attention.mixed_attention, q, k_pool,
                          v_pool, k_cur, v_cur, mask_pool, mask_cur)
    assert [c[:4] for c in spy.calls] == [
        ("bmm", torch.bfloat16, torch.bfloat16, torch.float32)] * 6
    # q.k over d for the pool and the batch, p.v over 256 + 256 + 88 cells
    # of the pool and the batch's 3
    assert [c[-1][-1] for c in spy.calls] == [d, d, dm.SPLIT_K, dm.SPLIT_K,
                                              s - 2 * dm.SPLIT_K, t]
    assert spy.widened == []
    # the card's law rounds q, k_cur, v_cur and the probabilities to bf16
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
