"""The port's legacy 32-element formats (Q4_0, Q4_1, Q5_0, Q5_1) against
the JAX package: the codec, the planes (q in superblock halves, f32 d, Q4_1
and Q5_1's added min in dm, Q5_0 and Q5_1's high bits in qh), `dequant` and
the load policy; the plain laws of kernel A's and kernel B's legacy
branches against qmatmul_gp_pallas and qmatmul_splith_pallas in interpret
mode, and B's centered weights against `_sh_scales`'s law; tiny Q4_0 and
Q5_0 files, and the port's importance-matrix layout with Q4_1/Q5_1
ffn_down, served greedily by both packages. Everything here runs on the
CPU; the CUDA kernels are held against their plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

from types import SimpleNamespace
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_tpu.cli import quantize as jax_quantize
from omni_tpu.core import GGMLType, quants
from omni_tpu.core.gguf import GGUFReader as JaxReader
from omni_tpu.kernels import dequant as jax_dequant
from omni_tpu.kernels import repack as jax_repack
from omni_tpu.kernels.dequant_matmul import (_sh_qh_halves, _sh_scales,
                                             qmatmul_gp_pallas,
                                             qmatmul_splith_pallas)
from omni_tpu.kernels.qformats import load_quantized as jax_load
from omni_tpu.models import qwen3 as jq
from omni_tpu.omni.pipeline import OmniPipeline as JaxPipeline
from omni_tpu.omni.pipeline import SessionConfig as JaxSessionConfig
from omni_tpu.runtime import Context as JaxContext
from omni_tpu.runtime import SamplerParams as JaxSamplerParams
from omni_tpu.testing import write_tiny_qwen3
from omni_tpu_torch import testing_synth
from omni_tpu_torch.convert import from_jax_params
from omni_tpu_torch.core import quants as port_quants
from omni_tpu_torch.core.gguf import GGUFReader
from omni_tpu_torch.kernels import dequant_matmul as dm
from omni_tpu_torch.kernels import qformats
from omni_tpu_torch.models import qwen3 as tq
from omni_tpu_torch.omni.pipeline import OmniPipeline, SessionConfig
from omni_tpu_torch.runtime import Context, SamplerParams
from test_torch_gguf import _assert_same_params
# the module's autouse fixture: no JAX compile-cache writes from this file
from test_torch_kernels import ATOL, ORDER_ATOL, RTOL, _x, no_compile_cache  # noqa: F401
from test_torch_model import WordTokenizer, _serve

Q4_0, Q4_1, Q5_0, Q5_1 = GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1
LEGACY = [Q4_0, Q4_1, Q5_0, Q5_1]
ids = lambda t: t.name  # noqa: E731


def _blocks(seed, qtype, n, k):
    """Blocks of a seeded [n, k] weight quantized by omni_tpu's encoder,
    with the cases a kernel may get wrong: rows 1 and 2 shifted by +3 and
    -3 (Q4_1/Q5_1's added min m positive there, negative elsewhere), and
    d = 0 in block 1 of row 0 and block 0 of the last row (Q4_1/Q5_1 keep
    their m there: every weight of such a block is m)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k), dtype=np.float32)
    w[1] += 3.0
    w[2 % n] -= 3.0
    b = np.array(quants.quantize(w, qtype)).reshape(n, k // 32, -1)
    b[0, 1, :2] = 0
    b[-1, 0, :2] = 0
    return b.reshape(n * k // 32, -1)


def _pair(seed, qtype, n=24, k=4096):
    """(JAX QTensor, the port's QTensor on the CPU, the blocks)."""
    import jax

    blocks = _blocks(seed, qtype, n, k)
    jqt = jax_repack(blocks, qtype, (n, k))
    pqt = from_jax_params(jax.tree_util.tree_map(np.asarray, jqt), "cpu")
    return jqt, pqt, blocks


# ---------------------------------------------------------------- the codec

@pytest.mark.parametrize("n,k", [(5, 256), (8, 1280), (4, 4096)])
@pytest.mark.parametrize("qtype", LEGACY, ids=ids)
def test_legacy_dequant_bit_exact(qtype, n, k):
    """The port's numpy oracle, its torch dequant of the planes and the JAX
    dequant all equal omni_tpu's block dequantiser bit for bit, on blocks
    with d = 0 and with m of both signs."""
    jqt, pqt, blocks = _pair(n + k, qtype, n, k)
    ref = quants.dequantize(blocks, qtype, (n, k))
    np.testing.assert_array_equal(port_quants.dequantize(blocks, qtype, (n, k)), ref)
    np.testing.assert_array_equal(qformats.dequant(pqt).numpy(), ref)
    np.testing.assert_array_equal(np.asarray(jax_dequant(jqt)), ref)
    assert (ref[0, 32:64] == (ref[0, 32] if qtype in (Q4_1, Q5_1) else 0)).all()
    if qtype in (Q4_1, Q5_1):
        assert (pqt.dm > 0).any() and (pqt.dm < 0).any() and ref[0, 32] != 0


@pytest.mark.parametrize("n,k", [(5, 256), (24, 1280), (3, 4096 + 512)])
@pytest.mark.parametrize("qtype", LEGACY, ids=ids)
def test_legacy_repack_is_the_transpose_of_jax_repack(qtype, n, k):
    """The port's torch repack of the GGUF blocks (element j in the low and
    j + 16 in the high nibble of byte j; qh a little-endian u32) gives the
    transposes of the JAX planes bit for bit: q in superblock halves, d
    (and dm) f32 [N, K/32], qh [N, K/8] in element order."""
    jqt, _, blocks = _pair(3 * n + k, qtype, n, k)
    pqt = qformats.repack(torch.from_numpy(blocks.copy()), qtype, (n, k))
    qformats.check_qtensor(pqt, qtype)
    want = {"q", "d"} | ({"dm"} if qtype in (Q4_1, Q5_1) else set()) | (
        {"qh"} if qtype in (Q5_0, Q5_1) else set())
    assert set(pqt.planes()) == set(jqt.planes()) == want
    for nm, a in pqt.planes().items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jqt, nm)).T)
    assert qformats.tile_granule(qtype) == 256
    if qtype in (Q5_0, Q5_1):  # fifth bits both set and clear
        assert 0.1 < (qformats.kquant_values(pqt) >= 16).float().mean() < 0.9


@pytest.mark.parametrize("qtype", LEGACY, ids=ids)
def test_legacy_load_policy_matches_jax(qtype):
    """A 2-D tensor with K % 256 == 0 (K = 1280) stays quantized, the JAX
    planes transposed; one with K % 256 != 0 (K = 1248, 39 blocks) is
    widened to bf16 exactly as the JAX load_quantized widens it, as are
    keep_quantized=False and a 1-D tensor; nothing raises."""
    rng = np.random.default_rng(7)
    kept = quants.quantize(rng.standard_normal((4, 1280), dtype=np.float32), qtype)
    got = qformats.load_quantized(kept, qtype, (4, 1280), device="cpu")
    want = jax_load(kept, qtype, (4, 1280))
    assert isinstance(got, qformats.QTensor) and got.ggml_type == qtype
    for nm, a in got.planes().items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(want, nm)).T)
    ragged = quants.quantize(rng.standard_normal((4, 1248), dtype=np.float32), qtype)
    for blocks, shape, keep in ((ragged, (4, 1248), True), (kept, (4, 1280), False),
                                (ragged, (4 * 1248,), True)):
        got = qformats.load_quantized(blocks, qtype, shape, keep, "cpu")
        want = np.asarray(jax_load(blocks, qtype, shape, keep).astype(np.float32))
        assert got.dtype == (torch.bfloat16 if len(shape) == 2 else torch.float32)
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_check_qtensor_wants_the_legacy_planes():
    """Q4_1 needs its dm plane and refuses sc; Q5_0 needs qh."""
    _, q41, _ = _pair(1, Q4_1, n=4, k=512)
    qformats.check_qtensor(q41, Q4_1)
    dmp = q41.dm
    q41.dm = None
    with pytest.raises(ValueError, match="plane dm"):
        qformats.check_qtensor(q41, Q4_1)
    q41.dm, q41.sc = dmp, torch.zeros((4, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="no plane sc"):
        qformats.check_qtensor(q41, Q4_1)
    _, q50, _ = _pair(2, Q5_0, n=4, k=512)
    q50.qh = None
    with pytest.raises(ValueError, match="plane qh"):
        qformats.check_qtensor(q50, Q5_0)


# ------------------------------------------------------------ the kernels' laws

@pytest.mark.parametrize("m", [1, 2, 3, 8], ids=lambda m: f"m{m}")
@pytest.mark.parametrize("qtype", LEGACY, ids=ids)
def test_plain_legacy_gemv_matches_gp_pallas(qtype, m):
    """Kernel A's legacy branches' plain law (dl = d, ml = 8d, 16d or −m)
    == qmatmul_gp_pallas (interpret) on a ragged N at K = 2304 (9 of the
    legacy formats' 256-element granules: no K-quant could take the gp
    path there), within tests/test_qkernels.py's tolerance and ORDER_ATOL
    (both sum bf16 x times the raw values in f32, in another order)."""
    jqt, pqt, _ = _pair(10 * m + 5, qtype, k=2304)
    x = _x(m + 13, m, 2304)
    want = np.asarray(qmatmul_gp_pallas(jnp.asarray(x), jqt, block_n=16,
                                        out_dtype=jnp.float32, interpret=True))
    got = getattr(dm, dm.HALVES_GEMV[qtype])(
        torch.from_numpy(x).to(torch.bfloat16), pqt, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ORDER_ATOL)


@pytest.mark.parametrize("m", [48, 300], ids=lambda m: f"m{m}")
@pytest.mark.parametrize("qtype", LEGACY, ids=ids)
def test_plain_legacy_gemm_matches_splith_pallas(qtype, m):
    """Kernel B's legacy branches' plain (centered) law ==
    qmatmul_splith_pallas (interpret) on the shapes of
    tests/test_qkernels.py::test_qmatmul_splith_matches_xla (N = 24,
    K = 4096, two K tiles). x is rounded to bf16 first, as the port's
    wrappers take it: the Pallas kernel sums the groups of its side term
    from the x it is given, and on the d = 0 blocks of Q4_1 and Q5_1 that
    side term carries the whole min."""
    jqt, pqt, _ = _pair(10 * m + 7, qtype)
    x = torch.from_numpy(_x(m + 17, m, 4096)).to(torch.bfloat16).float().numpy()
    want = np.asarray(qmatmul_splith_pallas(
        jnp.asarray(x), jqt, block_m=64, block_n=16, block_k=2048,
        out_dtype=jnp.float32, interpret=True))
    got = getattr(dm, dm.HALVES_GEMM[qtype])(
        torch.from_numpy(x).to(torch.bfloat16), pqt, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ORDER_ATOL)


@pytest.mark.parametrize("qtype", LEGACY, ids=ids)
def test_centered_weights_and_residual_are_sh_scales_law(qtype):
    """Kernel B's centered weights bf16((q − t)·dl) and residual ml − t·dl
    (`q4k_centered`, from the group law dl = d, ml = 8d / 16d / −m) equal
    `_sh_scales`'s law bit for bit: t = 8 or 16 and no residual for Q4_0
    and Q5_0; t = −m/d and the residual −m − t·d for Q4_1 and Q5_1, which
    is the whole −m on the d = 0 blocks."""
    n, k = 8, 512
    jqt, pqt, _ = _pair(11, qtype, n, k)
    refs = {nm: jnp.asarray(a) for nm, a in jqt.planes().items()}
    dl_lo, dl_hi, t_lo, t_hi, ml_res = _sh_scales(qtype, refs, k, n)
    qp = np.asarray(refs["q"]).astype(np.int32)
    lo, hi = (qp & 0xF).astype(np.float32), (qp >> 4).astype(np.float32)
    if qtype in (Q5_0, Q5_1):  # the TPU kernel's `five_bit` step
        hb_lo, hb_hi = _sh_qh_halves(refs["qh"], k, n)
        lo = lo + np.asarray(hb_lo).astype(np.float32) * 16.0
        hi = hi + np.asarray(hb_hi).astype(np.float32) * 16.0
    w_lo = np.asarray(((lo - t_lo) * dl_lo).astype(jnp.bfloat16).astype(jnp.float32))
    w_hi = np.asarray(((hi - t_hi) * dl_hi).astype(jnp.bfloat16).astype(jnp.float32))
    want = np.stack([w_lo.reshape(k // 256, 128, n), w_hi.reshape(k // 256, 128, n)],
                    axis=1).reshape(k, n).T
    w, res = dm.q4k_centered(pqt)
    np.testing.assert_array_equal(w.float().numpy(), want)
    if ml_res is None:
        assert qtype in (Q4_0, Q5_0) and not res.any()
    else:
        np.testing.assert_array_equal(res.numpy(), np.asarray(ml_res).T)
        assert res[0, 1] == -pqt.dm[0, 1] != 0 and (w[0, 32:64] == 0).all()


@pytest.mark.parametrize("name", ["q4_0_gemv", "q4_1_gemm", "q5_0_gemm", "q5_1_gemv"])
def test_chip_smoke_f64_law_is_the_legacy_kernels_law(name):
    """chip_smoke.py's law_f64 of the legacy branches (the reference of the
    Q4_0 and Q5_0 teacher-forced checks) equals the plain version to f32
    noise, and rounded to bf16 is within the kernel-vs-plain limit."""
    from chip_smoke import law_f64, limit_ratio

    qtype = GGMLType[name[:4].upper()]
    m = 3 if name.endswith("gemv") else 16
    _, pqt, _ = _pair(m + 9, qtype, n=40, k=2048)
    x = torch.from_numpy(_x(m, m, 2048)).to(torch.bfloat16)
    plain = getattr(dm, name + "_plain")
    want = plain(x, pqt, torch.float32)
    got = law_f64(name, x, pqt, torch.float32)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert limit_ratio(law_f64(name, x, pqt, torch.bfloat16).float(),
                       plain(x, pqt).float()) <= 1.0


@pytest.mark.parametrize("qtype", [Q4_1, Q5_1], ids=ids)
def test_check_kernel_rejects_a_kernel_that_subtracts_the_min(qtype):
    """chip_smoke.check_kernel fails a stand-in Q4_1/Q5_1 kernel that takes
    the K-quants' sign for m (w = q·d − m where the format adds m: off by
    2m on every element), and passes the plain version against itself, on
    testing_synth's m of both signs."""
    from chip_smoke import check_kernel

    qt = testing_synth.synth_quant(qtype, 256, 4096, "cpu",
                                   torch.Generator().manual_seed(0))
    name = dm.HALVES_GEMV[qtype]
    plain = getattr(dm, name + "_plain")

    def standin(x, w, out_dtype):
        flipped = qformats.QTensor(w.ggml_type, w.shape, w.q, None, None, w.d,
                                   -w.dm, w.qh)
        return plain(x, flipped, out_dtype)

    max_err = {}
    check_kernel(name, plain, plain, qt, "wq", 1, torch.bfloat16,
                 torch.Generator().manual_seed(3), max_err)
    with pytest.raises(SystemExit, match="disagrees"):
        check_kernel(name, standin, plain, qt, "wq", 1, torch.bfloat16,
                     torch.Generator().manual_seed(3), max_err)


def _on_a_mocked_card(fn, *args):
    """fn(*args) with the wrappers taking the card's path and a stand-in
    library whose every entry point checks its planes, launches nothing and
    returns 0; returns (fn's result, [(entry, null planes)])."""
    from omni_tpu_torch.kernels import _build

    called = []

    def entry(name):
        def fn_(*a):
            called.append((name, tuple(nm for nm, p in zip(qformats.PLANES, a[1:7])
                                       if p == 0)))
            return 0
        return fn_

    lib = {name: entry(name) for entries in _build.SOURCES.values() for name in entries}
    with mock.patch.object(dm, "_on_cuda", return_value=True), \
            mock.patch.object(_build, "load", return_value=lib), \
            mock.patch.object(torch.cuda, "current_stream",
                              return_value=SimpleNamespace(cuda_stream=0)):
        return fn(*args), called


@pytest.mark.parametrize("qtype", LEGACY, ids=ids)
def test_matmul_routes_legacy_formats_on_a_mocked_card(qtype):
    """On the card `matmul` sends a legacy weight to kernel A's branch at
    M = 1..8 and to B's at M > 8 (K = 1280: the 256 granule, no 2048
    needed), never to kernel D, passing exactly the planes the format has
    (qh only for Q5_0/Q5_1, dm only for Q4_1/Q5_1); each launch counts once
    under its own name."""
    _, pqt, _ = _pair(12, qtype, n=8, k=1280)
    dm.reset_launches()
    got = []
    for m in (1, 8, 9, 64):
        x = torch.from_numpy(_x(m, m, 1280))
        assert dm.kernel_for(m, pqt).__name__ == (
            dm.HALVES_GEMV if m <= 8 else dm.HALVES_GEMM)[qtype]
        got += _on_a_mocked_card(dm.matmul, x, pqt)[1]
    nulls = {"sc", "mn"} | ({"dm"} if qtype in (Q4_0, Q5_0) else set()) | (
        {"qh"} if qtype in (Q4_0, Q4_1) else set())
    gemv, gemm = dm.HALVES_GEMV[qtype], dm.HALVES_GEMM[qtype]
    assert [e for e, _ in got] == [gemv, gemv, gemm, gemm]
    assert all(set(n) == nulls for _, n in got)
    assert dm.launches == {**dict.fromkeys(dm.launches, 0), gemv: 2, gemm: 2}
    assert not any(dm.qgemm_launches.values())


@pytest.mark.parametrize("qtype", LEGACY, ids=ids)
def test_legacy_wrappers_launch_or_raise(qtype):
    """Where the kernels cannot be built (no nvcc here) a legacy weight on
    the card path raises rather than running the plain version, and counts
    no launch, through kernel A's and B's branches and through kernel D's
    (which takes every legacy format since it was finished); the other
    formats' wrappers refuse it."""
    _, pqt, _ = _pair(4, qtype, n=8, k=2048)
    dm.reset_launches()
    with mock.patch.object(dm, "_on_cuda", return_value=True), \
            mock.patch("omni_tpu_torch.kernels._build.load",
                       side_effect=RuntimeError("nvcc not found")), \
            mock.patch.object(dm, "q4k_gemv_plain") as gemv_plain, \
            mock.patch.object(dm, "q4k_gemm_plain") as gemm_plain, \
            mock.patch.object(dm, "qgemm_plain") as qgemm_plain:
        for m in (1, 16):
            with pytest.raises(RuntimeError, match="nvcc"):
                dm.matmul(torch.from_numpy(_x(0, m, 2048)), pqt)
            with pytest.raises(RuntimeError, match="nvcc"):
                dm.qgemm(torch.zeros((m, 2048), dtype=torch.bfloat16), pqt)
        for wrapper in (dm.q4k_gemv, dm.q5k_gemv, dm.q6k_gemv, dm.q8_0_gemv):
            with pytest.raises(ValueError, match=qtype.name):
                wrapper(torch.zeros((1, 2048), dtype=torch.bfloat16), pqt)
    assert not gemv_plain.called and not gemm_plain.called and not qgemm_plain.called
    assert not any(dm.launches.values())


# ------------------------------------------------- the port's synthetic files

@pytest.mark.parametrize("n_layers", [2, 36])
@pytest.mark.parametrize("recipe", ["Q4_0", "Q5_0"])
def test_legacy_recipes_match_the_jax_quantizer(recipe, n_layers):
    """The port's Q4_0 and Q5_0 rules equal the JAX quantizer's for every
    tensor: Q6_K head, the recipe's type everywhere else (the embedding
    too). The importance-matrix layout differs from them only at the
    ffn_down of layers i < n_layers // 8 (4 of Qwen3-8B's 36, none of 2),
    which become Q4_1 or Q5_1."""
    default = testing_synth.RECIPES[recipe]
    assert default == jax_quantize.RECIPES[recipe]
    names = ["output.weight", "token_embd.weight"] + [
        f"blk.{i}.{t}.weight" for i in range(n_layers)
        for t in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate",
                  "ffn_up", "ffn_down")]
    got = [testing_synth.pick_type(nm, recipe, default, n_layers) for nm in names]
    want = [jax_quantize.pick_type(nm, recipe, default, n_layers) for nm in names]
    assert got == want and got[0] == GGMLType.Q6_K
    assert got.count(default) == len(names) - 1
    im = [testing_synth.pick_type(nm, recipe, default, n_layers, imatrix=True)
          for nm in names]
    moved = [nm for nm, a, b in zip(names, got, im) if a != b]
    assert moved == [f"blk.{i}.ffn_down.weight" for i in range(n_layers // 8)]
    assert {im[names.index(nm)] for nm in moved} <= {
        {"Q4_0": Q4_1, "Q5_0": Q5_1}[recipe]}


@pytest.mark.parametrize("qtype", LEGACY, ids=ids)
def test_synthetic_legacy_blocks(qtype):
    """testing_synth's legacy blocks: random high bits (about half set),
    Q4_1/Q5_1's m of both signs and some blocks with d = 0 but m != 0;
    read the same by both packages' dequantisers."""
    nb = 64 * 64
    blocks = testing_synth.BLOCKS[qtype](nb, "cpu", torch.Generator().manual_seed(1))
    b = blocks.numpy()
    np.testing.assert_array_equal(port_quants.dequantize(b, qtype),
                                  quants.dequantize(b, qtype))
    qt = qformats.repack(blocks, qtype, (64, 2048))
    if qtype in (Q5_0, Q5_1):
        assert 0.45 < (qformats.kquant_values(qt) >= 16).float().mean() < 0.55
    if qtype in (Q4_1, Q5_1):
        zero = qt.d == 0
        assert 0 < zero.sum() < nb / 20 and (qt.dm[zero] != 0).all()
        assert (qt.dm > 0).any() and (qt.dm < 0).any()


# ------------------------------------------------------ the tiny GGUF files

_TINY = dict(n_layers=2, d_model=256, n_heads=2, n_kv_heads=1, head_dim=128,
             d_ff=512, n_vocab=512)


@pytest.fixture(scope="module")
def legacy_files(tmp_path_factory):
    """The tiny Qwen3 of the JAX package's tools quantized Q4_0 and Q5_0 by
    `omni-quantize` (Q6_K head, every other weight and the embedding in
    the recipe's type), and the port's random Q4_0 file in the
    importance-matrix layout with 8 layers (layer 0's ffn_down Q4_1)."""
    d = tmp_path_factory.mktemp("legacy")
    src = d / "f32.gguf"
    write_tiny_qwen3(src, qtype=GGMLType.F32, tied_head=False, **_TINY)
    files = {}
    for recipe in ("Q4_0", "Q5_0"):
        files[recipe] = d / f"{recipe.lower()}.gguf"
        jax_quantize.quantize_file(str(src), str(files[recipe]), recipe)
    files["Q4_0 imatrix"] = d / "q4_0_imatrix.gguf"
    cfg = tq.Qwen3Config(**{**_TINY, "n_layers": 8})
    types = testing_synth.write_qwen3_gguf(files["Q4_0 imatrix"], cfg, "Q4_0",
                                           torch.Generator().manual_seed(0),
                                           imatrix=True)
    assert [n for n, t in types.items() if t == Q4_1] == ["blk.0.ffn_down.weight"]
    return files


def _jax_ctx(jr, jparams):
    return JaxContext(jq.Qwen3Config.from_gguf(jr.kv), jparams, jq.forward,
                      jq.embed, n_ctx=512, sampler=JaxSamplerParams(greedy=True))


def _port_ctx(tr, tparams):
    return Context(tq.Qwen3Config.from_gguf(tr.kv), tparams, tq.forward,
                   tq.embed, n_ctx=512, sampler=SamplerParams(greedy=True),
                   device="cpu")


def _jax_turn(jctx):
    jpipe = JaxPipeline(llm=jctx, tokenizer=WordTokenizer(),
                        config=JaxSessionConfig(duplex=False, use_tts=False,
                                                max_preserved_context=512))
    try:
        return _serve(jpipe, 1)
    finally:
        jpipe.shutdown()


def _port_turn(tctx):
    return _serve(OmniPipeline(tctx, WordTokenizer(),
                               SessionConfig(max_preserved_context=512)), 1)


@pytest.mark.parametrize("which", ["Q4_0", "Q5_0", "Q4_0 imatrix"])
def test_legacy_file_loads_and_serves_as_omni_tpu(which, legacy_files):
    """Each file, loaded by each package's own reader and loader, gives the
    same parameters (planes, the dequantised embedding, norms), and a
    greedy turn of up to 16 tokens served from it emits the same tokens in
    both (the Q4_0 file's turn ends after 8, on the end-of-generation id).

    The Q4_0 file's turn is held against omni_tpu's pipeline run op by op
    (jax.disable_jit), as tests/test_torch_q5_k.py holds the Q5_K_M file's:
    omni_tpu's jitted steps meet a rounding flip at its sixth token (the
    next test proves it); the other two files against the jitted steps."""
    import jax

    path = legacy_files[which]
    jr, tr = JaxReader(path), GGUFReader(path)
    jparams, tparams = jq.load_params(jr), tq.load_params(tr, device="cpu")
    _assert_same_params(jparams, tparams)
    types = {w.ggml_type for lp in tparams["layers"] for w in lp.values()
             if isinstance(w, qformats.QTensor)}
    default = GGMLType[which.split()[0]]
    assert types == ({default, Q4_1} if "imatrix" in which else {default})
    assert tparams["output"].ggml_type == GGMLType.Q6_K
    assert tparams["token_embd"].dtype == torch.bfloat16
    jctx = _jax_ctx(jr, jparams)
    if which == "Q4_0":
        with jax.disable_jit():
            want = _jax_turn(jctx)
    else:
        want = _jax_turn(jctx)
    tctx = _port_ctx(tr, tparams)
    got = _port_turn(tctx)
    assert sum(len(e["content"].split()) for e in got) >= 8
    assert got == want
    assert tctx.n_past == jctx.n_past


def test_jitted_turn_from_the_q4_0_file_departs_at_a_rounding_flip(legacy_files):
    """The Q4_0 file's turn against omni_tpu's jitted steps: the two streams
    are identical up to the first token where the port's top-2 margin is
    below the logit distance between the two, a rounding flip (on this
    fixture the sixth token). Both contexts, fed omni_tpu's tokens up to
    there, lie within test_torch_model's JIT_LOGITS_ATOL (the noise of
    omni_tpu's jitted steps), and each picks its own turn's token on every
    row."""
    assert_departs_at_a_rounding_flip(legacy_files["Q4_0"])


def assert_departs_at_a_rounding_flip(path) -> None:
    """The body of the test above, for the tiny file at `path`."""
    from omni_tpu.runtime import Batch as JaxBatch
    from omni_tpu_torch.omni.pipeline import SIMPLEX_ASSISTANT_PROMPT
    from omni_tpu_torch.runtime import Batch
    from test_torch_model import JIT_LOGITS_ATOL, _np

    jr, tr = JaxReader(path), GGUFReader(path)
    jparams, tparams = jq.load_params(jr), tq.load_params(tr, device="cpu")

    def tokens(events):
        return [int(x) for e in events for x in e["content"].split()]

    want = tokens(_jax_turn(_jax_ctx(jr, jparams)))
    got = tokens(_port_turn(_port_ctx(tr, tparams)))
    assert len(want) >= 8 and len(got) >= 8
    if got == want:
        return
    first = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    tok = WordTokenizer()
    feeds = [tok.encode("<|im_start|>system\nyou are a tiny test model"
                        "\n<|audio_start|>"),
             tok.encode("<|audio_end|><|im_end|>\n<|im_start|>user\n"),
             tok.encode(SIMPLEX_ASSISTANT_PROMPT)] + [[t] for t in want]
    jc, tc = _jax_ctx(jr, jparams), _port_ctx(tr, tparams)
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
    top2 = np.sort(tl)[-2:]
    assert top2[1] - top2[0] < np.abs(jl - tl).max()
