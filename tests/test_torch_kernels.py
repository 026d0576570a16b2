"""The port's Q4_K and Q6_K weights and matmul kernels (omni_tpu_torch)
against the JAX package on the same inputs.

Inputs come from numpy seeds and go through both packages; the JAX side
runs its Pallas kernels in interpret mode, as tests/test_qkernels.py does.
On the CPU the port's kernel wrappers run their plain PyTorch versions;
the CUDA kernels themselves are held against those on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax._src import compilation_cache
from omni_tpu.core import GGMLType, quants
from omni_tpu.kernels import dequant as jax_dequant
from omni_tpu.kernels import qmatmul_xla, repack
from omni_tpu.kernels.dequant_matmul import (qmatmul_gp_pallas, qmatmul_pallas,
                                             qmatmul_splith_pallas)
from omni_tpu.kernels.qformats import concat_qtensors as jax_concat
from omni_tpu_torch.convert import from_jax_params
from omni_tpu_torch.core import quants as port_quants
from omni_tpu_torch.core.quants import dequantize_q4k
from omni_tpu_torch.kernels import dequant_matmul as dm
from omni_tpu_torch.kernels import qformats


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


def _pair(seed, qtype=GGMLType.Q4_K, n=24, k=4096):
    """(JAX QTensor, the port's QTensor on the CPU, f32 reference)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k), dtype=np.float32)
    blocks = quants.quantize(w, qtype)
    jqt = repack(blocks, qtype, (n, k))
    pqt = from_jax_params(jax.tree_util.tree_map(np.asarray, jqt), "cpu")
    return jqt, pqt, blocks


def _x(seed, m, k):
    return np.random.default_rng(seed).standard_normal((m, k), dtype=np.float32)


@pytest.mark.parametrize("n,k", [(16, 512), (24, 4096 + 2048), (7, 256)])
def test_q4k_dequant_bit_exact(n, k):
    """The port's numpy oracle, its torch dequant of the converted planes and
    the JAX dequant all equal omni_tpu's block dequantiser bit for bit."""
    jqt, pqt, blocks = _pair(n + k, n=n, k=k)
    ref = quants.dequantize(blocks, GGMLType.Q4_K, (n, k))
    np.testing.assert_array_equal(dequantize_q4k(blocks, (n, k)), ref)
    np.testing.assert_array_equal(qformats.dequant(pqt).numpy(), ref)
    np.testing.assert_array_equal(np.asarray(jax_dequant(jqt)), ref)


def test_converted_planes_are_a_permutation():
    """The N-major planes are the transposes of the JAX K-major planes, and
    byte r of superblock s holds elements s*256+r (low) and s*256+128+r
    (high) of the row."""
    jqt, pqt, _ = _pair(3, n=5, k=512)
    for nm in ("q", "sc", "mn", "d", "dm"):
        np.testing.assert_array_equal(getattr(pqt, nm).numpy(),
                                      np.asarray(getattr(jqt, nm)).T)
    vals = qformats.unpack_sb_halves(pqt.q).numpy()
    q = pqt.q.numpy()
    np.testing.assert_array_equal(vals[:, 256 + 7], q[:, 128 + 7] & 15)
    np.testing.assert_array_equal(vals[:, 256 + 128 + 7], q[:, 128 + 7] >> 4)


def test_concat_matches_jax():
    parts = [_pair(s, n=n, k=512) for s, n in ((1, 16), (2, 8), (3, 8))]
    jcat = jax_concat([p[0] for p in parts])
    pcat = qformats.concat_qtensors([p[1] for p in parts])
    assert pcat.shape == tuple(jcat.shape) == (32, 512)
    np.testing.assert_array_equal(qformats.dequant(pcat).numpy(),
                                  np.asarray(jax_dequant(jcat)))


@pytest.mark.parametrize("n,k", [(16, 512), (24, 4096 + 2048), (7, 256)])
def test_q6k_dequant_bit_exact(n, k):
    """Q6_K: the port's numpy oracle and its torch dequant of the repacked
    planes equal omni_tpu's block dequantiser bit for bit."""
    jqt, pqt, blocks = _pair(n + k, qtype=GGMLType.Q6_K, n=n, k=k)
    ref = quants.dequantize(blocks, GGMLType.Q6_K, (n, k))
    np.testing.assert_array_equal(
        port_quants.dequantize(blocks, GGMLType.Q6_K, (n, k)), ref)
    np.testing.assert_array_equal(qformats.dequant(pqt).numpy(), ref)
    np.testing.assert_array_equal(np.asarray(jax_dequant(jqt)), ref)


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K],
                         ids=lambda t: t.name)
@pytest.mark.parametrize("n,k", [(5, 256), (24, 4096 + 2048)])
def test_repack_is_the_transpose_of_jax_repack(qtype, n, k):
    """The port's torch repack of GGUF blocks gives the transposes of the
    JAX package's planes, and dequantises to the reference bit for bit."""
    jqt, _, blocks = _pair(3 * n + k, qtype=qtype, n=n, k=k)
    pqt = qformats.repack(torch.from_numpy(blocks.copy()), qtype, (n, k))
    qformats.check_qtensor(pqt, qtype)
    assert set(pqt.planes()) == set(jqt.planes())
    for nm, a in pqt.planes().items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jqt, nm)).T)
    np.testing.assert_array_equal(qformats.dequant(pqt).numpy(),
                                  quants.dequantize(blocks, qtype, (n, k)))


@pytest.mark.parametrize("qtype", [GGMLType.TQ1_0, GGMLType.TQ2_0, GGMLType.F32],
                         ids=lambda t: t.name)
def test_unported_formats_raise_naming_them(qtype):
    blocks = np.zeros((1, 256), np.float32) if qtype == GGMLType.F32 else \
        quants.quantize(np.zeros((1, 256), np.float32), qtype)
    with pytest.raises(NotImplementedError, match=qtype.name):
        qformats.repack(torch.from_numpy(np.asarray(blocks).view(np.uint8).copy()),
                        qtype, (1, 256))
    if qtype != GGMLType.F32:
        with pytest.raises(NotImplementedError, match=qtype.name):
            port_quants.dequantize(blocks, qtype)


# the tolerances of tests/test_qkernels.py:82-87: both sides accumulate
# bf16 products over K (up to 6144 here) in f32. The port's plain version
# follows the same law as each Pallas kernel, so it is also held to a much
# tighter bound that only f32 summation order can reach.
RTOL, ATOL, ORDER_ATOL = 2e-2, 4e-1, 5e-3


@pytest.mark.parametrize("k", [2048, 4096 + 2048], ids=lambda k: f"k{k}")
@pytest.mark.parametrize("m", [1, 2, 3, 8], ids=lambda m: f"m{m}")
def test_plain_gemv_matches_gp_pallas(m, k):
    """Kernel A's plain law == qmatmul_gp_pallas (interpret) on a ragged N."""
    jqt, pqt, _ = _pair(10 * m + k, k=k)
    x = _x(m, m, k)
    want = np.asarray(qmatmul_gp_pallas(jnp.asarray(x), jqt, block_n=16,
                                        out_dtype=jnp.float32,
                                        interpret=True))
    got = dm.q4k_gemv(torch.from_numpy(x).to(torch.bfloat16), pqt,
                      torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ORDER_ATOL)


@pytest.mark.parametrize("k", [2048, 4096 + 2048], ids=lambda k: f"k{k}")
@pytest.mark.parametrize("m", [16, 64], ids=lambda m: f"m{m}")
def test_plain_gemm_matches_splith_pallas(m, k):
    """Kernel B's plain (centered) law == qmatmul_splith_pallas
    (interpret) on a ragged N."""
    jqt, pqt, _ = _pair(10 * m + k, k=k)
    x = _x(m, m, k)
    want = np.asarray(qmatmul_splith_pallas(
        jnp.asarray(x), jqt, block_m=64, block_n=16, block_k=2048,
        out_dtype=jnp.float32, interpret=True))
    got = dm.q4k_gemm(torch.from_numpy(x).to(torch.bfloat16), pqt,
                      torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ORDER_ATOL)


@pytest.mark.parametrize("k", [2048, 4096], ids=lambda k: f"k{k}")
@pytest.mark.parametrize("m", [1, 2, 3, 8], ids=lambda m: f"m{m}")
def test_plain_q6k_gemv_matches_gp_pallas(m, k):
    """Kernel C's plain law == qmatmul_gp_pallas (interpret) for Q6_K on a
    ragged N."""
    jqt, pqt, _ = _pair(10 * m + k + 1, qtype=GGMLType.Q6_K, k=k)
    x = _x(m + 7, m, k)
    want = np.asarray(qmatmul_gp_pallas(jnp.asarray(x), jqt, block_n=16,
                                        out_dtype=jnp.float32,
                                        interpret=True))
    got = dm.q6k_gemv(torch.from_numpy(x).to(torch.bfloat16), pqt,
                      torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ORDER_ATOL)


@pytest.mark.parametrize("k", [1280, 2048], ids=lambda k: f"k{k}")
@pytest.mark.parametrize("m", [1, 16, 64], ids=lambda m: f"m{m}")
@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K],
                         ids=lambda t: t.name)
def test_plain_qgemm_matches_qmatmul_pallas(qtype, m, k):
    """Kernel D's plain law (uncentered for Q4_K) == qmatmul_pallas
    (interpret) on a ragged N."""
    jqt, pqt, _ = _pair(10 * m + k + 2, qtype=qtype, k=k)
    x = _x(m + 11, m, k)
    want = np.asarray(qmatmul_pallas(jnp.asarray(x), jqt, block_m=64,
                                     block_n=16, out_dtype=jnp.float32,
                                     interpret=True))
    got = dm.qgemm(torch.from_numpy(x).to(torch.bfloat16), pqt,
                   torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ORDER_ATOL)


@pytest.mark.parametrize("m", [1, 4, 48], ids=lambda m: f"m{m}")
def test_qmatmul_plain_matches_xla(m):
    """The dispatcher's path off the card (qmatmul_plain) == qmatmul_xla:
    the same bf16 dequant and f32 dot; only summation order differs."""
    jqt, pqt, _ = _pair(m, k=512)
    x = _x(m + 1, m, 512)
    want = np.asarray(qmatmul_xla(jnp.asarray(x), jqt, out_dtype=jnp.float32))
    got = dm.matmul(torch.from_numpy(x), pqt, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,k", [(64, 4096), (48, 12288)], ids=["k4096", "k12288"])
def test_chip_smoke_limit_catches_a_dropped_min_term(n, k):
    """chip_smoke.py's kernel-vs-plain limit passes a one-ulp bf16 flip of
    every output and fails a kernel that drops the min side term."""
    from chip_smoke import limit_ratio

    _, pqt, _ = _pair(n + k, n=n, k=k)
    x = torch.from_numpy(_x(k, 8, k)).to(torch.bfloat16)
    want = dm.q4k_gemv_plain(x, pqt).float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs())) - 7)
    assert limit_ratio(want + ulp, want) <= 1.0
    _, ml = qformats.q4k_group_scales(pqt)
    xs = x.float().reshape(8, k // 32, 32).sum(-1)
    no_min = (want + xs @ ml.T).to(torch.bfloat16).float()
    assert limit_ratio(no_min, want) > 1.0


@pytest.mark.parametrize("name,qtype,m", [
    ("q4k_gemv", GGMLType.Q4_K, 3), ("q4k_gemm", GGMLType.Q4_K, 16),
    ("q6k_gemv", GGMLType.Q6_K, 3), ("qgemm", GGMLType.Q6_K, 16),
    ("qgemm", GGMLType.Q4_K, 16)], ids=lambda v: getattr(v, "name", str(v)))
def test_chip_smoke_f64_law_is_the_kernels_law(name, qtype, m):
    """chip_smoke.py's law_f64, the reference of its Q4_K_M teacher-forced
    check, evaluates each kernel's own law: in f32 it equals the plain
    version to f32 summation noise, and rounded to bf16 it is within the
    kernel-vs-plain limit."""
    from chip_smoke import law_f64, limit_ratio

    _, pqt, _ = _pair(m + 7, qtype=qtype, n=40, k=2048)
    x = torch.from_numpy(_x(m, m, 2048)).to(torch.bfloat16)
    plain = getattr(dm, name + "_plain")
    want = plain(x, pqt, torch.float32)
    got = law_f64(name, x, pqt, torch.float32)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert limit_ratio(law_f64(name, x, pqt, torch.bfloat16).float(),
                       plain(x, pqt).float()) <= 1.0


def test_cpu_dispatch_launches_no_kernel():
    dm.reset_launches()
    for qtype in (GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.Q8_0,
                  GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1):
        _, pqt, _ = _pair(0, qtype=qtype, k=2048)
        for m in (1, 16):
            dm.matmul(torch.from_numpy(_x(m, m, 2048)), pqt)
    assert not any(dm.launches.values())


@pytest.mark.parametrize("qtype", [GGMLType.Q3_K, GGMLType.Q2_K],
                         ids=lambda t: t.name)
def test_cuda_path_raises_for_unported_formats(qtype):
    """On the card a Q2_K or Q3_K weight routes to its kernels (H at M = 1,
    D at M = 16), never to a plain version; the other formats' wrappers
    refuse it; and a weight of a format the port has no planes for (here
    the same planes relabelled TQ1_0, which the JAX package widens at load)
    raises NotImplementedError naming the format and the thirteen formats
    the port's kernels take, and no TPU kernel as unported."""
    _, pqt, _ = _pair(1, qtype=qtype, k=2048)
    with mock.patch.object(dm, "_on_cuda", return_value=True), \
            mock.patch.object(dm, "_launch",
                              side_effect=lambda name, *a: name) as launch, \
            mock.patch.object(dm, "q2k_gemv_plain") as gemv_plain, \
            mock.patch.object(dm, "qgemm_plain") as gemm_plain:
        assert dm.matmul(torch.from_numpy(_x(0, 1, 2048)), pqt) == dm.LOWBIT_GEMV[qtype]
        assert dm.matmul(torch.from_numpy(_x(0, 16, 2048)), pqt) == "qgemm"
        assert launch.call_count == 2
        assert not gemv_plain.called and not gemm_plain.called
        for wrapper, m in ((dm.q4k_gemv, 1), (dm.q4k_gemm, 16)):
            with pytest.raises(ValueError, match="Q4_K"):
                wrapper(torch.from_numpy(_x(0, m, 2048)).to(torch.bfloat16),
                        pqt)
        for wrapper in (dm.q5k_gemv, dm.q6k_gemv, dm.q8_0_gemv):
            with pytest.raises(ValueError, match="Q5_K|Q6_K|Q8_0"):
                wrapper(torch.from_numpy(_x(0, 1, 2048)).to(torch.bfloat16),
                        pqt)
        unported = dataclasses.replace(pqt, ggml_type=GGMLType.TQ1_0)
        with pytest.raises(NotImplementedError, match="TQ1_0.*thirteen formats") as e:
            dm.matmul(torch.from_numpy(_x(0, 1, 2048)), unported)
        assert "qffn_pallas" not in str(e.value)


def _routed(pqt, m):
    """The (kernel, C entry point) the card path launches for [m, K] x."""
    seen = []

    def launch(name, entry, x, qt, out_dtype):
        seen.append((name, entry))
        assert x.dtype == torch.bfloat16 and qt is pqt
        return torch.zeros((x.shape[0], qt.shape[0]), dtype=out_dtype)

    with mock.patch.object(dm, "_on_cuda", return_value=True), \
            mock.patch.object(dm, "_launch", launch):
        dm.matmul(torch.from_numpy(_x(0, m, pqt.shape[1])), pqt)
    assert len(seen) == 1
    return seen[0]


def test_cuda_path_raises_for_small_k():
    """K % 2048 != 0 has no A or B kernel (the TPU kernels' plane granule):
    a Q4_K weight at K = 512 goes to kernel D at every M."""
    _, pqt, _ = _pair(2, k=512)
    for m in (1, 8, 9, 64):
        assert _routed(pqt, m) == ("qgemm", "qgemm_q4k")


# the JAX dispatcher's order (dequant_matmul.py:665-672): gp (M <= 8,
# K % 2048; K % 256 for Q8_0), then sh (M > 8, Q4_K or Q5_K, K % 2048), then
# the generic kernel
ROUTES = [
    (GGMLType.Q4_K, 1, 2048, ("q4k_gemv", "q4k_gemv")),
    (GGMLType.Q4_K, 8, 4096, ("q4k_gemv", "q4k_gemv")),
    (GGMLType.Q4_K, 9, 2048, ("q4k_gemm", "q4k_gemm")),
    (GGMLType.Q4_K, 64, 6144, ("q4k_gemm", "q4k_gemm")),
    (GGMLType.Q4_K, 1, 1280, ("qgemm", "qgemm_q4k")),
    (GGMLType.Q4_K, 64, 1280, ("qgemm", "qgemm_q4k")),
    (GGMLType.Q5_K, 1, 2048, ("q5k_gemv", "q5k_gemv")),
    (GGMLType.Q5_K, 8, 12288, ("q5k_gemv", "q5k_gemv")),
    (GGMLType.Q5_K, 9, 2048, ("q5k_gemm", "q5k_gemm")),
    (GGMLType.Q5_K, 64, 4096, ("q5k_gemm", "q5k_gemm")),
    (GGMLType.Q5_K, 1, 1280, ("qgemm", "qgemm_q5k")),
    (GGMLType.Q5_K, 64, 1280, ("qgemm", "qgemm_q5k")),
    (GGMLType.Q6_K, 1, 2048, ("q6k_gemv", "q6k_gemv")),
    (GGMLType.Q6_K, 8, 4096, ("q6k_gemv", "q6k_gemv")),
    (GGMLType.Q6_K, 9, 2048, ("qgemm", "qgemm_q6k")),
    (GGMLType.Q6_K, 256, 4096, ("qgemm", "qgemm_q6k")),
    (GGMLType.Q6_K, 1, 256, ("qgemm", "qgemm_q6k")),
    (GGMLType.Q6_K, 3, 1280, ("qgemm", "qgemm_q6k")),
    (GGMLType.Q8_0, 1, 4096, ("q8_0_gemv", "q8_0_gemv")),
    (GGMLType.Q8_0, 8, 256, ("q8_0_gemv", "q8_0_gemv")),
    (GGMLType.Q8_0, 3, 1280, ("q8_0_gemv", "q8_0_gemv")),
    (GGMLType.Q8_0, 9, 4096, ("qgemm", "qgemm_q8_0")),
    (GGMLType.Q8_0, 64, 4096, ("qgemm", "qgemm_q8_0")),
    (GGMLType.Q8_0, 1, 1248, ("qgemm", "qgemm_q8_0")),
    (GGMLType.Q8_0, 1, 96, ("qgemm", "qgemm_q8_0")),
]


@pytest.mark.parametrize("qtype,m,k,want", ROUTES,
                         ids=[f"{t.name}-m{m}-k{k}" for t, m, k, _ in ROUTES])
def test_dispatch_routing_on_a_mocked_card(qtype, m, k, want):
    _, pqt, _ = _pair(m + k, qtype=qtype, n=8, k=k)
    assert _routed(pqt, m) == want


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K,
                                   GGMLType.Q8_0], ids=lambda t: t.name)
def test_cuda_wrapper_launches_or_raises(qtype):
    """A Q4_K, Q5_K, Q6_K or Q8_0 weight on the card path goes to a kernel launcher:
    where the kernel cannot be built (no nvcc here) the call raises rather
    than running the plain version, and no launch is counted."""
    dm.reset_launches()
    plains = ("q4k_gemv_plain", "q4k_gemm_plain", "q5k_gemv_plain",
              "q5k_gemm_plain", "q6k_gemv_plain", "qgemm_plain", "q8_0_gemv_plain")
    with mock.patch.object(dm, "_on_cuda", return_value=True), \
            mock.patch("omni_tpu_torch.kernels._build.load",
                       side_effect=RuntimeError("nvcc not found")), \
            mock.patch.multiple(dm, **{p: mock.DEFAULT for p in plains}) as mocks:
        for k in (2048, 1280):
            _, pqt, _ = _pair(4, qtype=qtype, k=k)
            for m in (1, 16):
                with pytest.raises(RuntimeError, match="nvcc"):
                    dm.matmul(torch.from_numpy(_x(0, m, k)), pqt)
    assert not any(p.called for p in mocks.values())
    assert not any(dm.launches.values())


@pytest.mark.parametrize("case", ["m_too_big", "m_too_small", "k_mismatch",
                                  "out_dtype", "bad_plane", "q6k_m_too_big",
                                  "q6k_bad_plane", "qgemm_extra_plane"])
def test_wrapper_argument_checks(case):
    _, pqt, _ = _pair(5, k=2048)
    x1 = torch.zeros((1, 2048), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        if case == "m_too_big":
            dm.q4k_gemv(torch.zeros((9, 2048), dtype=torch.bfloat16), pqt)
        elif case == "m_too_small":
            dm.q4k_gemm(torch.zeros((8, 2048), dtype=torch.bfloat16), pqt)
        elif case == "k_mismatch":
            dm.q4k_gemv(torch.zeros((1, 1024), dtype=torch.bfloat16), pqt)
        elif case == "out_dtype":
            dm.q4k_gemv(x1, pqt, torch.float16)
        elif case.startswith(("q6k", "qgemm")):
            _, q6, _ = _pair(5, qtype=GGMLType.Q6_K, k=2048)
            if case == "q6k_m_too_big":
                dm.q6k_gemv(torch.zeros((9, 2048), dtype=torch.bfloat16), q6)
            elif case == "q6k_bad_plane":
                q6.sc = q6.sc[:, :-1].contiguous()
                dm.q6k_gemv(x1, q6)
            else:
                q6.mn = q6.sc
                dm.qgemm(x1, q6)
        else:
            pqt.sc = pqt.sc[:, :-1]
            dm.q4k_gemv(x1, pqt)
