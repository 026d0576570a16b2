"""The port's Q4_K weights and matmul kernels (omni_tpu_torch) against the
JAX package on the same inputs.

Inputs come from numpy seeds and go through both packages; the JAX side
runs its Pallas kernels in interpret mode, as tests/test_qkernels.py does.
On the CPU the port's kernel wrappers run their plain PyTorch versions;
the CUDA kernels themselves are held against those on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

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
from omni_tpu.kernels.dequant_matmul import (qmatmul_gp_pallas,
                                             qmatmul_splith_pallas)
from omni_tpu.kernels.qformats import concat_qtensors as jax_concat
from omni_tpu_torch.convert import from_jax_params
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


def test_cpu_dispatch_launches_no_kernel():
    _, pqt, _ = _pair(0, k=2048)
    dm.reset_launches()
    for m in (1, 16):
        dm.matmul(torch.from_numpy(_x(m, m, 2048)), pqt)
    assert dm.launches == {"q4k_gemv": 0, "q4k_gemm": 0}


@pytest.mark.parametrize("qtype", [GGMLType.Q6_K, GGMLType.Q8_0],
                         ids=lambda t: t.name)
def test_cuda_path_raises_for_unported_formats(qtype):
    """On the card a format without a ported kernel raises, naming the TPU
    kernel still to port; it never falls back to the plain version."""
    _, pqt, _ = _pair(1, qtype=qtype, k=2048)
    x = torch.from_numpy(_x(0, 1, 2048))
    with mock.patch.object(dm, "_on_cuda", return_value=True):
        with pytest.raises(NotImplementedError, match="qmatmul_pallas"):
            dm.matmul(x, pqt)
        for wrapper, m in ((dm.q4k_gemv, 1), (dm.q4k_gemm, 16)):
            with pytest.raises(ValueError, match="Q4_K"):
                wrapper(torch.from_numpy(_x(0, m, 2048)).to(torch.bfloat16),
                        pqt)


def test_cuda_path_raises_for_small_k():
    """K % 2048 != 0 has no kernel (the TPU kernels' plane granule)."""
    _, pqt, _ = _pair(2, k=512)
    with mock.patch.object(dm, "_on_cuda", return_value=True):
        with pytest.raises(NotImplementedError, match="qmatmul_pallas"):
            dm.matmul(torch.from_numpy(_x(0, 1, 512)), pqt)


def test_cuda_wrapper_launches_or_raises():
    """A Q4_K weight on the card path goes to the kernel launcher: where
    the kernel cannot be built (no nvcc here) the call raises rather than
    running the plain version, and no launch is counted."""
    _, pqt, _ = _pair(4, k=2048)
    dm.reset_launches()
    with mock.patch.object(dm, "_on_cuda", return_value=True), \
            mock.patch("omni_tpu_torch.kernels._build.load",
                       side_effect=RuntimeError("nvcc not found")), \
            mock.patch.object(dm, "q4k_gemv_plain") as plain_a, \
            mock.patch.object(dm, "q4k_gemm_plain") as plain_b:
        for m in (1, 16):
            with pytest.raises(RuntimeError, match="nvcc"):
                dm.matmul(torch.from_numpy(_x(0, m, 2048)), pqt)
    assert not plain_a.called and not plain_b.called
    assert dm.launches == {"q4k_gemv": 0, "q4k_gemm": 0}


@pytest.mark.parametrize("case", ["m_too_big", "m_too_small", "k_mismatch",
                                  "out_dtype", "bad_plane"])
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
        else:
            pqt.sc = pqt.sc[:, :-1]
            dm.q4k_gemv(x1, pqt)
