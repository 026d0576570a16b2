"""The port's low-bit K-quants (Q2_K, Q3_K) and the last branches of
kernel D against the JAX package: the numpy oracles (Q3_K's packed 6-bit
scales on every value), the quarter planes of the device repack, `dequant`
and the load policy; the exactness of the scale law in f32; the plain laws
of kernel H (`q2k_gemv`, `q3k_gemv`) against qmatmul_gp_pallas and of
kernel D's Q2_K, Q3_K, Q4_0, Q4_1, Q5_0 and Q5_1 branches against
qmatmul_pallas, both in interpret mode; `kernel_for` against the JAX
dispatcher's order under every setting of its three switches; the KV
session operations of `Context` against omni_tpu's; and tiny Q2_K and Q3_K
files served greedily by both packages. Everything here runs on the CPU;
the CUDA kernels are held against their plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

import itertools
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_tpu.cli import quantize as jax_quantize
from omni_tpu.core import GGMLType, quants
from omni_tpu.core.dtypes import type_traits
from omni_tpu.core.gguf import GGUFReader as JaxReader
from omni_tpu.kernels import dequant as jax_dequant
from omni_tpu.kernels import repack as jax_repack
from omni_tpu.kernels.dequant_matmul import (gp_supported, qmatmul_gp_pallas,
                                             qmatmul_pallas, sh_supported)
from omni_tpu.kernels.qformats import load_quantized as jax_load
from omni_tpu.models import qwen3 as jq
from omni_tpu.runtime import Batch as JaxBatch
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
from omni_tpu_torch.runtime import Batch, Context, SamplerParams
from test_torch_gguf import _assert_same_params
# the module's autouse fixture: no JAX compile-cache writes from this file
from test_torch_kernels import ATOL, ORDER_ATOL, RTOL, _x, no_compile_cache  # noqa: F401
from test_torch_legacy_quants import (_jax_ctx, _jax_turn, _on_a_mocked_card,
                                      _port_ctx, _port_turn,
                                      assert_departs_at_a_rounding_flip)

ROOT = Path(__file__).resolve().parent.parent
Q2_K, Q3_K = GGMLType.Q2_K, GGMLType.Q3_K
LOWBIT = [Q2_K, Q3_K]
LEGACY = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1]
ids = lambda t: t.name  # noqa: E731


def _blocks(seed, qtype, n, k, source="quantized"):
    """Blocks of a seeded [n, k] weight: quantized by omni_tpu's encoder,
    or ("random") every byte random but the f16 scales, which are drawn
    uniform in [1e-3, 1e-2) so every value is finite (Q3_K's hmask, quarters
    and packed scales, Q2_K's scales, mins and quarters over all their
    values)."""
    rng = np.random.default_rng(seed)
    if source == "quantized":
        w = rng.standard_normal((n, k), dtype=np.float32)
        return np.array(quants.quantize(w, qtype)).reshape(-1, type_traits(qtype).type_size)
    nb = n * k // 256
    b = rng.integers(0, 256, (nb, type_traits(qtype).type_size), dtype=np.uint8)
    off = 80 if qtype == Q2_K else 108
    nf = 2 if qtype == Q2_K else 1
    f = rng.uniform(1e-3, 1e-2, (nb, nf)).astype("<f2")
    b[:, off:off + 2 * nf] = f.view(np.uint8)
    return b


def _pair(seed, qtype, n=24, k=4096, source="quantized"):
    """(JAX QTensor, the port's QTensor on the CPU, the blocks)."""
    import jax

    blocks = _blocks(seed, qtype, n, k, source)
    jqt = jax_repack(blocks, qtype, (n, k))
    pqt = from_jax_params(jax.tree_util.tree_map(np.asarray, jqt), "cpu")
    return jqt, pqt, blocks


# ---------------------------------------------------------------- the codec

@pytest.mark.parametrize("source", ["quantized", "random"])
@pytest.mark.parametrize("n,k", [(5, 256), (8, 1280), (3, 4096 + 512)])
@pytest.mark.parametrize("qtype", LOWBIT, ids=ids)
def test_lowbit_dequant_bit_exact(qtype, n, k, source):
    """The port's numpy oracle, its torch dequant of the planes and the JAX
    dequant (dequant_tile) equal omni_tpu's block dequantiser bit for bit,
    on encoder output and on random bytes."""
    jqt, pqt, blocks = _pair(n + k, qtype, n, k, source)
    ref = quants.dequantize(blocks, qtype, (n, k))
    np.testing.assert_array_equal(port_quants.dequantize(blocks, qtype, (n, k)), ref)
    np.testing.assert_array_equal(qformats.dequant(pqt).numpy(), ref)
    np.testing.assert_array_equal(np.asarray(jax_dequant(jqt)), ref)


def test_unpack_scales_q3k_on_every_6_bit_value():
    """Q3_K's 12-byte scales: four superblocks carry each 6-bit value
    0..63 once; the port's numpy unpacking and its device repack give
    omni_tpu's signed scales (value − 32) for every one, at each of the 16
    positions a value can take."""
    vals = np.arange(64, dtype=np.int16) - 32
    for shift in range(16):
        sc = np.roll(vals, shift).reshape(4, 16).astype(np.int8)
        packed = quants._pack_scales_q3k(sc)
        want = quants._unpack_scales_q3k(packed)
        np.testing.assert_array_equal(want, sc)
        np.testing.assert_array_equal(port_quants._unpack_scales_q3k(packed), want)
        b = _blocks(shift, Q3_K, 1, 1024, "random")
        b[:, 96:108] = packed
        pqt = qformats.repack(torch.from_numpy(b.copy()), Q3_K, (1, 1024))
        np.testing.assert_array_equal(pqt.sc.numpy().reshape(4, 16), want)


# ---------------------------------------------------------------- the planes

@pytest.mark.parametrize("source", ["quantized", "random"])
@pytest.mark.parametrize("n,k", [(5, 256), (24, 1280), (3, 4096 + 512)])
@pytest.mark.parametrize("qtype", LOWBIT, ids=ids)
def test_lowbit_repack_is_the_transpose_of_jax_repack(qtype, n, k, source):
    """The port's torch repack of the GGUF blocks gives the transposes of
    the JAX planes bit for bit: q u8 [N, K/4] in superblock-local quarters
    (element s·256 + 64j + r at shift 2j of byte r), sc int8 [N, K/16], d f32
    [N, K/256]; Q2_K's mn int8 [N, K/16] and dm f32 [N, K/256], Q3_K's qh
    u8 [N, K/8] (bit 2 of q + 4, element order)."""
    jqt, _, blocks = _pair(3 * n + k, qtype, n, k, source)
    pqt = qformats.repack(torch.from_numpy(blocks.copy()), qtype, (n, k))
    qformats.check_qtensor(pqt, qtype)
    want = {"q", "sc", "d"} | ({"mn", "dm"} if qtype == Q2_K else {"qh"})
    assert set(pqt.planes()) == set(jqt.planes()) == want
    for nm, a in pqt.planes().items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jqt, nm)).T)
    assert qformats.tile_granule(qtype) == 256
    # element 64j + r of superblock 0 is at shift 2j of byte r; the file's
    # qs put element 128h + 32i + l at shift 2i of byte 32h + l
    v = qformats.unpack_sb_quarters(pqt.q)[0, :256].numpy()
    off = 16 if qtype == Q2_K else 32
    qs = blocks[0, off:off + 64]
    e = np.arange(256)
    np.testing.assert_array_equal(v, (qs[32 * (e // 128) + e % 32] >> (2 * ((e % 128) // 32))) & 3)


@pytest.mark.parametrize("qtype", LOWBIT, ids=ids)
def test_lowbit_load_policy_matches_jax(qtype):
    """A 2-D tensor stays quantized, the JAX planes transposed (K = 1280:
    `kernel_for` sends it to kernel D at every M, as the JAX dispatcher's
    gp_supported refuses it, and K = 2048: kernel H at M = 1..8);
    keep_quantized=False and a 1-D tensor widen exactly as the JAX
    load_quantized widens them."""
    rng = np.random.default_rng(7)
    for shape in ((4, 1280), (4, 2048)):
        blocks = quants.quantize(rng.standard_normal(shape, dtype=np.float32), qtype)
        got = qformats.load_quantized(blocks, qtype, shape, device="cpu")
        want = jax_load(blocks, qtype, shape)
        assert isinstance(got, qformats.QTensor) and got.ggml_type == qtype
        for nm, a in got.planes().items():
            np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(want, nm)).T)
        for m in (1, 8, 9):
            kern = dm.kernel_for(m, got)
            assert kern is (getattr(dm, dm.LOWBIT_GEMV[qtype]) if gp_supported(m, want)
                            else dm.qgemm)
            assert not sh_supported(m, want)
        for blocks_, shape_, keep in ((blocks, shape, False),
                                      (blocks, (shape[0] * shape[1],), True)):
            got = qformats.load_quantized(blocks_, qtype, shape_, keep, "cpu")
            want = np.asarray(jax_load(blocks_, qtype, shape_, keep).astype(np.float32))
            assert got.dtype == (torch.float32 if len(shape_) == 1 else torch.bfloat16)
            np.testing.assert_array_equal(got.float().numpy(), want)


def test_check_qtensor_wants_the_lowbit_planes():
    """Q2_K needs mn and dm and refuses qh; Q3_K needs qh and refuses mn."""
    _, q2, _ = _pair(1, Q2_K, n=4, k=512)
    _, q3, _ = _pair(2, Q3_K, n=4, k=512)
    qformats.check_qtensor(q2, Q2_K)
    qformats.check_qtensor(q3, Q3_K)
    mn = q2.mn
    q2.mn = None
    with pytest.raises(ValueError, match="plane mn"):
        qformats.check_qtensor(q2, Q2_K)
    q2.mn, q2.qh = mn, q3.qh
    with pytest.raises(ValueError, match="no plane qh"):
        qformats.check_qtensor(q2, Q2_K)
    q3.mn = mn
    with pytest.raises(ValueError, match="no plane mn"):
        qformats.check_qtensor(q3, Q3_K)


# -------------------------------------------------------- the scale law's exactness

def test_lowbit_scale_products_are_exact_in_f32():
    """Over every finite f16 d (normal and subnormal, both signs), every
    scale (Q2_K's 0..15, Q3_K's −32..31) and every value (−4..3): dl = d·sc
    and q·dl are exact in f32, so kernel D's products need no rounding and
    a contracted multiply-add cannot move a bf16 weight; Q2_K's q·dl − ml
    (ml = dm·mn, exact too) then rounds once, to the f32 nearest the exact
    difference, whichever way it is formed."""
    h = np.arange(0x10000, dtype=np.uint32).astype(np.uint16).view(np.float16)
    d = h[np.isfinite(h)].astype(np.float32)
    sc = np.arange(-32, 32, dtype=np.float32)
    dl = d[:, None] * sc[None, :]  # f32 products
    np.testing.assert_array_equal(dl.astype(np.float64),
                                  d.astype(np.float64)[:, None] * sc[None, :])
    for q in range(-4, 4):
        np.testing.assert_array_equal((np.float32(q) * dl).astype(np.float64),
                                      q * dl.astype(np.float64))
    # Q2_K: dl = d·sc (sc 0..15), ml = dm·mn (mn 0..15), q 0..3
    rng = np.random.default_rng(0)
    pick = rng.integers(0, len(d), (2, 1 << 20))
    dl2 = d[pick[0]] * rng.integers(0, 16, 1 << 20).astype(np.float32)
    ml2 = d[pick[1]] * rng.integers(0, 16, 1 << 20).astype(np.float32)
    q2 = rng.integers(0, 4, 1 << 20).astype(np.float32)
    got = torch.from_numpy(q2) * torch.from_numpy(dl2) - torch.from_numpy(ml2)
    exact = q2.astype(np.float64) * dl2.astype(np.float64) - ml2.astype(np.float64)
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))


# ------------------------------------------------------------ the kernels' laws

@pytest.mark.parametrize("m,k", [(1, 6144), (2, 4096), (3, 4096), (8, 4096)],
                         ids=lambda v: str(v))
@pytest.mark.parametrize("qtype", LOWBIT, ids=ids)
def test_plain_lowbit_gemv_matches_gp_pallas(qtype, m, k):
    """Kernel H's plain law (per 16-group P = x·q with q the raw values,
    then Σ dl·P − ml·xs; Q3_K without the min) == qmatmul_gp_pallas
    (interpret) on a ragged N = 24 (tests/test_qkernels.py:52-92), within
    tests/test_qkernels.py's tolerance (rtol 2e-2, atol 0.4) and
    ORDER_ATOL (5e-3: both sum bf16 x times exact values in f32, in another
    order)."""
    jqt, pqt, _ = _pair(10 * m + k, qtype, k=k)
    x = _x(m + 13, m, k)
    assert gp_supported(m, jqt)
    want = np.asarray(qmatmul_gp_pallas(jnp.asarray(x), jqt, block_n=16,
                                        out_dtype=jnp.float32, interpret=True))
    wrapper = dm.kernel_for(m, pqt)
    assert wrapper.__name__ == dm.LOWBIT_GEMV[qtype]
    got = wrapper(torch.from_numpy(x).to(torch.bfloat16), pqt, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ORDER_ATOL)


@pytest.mark.parametrize("m", [1, 4, 48], ids=lambda m: f"m{m}")
@pytest.mark.parametrize("qtype", LOWBIT + LEGACY, ids=ids)
def test_plain_qgemm_matches_qmatmul_pallas(qtype, m):
    """Kernel D's plain law for its Q2_K, Q3_K and legacy branches
    (dequant_tile's bf16 weights: bf16(q·dl − ml), bf16(q·dl),
    bf16((q − 8)·d), bf16((q − 16)·d), bf16(q·d + m); then a dot with f32
    accumulation) == qmatmul_pallas (interpret) at K = 512 on a ragged N
    (tests/test_qkernels.py:153-165), within the same tolerances."""
    import jax

    k = 512
    if qtype in LOWBIT:
        jqt, pqt, _ = _pair(10 * m + 7, qtype, k=k)
    else:
        rng = np.random.default_rng(10 * m + 7)
        blocks = quants.quantize(rng.standard_normal((24, k), dtype=np.float32) + 0.5,
                                 qtype)
        jqt = jax_repack(blocks, qtype, (24, k))
        pqt = from_jax_params(jax.tree_util.tree_map(np.asarray, jqt), "cpu")
    x = _x(m + 17, m, k)
    want = np.asarray(qmatmul_pallas(jnp.asarray(x), jqt, block_m=64, block_n=16,
                                     out_dtype=jnp.float32, interpret=True))
    np.testing.assert_array_equal(
        qformats.dequant(pqt, torch.bfloat16).float().numpy(),
        np.asarray(jax_dequant(jqt, jnp.bfloat16).astype(jnp.float32)))
    got = dm.qgemm(torch.from_numpy(x).to(torch.bfloat16), pqt, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ORDER_ATOL)


@pytest.mark.parametrize("qtype", LOWBIT, ids=ids)
def test_chip_smoke_f64_law_is_the_lowbit_kernels_law(qtype):
    """chip_smoke.py's law_f64 of kernel H and D's low-bit branches (the
    references of the teacher-forced checks) equals the plain version to
    f32 noise, and rounded to bf16 is within the kernel-vs-plain limit."""
    from chip_smoke import law_f64, limit_ratio

    _, pqt, _ = _pair(9, qtype, n=40, k=2048)
    for name, m in ((dm.LOWBIT_GEMV[qtype], 3), ("qgemm", 16)):
        x = torch.from_numpy(_x(m, m, 2048)).to(torch.bfloat16)
        plain = getattr(dm, name + "_plain")
        want = plain(x, pqt, torch.float32)
        got = law_f64(name, x, pqt, torch.float32)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
        assert limit_ratio(law_f64(name, x, pqt, torch.bfloat16).float(),
                           plain(x, pqt).float()) <= 1.0


@pytest.mark.parametrize("qtype", LOWBIT, ids=ids)
def test_check_kernel_rejects_a_misread_lowbit_plane(qtype):
    """chip_smoke.check_kernel fails a stand-in kernel H that drops Q2_K's
    mins or reads Q3_K's high bit in the wrong sense (hmask set taken as
    "subtract 4"), and passes the plain version against itself, on
    testing_synth's blocks."""
    from chip_smoke import check_kernel

    qt = testing_synth.synth_quant(qtype, 256, 4096, "cpu",
                                   torch.Generator().manual_seed(0))
    name = dm.LOWBIT_GEMV[qtype]
    plain = getattr(dm, name + "_plain")

    def standin(x, w, out_dtype):
        if qtype == Q2_K:
            bad = qformats.QTensor(Q2_K, w.shape, w.q, w.sc, torch.zeros_like(w.mn),
                                   w.d, w.dm)
        else:
            bad = qformats.QTensor(Q3_K, w.shape, w.q, w.sc, None, w.d, None,
                                   qh=~w.qh)
        return plain(x, bad, out_dtype)

    max_err = {}
    check_kernel(name, plain, plain, qt, "wq", 1, torch.bfloat16,
                 torch.Generator().manual_seed(3), max_err)
    with pytest.raises(SystemExit, match="disagrees"):
        check_kernel(name, standin, plain, qt, "wq", 1, torch.bfloat16,
                     torch.Generator().manual_seed(3), max_err)


# ----------------------------------------------------------------- the routes

FORMATS = [GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.Q8_0, *LEGACY,
           GGMLType.IQ4_NL, GGMLType.IQ4_XS, GGMLType.MXFP4, Q2_K, Q3_K]
SWITCHES = list(itertools.product([True, False], repeat=3))


@pytest.fixture(scope="module")
def route_weights():
    """{(format, K): (JAX QTensor, the port's)} for the thirteen formats the
    JAX package keeps quantized, at K = 512, 1280, 2048, 4096."""
    import jax

    out = {}
    rng = np.random.default_rng(5)
    for t in FORMATS:
        for k in (512, 1280, 2048, 4096):
            blocks = quants.quantize(rng.standard_normal((8, k), dtype=np.float32), t)
            jqt = jax_repack(blocks, t, (8, k))
            out[t, k] = jqt, from_jax_params(jax.tree_util.tree_map(np.asarray, jqt), "cpu")
    return out


@pytest.mark.parametrize("gp_decode,gp_smallm,sh_prefill", SWITCHES,
                         ids=lambda v: "on" if v else "off")
def test_kernel_for_follows_the_jax_dispatcher(gp_decode, gp_smallm, sh_prefill,
                                               route_weights):
    """Under each of the 8 settings of OMNI_GP_DECODE, OMNI_GP_SMALLM and
    OMNI_SH_PREFILL, `kernel_for` picks, for all 13 formats at M = 1, 2, 8,
    9, 64 and K = 512, 1280, 2048, 4096, the route the JAX `matmul` takes
    on a TPU (omni_tpu/kernels/dequant_matmul.py:665-672, its own
    gp_supported and sh_supported): gp, then sh, then qmatmul_pallas
    (kernel D); the gp and sh kernels are the weight's format's."""
    seen = set()
    with mock.patch.multiple(dm, GP_DECODE=gp_decode, GP_SMALLM=gp_smallm,
                             SH_PREFILL=sh_prefill):
        for (t, k), (jqt, pqt) in route_weights.items():
            for m in (1, 2, 8, 9, 64):
                if gp_decode and gp_supported(m, jqt) and (m == 1 or gp_smallm):
                    want = "gp"
                elif sh_prefill and sh_supported(m, jqt):
                    want = "sh"
                else:
                    want = "pallas"
                kern = dm.kernel_for(m, pqt)
                got = ("gp" if kern in dm._GEMV.values() else
                       "sh" if kern in dm._GEMM.values() else
                       "pallas" if kern is dm.qgemm else None)
                assert got == want, (t.name, k, m)
                if got == "gp":
                    assert kern is dm._GEMV[t]
                if got == "sh":
                    assert kern is dm._GEMM[t]
                seen.add(want)
    assert "pallas" in seen and (("gp" in seen) == gp_decode)


def test_switches_are_read_from_the_environment():
    """The three switches are module constants read at import, with the JAX
    package's defaults (on)."""
    code = ("from omni_tpu_torch.kernels import dequant_matmul as dm; "
            "print(dm.GP_DECODE, dm.GP_SMALLM, dm.SH_PREFILL)")
    base = {k: v for k, v in os.environ.items()
            if k not in ("OMNI_GP_DECODE", "OMNI_GP_SMALLM", "OMNI_SH_PREFILL")}
    for extra, want in (({}, "True True True"),
                        ({"OMNI_GP_DECODE": "0"}, "False True True"),
                        ({"OMNI_GP_SMALLM": "0"}, "True False True"),
                        ({"OMNI_SH_PREFILL": "0", "OMNI_GP_DECODE": "1"},
                         "True True False")):
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                           env={**base, "PYTHONPATH": str(ROOT), **extra},
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        assert r.stdout.split() == want.split()


@pytest.mark.parametrize("qtype", LOWBIT, ids=ids)
def test_matmul_routes_lowbit_formats_on_a_mocked_card(qtype):
    """On the card `matmul` sends a Q2_K or Q3_K weight to kernel H's entry
    at M = 1..8 where K % 2048 == 0 and to kernel D's branch otherwise (M >
    8, and every M at K = 1280), passing exactly its planes (Q2_K no qh,
    Q3_K no mn or dm); each launch counts once under its own name, D's also
    under its format in qgemm_launches."""
    dm.reset_launches()
    got = []
    for k in (2048, 1280):
        _, pqt, _ = _pair(12, qtype, n=8, k=k)
        for m in (1, 8, 9, 64):
            x = torch.from_numpy(_x(m, m, k))
            gp = m <= 8 and k % 2048 == 0
            assert dm.kernel_for(m, pqt).__name__ == (dm.LOWBIT_GEMV[qtype] if gp
                                                      else "qgemm")
            got += _on_a_mocked_card(dm.matmul, x, pqt)[1]
    nulls = {"qh"} if qtype == Q2_K else {"mn", "dm"}
    gemv, gemm = dm.LOWBIT_GEMV[qtype], dm._QGEMM_ENTRY[qtype]
    assert sorted(e for e, _ in got) == sorted([gemv] * 2 + [gemm] * 6)
    assert all(set(n) == nulls for _, n in got)
    assert dm.launches == {**dict.fromkeys(dm.launches, 0), gemv: 2, "qgemm": 6}
    assert dm.qgemm_launches == {**dict.fromkeys(dm.qgemm_launches, 0),
                                 qtype.name: 6}


@pytest.mark.parametrize("qtype", LEGACY, ids=ids)
def test_switched_routes_send_legacy_weights_to_kernel_d(qtype):
    """With OMNI_GP_DECODE and OMNI_SH_PREFILL off, a legacy weight goes to
    kernel D's branch of its format at every M, passing exactly the format's
    planes; with only OMNI_GP_SMALLM off, M = 2..8 goes to D and M = 1 to
    kernel A's branch."""
    import jax

    rng = np.random.default_rng(3)
    blocks = quants.quantize(rng.standard_normal((8, 2048), dtype=np.float32), qtype)
    jqt = jax_repack(blocks, qtype, (8, 2048))
    pqt = from_jax_params(jax.tree_util.tree_map(np.asarray, jqt), "cpu")
    nulls = {"sc", "mn"} | ({"dm"} if qtype in (GGMLType.Q4_0, GGMLType.Q5_0) else set()) | (
        {"qh"} if qtype in (GGMLType.Q4_0, GGMLType.Q4_1) else set())
    dm.reset_launches()
    with mock.patch.multiple(dm, GP_DECODE=False, SH_PREFILL=False):
        got = [_on_a_mocked_card(dm.matmul, torch.from_numpy(_x(m, m, 2048)), pqt)[1][0]
               for m in (1, 8, 9, 64)]
    assert [e for e, _ in got] == [dm._QGEMM_ENTRY[qtype]] * 4
    assert all(set(n) == nulls for _, n in got)
    assert dm.qgemm_launches[qtype.name] == 4 == dm.launches["qgemm"]
    with mock.patch.object(dm, "GP_SMALLM", False):
        assert dm.kernel_for(1, pqt) is dm._GEMV[qtype]
        assert dm.kernel_for(2, pqt) is dm.qgemm
        assert dm.kernel_for(9, pqt) is dm._GEMM[qtype]


@pytest.mark.parametrize("qtype", LOWBIT, ids=ids)
def test_lowbit_wrappers_launch_or_raise(qtype):
    """Where the kernels cannot be built (no nvcc here) a Q2_K or Q3_K
    weight on the card path raises rather than running the plain version,
    and counts no launch; the other formats' wrappers refuse it."""
    _, pqt, _ = _pair(4, qtype, n=8, k=2048)
    dm.reset_launches()
    with mock.patch.object(dm, "_on_cuda", return_value=True), \
            mock.patch("omni_tpu_torch.kernels._build.load",
                       side_effect=RuntimeError("nvcc not found")), \
            mock.patch.object(dm, "q2k_gemv_plain") as gemv_plain, \
            mock.patch.object(dm, "qgemm_plain") as gemm_plain:
        for m in (1, 16):
            with pytest.raises(RuntimeError, match="nvcc"):
                dm.matmul(torch.from_numpy(_x(0, m, 2048)), pqt)
        other = dm.q3k_gemv if qtype == Q2_K else dm.q2k_gemv
        for wrapper in (dm.q4k_gemv, dm.q6k_gemv, dm.q8_0_gemv, other):
            with pytest.raises(ValueError, match=qtype.name):
                wrapper(torch.zeros((1, 2048), dtype=torch.bfloat16), pqt)
    assert not gemv_plain.called and not gemm_plain.called
    assert not any(dm.launches.values())


# ------------------------------------------------- the port's synthetic files

@pytest.mark.parametrize("recipe", ["Q2_K", "Q3_K"])
def test_lowbit_recipes_match_the_jax_quantizer(recipe):
    """The port's Q2_K and Q3_K rules equal the JAX quantizer's uniform rule
    (`pick_type`) for every tensor of a 36-layer Qwen3: the head Q6_K, every
    other weight, the embedding too, in the recipe's type."""
    default = testing_synth.RECIPES[recipe]
    assert default == GGMLType[recipe]
    names = ["output.weight", "token_embd.weight"] + [
        f"blk.{i}.{t}.weight" for i in range(36)
        for t in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate",
                  "ffn_up", "ffn_down")]
    got = [testing_synth.pick_type(nm, recipe, default, 36) for nm in names]
    want = [jax_quantize.pick_type(nm, recipe, default, 36) for nm in names]
    assert got == want and got[0] == GGMLType.Q6_K
    assert got.count(default) == len(names) - 1


@pytest.mark.parametrize("qtype", LOWBIT, ids=ids)
def test_synthetic_lowbit_blocks(qtype):
    """testing_synth's blocks: every scale (Q2_K 0..15, Q3_K −32..31), min
    and value appears, d (and dm) in [1e-5, 1.1e-4); read the same by both
    packages' dequantisers, weights of the RMS the docstring gives (Q2_K
    9.6e-4 with mean 2.3e-4, Q3_K 2.9e-3 with mean ~0)."""
    nb = 64 * 2048 // 256
    blocks = testing_synth.BLOCKS[qtype](nb, "cpu", torch.Generator().manual_seed(1))
    b = blocks.numpy()
    ref = quants.dequantize(b, qtype).astype(np.float64)
    np.testing.assert_array_equal(port_quants.dequantize(b, qtype), ref)
    rms, mean = np.sqrt(np.mean(ref ** 2)), ref.mean()
    qt = qformats.repack(blocks, qtype, (64, 2048))
    assert 9e-6 < qt.d.min() and qt.d.max() < 1.11e-4
    if qtype == Q2_K:
        assert set(qt.sc.unique().tolist()) == set(qt.mn.unique().tolist()) == set(range(16))
        assert 8e-4 < rms < 1.15e-3 and 1.8e-4 < mean < 2.8e-4
    else:
        assert set(qt.sc.unique().tolist()) == set(range(-32, 32))
        assert 2.5e-3 < rms < 3.3e-3 and abs(mean) < 1e-4
    assert set(qformats.lowbit_values(qt).unique().tolist()) == (
        set(range(4)) if qtype == Q2_K else set(range(-4, 4)))


# ------------------------------------------------------ the tiny GGUF files

_TINY = dict(n_layers=2, d_model=256, n_heads=2, n_kv_heads=1, head_dim=128,
             d_ff=512, n_vocab=512)


@pytest.fixture(scope="module")
def lowbit_files(tmp_path_factory):
    """The tiny F32 Qwen3 of the JAX package's tools (separate head)
    quantized Q2_K and Q3_K by `omni-quantize`'s `quantize_file` (GGUFWriter
    and `quants.quantize`) under the JAX quantizer's uniform rule: the head
    Q6_K, every other weight and the embedding in the format. The JAX
    quantizer has no recipe of these names, so the test lends it one."""
    d = tmp_path_factory.mktemp("lowbit")
    src = d / "f32.gguf"
    write_tiny_qwen3(src, qtype=GGMLType.F32, tied_head=False, **_TINY)
    files = {}
    for recipe in ("Q2_K", "Q3_K"):
        files[recipe] = d / f"{recipe.lower()}.gguf"
        with mock.patch.dict(jax_quantize.RECIPES, {recipe: GGMLType[recipe]}):
            jax_quantize.quantize_file(str(src), str(files[recipe]), recipe)
    return files


@pytest.mark.parametrize("recipe", ["Q2_K", "Q3_K"])
def test_lowbit_file_routes_as_the_jax_dispatcher(recipe, lowbit_files):
    """Each weight of the tiny file goes, at M = 1, 8 and 64, to the kernel
    the JAX dispatcher would pick: K = 256 and 512 are no multiples of 2048,
    so gp_supported refuses every one, and kernel D takes them all."""
    path = lowbit_files[recipe]
    jparams, tparams = jq.load_params(JaxReader(path)), tq.load_params(
        GGUFReader(path), device="cpu")
    n = 0
    for jl, tl in zip(jparams["layers"], tparams["layers"], strict=True):
        for key, w in tl.items():
            if not isinstance(w, qformats.QTensor):
                continue
            for m in (1, 8, 64):
                assert not gp_supported(m, jl[key]) and not sh_supported(m, jl[key])
                assert dm.kernel_for(m, w) is dm.qgemm
                n += 1
    assert n == 2 * 7 * 3


@pytest.mark.parametrize("recipe", ["Q2_K", "Q3_K"])
def test_lowbit_file_loads_and_serves_as_omni_tpu(recipe, lowbit_files):
    """Each file, loaded by each package's own reader and loader, gives the
    same parameters (planes, the embedding widened to bf16, norms), and a
    greedy turn of up to 16 tokens served from it emits the same tokens in
    both. The Q3_K file's turn is held against omni_tpu's jitted steps;
    the Q2_K file's against its pipeline run op by op (jax.disable_jit), as
    tests/test_torch_legacy_quants.py holds the Q4_0 file's: omni_tpu's
    jitted steps meet a rounding flip at its ninth token (the next test
    proves it)."""
    import jax

    path = lowbit_files[recipe]
    jr, tr = JaxReader(path), GGUFReader(path)
    jparams, tparams = jq.load_params(jr), tq.load_params(tr, device="cpu")
    _assert_same_params(jparams, tparams)
    types = {w.ggml_type for lp in tparams["layers"] for w in lp.values()
             if isinstance(w, qformats.QTensor)}
    assert types == {GGMLType[recipe]}
    assert tparams["output"].ggml_type == GGMLType.Q6_K
    embd = tr.tensors["token_embd.weight"]
    assert embd.ggml_type == GGMLType[recipe]
    want_embd = port_quants.dequantize(embd.data, embd.ggml_type, embd.shape)
    assert torch.equal(tparams["token_embd"],
                       torch.from_numpy(want_embd).to(torch.bfloat16))
    jctx = _jax_ctx(jr, jparams)
    if recipe == "Q2_K":
        with jax.disable_jit():
            want = _jax_turn(jctx)
    else:
        want = _jax_turn(jctx)
    tctx = _port_ctx(tr, tparams)
    got = _port_turn(tctx)
    assert sum(len(e["content"].split()) for e in got) >= 8
    assert got == want
    assert tctx.n_past == jctx.n_past


def test_jitted_turn_from_the_q2_k_file_departs_at_a_rounding_flip(lowbit_files):
    """The Q2_K file's turn against omni_tpu's jitted steps: identical up to
    the first token where the port's top-2 margin is below the logit
    distance between the two (the ninth here), both within
    JIT_LOGITS_ATOL, each picking its own turn's token on every row
    (`assert_departs_at_a_rounding_flip`)."""
    assert_departs_at_a_rounding_flip(lowbit_files["Q2_K"])


# ------------------------------------------------- the KV session operations

@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    path = tmp_path_factory.mktemp("kvops") / "tiny.gguf"
    write_tiny_qwen3(path, qtype=GGMLType.F32, tied_head=False, n_layers=1,
                     d_model=128, n_heads=2, n_kv_heads=1, head_dim=64, d_ff=128,
                     n_vocab=64)
    jr, tr = JaxReader(path), GGUFReader(path)
    return jr, jq.load_params(jr), tr, tq.load_params(tr, device="cpu")


def _shadows(ctx):
    return (ctx.cells_used, ctx.kv_high, np.asarray(ctx.cache.pos).astype(np.int64),
            np.asarray(ctx.cache.seq_mask).astype(np.int64))


@pytest.mark.parametrize("kv_dtype", ["bf16", "q8_0", "q4_0"])
def test_kv_session_ops_keep_the_shadows_of_jax(kv_dtype, tiny_model):
    """Three sequences of 4 tokens each fill a 32-cell pool in both
    packages; after each of seq_rm, seq_cp, seq_rm_all, seq_keep and
    clear_kv (and a decode between them, into the cells the operations
    freed), the port's Context's host shadows cells_used and kv_high and
    its cells' pos and seq_mask equal omni_tpu's. None of these touches a
    cell's values, so bf16, q8_0 and q4_0 pools behave alike."""
    jr, jparams, tr, tparams = tiny_model
    jctx = JaxContext(jq.Qwen3Config.from_gguf(jr.kv), jparams, jq.forward, jq.embed,
                      n_ctx=32, kv_dtype=jnp.bfloat16 if kv_dtype == "bf16" else kv_dtype,
                      sampler=JaxSamplerParams(greedy=True), buckets=(4,))
    tctx = Context(tq.Qwen3Config.from_gguf(tr.kv), tparams, tq.forward, tq.embed,
                   n_ctx=32, kv_dtype=kv_dtype, sampler=SamplerParams(greedy=True),
                   buckets=(4,), device="cpu")

    def both(op, *a):
        if op == "decode":
            toks, seq = np.arange(4) + 3 * a[0], np.full(4, a[0], np.int32)
            jctx.decode(JaxBatch(tokens=toks, seq_id=seq))
            tctx.decode(Batch(tokens=toks, seq_id=seq))
        else:
            getattr(jctx, op)(*a)
            getattr(tctx, op)(*a)
        want, got = _shadows(jctx), _shadows(tctx)
        assert got[:2] == want[:2], (op, a)
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])

    for s in (0, 1, 2):
        both("decode", s)
    steps = [("seq_rm", 1, 1, 3), ("seq_cp", 0, 3, 1, -1), ("decode", 1),
             ("seq_rm_all", 2, 3), ("seq_rm", 0), ("decode", 0), ("seq_keep", 3),
             ("decode", 2), ("seq_rm", 3, -1, -1), ("clear_kv",), ("decode", 1)]
    for op, *a in steps:
        both(op, *a)
    assert tctx.cells_used == 4
