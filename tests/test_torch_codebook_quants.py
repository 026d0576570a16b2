"""The port's codebook formats (IQ4_NL, IQ4_XS, MXFP4) against the JAX
package: the numpy oracles (with the e8m0 edge exponents and IQ4_XS's
extreme sub-scales), the nibble-index planes of the device repack (the
file's quant bytes; through the codebook, the JAX package's int8 value
planes), `dequant`, the load policy and `from_jax_params`' inverse
codebook; the routes `kernel_for` picks; the plain laws of kernel E's
`iq4_nl_gemv`, `iq4_xs_gemv` and `mxfp4_gemv` against qmatmul_gp_pallas
and of kernel D's three codebook branches against qmatmul_pallas, both in
interpret mode; `chip_smoke.check_kernel` failing
a kernel that drops IQ4_XS's sub-scale or is one exponent off on MXFP4;
and a tiny file of each recipe, made by omni_tpu's quantizer, served
greedily by both packages. Everything here runs on the CPU; the CUDA
kernels are held against their plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

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
from omni_tpu.kernels.qformats import tile_granule as jax_granule
from omni_tpu.models import qwen3 as jq
from omni_tpu.testing import write_tiny_qwen3
from omni_tpu_torch import testing_synth
from omni_tpu_torch.convert import from_jax_params
from omni_tpu_torch.core import quants as port_quants
from omni_tpu_torch.core.gguf import GGUFReader
from omni_tpu_torch.kernels import dequant_matmul as dm
from omni_tpu_torch.kernels import qformats
from omni_tpu_torch.models import qwen3 as tq
from test_torch_gguf import _assert_same_params
# the module's autouse fixture: no JAX compile-cache writes from this file
from test_torch_kernels import ATOL, ORDER_ATOL, RTOL, _x, no_compile_cache  # noqa: F401
from test_torch_legacy_quants import (_jax_ctx, _jax_turn, _on_a_mocked_card,
                                      _port_ctx, _port_turn)

IQ4_NL, IQ4_XS, MXFP4 = GGMLType.IQ4_NL, GGMLType.IQ4_XS, GGMLType.MXFP4
CODEBOOK = [IQ4_NL, IQ4_XS, MXFP4]
ids = lambda t: t.name  # noqa: E731


def _blocks(seed, qtype, n, k, edges=True):
    """Blocks of a seeded [n, k] weight quantized by omni_tpu's encoder;
    with `edges`, the cases a codec may get wrong: MXFP4's first four blocks
    take the exponents 0 and 1 (a subnormal d), 2 (the least normal one)
    and 254 (the largest finite); IQ4_XS's first superblock every sub-scale
    at −32 (ls = 0), its second at 31 (ls = 63)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k), dtype=np.float32)
    b = np.array(quants.quantize(w, qtype)).reshape(-1, type_traits(qtype).type_size)
    if not edges:
        return b
    if qtype == MXFP4:
        b[:4, 0] = (0, 1, 2, 254)
    if qtype == IQ4_XS and len(b) > 1:
        b[0, 2:8] = 0  # scales_h, scales_l: ls = 0
        b[1, 2:8] = 0xFF  # ls = 63
    return b


def _pair(seed, qtype, n=24, k=4096, edges=True):
    """(JAX QTensor, the port's QTensor on the CPU, the blocks)."""
    import jax

    blocks = _blocks(seed, qtype, n, k, edges)
    jqt = jax_repack(blocks, qtype, (n, k))
    pqt = from_jax_params(jax.tree_util.tree_map(np.asarray, jqt), "cpu")
    return jqt, pqt, blocks


# ---------------------------------------------------------------- the codec

@pytest.mark.parametrize("n,k", [(5, 256), (8, 1280), (3, 4096 + 512)])
@pytest.mark.parametrize("qtype", CODEBOOK, ids=ids)
def test_codebook_dequant_bit_exact(qtype, n, k):
    """The port's numpy oracle and its torch dequant of the planes equal
    omni_tpu's block dequantiser bit for bit, on the edge exponents and
    sub-scales of `_blocks` (an e8m0 byte of 254 times the codebook's ±12
    overflows f32 to ±inf in every one of them; e = 0 and 1 give a
    subnormal d, which the port keeps). So does the JAX dequant, but on the
    blocks of a subnormal d, which XLA on the CPU reads as zero."""
    jqt, pqt, blocks = _pair(n + k, qtype, n, k)
    with np.errstate(over="ignore"):
        ref = quants.dequantize(blocks, qtype, (n, k))
        np.testing.assert_array_equal(port_quants.dequantize(blocks, qtype, (n, k)),
                                      ref)
    np.testing.assert_array_equal(qformats.dequant(pqt).numpy(), ref)
    dl = qformats.int8_group_scales(pqt).repeat_interleave(32, 1).numpy()
    sub = (dl != 0) & (np.abs(dl) < np.finfo(np.float32).tiny)
    assert sub.any() == (qtype == MXFP4)
    np.testing.assert_array_equal(np.asarray(jax_dequant(jqt)), np.where(sub, 0, ref))
    if qtype == MXFP4:
        assert pqt.d[0, 0].item() == 2.0 ** -128 and pqt.d[0, 2].item() == 2.0 ** -126
        assert pqt.d[0, 3].item() == 2.0 ** 126
    if qtype == IQ4_XS:
        assert (pqt.sc[0, :8] == -32).all() and (pqt.sc[0, 8:16] == 31).all()


@pytest.mark.parametrize("e", [0, 1, 2, 3, 127, 128, 253, 254, 255])
def test_e8m0_half_builds_d_from_bits(e):
    """The port's device e8m0 decoding and its numpy copy equal omni_tpu's
    `_e8m0_half` bit for bit on the subnormal (e = 0, 1), normal and top
    exponents (e = 255, NaN in the OCP format, is 2^127 in both), with no
    exp2 or ldexp."""
    b = np.array([e], np.uint8)
    want = quants._e8m0_half(b).view(np.uint32)
    np.testing.assert_array_equal(port_quants._e8m0_half(b).view(np.uint32), want)
    got = qformats.e8m0_half(torch.from_numpy(b)).view(torch.int32).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want)


def _cases(shapes, granule_of):
    """(qtype, *shape) for each codebook format and each shape whose K holds
    whole planes of it: K % 256 != 0 only for IQ4_NL and MXFP4."""
    return [(t, *s) for t in CODEBOOK for s in shapes if s[-1] % granule_of(t) == 0]


def _qs(blocks, qtype, n, k):
    """The quant bytes of the blocks, [n, k/2] in file order (each
    32-group's 16 bytes: element j in the low nibble of byte j, j + 16 in
    its high one)."""
    off = 8 if qtype == IQ4_XS else (2 if qtype == IQ4_NL else 1)
    per = 128 if qtype == IQ4_XS else 16
    return blocks[:, off:off + per].reshape(n, k // 2)


@pytest.mark.parametrize("qtype,n,k", _cases([(5, 256), (24, 1280), (3, 4096 + 512),
                                              (4, 1056)], jax_granule),
                         ids=lambda v: getattr(v, "name", str(v)))
def test_codebook_repack_is_the_transpose_of_jax_repack(qtype, n, k):
    """The port's torch repack of the GGUF blocks keeps the file's quant
    bytes as its q plane, u8 [N, K/2] (element j in the low and j + 16 in
    the high nibble of byte j of each 32-group); decoded through the
    codebook (`int8_values`) it is the transpose of the JAX int8 value
    plane bit for bit, and the scales (IQ4_XS's 6-bit sc from scales_l and
    scales_h; MXFP4's d from the e8m0 byte's bits) are the transposes of
    the JAX planes bit for bit: d f32 [N, K/32] (IQ4_XS: sc int8 [N, K/32],
    d [N, K/256]). K = 1056 (33 blocks) is for the 32-granule formats
    only."""
    jqt, _, blocks = _pair(3 * n + k, qtype, n, k)
    pqt = qformats.repack(torch.from_numpy(blocks.copy()), qtype, (n, k))
    qformats.check_qtensor(pqt, qtype)
    want = {"q", "d"} | ({"sc"} if qtype == IQ4_XS else set())
    assert set(pqt.planes()) == set(jqt.planes()) == want
    assert pqt.q.dtype == torch.uint8 and tuple(pqt.q.shape) == (n, k // 2)
    np.testing.assert_array_equal(pqt.q.numpy(), _qs(blocks, qtype, n, k))
    values = qformats.int8_values(pqt)
    assert values.dtype == torch.int8
    np.testing.assert_array_equal(values.numpy(), np.asarray(jqt.q).T)
    for nm, a in pqt.planes().items():
        if nm != "q":
            np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jqt, nm)).T)
    assert qformats.tile_granule(qtype) == jax_granule(qtype)
    # the elements of block 0 in element order: the codebook of nibble j of
    # byte j % 16, low for j < 16
    off = 4 + 4 if qtype == IQ4_XS else (2 if qtype == IQ4_NL else 1)
    nib = np.concatenate([blocks[0, off:off + 16] & 0xF, blocks[0, off:off + 16] >> 4])
    table = qformats.MXFP4_KVALUES if qtype == MXFP4 else qformats.IQ4NL_KVALUES
    np.testing.assert_array_equal(values[0, :32].numpy(), np.array(table)[nib])


@pytest.mark.parametrize("qtype", CODEBOOK, ids=ids)
def test_codebook_load_policy_matches_jax(qtype):
    """A 2-D tensor stays quantized, the JAX planes transposed (q as
    nibble indexes whose codebook values are the JAX int8 plane's), at
    K = 1280 and, for IQ4_NL and MXFP4, at K = 1056 (their granule is 32), where
    `kernel_for` sends it to kernel D at every M, as the JAX dispatcher's
    gp_supported refuses it; keep_quantized=False and a 1-D tensor widen
    exactly as the JAX load_quantized widens them."""
    rng = np.random.default_rng(7)
    shapes = [(4, 1280)] + ([(4, 1056)] if qtype != IQ4_XS else [])
    for shape in shapes:
        blocks = quants.quantize(rng.standard_normal(shape, dtype=np.float32), qtype)
        got = qformats.load_quantized(blocks, qtype, shape, device="cpu")
        want = jax_load(blocks, qtype, shape)
        assert isinstance(got, qformats.QTensor) and got.ggml_type == qtype
        for nm, a in got.planes().items():
            if nm == "q":
                a = qformats.int8_values(got)
            np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(want, nm)).T)
        for m in (1, 8, 9):
            assert (dm.kernel_for(m, got) is dm.qgemm) == (
                not gp_supported(m, want) and not sh_supported(m, want))
        for blocks_, shape_, keep in ((blocks, shape, False),
                                      (blocks, (shape[0] * shape[1],), True)):
            got = qformats.load_quantized(blocks_, qtype, shape_, keep, "cpu")
            want = np.asarray(jax_load(blocks_, qtype, shape_, keep).astype(np.float32))
            assert got.dtype == (torch.float32 if len(shape_) == 1 else torch.bfloat16)
            np.testing.assert_array_equal(got.float().numpy(), want)
    if qtype != IQ4_XS:  # the last shape, K = 1056
        kept = qformats.load_quantized(blocks, qtype, shapes[-1], device="cpu")
        assert dm.kernel_for(1, kept) is dm.qgemm


def test_check_qtensor_wants_the_codebook_planes():
    """The q plane is u8 nibble indexes [N, K/2] (the JAX package's int8
    value plane [N, K] is refused); IQ4_XS needs its sc plane, at one byte
    per 32; IQ4_NL and MXFP4 refuse one."""
    _, xs, _ = _pair(1, IQ4_XS, n=4, k=512)
    qformats.check_qtensor(xs, IQ4_XS)
    qp = xs.q
    xs.q = qformats.int8_values(xs)
    with pytest.raises(ValueError, match="plane q"):
        qformats.check_qtensor(xs, IQ4_XS)
    xs.q = qp
    scp = xs.sc
    xs.sc = None
    with pytest.raises(ValueError, match="plane sc"):
        qformats.check_qtensor(xs, IQ4_XS)
    xs.sc = scp[:, :8].contiguous()
    with pytest.raises(ValueError, match="plane sc"):
        qformats.check_qtensor(xs, IQ4_XS)
    _, nl, _ = _pair(2, IQ4_NL, n=4, k=512)
    nl.sc = scp
    with pytest.raises(ValueError, match="no plane sc"):
        qformats.check_qtensor(nl, IQ4_NL)


def test_from_jax_params_carries_the_codebook_planes():
    """`from_jax_params` carries a parameter tree of the three formats'
    QTensors across, nothing widened: the scales transposed, the int8
    value plane turned back into the port's nibble plane through the
    inverse codebook, which equals the port's own repack of the same
    blocks (the file's quant bytes) and decodes to the JAX values bit for
    bit. MXFP4's 0 sits at indexes 0 and 8 of its codebook: blocks holding
    both come back with index 0 for each, the same values."""
    import jax

    pairs = {t.name: _pair(5, t, n=8, k=512) for t in CODEBOOK}
    zeros = _blocks(6, MXFP4, 8, 512, edges=False)
    zeros[:, 1:] = np.where(np.arange(16) % 2 == 0, 0x80, 0x08).astype(np.uint8)
    pairs["MXFP4 zeros"] = (jax_repack(zeros, MXFP4, (8, 512)), None, zeros)
    tree = from_jax_params(jax.tree_util.tree_map(
        np.asarray, {"w": {nm: p[0] for nm, p in pairs.items()}}), "cpu")
    for name, (jqt, _, blocks) in pairs.items():
        t = GGMLType[name.split()[0]]
        pqt = tree["w"][name]
        assert pqt.ggml_type == t and pqt.shape == (8, 512)
        assert set(pqt.planes()) == set(jqt.planes())
        qformats.check_qtensor(pqt, t)
        for nm, a in pqt.planes().items():
            assert a.dtype == {"d": torch.float32, "q": torch.uint8}.get(nm, torch.int8)
            want = np.asarray(getattr(jqt, nm)).T
            got = qformats.int8_values(pqt) if nm == "q" else a
            np.testing.assert_array_equal(got.numpy(), want)
        own = qformats.repack(torch.from_numpy(blocks.copy()), t, (8, 512))
        if name == "MXFP4 zeros":  # every index 8 of the file comes back as 0
            assert (_qs(blocks, t, 8, 512) == 0x80).sum() == 8 * 128
            assert (pqt.q == 0).all() and torch.equal(qformats.dequant(pqt),
                                                      qformats.dequant(own))
        else:
            assert torch.equal(pqt.q, own.q)


@pytest.mark.parametrize("qtype", CODEBOOK, ids=ids)
def test_codebook_plane_inverts_the_codebook(qtype):
    """`codebook_plane` is the inverse of `int8_values` on every index (the
    first of MXFP4's two zeros) and refuses a value outside the codebook."""
    table = torch.tensor(qformats.CODEBOOK_VALUES[qtype], dtype=torch.int8)
    values = table[torch.arange(64 * 32) % 16].reshape(64, 32)
    plane = qformats.codebook_plane(values, qtype)
    assert plane.dtype == torch.uint8 and tuple(plane.shape) == (64, 16)
    qt = qformats.QTensor(qtype, (64, 32), plane, None, None, None, None)
    assert torch.equal(qformats.int8_values(qt), values)
    idx = torch.cat([plane & 0xF, plane >> 4], dim=1).reshape(-1)
    first = {int(v): table.tolist().index(int(v)) for v in table}
    assert idx.tolist() == [first[int(v)] for v in values.reshape(-1)]
    with pytest.raises(ValueError, match="outside the codebook"):
        qformats.codebook_plane(torch.full((1, 32), 7, dtype=torch.int8), qtype)


# ------------------------------------------------------------ the kernels' laws

# K of the gp path per format: 2304 for IQ4_NL and MXFP4 (9 x 256: no K-quant
# could take the gp path there), 4096 for IQ4_XS (its d plane has one row per
# 256 elements, so it needs K % 2048)
GP_K = {IQ4_NL: 2304, MXFP4: 2304, IQ4_XS: 4096}


@pytest.mark.parametrize("m", [1, 2, 3, 8], ids=lambda m: f"m{m}")
@pytest.mark.parametrize("qtype", CODEBOOK, ids=ids)
def test_plain_codebook_gemv_matches_gp_pallas(qtype, m):
    """Kernel E's codebook entries' plain law (per 32-group P = x·q, then
    Σ dl·P with dl = d, or d·sc for IQ4_XS) == qmatmul_gp_pallas (interpret)
    on a ragged N, within tests/test_qkernels.py's tolerance and ORDER_ATOL
    (both sum bf16 x times the int8 values in f32, in another order)."""
    k = GP_K[qtype]
    jqt, pqt, _ = _pair(10 * m + 5, qtype, k=k, edges=False)
    x = _x(m + 13, m, k)
    assert gp_supported(m, jqt)
    want = np.asarray(qmatmul_gp_pallas(jnp.asarray(x), jqt, block_n=16,
                                        out_dtype=jnp.float32, interpret=True))
    wrapper = dm.kernel_for(m, pqt)
    assert wrapper.__name__ == dm.CODEBOOK_GEMV[qtype]
    got = wrapper(torch.from_numpy(x).to(torch.bfloat16), pqt, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ORDER_ATOL)


@pytest.mark.parametrize("qtype,m,k", _cases([(48, 4096), (300, 1280), (1, 1056)],
                                              jax_granule),
                         ids=lambda v: getattr(v, "name", str(v)))
def test_plain_codebook_qgemm_matches_qmatmul_pallas(qtype, m, k):
    """Kernel D's codebook branches' plain law (w = bf16(q·d), IQ4_XS
    bf16(q·(d·sc)), then a dot with f32 accumulation) == qmatmul_pallas
    (interpret) on a ragged N at prefill M, and at M = 1 with K = 1056 (33
    blocks: the route of an IQ4_NL or MXFP4 weight with K % 256 != 0)."""
    jqt, pqt, _ = _pair(10 * m + 7, qtype, k=k, edges=False)
    x = _x(m + 17, m, k)
    want = np.asarray(qmatmul_pallas(jnp.asarray(x), jqt, block_m=64, block_n=16,
                                     out_dtype=jnp.float32, interpret=True))
    assert dm.kernel_for(m, pqt) is dm.qgemm
    got = dm.qgemm(torch.from_numpy(x).to(torch.bfloat16), pqt, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ORDER_ATOL)


def test_iq4_xs_weights_are_exact_in_f32():
    """Kernel D's IQ4_XS weights are bf16(q·(d·sc)) (dequant_tile's order),
    and the f32 product is exact in either order: d is an f16 (11
    significant bits), q and sc fit 7 and 6, so q·d·sc needs at most 24
    bits. The one rounding is the cast to bf16, which both orders share."""
    _, pqt, _ = _pair(3, IQ4_XS, n=64, k=4096)
    q = qformats.int8_values(pqt).double()
    d = pqt.d.double().repeat_interleave(256, 1)
    sc = pqt.sc.double().repeat_interleave(32, 1)
    exact = q * d * sc
    assert torch.equal(qformats.dequant(pqt).double(), exact)
    assert torch.equal((q.float() * pqt.d.repeat_interleave(256, 1))
                       * sc.float(), exact.float())
    assert torch.equal(qformats.dequant(pqt, torch.bfloat16), exact.to(torch.bfloat16))


@pytest.mark.parametrize("qtype", CODEBOOK, ids=ids)
def test_chip_smoke_f64_law_is_the_codebook_kernels_law(qtype):
    """chip_smoke.py's law_f64 of kernel E's codebook entries and D's
    branches (the references of the codebook teacher-forced checks) equals
    the plain version to f32 noise, and rounded to bf16 is within the
    kernel-vs-plain limit."""
    from chip_smoke import law_f64, limit_ratio

    _, pqt, _ = _pair(9, qtype, n=40, k=2048, edges=False)
    for name, m in ((dm.CODEBOOK_GEMV[qtype], 3), ("qgemm", 16)):
        x = torch.from_numpy(_x(m, m, 2048)).to(torch.bfloat16)
        plain = getattr(dm, name + "_plain")
        want = plain(x, pqt, torch.float32)
        got = law_f64(name, x, pqt, torch.float32)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
        assert limit_ratio(law_f64(name, x, pqt, torch.bfloat16).float(),
                           plain(x, pqt).float()) <= 1.0


@pytest.mark.parametrize("qtype", [IQ4_XS, MXFP4], ids=ids)
def test_check_kernel_rejects_a_wrong_codebook_scale(qtype):
    """chip_smoke.check_kernel fails a stand-in kernel E that drops IQ4_XS's
    sub-scale (dl = d in place of d·sc) or reads MXFP4's e8m0 byte one
    exponent off (d doubled), and passes the plain version against itself,
    on testing_synth's blocks."""
    from chip_smoke import check_kernel

    qt = testing_synth.synth_quant(qtype, 256, 4096, "cpu",
                                   torch.Generator().manual_seed(0))
    name = dm.CODEBOOK_GEMV[qtype]
    plain = getattr(dm, name + "_plain")

    def standin(x, w, out_dtype):
        if qtype == IQ4_XS:
            bad = qformats.QTensor(IQ4_XS, w.shape, w.q, torch.ones_like(w.sc),
                                   None, w.d, None)
        else:
            bad = qformats.QTensor(MXFP4, w.shape, w.q, None, None, 2 * w.d, None)
        return plain(x, bad, out_dtype)

    max_err = {}
    check_kernel(name, plain, plain, qt, "wq", 1, torch.bfloat16,
                 torch.Generator().manual_seed(3), max_err)
    with pytest.raises(SystemExit, match="disagrees"):
        check_kernel(name, standin, plain, qt, "wq", 1, torch.bfloat16,
                     torch.Generator().manual_seed(3), max_err)


@pytest.mark.parametrize("qtype", CODEBOOK, ids=ids)
def test_matmul_routes_codebook_formats_on_a_mocked_card(qtype):
    """On the card `matmul` sends a codebook weight to kernel E's entry of
    its format at M = 1..8 where K % GP_MIN_K == 0 (K = 2048), and to
    kernel D's branch otherwise: at M > 8, and at every M where K = 1280
    is no multiple of IQ4_XS's 2048 (IQ4_NL and MXFP4 take E there); only
    IQ4_XS passes an sc plane. Each launch counts once under its own name,
    D's also under its format in qgemm_launches."""
    dm.reset_launches()
    got = []
    for k in (2048, 1280):
        _, pqt, _ = _pair(12, qtype, n=8, k=k)
        for m in (1, 8, 9, 64):
            x = torch.from_numpy(_x(m, m, k))
            gp = m <= 8 and k % dm.GP_MIN_K[qtype] == 0
            assert dm.kernel_for(m, pqt).__name__ == (dm.CODEBOOK_GEMV[qtype] if gp
                                                      else "qgemm")
            got += _on_a_mocked_card(dm.matmul, x, pqt)[1]
    nulls = {"mn", "dm", "qh"} | ({"sc"} if qtype != IQ4_XS else set())
    gemv, gemm = dm.CODEBOOK_GEMV[qtype], dm._QGEMM_ENTRY[qtype]
    n_gemv = 4 if qtype != IQ4_XS else 2
    assert sorted(e for e, _ in got) == sorted([gemv] * n_gemv + [gemm] * (8 - n_gemv))
    assert all(set(n) == nulls for _, n in got)
    assert dm.launches == {**dict.fromkeys(dm.launches, 0), gemv: n_gemv,
                           "qgemm": 8 - n_gemv}
    assert dm.qgemm_launches == {**dict.fromkeys(dm.qgemm_launches, 0),
                                 qtype.name: 8 - n_gemv}


@pytest.mark.parametrize("qtype", CODEBOOK, ids=ids)
def test_codebook_wrappers_launch_or_raise(qtype):
    """Where the kernels cannot be built (no nvcc here) a codebook weight on
    the card path raises rather than running the plain version, and counts
    no launch; the other formats' wrappers refuse it."""
    _, pqt, _ = _pair(4, qtype, n=8, k=2048)
    dm.reset_launches()
    with mock.patch.object(dm, "_on_cuda", return_value=True), \
            mock.patch("omni_tpu_torch.kernels._build.load",
                       side_effect=RuntimeError("nvcc not found")), \
            mock.patch.object(dm, "codebook_gemv_plain") as gemv_plain, \
            mock.patch.object(dm, "qgemm_plain") as gemm_plain:
        for m in (1, 16):
            with pytest.raises(RuntimeError, match="nvcc"):
                dm.matmul(torch.from_numpy(_x(0, m, 2048)), pqt)
        others = [getattr(dm, n) for t, n in dm.CODEBOOK_GEMV.items() if t != qtype]
        for wrapper in (dm.q4k_gemv, dm.q6k_gemv, dm.q8_0_gemv, *others):
            with pytest.raises(ValueError, match=qtype.name):
                wrapper(torch.zeros((1, 2048), dtype=torch.bfloat16), pqt)
    assert not gemv_plain.called and not gemm_plain.called
    assert not any(dm.launches.values())


# ------------------------------------------------- the port's synthetic files

@pytest.mark.parametrize("recipe", ["IQ4_NL", "IQ4_XS", "MXFP4"])
def test_codebook_recipes_match_the_jax_quantizer(recipe):
    """The port's IQ4_NL, IQ4_XS and MXFP4 rules equal the JAX quantizer's
    for every tensor of a 36-layer Qwen3: the head Q6_K, every other
    weight, the embedding too, in the recipe's type."""
    default = testing_synth.RECIPES[recipe]
    assert default == jax_quantize.RECIPES[recipe] == GGMLType[recipe]
    names = ["output.weight", "token_embd.weight"] + [
        f"blk.{i}.{t}.weight" for i in range(36)
        for t in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate",
                  "ffn_up", "ffn_down")]
    got = [testing_synth.pick_type(nm, recipe, default, 36) for nm in names]
    want = [jax_quantize.pick_type(nm, recipe, default, 36) for nm in names]
    assert got == want and got[0] == GGMLType.Q6_K
    assert got.count(default) == len(names) - 1


@pytest.mark.parametrize("qtype", CODEBOOK, ids=ids)
def test_synthetic_codebook_blocks(qtype):
    """testing_synth's blocks: every codebook index appears, IQ4_XS's
    sub-scales span −32..31, MXFP4's exponents sit at 119..121; read the
    same by both packages' dequantisers, weights of RMS 0.02-0.035."""
    nb = 64 * 2048 // type_traits(qtype).block_size
    blocks = testing_synth.BLOCKS[qtype](nb, "cpu", torch.Generator().manual_seed(1))
    b = blocks.numpy()
    ref = quants.dequantize(b, qtype)
    np.testing.assert_array_equal(port_quants.dequantize(b, qtype), ref)
    assert 0.02 < np.sqrt(np.mean(ref.astype(np.float64) ** 2)) < 0.035
    qt = qformats.repack(blocks, qtype, (64, 2048))
    table = qformats.MXFP4_KVALUES if qtype == MXFP4 else qformats.IQ4NL_KVALUES
    assert set(qformats.int8_values(qt).unique().tolist()) == set(table)
    assert set(torch.cat([qt.q & 0xF, qt.q >> 4]).unique().tolist()) == set(range(16))
    if qtype == IQ4_XS:
        assert qt.sc.min() == -32 and qt.sc.max() == 31
    if qtype == MXFP4:
        assert set(b[:, 0].tolist()) == {119, 120, 121}


# ------------------------------------------------------ the tiny GGUF files

_TINY = dict(n_layers=2, d_model=256, n_heads=2, n_kv_heads=1, head_dim=128,
             d_ff=512, n_vocab=512)


@pytest.fixture(scope="module")
def codebook_files(tmp_path_factory):
    """The tiny F16 Qwen3 of the JAX package's tools (separate head)
    quantized IQ4_NL, IQ4_XS and MXFP4 by `omni-quantize`: the head Q6_K,
    every other weight and the embedding in the recipe's type."""
    d = tmp_path_factory.mktemp("codebook")
    src = d / "f16.gguf"
    write_tiny_qwen3(src, qtype=GGMLType.F16, tied_head=False, **_TINY)
    files = {}
    for recipe in ("IQ4_NL", "IQ4_XS", "MXFP4"):
        files[recipe] = d / f"{recipe.lower()}.gguf"
        jax_quantize.quantize_file(str(src), str(files[recipe]), recipe)
    return files


@pytest.mark.parametrize("recipe", ["IQ4_NL", "IQ4_XS", "MXFP4"])
def test_codebook_file_routes_as_the_jax_dispatcher(recipe, codebook_files):
    """Each weight of the tiny file goes, at M = 1, 8 and 64, to the kernel
    the JAX dispatcher would pick: gp where gp_supported (IQ4_NL and MXFP4
    at K = 256 and 512), else qmatmul_pallas (kernel D): every IQ4_XS
    weight here, whose K is no multiple of 2048, and every prefill."""
    path = codebook_files[recipe]
    jparams, tparams = jq.load_params(JaxReader(path)), tq.load_params(
        GGUFReader(path), device="cpu")
    n_gemv = 0
    for jl, tl in zip(jparams["layers"], tparams["layers"], strict=True):
        for key, w in tl.items():
            if not isinstance(w, qformats.QTensor):
                continue
            for m in (1, 8, 64):
                gp, sh = gp_supported(m, jl[key]), sh_supported(m, jl[key])
                assert not sh
                kern = dm.kernel_for(m, w)
                assert kern.__name__ == (dm.CODEBOOK_GEMV[w.ggml_type] if gp else "qgemm")
                n_gemv += gp
    assert n_gemv == (0 if recipe == "IQ4_XS" else 2 * 7 * 2)


@pytest.mark.parametrize("recipe", ["IQ4_NL", "IQ4_XS", "MXFP4"])
def test_codebook_file_loads_and_serves_as_omni_tpu(recipe, codebook_files):
    """Each file, loaded by each package's own reader and loader, gives the
    same parameters (planes, the dequantised embedding, norms), and a
    greedy turn of up to 16 tokens served from it emits the same tokens in
    both."""
    path = codebook_files[recipe]
    jr, tr = JaxReader(path), GGUFReader(path)
    jparams, tparams = jq.load_params(jr), tq.load_params(tr, device="cpu")
    _assert_same_params(jparams, tparams)
    types = {w.ggml_type for lp in tparams["layers"] for w in lp.values()
             if isinstance(w, qformats.QTensor)}
    assert types == {GGMLType[recipe]}
    assert tparams["output"].ggml_type == GGMLType.Q6_K
    assert tparams["token_embd"].dtype == torch.bfloat16
    embd = tr.tensors["token_embd.weight"]
    assert embd.ggml_type == GGMLType[recipe]
    with np.errstate(over="ignore"):
        want_embd = port_quants.dequantize(embd.data, embd.ggml_type, embd.shape)
    assert torch.equal(tparams["token_embd"],
                       torch.from_numpy(want_embd).to(torch.bfloat16))
    jctx = _jax_ctx(jr, jparams)
    want = _jax_turn(jctx)
    tctx = _port_ctx(tr, tparams)
    got = _port_turn(tctx)
    assert sum(len(e["content"].split()) for e in got) >= 8
    assert got == want
    assert tctx.n_past == jctx.n_past
