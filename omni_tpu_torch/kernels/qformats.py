"""Quantized weight planes for the port, and the load policy.

Counterpart of `omni_tpu/kernels/qformats.py`. The JAX package stores a
weight W[N, K] K-major (planes [K', N]) because the TPU's sublane rules want
quant groups down the rows. A GEMV on the card reads best with each output
row's K contiguous, so the port stores the same planes N-major: plane
[N, K'] is the transpose of the JAX plane [K', N], a pure permutation of its
bytes (and the JAX planes are themselves a permutation of the GGUF blocks).

Q8_0 planes (rows × K'):
- q  int8 [N, K]     the value, element order
- d  f32  [N, K/32]  block scale (the file's f16, widened)

Q4_K planes (rows × K'):
- q  u8   [N, K/2]   superblock-local halves: byte r of superblock s holds
                     element s·256+r in the low nibble, s·256+128+r in the
                     high one
- sc int8 [N, K/32]  6-bit group scales, already unpacked
- mn int8 [N, K/32]  6-bit group mins
- d  f32  [N, K/256] super-scale
- dm f32  [N, K/256] super-min-scale

Q5_K planes: the Q4_K planes (q holds the low four bits of each value), and
- qh u8   [N, K/8]   the high bits in element order: bit b of byte r is the
                     fifth bit of element 8r+b (the JAX plane, transposed)

Q6_K planes:
- q  int8 [N, K]     the 6-bit value q − 32, sign-extended, element order
                     (8 bits where the file has 6.56: byte loads, no shifts)
- sc int8 [N, K/16]  group scales
- d  f32  [N, K/256] super-scale

Q4_0, Q4_1, Q5_0 and Q5_1 planes (the 32-element legacy formats; the
K-quants' q and qh planes, a scale per 32 instead of d·sc):
- q  u8   [N, K/2]   superblock-local halves, as Q4_K's (the low four bits
                     of each value)
- d  f32  [N, K/32]  block scale (the file's f16, widened)
- dm f32  [N, K/32]  Q4_1 and Q5_1 only: the added min m (w = q·d + m)
- qh u8   [N, K/8]   Q5_0 and Q5_1 only: the high bits in element order, as
                     Q5_K's
Q4_0 and Q5_0 dequantise as (q − 8)·d and (q − 16)·d.

IQ4_NL, IQ4_XS and MXFP4 planes (the codebook formats). The JAX package
applies the 16-entry codebook at load (int8 value planes, [K, N]); the
port keeps the file's nibble INDEXES and applies the codebook where the
values are used (`int8_values`; on the card, in registers):
- q  u8   [N, K/2]   each 32-group's 16 quant bytes as the file holds
                     them: byte j holds element j's index in its low
                     nibble and element j + 16's in its high one; the
                     values (CODEBOOK_VALUES) are IQ4_NL's and IQ4_XS's
                     −127..113, MXFP4's the e2m1 values pre-doubled, 0,
                     ±1, ±2, ±3, ±4, ±6, ±8, ±12 (0 at indexes 0 and 8)
- d  f32  [N, K/32]  IQ4_NL: the block's f16 d, widened; MXFP4: 2^(e − 128)
                     built from the e8m0 byte's bits (subnormal for e < 2)
IQ4_XS has the same q plane, and
- sc int8 [N, K/32]  the 6-bit group scale minus 32, in −32..31
- d  f32  [N, K/256] the superblock's f16 d, widened
IQ4_NL and MXFP4 dequantise as Q8_0 does (v·d, v the codebook value),
IQ4_XS as v·(d·sc), the f32 product d·sc formed first.

Q2_K planes (the 2-bit K-quant, a scale and a min per 16 elements):
- q  u8   [N, K/4]   superblock-local quarters: byte r of superblock s holds
                     element s·256 + 64j + r at shift 2j (j = 0..3), the
                     value 0..3 (`_pack_sb_quarters` of the JAX package;
                     the file's qs group by 32 instead, per 128 elements)
- sc int8 [N, K/16]  4-bit group scales 0..15
- mn int8 [N, K/16]  4-bit group mins 0..15
- d  f32  [N, K/256] super-scale
- dm f32  [N, K/256] super-min-scale
Q2_K dequantises as q·dl − ml with dl = d·sc and ml = dm·mn per 16.

Q3_K planes (the 3-bit K-quant, signed, no min), holding q + 4 in 0..7:
- q  u8   [N, K/4]   (q + 4) & 3 in quarters, as Q2_K's q
- qh u8   [N, K/8]   bit 2 of q + 4 in element order, as Q5_K's qh (the
                     file's hmask bit: set means "do not subtract 4")
- sc int8 [N, K/16]  the 6-bit group scale minus 32, in −32..31
- d  f32  [N, K/256] super-scale
Q3_K dequantises as (quarter + 4·hbit − 4)·dl with dl = d·sc per 16.

`repack` builds these planes from GGUF block bytes ON THE DEVICE, as torch
ops on the uploaded blocks: a host pass over a 5 GB checkpoint would take
minutes. Every format the JAX package keeps quantized (its
`NATIVE_QTYPES`: Q8_0, Q4_0, Q4_1, Q5_0, Q5_1, Q2_K, Q3_K, Q4_K, Q5_K,
Q6_K, IQ4_NL, IQ4_XS and MXFP4) has planes, dequantisers and kernels in
the port.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..core.dtypes import QK_K, GGMLType, type_traits

PLANES = ("q", "sc", "mn", "d", "dm", "qh")
# the 32-element legacy formats, whose q plane is the K-quants' halves
LEGACY = (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1)
# the codebook formats, whose q plane holds nibble indexes into a
# 16-entry codebook (CODEBOOK_VALUES)
CODEBOOK = (GGMLType.IQ4_NL, GGMLType.IQ4_XS, GGMLType.MXFP4)
# the 2- and 3-bit K-quants, whose q plane holds superblock-local quarters
# and whose scales (and Q2_K's mins) come per 16 elements
LOWBIT = (GGMLType.Q2_K, GGMLType.Q3_K)
QUANTIZED = (GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.Q8_0,
             *LEGACY, *CODEBOOK, *LOWBIT)
# the formats whose values carry a fifth bit from the qh plane
FIVE_BIT = (GGMLType.Q5_K, GGMLType.Q5_0, GGMLType.Q5_1)
# planes with one scale per 32 elements need only whole 32-blocks in K; the
# others need whole 256-superblocks (the JAX package's tile_granule)
_GRANULE_32 = (GGMLType.Q8_0, GGMLType.IQ4_NL, GGMLType.MXFP4)


def tile_granule(t: GGMLType) -> int:
    """The K multiple a format's planes need."""
    return 32 if t in _GRANULE_32 else QK_K


@dataclass
class QTensor:
    """A quantized 2-D weight, logical shape [N, K], planes stored [N, K']."""

    ggml_type: GGMLType
    shape: tuple[int, int]  # logical (N, K)
    q: torch.Tensor
    sc: torch.Tensor | None
    mn: torch.Tensor | None
    d: torch.Tensor
    dm: torch.Tensor | None
    qh: torch.Tensor | None = None

    def planes(self) -> dict[str, torch.Tensor]:
        return {nm: getattr(self, nm) for nm in PLANES
                if getattr(self, nm) is not None}

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.planes().values())


def plane_specs(t: GGMLType, n: int, k: int) -> dict[str, tuple[tuple, torch.dtype]]:
    """The planes of an [n, k] weight of type `t`: name -> (shape, dtype)."""
    if t == GGMLType.Q8_0:
        return {"q": ((n, k), torch.int8), "d": ((n, k // 32), torch.float32)}
    if t in CODEBOOK:
        if t == GGMLType.IQ4_XS:
            return {"q": ((n, k // 2), torch.uint8), "sc": ((n, k // 32), torch.int8),
                    "d": ((n, k // QK_K), torch.float32)}
        return {"q": ((n, k // 2), torch.uint8), "d": ((n, k // 32), torch.float32)}
    if t in (GGMLType.Q4_K, GGMLType.Q5_K):
        specs = {"q": ((n, k // 2), torch.uint8), "sc": ((n, k // 32), torch.int8),
                 "mn": ((n, k // 32), torch.int8),
                 "d": ((n, k // QK_K), torch.float32),
                 "dm": ((n, k // QK_K), torch.float32)}
        if t == GGMLType.Q5_K:
            specs["qh"] = ((n, k // 8), torch.uint8)
        return specs
    if t == GGMLType.Q6_K:
        return {"q": ((n, k), torch.int8), "sc": ((n, k // 16), torch.int8),
                "d": ((n, k // QK_K), torch.float32)}
    if t in LOWBIT:
        specs = {"q": ((n, k // 4), torch.uint8), "sc": ((n, k // 16), torch.int8),
                 "d": ((n, k // QK_K), torch.float32)}
        if t == GGMLType.Q2_K:
            specs["mn"] = ((n, k // 16), torch.int8)
            specs["dm"] = ((n, k // QK_K), torch.float32)
        else:
            specs["qh"] = ((n, k // 8), torch.uint8)
        return specs
    if t in LEGACY:
        specs = {"q": ((n, k // 2), torch.uint8), "d": ((n, k // 32), torch.float32)}
        if t in (GGMLType.Q4_1, GGMLType.Q5_1):
            specs["dm"] = ((n, k // 32), torch.float32)
        if t in FIVE_BIT:
            specs["qh"] = ((n, k // 8), torch.uint8)
        return specs
    raise NotImplementedError(f"{GGMLType(t).name} has no planes in the port")


def check_qtensor(qt: QTensor, *types: GGMLType) -> None:
    """Raise ValueError unless `qt` is a well-formed QTensor of one of
    `types`: K whole blocks of its granule, every plane of its format contiguous with
    the right shape and dtype, no other plane."""
    if qt.ggml_type not in types:
        raise ValueError(f"expected {' or '.join(t.name for t in types)}, "
                         f"got {GGMLType(qt.ggml_type).name}")
    n, k = qt.shape
    if k % tile_granule(qt.ggml_type):
        raise ValueError(f"{qt.ggml_type.name} K={k} is not a multiple of "
                         f"{tile_granule(qt.ggml_type)}")
    want = plane_specs(qt.ggml_type, n, k)
    for nm in PLANES:
        a = getattr(qt, nm)
        if nm not in want:
            if a is not None:
                raise ValueError(f"{qt.ggml_type.name} has no plane {nm}")
            continue
        shape, dtype = want[nm]
        if a is None or tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"{qt.ggml_type.name} plane {nm}: want {shape} "
                             f"{dtype}, got "
                             f"{None if a is None else (tuple(a.shape), a.dtype)}")
        if not a.is_contiguous():
            raise ValueError(f"{qt.ggml_type.name} plane {nm} is not contiguous")


def _expand(a: torch.Tensor, r: int) -> torch.Tensor:
    """[N, G] -> [N, G*r], each column repeated r times."""
    return a.repeat_interleave(r, dim=1)


def unpack_sb_halves(qp: torch.Tensor) -> torch.Tensor:
    """[N, K/2] packed bytes -> [N, K] uint8 values in element order."""
    n, half = qp.shape
    lo = (qp & 0xF).reshape(n, half // 128, 1, 128)
    hi = (qp >> 4).reshape(n, half // 128, 1, 128)
    return torch.cat([lo, hi], dim=2).reshape(n, half * 2)


def unpack_sb_quarters(qp: torch.Tensor) -> torch.Tensor:
    """[N, K/4] packed quarters -> [N, K] uint8 values 0..3 in element
    order: byte r of superblock s holds element s·256 + 64j + r at shift
    2j."""
    n, quarter = qp.shape
    sh = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=qp.device)
    v = (qp.reshape(n, quarter // 64, 1, 64) >> sh.reshape(1, 1, 4, 1)) & 3
    return v.reshape(n, quarter * 4)


def unpack_bits(qh: torch.Tensor) -> torch.Tensor:
    """[N, K/8] bit plane -> [N, K] uint8 0/1, bit b of byte r as element
    8r+b."""
    n, nb = qh.shape
    sh = torch.arange(8, dtype=torch.uint8, device=qh.device)
    return ((qh[..., None] >> sh) & 1).reshape(n, nb * 8)


def kquant_values(qt: QTensor) -> torch.Tensor:
    """The raw values q of a weight whose q plane is superblock-local halves,
    uint8 [N, K] in element order: Q4_K, Q4_0 and Q4_1 0..15; Q5_K, Q5_0
    and Q5_1 0..31 (the nibble plus 16 x its high bit)."""
    q = unpack_sb_halves(qt.q)
    if qt.ggml_type in FIVE_BIT:
        q = q | (unpack_bits(qt.qh) << 4)
    return q


def q4k_group_scales(qt: QTensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-32-group (dl, ml) as f32 [N, K/32], w = q·dl − ml, of a weight
    whose q plane is superblock-local halves (the group law of the TPU
    kernels' `_gp_slice`): (d·sc, dm·mn) for Q4_K and Q5_K, the exact f32
    products the reference dequantiser forms; (d, 8·d) for Q4_0, (d, 16·d)
    for Q5_0 (the offset folded into the min, exact in f32); (d, −m) for
    Q4_1 and Q5_1, whose min is added."""
    t = qt.ggml_type
    if t in (GGMLType.Q4_0, GGMLType.Q5_0):
        return qt.d, (8.0 if t == GGMLType.Q4_0 else 16.0) * qt.d
    if t in (GGMLType.Q4_1, GGMLType.Q5_1):
        return qt.d, -qt.dm
    dl = _expand(qt.d, 8) * qt.sc.to(torch.float32)
    ml = _expand(qt.dm, 8) * qt.mn.to(torch.float32)
    return dl, ml


def q6k_group_scales(qt: QTensor) -> torch.Tensor:
    """Per-16-group dl = d·sc as f32 [N, K/16] (Q6_K, Q2_K and Q3_K)."""
    return _expand(qt.d, 16) * qt.sc.to(torch.float32)


def lowbit_values(qt: QTensor) -> torch.Tensor:
    """The raw values q of a Q2_K or Q3_K weight, int8 [N, K] in element
    order: Q2_K's quarters 0..3; Q3_K's quarter + 4·hbit − 4, in −4..3."""
    q = unpack_sb_quarters(qt.q).to(torch.int8)
    if qt.ggml_type == GGMLType.Q3_K:
        q = q + 4 * unpack_bits(qt.qh).to(torch.int8) - 4
    return q


def lowbit_group_scales(qt: QTensor) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Per-16-group (dl, ml) as f32 [N, K/16] of a Q2_K or Q3_K weight, the
    law w = q·dl − ml of `_gp_slice`: dl = d·sc and, for Q2_K, ml = dm·mn
    (the exact f32 products the reference dequantiser forms); Q3_K has no
    min (None)."""
    ml = None
    if qt.ggml_type == GGMLType.Q2_K:
        ml = _expand(qt.dm, 16) * qt.mn.to(torch.float32)
    return q6k_group_scales(qt), ml


def int8_group_scales(qt: QTensor) -> torch.Tensor:
    """Per-32-group dl as f32 [N, K/32] of a weight of int8 values (Q8_0's
    plane, the codebook formats' values), w = q·dl: d for Q8_0, IQ4_NL and
    MXFP4; the f32 product d·sc for IQ4_XS (the reference's and
    `_gp_slice`'s dl)."""
    if qt.ggml_type == GGMLType.IQ4_XS:
        return _expand(qt.d, 8) * qt.sc.to(torch.float32)
    return qt.d


def int8_values(qt: QTensor) -> torch.Tensor:
    """The int8 values [N, K] in element order of a Q8_0 weight (its q
    plane) or of a codebook one (its indexes through the codebook: the JAX
    package's value plane, transposed)."""
    if qt.ggml_type in CODEBOOK:
        n, k = qt.shape
        return _codebook_values(qt.q.reshape(n, k // 32, 16),
                                CODEBOOK_VALUES[qt.ggml_type]).reshape(n, k)
    return qt.q


def dequant(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Full dequantization -> logical [N, K] (bit-exact with the reference
    in f32): the law of `dequant_tile`, rounded once to `dtype`."""
    if qt.ggml_type in (GGMLType.Q8_0, *CODEBOOK):
        return (int8_values(qt).to(torch.float32)
                * _expand(int8_group_scales(qt), 32)).to(dtype)
    if qt.ggml_type in (GGMLType.Q4_K, GGMLType.Q5_K):
        q = kquant_values(qt).to(torch.float32)
        dl, ml = q4k_group_scales(qt)
        return (q * _expand(dl, 32) - _expand(ml, 32)).to(dtype)
    if qt.ggml_type == GGMLType.Q6_K:
        return (qt.q.to(torch.float32) * _expand(q6k_group_scales(qt), 16)
                ).to(dtype)
    if qt.ggml_type in LEGACY:
        return _legacy_law(kquant_values(qt), qt.d, qt.dm, qt.ggml_type, dtype)
    if qt.ggml_type in LOWBIT:
        dl, ml = lowbit_group_scales(qt)
        w = lowbit_values(qt).to(torch.float32) * _expand(dl, 16)
        return (w if ml is None else w - _expand(ml, 16)).to(dtype)
    raise NotImplementedError(
        f"dequant: {GGMLType(qt.ggml_type).name} is not ported yet")


def _legacy_law(q: torch.Tensor, d: torch.Tensor, m: torch.Tensor | None,
                t: GGMLType, dtype) -> torch.Tensor:
    """A legacy weight from its values q (uint8 [N, K]) and per-32 d (and m):
    (q − 8)·d, (q − 16)·d or q·d + m in f32, the JAX package's `dequant_tile`
    law (one rounding, or two where m is added), rounded once to `dtype`."""
    qf = q.to(torch.float32)
    if t in (GGMLType.Q4_0, GGMLType.Q5_0):
        return ((qf - (8.0 if t == GGMLType.Q4_0 else 16.0)) * _expand(d, 32)).to(dtype)
    return (qf * _expand(d, 32) + _expand(m, 32)).to(dtype)


def concat_qtensors(qts: list[QTensor]) -> QTensor:
    """Concatenate same-K QTensors along the output-feature axis (plane
    rows) — fuses QKV and gate+up into one launch each. Mixed formats are
    refused, as the JAX package refuses them."""
    t, k = qts[0].ggml_type, qts[0].shape[1]
    if not all(q.ggml_type == t and q.shape[1] == k for q in qts):
        raise ValueError("concat_qtensors: mixed formats or K: "
                         + ", ".join(f"{q.ggml_type.name} {q.shape}" for q in qts))
    cat = {}
    for f in fields(QTensor):
        if f.name in PLANES:
            arrs = [getattr(q, f.name) for q in qts]
            cat[f.name] = None if arrs[0] is None else torch.cat(arrs, dim=0)
    return QTensor(t, (sum(q.shape[0] for q in qts), k), **cat)


# --------------------------------------------------------------------------
# GGUF blocks -> planes, on the device
# --------------------------------------------------------------------------

def _f16_field(b: torch.Tensor, lo: int) -> torch.Tensor:
    """Bytes [..., lo:lo+2] of each block, read as a little-endian f16, as
    f32 [...]."""
    return b[..., lo:lo + 2].contiguous().view(torch.float16)[..., 0].to(torch.float32)


def repack(blocks: torch.Tensor, ggml_type: GGMLType,
           shape: tuple[int, int]) -> QTensor:
    """GGUF block bytes (uint8 [N·K/block_size, type_size], on any device)
    -> the port's N-major planes on the same device. A pure permutation of
    the bytes (scales unpacked to one byte each, f16 scales widened to f32);
    the transpose of `omni_tpu.kernels.qformats.repack`."""
    t = GGMLType(ggml_type)
    n, k = shape
    if t not in QUANTIZED:
        raise NotImplementedError(f"repack: {t.name} is not ported")
    if k % tile_granule(t):
        raise ValueError(f"repack: K={k} is not a multiple of {tile_granule(t)}")
    if t in LEGACY:
        q, d, m, qh = _legacy_fields(blocks, t, n, k)
        # element s·256 + r in the low nibble of byte r of superblock s,
        # s·256 + 128 + r in its high one
        h = (q & 0xF).reshape(n, k // QK_K, 2, 128)
        return QTensor(t, (n, k), q=(h[:, :, 0] | (h[:, :, 1] << 4)).reshape(n, k // 2),
                       sc=None, mn=None, d=d, dm=m, qh=qh)
    if t in CODEBOOK:
        return _codebook_repack(blocks, t, n, k)
    if t in LOWBIT:
        return _lowbit_repack(blocks, t, n, k)
    if t == GGMLType.Q8_0:
        # 34-byte blocks, not 16-byte aligned: the fields are cut from the
        # uint8 [N, K/32, 34] view, the f16 d in bytes 0-1, then 32 int8
        b = blocks.reshape(n, k // 32, type_traits(t).type_size)
        q = b[..., 2:].contiguous().view(torch.int8).reshape(n, k)
        return QTensor(t, (n, k), q=q, sc=None, mn=None, d=_f16_field(b, 0),
                       dm=None)
    nsb = k // QK_K
    b = blocks.reshape(n, nsb, type_traits(t).type_size)
    if t in (GGMLType.Q4_K, GGMLType.Q5_K):
        s = b[..., 4:16]
        a, bb, c = s[..., 0:4], s[..., 4:8], s[..., 8:12]
        sc = torch.cat([a & 0x3F, (c & 0x0F) | ((a >> 2) & 0x30)], dim=-1)
        mn = torch.cat([bb & 0x3F, (c >> 4) | ((bb >> 2) & 0x30)], dim=-1)
        # 4 runs of 32 bytes: low nibbles are elements 64j..64j+31, high
        # nibbles 64j+32..64j+63; then byte r = element r | element 128+r
        qs = b[..., (16 if t == GGMLType.Q4_K else 48):].reshape(n, nsb, 4, 1, 32)
        v = torch.cat([qs & 0xF, qs >> 4], dim=3).reshape(n, nsb, 2, 128)
        q = (v[:, :, 0] | (v[:, :, 1] << 4)).reshape(n, k // 2)
        qh = _high_bit_plane(b[..., 16:48], n, k) if t == GGMLType.Q5_K else None
        return QTensor(t, (n, k), q=q,
                       sc=sc.to(torch.int8).reshape(n, nsb * 8),
                       mn=mn.to(torch.int8).reshape(n, nsb * 8),
                       d=_f16_field(b, 0), dm=_f16_field(b, 2), qh=qh)
    # Q6_K: per 128-element half, ql bytes 0..63 give groups 0, 1 (low
    # nibbles) and 2, 3 (high nibbles); qh byte l gives group j's two high
    # bits at shift 2j
    ql = b[..., :128].reshape(n, nsb, 2, 1, 64)
    lo = torch.cat([ql & 0xF, ql >> 4], dim=3).reshape(n, nsb, 2, 128)
    qh = b[..., 128:192].reshape(n, nsb, 2, 1, 32)
    sh = torch.tensor([0, 2, 4, 6], dtype=torch.uint8,
                      device=b.device).reshape(1, 1, 1, 4, 1)
    hi = ((qh >> sh) & 3).reshape(n, nsb, 2, 128)
    q = ((lo | (hi << 4)).to(torch.int8) - 32).reshape(n, k)
    sc = b[..., 192:208].contiguous().view(torch.int8).reshape(n, nsb * 16)
    return QTensor(t, (n, k), q=q, sc=sc, mn=None, d=_f16_field(b, 208),
                   dm=None)


def _high_bit_plane(hb: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The 32 bytes of high bits of each superblock (uint8 [N, K/256, 32];
    bit i of byte l is element 32i + l's: Q5_K's qh, Q3_K's hmask) -> the
    [N, K/8] plane in element order, element 8r + b in bit b of byte r."""
    sh = torch.arange(8, dtype=torch.uint8, device=hb.device).reshape(8, 1)
    bits = ((hb.reshape(n, k // QK_K, 1, 32) >> sh) & 1).reshape(n, k // 8, 8)
    out = bits[..., 0]
    for j in range(1, 8):
        out = out | (bits[..., j] << j)
    return out


def _lowbit_repack(blocks: torch.Tensor, t: GGMLType, n: int, k: int) -> QTensor:
    """Q2_K and Q3_K superblocks -> their planes. A superblock's qs[64]
    hold its elements in two runs of 32 bytes, 128 elements each: bits 2i
    and 2i + 1 of byte l of run h are element 128h + 32i + l. The plane
    regroups them into quarters: byte r holds elements 64j + r at shift
    2j."""
    nsb = k // QK_K
    b = blocks.reshape(n, nsb, type_traits(t).type_size)
    off = 16 if t == GGMLType.Q2_K else 32  # where qs starts
    sh = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=b.device)
    qs = b[..., off:off + 64].reshape(n, nsb, 2, 1, 32)
    v = ((qs >> sh.reshape(4, 1)) & 3).reshape(n, nsb, 4, 64)  # element order
    q = (v[:, :, 0] | (v[:, :, 1] << 2) | (v[:, :, 2] << 4) | (v[:, :, 3] << 6)
         ).reshape(n, k // 4)
    if t == GGMLType.Q2_K:
        s = b[..., :16]
        return QTensor(t, (n, k), q=q, sc=(s & 0xF).to(torch.int8).reshape(n, nsb * 16),
                       mn=(s >> 4).to(torch.int8).reshape(n, nsb * 16),
                       d=_f16_field(b, 80), dm=_f16_field(b, 82))
    # hmask: each element's "do not subtract 4" bit, bit 2 of q + 4
    qh = _high_bit_plane(b[..., :32], n, k)
    s = b[..., 96:108].to(torch.int32)
    lo = torch.cat([s[..., :8] & 0xF, s[..., :8] >> 4], dim=-1)  # scale i: i % 8, i // 8
    hi = (s[..., 8:12].reshape(n, nsb, 1, 4) >> (2 * torch.arange(
        4, device=b.device)).reshape(4, 1)) & 3  # scale i: byte 8 + i % 4, i // 4
    sc = ((lo | (hi.reshape(n, nsb, 16) << 4)) - 32).to(torch.int8)
    return QTensor(t, (n, k), q=q, sc=sc.reshape(n, nsb * 16), mn=None,
                   d=_f16_field(b, 108), dm=None, qh=qh)


def _legacy_fields(blocks: torch.Tensor, t: GGMLType, n: int, k: int):
    """The fields of legacy blocks (uint8 [N·K/32, type_size]) in element
    order: (values q uint8 [N, K], the nibble plus 16 x its high bit for
    Q5_0/Q5_1; d f32 [N, K/32]; Q4_1/Q5_1's m f32 [N, K/32] or None; the
    high-bit plane uint8 [N, K/8] or None). A block's 16 quant bytes hold
    element j in the low nibble of byte j and element j + 16 in its high
    one; its 4 qh bytes are a little-endian u32 with bit j for element j,
    which is already the plane's bit order, so they are copied as they
    are."""
    b = blocks.reshape(n, k // 32, type_traits(t).type_size)
    with_min = t in (GGMLType.Q4_1, GGMLType.Q5_1)
    off = 4 if with_min else 2
    m = _f16_field(b, 2) if with_min else None
    qh = None
    if t in FIVE_BIT:
        qh = b[..., off:off + 4].reshape(n, k // 8)
        off += 4
    qs = b[..., off:off + 16]
    q = torch.cat([qs & 0xF, qs >> 4], dim=-1).reshape(n, k)
    if qh is not None:
        q = q | (unpack_bits(qh) << 4)
    return q, _f16_field(b, 0), m, qh


# the codebooks of `omni_tpu/core/quants.py` (kvalues_iq4nl; MXFP4's e2m1
# values pre-doubled, as the JAX planes hold them), per format
IQ4NL_KVALUES = (-127, -104, -83, -65, -49, -35, -22, -10,
                 1, 13, 25, 38, 53, 69, 89, 113)
MXFP4_KVALUES = (0, 1, 2, 3, 4, 6, 8, 12, 0, -1, -2, -3, -4, -6, -8, -12)
CODEBOOK_VALUES = {GGMLType.IQ4_NL: IQ4NL_KVALUES, GGMLType.IQ4_XS: IQ4NL_KVALUES,
                   GGMLType.MXFP4: MXFP4_KVALUES}


def _codebook_values(qs: torch.Tensor, kvalues: tuple) -> torch.Tensor:
    """[..., 16] quant bytes of 32-element groups -> int8 [..., 32]
    codebook values in element order: byte j holds element j in its low
    nibble and element j + 16 in its high one (one lookup a byte)."""
    table = torch.tensor(kvalues, dtype=torch.int8, device=qs.device)
    byte = torch.arange(256, device=qs.device)
    pairs = torch.stack([table[byte & 0xF], table[byte >> 4]])  # [2, 256]
    return pairs[:, qs.int()].movedim(0, -2).flatten(-2)


def e8m0_half(e: torch.Tensor) -> torch.Tensor:
    """e8m0 exponent bytes -> 2^(e − 128) as f32, built from the bits as
    `_e8m0_half` builds them: 0x200000 << e for e < 2 (subnormal), else the
    biased exponent e − 1. No exp2: the subnormals are exact."""
    e = e.to(torch.int32)
    bits = torch.where(e < 2, 0x0020_0000 << e, (e - 1) << 23)
    return bits.view(torch.float32)


def codebook_plane(values: torch.Tensor, t: GGMLType) -> torch.Tensor:
    """int8 codebook values [N, K] in element order (the JAX package's
    value plane, transposed) -> the port's q plane of codebook format `t`,
    u8 [N, K/2] of nibble indexes; the inverse of `int8_values`. MXFP4's 0
    takes index 0 (index 8 holds the same value). Raises ValueError on a
    value that is not in the codebook."""
    n, k = values.shape
    table = CODEBOOK_VALUES[t]
    inverse = torch.full((256,), -1, dtype=torch.int16, device=values.device)
    for i in reversed(range(16)):  # the first index of a repeated value
        inverse[table[i] + 128] = i
    idx = inverse[values.to(torch.int64) + 128]
    if (idx < 0).any():
        raise ValueError(f"{GGMLType(t).name}: a value outside the codebook")
    idx = idx.to(torch.uint8).reshape(n, k // 32, 2, 16)
    return (idx[:, :, 0] | (idx[:, :, 1] << 4)).reshape(n, k // 2)


def _codebook_repack(blocks: torch.Tensor, t: GGMLType, n: int,
                     k: int) -> QTensor:
    """IQ4_NL, MXFP4 (blocks of 32) and IQ4_XS (superblocks of 256) block
    bytes -> their planes: the quant bytes copied, scales widened."""
    if t == GGMLType.IQ4_XS:
        nsb = k // QK_K
        b = blocks.reshape(n, nsb, type_traits(t).type_size)
        # scales_h: a little-endian u16, 2 bits per group; scales_l: 4 bytes,
        # group j's low 4 bits in nibble j % 2 of byte j // 2
        sh = b[..., 2].to(torch.int32) | (b[..., 3].to(torch.int32) << 8)
        sl = b[..., 4:8].to(torch.int32)
        lo4 = torch.stack([sl & 0xF, sl >> 4], dim=-1).reshape(n, nsb, 8)
        hi2 = (sh[..., None] >> (2 * torch.arange(8, device=b.device))) & 3
        sc = ((lo4 | (hi2 << 4)) - 32).to(torch.int8).reshape(n, nsb * 8)
        return QTensor(t, (n, k), q=b[..., 8:].reshape(n, k // 2).contiguous(), sc=sc,
                       mn=None, d=_f16_field(b, 0), dm=None)
    b = blocks.reshape(n, k // 32, type_traits(t).type_size)
    if t == GGMLType.IQ4_NL:
        qs, d = b[..., 2:], _f16_field(b, 0)
    else:
        qs, d = b[..., 1:], e8m0_half(b[..., 0])
    return QTensor(t, (n, k), q=qs.reshape(n, k // 2).contiguous(), sc=None, mn=None,
                   d=d, dm=None)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A copy of numpy array `a` (a read-only mmap view is fine) on
    `device`."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        t = torch.from_numpy(a)
    return t.to(device, copy=True)


def _widen(a: np.ndarray, t: GGMLType, device) -> torch.Tensor:
    """Plain F32/F16/BF16 data -> f32 on `device` (widened there)."""
    if t == GGMLType.BF16:
        return upload(a.view(np.int16), device).view(torch.bfloat16).to(torch.float32)
    if t in (GGMLType.F32, GGMLType.F16):
        return upload(a, device).to(torch.float32)
    raise NotImplementedError(f"load_quantized: {t.name} tensors are not ported")


def load_quantized(blocks: np.ndarray, ggml_type: GGMLType,
                   shape: tuple[int, ...], keep_quantized: bool = True,
                   device=None):
    """The JAX package's load policy (`load_quantized`), for the formats the
    port has:
    - a 2-D Q8_0, Q4_0, Q4_1, Q5_0, Q5_1, Q2_K, Q3_K, Q4_K, Q5_K, Q6_K,
      IQ4_NL, IQ4_XS or MXFP4 tensor (the JAX package's NATIVE_QTYPES)
      stays quantized (a QTensor on `device`) where K holds
      whole blocks of the format's `tile_granule` (always, but for a legacy
      tensor with K % 256 != 0), unless keep_quantized=False; otherwise it
      is dequantised there to bf16 (the JAX package widens such a legacy
      tensor too);
    - F32, F16 and BF16 widen (an F16 weight becomes bf16, as in the JAX
      package: 3 mantissa bits fewer than llama.cpp keeps);
    - 1-D tensors (norms, biases) become f32, 2-D dense ones bf16;
    - every other format raises NotImplementedError naming it. The JAX
      package widens those (TQ1_0, TQ2_0, IQ1_S, IQ1_M, IQ2_*, IQ3_*) to
      dense bf16 at load with a warning; the port has no dequantisers for
      them yet, so it refuses them rather than guess."""
    from .. import resolve_device

    t = GGMLType(ggml_type)
    device = resolve_device(device)
    out_dtype = torch.float32 if len(shape) == 1 else torch.bfloat16
    if not type_traits(t).is_quantized:
        return _widen(np.asarray(blocks), t, device).reshape(shape).to(out_dtype)
    if t not in QUANTIZED:
        raise NotImplementedError(
            f"load_quantized: {t.name} weights are not ported (only "
            f"{', '.join(q.name for q in QUANTIZED)} are)")
    if len(shape) not in (1, 2):
        raise NotImplementedError(f"load_quantized: {len(shape)}-D {t.name} tensor")
    n, k = (1, shape[0]) if len(shape) == 1 else shape
    b = upload(np.asarray(blocks), device)
    if keep_quantized and len(shape) == 2 and k % tile_granule(t) == 0:
        return repack(b, t, (n, k))
    if t in LEGACY:  # whole 32-blocks, not necessarily whole planes
        q, d, m, _ = _legacy_fields(b, t, n, k)
        return _legacy_law(q, d, m, t, out_dtype).reshape(shape)
    return dequant(repack(b, t, (n, k)), out_dtype).reshape(shape)
