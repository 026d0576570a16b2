"""Numpy dequantisers: the bit-exact oracle inside the port.

A copy of the Q8_0, Q4_0, Q4_1, Q5_0, Q5_1, Q2_K, Q3_K, Q4_K, Q5_K, Q6_K,
IQ4_NL, IQ4_XS and MXFP4 paths of `omni_tpu/core/quants.py` (ggml-quants.c
dequantize_row_q8_0 / _q4_0 / _q4_1 / _q5_0 / _q5_1 / _q2_K / _q3_K /
_q4_K / _q5_K / _q6_K / _iq4_nl / _iq4_xs / _mxfp4 semantics), plus the
widening of the
plain float types. The effective group scale is the single f32 product
d*sc:
- Q8_0: w = q*d per 32-element block (34 bytes: f16 d, then 32 int8 q);
- Q4_0: w = (q - 8)*d per 32-element block (18 bytes: f16 d, then 16
  bytes whose low nibbles are elements 0..15 and high nibbles 16..31);
- Q4_1: w = q*d + m (20 bytes: f16 d, f16 m, the nibbles);
- Q5_0: w = (q - 16)*d, q in 0..31, its fifth bit from a little-endian
  u32 whose bit j is element j's (22 bytes: d, qh, the nibbles);
- Q5_1: w = q*d + m (24 bytes: d, m, qh, the nibbles);
- Q2_K: w = q*(d*sc) - dmin*mn per 16-element group, q in 0..3, sc and
  mn 4 bits each (84 bytes: scales[16] with the scale in the low nibble
  and the min in the high one, qs[64], f16 d, f16 dmin); each 32-byte run
  of qs holds 128 elements, 32 per 2-bit shift 0, 2, 4, 6;
- Q3_K: w = (d*sc)*q per 16-element group, q = ql - 4 where the group's
  hmask bit is clear (a set bit means "do not subtract 4"), in -4..3, sc a
  signed 6-bit scale packed in 12 bytes (110 bytes: hmask[32], qs[64] laid
  out as Q2_K's, scales[12], f16 d); bit b of hmask byte l is element
  32b + l;
- Q4_K: w = q*(d*sc) - dmin*mn per 32-element group, q in 0..15;
- Q5_K: the same with q in 0..31, its high bit from a 32-byte plane (176
  bytes: f16 d, f16 dmin, 12 bytes of scales, qh[32], then the nibbles);
- Q6_K: w = (d*sc)*(q - 32) per 16-element group, q in 0..63;
- IQ4_NL: w = d*kv[i] per 32-element block, kv the 16-entry non-linear
  codebook, i a nibble (18 bytes: f16 d, then 16 bytes whose low nibbles
  are elements 0..15 and high nibbles 16..31);
- IQ4_XS: w = (d*(ls - 32))*kv[i] per 32-element group of a 256-element
  superblock, ls a 6-bit scale: 4 low bits from scales_l, 2 high bits from
  the u16 scales_h (136 bytes: f16 d, scales_h, scales_l[4], the nibbles);
- MXFP4: w = d*kv[i] per 32-element block with the e2m1 codebook
  pre-doubled and d = 2^(e - 128) from an e8m0 exponent byte (17 bytes: e,
  then the nibbles); d is subnormal in f32 for e = 0 and 1.
"""

from __future__ import annotations

import numpy as np

from .dtypes import QK_K, GGMLType, type_traits


def _f16(b: np.ndarray) -> np.ndarray:
    """f16 little-endian bytes -> f32."""
    return b.view("<f2").astype(np.float32)


def _split_nibbles(qs: np.ndarray, group: int) -> np.ndarray:
    """Each `group`-byte run yields `group` low nibbles followed by `group`
    high nibbles (the ggml convention)."""
    n = qs.shape[0]
    q = qs.reshape(n, -1, group)
    return np.stack([q & np.uint8(0xF), q >> np.uint8(4)],
                    axis=2).reshape(n, -1)


def _expand_bits(b: np.ndarray, shifts: list[int], group: int,
                 mask: int) -> np.ndarray:
    """Each `group`-byte run yields, for each shift in order, `group`
    values of (byte >> shift) & mask."""
    n = b.shape[0]
    q = b.reshape(n, -1, 1, group)
    sh = np.array(shifts, dtype=np.uint8).reshape(1, 1, len(shifts), 1)
    return ((q >> sh) & np.uint8(mask)).reshape(n, -1)


def _unpack_scale_min_k4(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """12-byte packed 6-bit scales/mins -> (8 scales, 8 mins) per
    superblock (ggml-quants.c get_scale_min_k4)."""
    a, bb, c = scales[:, 0:4], scales[:, 4:8], scales[:, 8:12]
    sc = np.concatenate([a & 0x3F, (c & 0x0F) | ((a >> 2) & 0x30)], axis=-1)
    mn = np.concatenate([bb & 0x3F, (c >> 4) | ((bb >> 2) & 0x30)], axis=-1)
    return sc, mn


def _deq_q8_0(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, :2])
    q = b[:, 2:].view(np.int8).astype(np.float32)
    return q * d


def _qh_bits(b4: np.ndarray) -> np.ndarray:
    """4-byte qh field -> 32 single bits per block, bit j of the
    little-endian u32 for element j."""
    n = b4.shape[0]
    qh = b4.reshape(n, 4).view("<u4").reshape(n, 1)
    return ((qh >> np.arange(32, dtype=np.uint32).reshape(1, 32))
            & np.uint32(1)).astype(np.uint8)


def _deq_q4_0(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, :2])
    q = _split_nibbles(b[:, 2:], 16).astype(np.int8) - np.int8(8)
    return d * q.astype(np.float32)


def _deq_q4_1(b: np.ndarray) -> np.ndarray:
    d, m = _f16(b[:, :2]), _f16(b[:, 2:4])
    q = _split_nibbles(b[:, 4:], 16).astype(np.float32)
    return d * q + m


def _deq_q5_0(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, :2])
    hi = _qh_bits(b[:, 2:6])
    lo = _split_nibbles(b[:, 6:], 16)
    q = (lo | (hi << np.uint8(4))).astype(np.int8) - np.int8(16)
    return d * q.astype(np.float32)


def _deq_q5_1(b: np.ndarray) -> np.ndarray:
    d, m = _f16(b[:, :2]), _f16(b[:, 2:4])
    hi = _qh_bits(b[:, 4:8])
    lo = _split_nibbles(b[:, 8:], 16)
    q = (lo | (hi << np.uint8(4))).astype(np.float32)
    return d * q + m


def _deq_q2_k(b: np.ndarray) -> np.ndarray:
    n = b.shape[0]
    scales, qs = b[:, :16], b[:, 16:80]
    d, dmin = _f16(b[:, 80:82]), _f16(b[:, 82:84])
    dl = (d * (scales & np.uint8(0xF)).astype(np.float32)).reshape(n, 16, 1)
    ml = (dmin * (scales >> np.uint8(4)).astype(np.float32)).reshape(n, 16, 1)
    q = _expand_bits(qs, [0, 2, 4, 6], 32, 3).reshape(n, 16, 16).astype(np.float32)
    return (dl * q - ml).reshape(n, QK_K)


def _unpack_scales_q3k(scales: np.ndarray) -> np.ndarray:
    """12 bytes -> 16 signed 6-bit scales (ggml-quants.c's layout): the low
    4 bits of scale i in nibble i // 8 of byte i % 8, the high 2 bits at
    shift 2·(i // 4) of byte 8 + i % 4, minus 32."""
    lo = _expand_bits(scales[:, :8], [0, 4], 8, 0xF)
    hi = _expand_bits(scales[:, 8:12], [0, 2, 4, 6], 4, 0x3)
    return (lo | (hi << np.uint8(4))).astype(np.int8) - np.int8(32)


def _deq_q3_k(b: np.ndarray) -> np.ndarray:
    n = b.shape[0]
    hmask, qs, scales = b[:, :32], b[:, 32:96], b[:, 96:108]
    d = _f16(b[:, 108:110])
    sc = _unpack_scales_q3k(scales).astype(np.float32)
    dl = (d * sc).reshape(n, 16, 1)
    ql = _expand_bits(qs, [0, 2, 4, 6], 32, 3).reshape(n, 16, 16)
    qh = _expand_bits(hmask, list(range(8)), 32, 1).reshape(n, 16, 16)
    qh = qh ^ np.uint8(1)  # a set hmask bit means "do not subtract 4"
    q = (ql.astype(np.int8) - (qh << np.uint8(2)).astype(np.int8)).astype(np.float32)
    return (dl * q).reshape(n, QK_K)


def _deq_q4_k(b: np.ndarray) -> np.ndarray:
    n = b.shape[0]
    d, dmin = _f16(b[:, :2]), _f16(b[:, 2:4])
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    dl = (d * sc.astype(np.float32)).reshape(n, 8, 1)
    ml = (dmin * mn.astype(np.float32)).reshape(n, 8, 1)
    q = _split_nibbles(b[:, 16:], 32).reshape(n, 8, 32).astype(np.float32)
    return (dl * q - ml).reshape(n, QK_K)


def q5k_values(b: np.ndarray) -> np.ndarray:
    """Q5_K blocks [n, 176] -> the 5-bit values as uint8 [n, 256] in element
    order: bit i of qh byte l is the high bit of element 32i + l."""
    hi = _expand_bits(b[:, 16:48], list(range(8)), 32, 1)
    lo = _split_nibbles(b[:, 48:], 32)
    return lo | (hi << np.uint8(4))


def _deq_q5_k(b: np.ndarray) -> np.ndarray:
    n = b.shape[0]
    d, dmin = _f16(b[:, :2]), _f16(b[:, 2:4])
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    dl = (d * sc.astype(np.float32)).reshape(n, 8, 1)
    ml = (dmin * mn.astype(np.float32)).reshape(n, 8, 1)
    q = q5k_values(b).reshape(n, 8, 32).astype(np.float32)
    return (dl * q - ml).reshape(n, QK_K)


def q6k_values(b: np.ndarray) -> np.ndarray:
    """Q6_K blocks [n, 210] -> the 6-bit values q - 32 as int8 [n, 256] in
    element order. Per 128-element half: the low nibbles of ql bytes 0..63
    are groups 0 and 1 (32 each), their high nibbles groups 2 and 3; qh
    byte l holds the two high bits of group j's element l at shift 2j."""
    n = b.shape[0]
    lo = _split_nibbles(b[:, :128], 64)
    hi = _expand_bits(b[:, 128:192], [0, 2, 4, 6], 32, 3)
    return ((lo | (hi << np.uint8(4))).astype(np.int8)
            - np.int8(32)).reshape(n, QK_K)


def _deq_q6_k(b: np.ndarray) -> np.ndarray:
    n = b.shape[0]
    d = _f16(b[:, 208:210])
    dl = (d * b[:, 192:208].view(np.int8).astype(np.float32)).reshape(n, 16, 1)
    q = q6k_values(b).astype(np.float32)
    return (dl * q.reshape(n, 16, 16)).reshape(n, QK_K)


# the IQ4 codebook (ggml-common.h kvalues_iq4nl)
_IQ4NL_KVALUES = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    np.int8)


def _deq_iq4_nl(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, :2])
    idx = _split_nibbles(b[:, 2:], 16).astype(np.int64)
    return d * _IQ4NL_KVALUES[idx].astype(np.float32)


def _deq_iq4_xs(b: np.ndarray) -> np.ndarray:
    n = b.shape[0]
    d = _f16(b[:, :2])
    sh = b[:, 2:4].copy().view("<u2").astype(np.uint32)  # [n, 1]
    lo4 = _split_nibbles(b[:, 4:4 + QK_K // 64], 1)  # [n, 8] group low bits
    hi2 = ((sh >> (2 * np.arange(QK_K // 32, dtype=np.uint32)[None, :]))
           & np.uint32(3)).astype(np.uint8)
    scales = (lo4 | (hi2 << np.uint8(4))).astype(np.int16) - 32  # [n, 8]
    dl = d * scales.astype(np.float32)  # [n, 8]
    idx = _split_nibbles(b[:, 4 + QK_K // 64:].reshape(n * (QK_K // 32), 16),
                         16).astype(np.int64)  # per-32-group element order
    vals = _IQ4NL_KVALUES[idx].astype(np.float32).reshape(n, QK_K // 32, 32)
    return (dl[:, :, None] * vals).reshape(n, QK_K)


# MXFP4's e2m1 codebook, pre-doubled so that the e8m0 scale drops one
# exponent step (ggml-impl.h ggml_e8m0_to_fp32_half)
_MXFP4_KVALUES = np.array(
    [0, 1, 2, 3, 4, 6, 8, 12, 0, -1, -2, -3, -4, -6, -8, -12], dtype=np.float32)


def _e8m0_half(e: np.ndarray) -> np.ndarray:
    """e8m0 exponent byte -> 2^(e-127)/2 as f32, built from its bits
    (subnormal below e = 2)."""
    e = e.astype(np.uint32)
    bits = np.where(e < 2, np.uint32(0x0020_0000) << e,
                    (e - np.uint32(1)) << np.uint32(23))
    return bits.view(np.float32)


def _deq_mxfp4(b: np.ndarray) -> np.ndarray:
    d = _e8m0_half(b[:, :1])
    idx = _split_nibbles(b[:, 1:], 16).astype(np.int64)
    return d * _MXFP4_KVALUES[idx]


_DEQUANT = {GGMLType.Q8_0: _deq_q8_0, GGMLType.Q4_0: _deq_q4_0,
            GGMLType.Q4_1: _deq_q4_1, GGMLType.Q5_0: _deq_q5_0,
            GGMLType.Q5_1: _deq_q5_1, GGMLType.Q2_K: _deq_q2_k,
            GGMLType.Q3_K: _deq_q3_k, GGMLType.Q4_K: _deq_q4_k,
            GGMLType.Q5_K: _deq_q5_k, GGMLType.Q6_K: _deq_q6_k,
            GGMLType.IQ4_NL: _deq_iq4_nl, GGMLType.IQ4_XS: _deq_iq4_xs,
            GGMLType.MXFP4: _deq_mxfp4}


def dequantize(blocks: np.ndarray, ggml_type: GGMLType | int,
               shape: tuple[int, ...] | None = None) -> np.ndarray:
    """Block bytes (or a plain F32/F16/BF16 array) -> float32, reshaped to
    `shape` if given. Other formats are not ported and raise."""
    t = GGMLType(ggml_type)
    if t == GGMLType.F32:
        out = np.asarray(blocks, dtype=np.float32)
    elif t == GGMLType.F16:
        out = np.asarray(blocks).astype(np.float32)
    elif t == GGMLType.BF16:
        bits = np.asarray(blocks).view(np.uint16).astype(np.uint32) << 16
        out = bits.view(np.float32)
    elif t in _DEQUANT:
        b = np.ascontiguousarray(blocks, dtype=np.uint8).reshape(
            -1, type_traits(t).type_size)
        out = _DEQUANT[t](b)
    else:
        raise NotImplementedError(f"dequantize: {t.name} is not ported")
    return out.reshape(shape) if shape is not None else out.reshape(-1)


def dequantize_q4k(blocks: np.ndarray,
                   shape: tuple[int, ...] | None = None) -> np.ndarray:
    """Q4_K block bytes -> float32 array (reshaped to `shape` if given)."""
    return dequantize(blocks, GGMLType.Q4_K, shape)
