"""Numpy Q4_K dequantiser: the bit-exact oracle inside the port.

A copy of the Q4_K path of `omni_tpu/core/quants.py` (ggml-quants.c
dequantize_row_q4_K semantics): the effective group scale is the single
f32 product d*sc, and w = q*(d*sc) - dmin*mn.
"""

from __future__ import annotations

import numpy as np

from .dtypes import QK_K, Q4K_TRAITS


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


def _unpack_scale_min_k4(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """12-byte packed 6-bit scales/mins -> (8 scales, 8 mins) per
    superblock (ggml-quants.c get_scale_min_k4)."""
    a, bb, c = scales[:, 0:4], scales[:, 4:8], scales[:, 8:12]
    sc = np.concatenate([a & 0x3F, (c & 0x0F) | ((a >> 2) & 0x30)], axis=-1)
    mn = np.concatenate([bb & 0x3F, (c >> 4) | ((bb >> 2) & 0x30)], axis=-1)
    return sc, mn


def dequantize_q4k(blocks: np.ndarray,
                   shape: tuple[int, ...] | None = None) -> np.ndarray:
    """Q4_K block bytes -> float32 array (reshaped to `shape` if given)."""
    b = np.ascontiguousarray(blocks, dtype=np.uint8).reshape(
        -1, Q4K_TRAITS.type_size)
    n = b.shape[0]
    d, dmin = _f16(b[:, :2]), _f16(b[:, 2:4])
    sc, mn = _unpack_scale_min_k4(b[:, 4:16])
    dl = (d * sc.astype(np.float32)).reshape(n, 8, 1)
    ml = (dmin * mn.astype(np.float32)).reshape(n, 8, 1)
    q = _split_nibbles(b[:, 16:], 32).reshape(n, 8, 32).astype(np.float32)
    out = (dl * q - ml).reshape(n * QK_K)
    return out.reshape(shape) if shape is not None else out
