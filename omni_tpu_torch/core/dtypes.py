"""GGML dtype ids and block layouts.

A copy of `omni_tpu/core/dtypes.py` (enum values per the GGUF format,
llama.cpp ggml/include/ggml.h:380-420; block layouts per ggml-common.h).
The GGUF reader needs every type's block size to step over tensors it does
not load. Kept here so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

# Superblock size for K-quants (ggml-common.h:89).
QK_K = 256


class GGMLType(enum.IntEnum):
    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    TQ1_0 = 34
    TQ2_0 = 35
    MXFP4 = 39


@dataclass(frozen=True)
class TypeTraits:
    """Block layout of one GGML dtype: `block_size` logical elements are
    stored in `type_size` bytes."""

    block_size: int
    type_size: int
    numpy_dtype: np.dtype | None = None  # set for non-quantized types

    @property
    def is_quantized(self) -> bool:
        return self.numpy_dtype is None


TYPE_TRAITS: dict[GGMLType, TypeTraits] = {
    GGMLType.F32: TypeTraits(1, 4, np.dtype(np.float32)),
    GGMLType.F16: TypeTraits(1, 2, np.dtype(np.float16)),
    GGMLType.F64: TypeTraits(1, 8, np.dtype(np.float64)),
    GGMLType.I8: TypeTraits(1, 1, np.dtype(np.int8)),
    GGMLType.I16: TypeTraits(1, 2, np.dtype(np.int16)),
    GGMLType.I32: TypeTraits(1, 4, np.dtype(np.int32)),
    GGMLType.I64: TypeTraits(1, 8, np.dtype(np.int64)),
    # BF16 has no numpy dtype; exposed as its uint16 bit pattern
    GGMLType.BF16: TypeTraits(1, 2, np.dtype(np.uint16)),
    GGMLType.Q4_0: TypeTraits(32, 2 + 16),
    GGMLType.Q4_1: TypeTraits(32, 2 + 2 + 16),
    GGMLType.Q5_0: TypeTraits(32, 2 + 4 + 16),
    GGMLType.Q5_1: TypeTraits(32, 2 + 2 + 4 + 16),
    GGMLType.Q8_0: TypeTraits(32, 2 + 32),
    GGMLType.Q8_1: TypeTraits(32, 2 + 2 + 32),
    GGMLType.Q2_K: TypeTraits(QK_K, 16 + 64 + 2 + 2),
    GGMLType.Q3_K: TypeTraits(QK_K, 32 + 64 + 12 + 2),
    # d, dmin (f16), 12 bytes of packed 6-bit scales/mins, 128 of nibbles
    GGMLType.Q4_K: TypeTraits(QK_K, 2 + 2 + 12 + 128),
    GGMLType.Q5_K: TypeTraits(QK_K, 2 + 2 + 12 + 32 + 128),
    # 128 bytes of low nibbles, 64 of 2-bit highs, 16 int8 scales, d (f16)
    GGMLType.Q6_K: TypeTraits(QK_K, 128 + 64 + 16 + 2),
    GGMLType.Q8_K: TypeTraits(QK_K, 4 + 256 + 32),
    GGMLType.MXFP4: TypeTraits(32, 1 + 16),
    GGMLType.IQ4_NL: TypeTraits(32, 2 + 16),
    GGMLType.IQ4_XS: TypeTraits(QK_K, 2 + 2 + QK_K // 64 + QK_K // 2),
    GGMLType.IQ2_XXS: TypeTraits(QK_K, 2 + QK_K // 8 * 2),
    GGMLType.IQ2_XS: TypeTraits(QK_K, 2 + QK_K // 8 * 2 + QK_K // 32),
    GGMLType.IQ2_S: TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 16),
    GGMLType.IQ3_XXS: TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 8),
    GGMLType.IQ3_S: TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 32 + QK_K // 8
                               + QK_K // 64),
    GGMLType.IQ1_S: TypeTraits(QK_K, 2 + QK_K // 8 + QK_K // 16),
    GGMLType.IQ1_M: TypeTraits(QK_K, QK_K // 8 + QK_K // 16 + QK_K // 32),
    GGMLType.TQ1_0: TypeTraits(QK_K, (QK_K - 4 * QK_K // 64) // 5 + QK_K // 64 + 2),
    GGMLType.TQ2_0: TypeTraits(QK_K, QK_K // 4 + 2),
}


def type_traits(t: GGMLType | int) -> TypeTraits:
    t = GGMLType(t)
    if t not in TYPE_TRAITS:
        raise NotImplementedError(f"GGML dtype {t.name} is not supported")
    return TYPE_TRAITS[t]


def row_nbytes(t: GGMLType | int, n_elements: int) -> int:
    tr = type_traits(t)
    if n_elements % tr.block_size != 0:
        raise ValueError(
            f"{GGMLType(t).name}: row of {n_elements} elements is not a "
            f"multiple of block size {tr.block_size}")
    return n_elements // tr.block_size * tr.type_size
