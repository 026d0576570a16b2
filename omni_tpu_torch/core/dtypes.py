"""GGML dtype ids and the Q4_K block layout.

A copy of what the port needs from `omni_tpu/core/dtypes.py` (enum values
per the GGUF format, llama.cpp ggml/include/ggml.h:380-420; Q4_K
block per ggml-common.h). Kept here so the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

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
    """`block_size` logical elements are stored in `type_size` bytes."""

    block_size: int
    type_size: int


# d (f16) + dmin (f16) + 12 bytes of packed 6-bit scales/mins + 128 bytes
# of nibbles per 256-element superblock.
Q4K_TRAITS = TypeTraits(QK_K, 2 + 2 + 12 + QK_K // 2)
