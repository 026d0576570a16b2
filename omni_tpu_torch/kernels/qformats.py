"""Quantized weight planes for the port.

Counterpart of `omni_tpu/kernels/qformats.py`. The JAX package stores a
weight W[N, K] K-major (planes [K', N]) because the TPU's sublane rules want
quant groups down the rows. A GEMV on the card reads best with each output
row's K contiguous, so the port stores the same planes N-major: plane
[N, K'] is the transpose of the JAX plane [K', N], a pure permutation of its
bytes (and the JAX planes are themselves a permutation of the GGUF blocks).

Q4_K planes (rows × K'):
- q  u8   [N, K/2]   superblock-local halves: byte r of superblock s holds
                     element s·256+r in the low nibble, s·256+128+r in the
                     high one
- sc int8 [N, K/32]  6-bit group scales, already unpacked
- mn int8 [N, K/32]  6-bit group mins
- d  f32  [N, K/256] super-scale
- dm f32  [N, K/256] super-min-scale

Other formats keep whatever planes the converter gives them; only Q4_K has
a dequantiser and kernels in this slice.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from ..core.dtypes import QK_K, GGMLType

PLANES = ("q", "sc", "mn", "d", "dm", "qh")


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


def _expand(a: torch.Tensor, r: int) -> torch.Tensor:
    """[N, G] -> [N, G*r], each column repeated r times."""
    return a.repeat_interleave(r, dim=1)


def unpack_sb_halves(qp: torch.Tensor) -> torch.Tensor:
    """[N, K/2] packed bytes -> [N, K] uint8 values in element order."""
    n, half = qp.shape
    lo = (qp & 0xF).reshape(n, half // 128, 1, 128)
    hi = (qp >> 4).reshape(n, half // 128, 1, 128)
    return torch.cat([lo, hi], dim=2).reshape(n, half * 2)


def q4k_group_scales(qt: QTensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-32-group (dl, ml) = (d·sc, dm·mn) as f32 [N, K/32] — the exact
    f32 products the reference dequantiser forms."""
    dl = _expand(qt.d, 8) * qt.sc.to(torch.float32)
    ml = _expand(qt.dm, 8) * qt.mn.to(torch.float32)
    return dl, ml


def dequant(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Full dequantization -> logical [N, K] (bit-exact with the reference
    in f32)."""
    if qt.ggml_type != GGMLType.Q4_K:
        raise NotImplementedError(
            f"dequant: {GGMLType(qt.ggml_type).name} is not ported yet")
    q = unpack_sb_halves(qt.q).to(torch.float32)
    dl, ml = q4k_group_scales(qt)
    return (q * _expand(dl, 32) - _expand(ml, 32)).to(dtype)


def concat_qtensors(qts: list[QTensor]) -> QTensor:
    """Concatenate same-K QTensors along the output-feature axis (plane
    rows) — fuses QKV and gate+up into one launch each."""
    t, k = qts[0].ggml_type, qts[0].shape[1]
    if not all(q.ggml_type == t and q.shape[1] == k for q in qts):
        raise ValueError("concat_qtensors: mixed formats or K")
    cat = {}
    for f in fields(QTensor):
        if f.name in PLANES:
            arrs = [getattr(q, f.name) for q in qts]
            cat[f.name] = None if arrs[0] is None else torch.cat(arrs, dim=0)
    return QTensor(t, (sum(q.shape[0] for q in qts), k), **cat)


def check_q4k(qt: QTensor) -> None:
    """Raise unless `qt` is a well-formed Q4_K QTensor."""
    if qt.ggml_type != GGMLType.Q4_K:
        raise ValueError(f"expected Q4_K, got {GGMLType(qt.ggml_type).name}")
    n, k = qt.shape
    if k % QK_K:
        raise ValueError(f"Q4_K K={k} is not a multiple of {QK_K}")
    want = {"q": ((n, k // 2), torch.uint8), "sc": ((n, k // 32), torch.int8),
            "mn": ((n, k // 32), torch.int8),
            "d": ((n, k // QK_K), torch.float32),
            "dm": ((n, k // QK_K), torch.float32)}
    for nm, (shape, dtype) in want.items():
        a = getattr(qt, nm)
        if a is None or tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"Q4_K plane {nm}: want {shape} {dtype}, got "
                             f"{None if a is None else (tuple(a.shape), a.dtype)}")
        if not a.is_contiguous():
            raise ValueError(f"Q4_K plane {nm} is not contiguous")
