"""Quantized matmul: the `matmul` dispatcher and the two Q4_K kernels.

Counterpart of `omni_tpu/kernels/dequant_matmul.py`. On a CUDA tensor a
Q4_K weight goes to a kernel written by hand for Hopper
(`csrc/q4k_gemv.cu` at M <= 8, `csrc/q4k_gemm.cu` above), the conditions of
`gp_supported` / `sh_supported` (dequant_matmul.py:321-326, :449-454) with
K % 2048 == 0. Each kernel has a plain PyTorch version of the same law
beside it: the wrapper runs it only for a tensor that lies on the CPU, and
on a CUDA tensor it launches the kernel or raises. `qmatmul_plain` plays
the role of `qmatmul_xla`: the dispatcher's path off the card.
"""

from __future__ import annotations

import torch

from ..core.dtypes import GGMLType
from .qformats import QTensor, check_q4k, dequant, q4k_group_scales, unpack_sb_halves

GP_MAX_M = 8  # decode rows kernel A takes (the TPU kernel's _GP_MAX_M)
MIN_K = 2048  # the K granule both TPU kernels need for Q4_K (_gp_min_tk)

# kernel launches, one count per wrapper; a run resets and reads them
launches = {"q4k_gemv": 0, "q4k_gemm": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _on_cuda(x: torch.Tensor) -> bool:
    return x.is_cuda


def _check(x: torch.Tensor, qt: QTensor, out_dtype) -> None:
    check_q4k(qt)
    if x.dim() != 2 or x.shape[1] != qt.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not match weight {qt.shape}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype}: want bfloat16 or float32")


def _launch(name: str, x: torch.Tensor, qt: QTensor, out_dtype) -> torch.Tensor:
    """Launch kernel `name` on the current stream (CUDA tensors only)."""
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous bfloat16, got {x.dtype}")
    planes = (qt.q, qt.sc, qt.mn, qt.d, qt.dm)
    if any(p.device != x.device for p in planes):
        raise ValueError(f"{name}: x and weight planes on different devices")
    if x.data_ptr() % 16 or qt.q.data_ptr() % 16:
        raise ValueError(f"{name}: x and q must be 16-byte aligned")
    from . import _build

    fn = getattr(_build.load()[name], name)
    m, k = x.shape
    n = qt.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    rc = fn(x.data_ptr(), *(p.data_ptr() for p in planes), out.data_ptr(),
            m, n, k, int(out_dtype == torch.float32),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    launches[name] += 1
    return out


def q4k_gemv_plain(x: torch.Tensor, qt: QTensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel A's law in plain PyTorch (the group law of qmatmul_gp_pallas):
    per 32-group P = x_bf16 · q (raw nibbles), out = Σ_g dl·P − ml·xs with
    xs the group sums of x_bf16, all in f32."""
    m, k = x.shape
    n = qt.shape[0]
    g = k // 32
    xb = x.to(torch.bfloat16).to(torch.float32).reshape(m, g, 32)
    q = unpack_sb_halves(qt.q).to(torch.float32).reshape(n, g, 32)
    p = torch.einsum("mgk,ngk->mng", xb, q)  # [M, N, G]
    dl, ml = q4k_group_scales(qt)  # [N, G]
    xs = xb.sum(-1)  # [M, G]
    out = (dl[None] * p - ml[None] * xs[:, None, :]).sum(-1)
    return out.to(out_dtype)


def q4k_gemm_plain(x: torch.Tensor, qt: QTensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel B's law in plain PyTorch (the centered law of
    qmatmul_splith_pallas): w = bf16((q − t)·dl) with t = ml/dl, a bf16 dot
    with f32 accumulation, and the residual ml − t·dl folded back through
    the group sums of x."""
    m, k = x.shape
    n = qt.shape[0]
    dl, ml = q4k_group_scales(qt)
    nz = dl != 0
    t = torch.where(nz, ml / torch.where(nz, dl, torch.ones_like(dl)),
                    torch.zeros_like(dl))
    ml_res = ml - t * dl
    q = unpack_sb_halves(qt.q).to(torch.float32)
    w = ((q - t.repeat_interleave(32, 1)) * dl.repeat_interleave(32, 1)
         ).to(torch.bfloat16).to(torch.float32)
    acc = x.to(torch.bfloat16).to(torch.float32) @ w.T
    xs = x.to(torch.float32).reshape(m, k // 32, 32).sum(-1)
    return (acc - xs @ ml_res.T).to(out_dtype)


def q4k_gemv(x: torch.Tensor, qt: QTensor,
             out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel A (replaces qmatmul_gp_pallas for Q4_K): M = 1..8."""
    _check(x, qt, out_dtype)
    if not 1 <= x.shape[0] <= GP_MAX_M:
        raise ValueError(f"q4k_gemv takes M = 1..{GP_MAX_M}, got {x.shape[0]}")
    if _on_cuda(x):
        return _launch("q4k_gemv", x, qt, out_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"q4k_gemv: unsupported device {x.device}")
    return q4k_gemv_plain(x, qt, out_dtype)


def q4k_gemm(x: torch.Tensor, qt: QTensor,
             out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel B (replaces qmatmul_splith_pallas for Q4_K): M > 8."""
    _check(x, qt, out_dtype)
    if x.shape[0] <= GP_MAX_M:
        raise ValueError(f"q4k_gemm takes M > {GP_MAX_M}, got {x.shape[0]}")
    if _on_cuda(x):
        return _launch("q4k_gemm", x, qt, out_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"q4k_gemm: unsupported device {x.device}")
    return q4k_gemm_plain(x, qt, out_dtype)


def qmatmul_plain(x: torch.Tensor, qt: QTensor,
                  out_dtype=torch.bfloat16) -> torch.Tensor:
    """The path off the card (qmatmul_xla's role): dequant to bf16, then a
    dot with f32 accumulation."""
    w = dequant(qt, torch.bfloat16).to(torch.float32)
    return (x.to(torch.bfloat16).to(torch.float32) @ w.T).to(out_dtype)


def matmul(x: torch.Tensor, w, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Unified linear: `w` is a QTensor or a plain [N, K] tensor."""
    if isinstance(w, QTensor):
        if not _on_cuda(x):
            return qmatmul_plain(x, w, out_dtype)
        if w.ggml_type == GGMLType.Q4_K and w.shape[1] % MIN_K == 0:
            xb = x.to(torch.bfloat16).contiguous()
            if x.shape[0] <= GP_MAX_M:
                return q4k_gemv(xb, w, out_dtype)
            return q4k_gemm(xb, w, out_dtype)
        raise NotImplementedError(
            f"no CUDA kernel for {GGMLType(w.ggml_type).name} K={w.shape[1]}: "
            "qmatmul_pallas (the generic fused dequant x matmul, "
            "omni_tpu/kernels/dequant_matmul.py:103) is not ported yet")
    return (x.to(w.dtype).to(torch.float32) @ w.to(torch.float32).T
            ).to(out_dtype)
