"""Normalization (counterpart of omni_tpu/kernels/norms.py): f32
statistics whatever the activation dtype, as ggml_rms_norm computes them."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None,
             eps: float = 1e-6) -> torch.Tensor:
    """weight=None = non-parametric (ggml_rms_norm with NULL weight)."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.to(torch.float32)
    return out.to(x.dtype)
