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


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None,
               bias: torch.Tensor | None = None,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm with f32 statistics (ggml_norm); weight=None is the
    non-parametric form. The variance is the biased one, as jnp.var's."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


def layer_norm_nobias(x: torch.Tensor, weight: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """Bias-free LayerNorm (llama.cpp's LLM_NORM), positionally as
    `rms_norm`."""
    return layer_norm(x, weight, None, eps)
