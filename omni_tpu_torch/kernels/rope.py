"""Rotary position embeddings (counterpart of omni_tpu/kernels/rope.py):
NeoX-style halves for Qwen3, adjacent pairs for the NORM variant. Positions
are explicit per token."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, base: float, device=None) -> torch.Tensor:
    """Inverse frequencies for each rotated pair: [head_dim/2] f32."""
    exponents = (torch.arange(0, head_dim, 2, dtype=torch.float32,
                              device=device) / head_dim)
    return 1.0 / (base ** exponents)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, base: float = 10000.0,
               freqs: torch.Tensor | None = None, neox: bool = True,
               scale: float = 1.0) -> torch.Tensor:
    """Rotate x[..., T, H, D] by per-token positions pos[..., T]."""
    d = x.shape[-1]
    if freqs is None:
        freqs = rope_freqs(d, base, device=x.device)
    angles = pos[..., None].to(torch.float32) * freqs  # [..., T, D/2]
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    if scale != 1.0:
        cos = cos * scale
        sin = sin * scale
    xf = x.to(torch.float32)
    if neox:
        x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
        return out.to(x.dtype)
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
