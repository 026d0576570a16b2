"""Rotary position embeddings (counterpart of omni_tpu/kernels/rope.py):
NeoX-style halves for Qwen3, adjacent pairs for the NORM variant. Positions
are explicit per token, which is what makes llama.cpp's KV position shifts
expressible: cached K is stored rotated, and a shift is an incremental
rotation by the delta (`rope_shift`)."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, base: float, device=None) -> torch.Tensor:
    """Inverse frequencies for each rotated pair: [head_dim/2] f32."""
    exponents = (torch.arange(0, head_dim, 2, dtype=torch.float32,
                              device=device) / head_dim)
    return 1.0 / (base ** exponents)


def rope_trig(angles: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of f32 angles, in f32."""
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, base: float = 10000.0,
               freqs: torch.Tensor | None = None, neox: bool = True,
               scale: float = 1.0) -> torch.Tensor:
    """Rotate x[..., T, H, D] by per-token positions pos[..., T]."""
    d = x.shape[-1]
    if freqs is None:
        freqs = rope_freqs(d, base, device=x.device)
    angles = pos[..., None].to(torch.float32) * freqs  # [..., T, D/2]
    cos, sin = rope_trig(angles)
    cos = cos[..., None, :]  # broadcast over heads
    sin = sin[..., None, :]
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


def rope_shift(k: torch.Tensor, delta: torch.Tensor,
               base: float = 10000.0) -> torch.Tensor:
    """Rotate cached K rows [..., S, H, D] by per-row position deltas
    [..., S] (the K shift of context shift and self-extend: llama.cpp's
    build_rope_shift)."""
    return apply_rope(k, delta, base)
