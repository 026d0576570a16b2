"""Sampler parameters and the greedy path of the sampler chain
(omni_tpu/runtime/sampler.py): logit bias, then the repetition/frequency/
presence penalties over a trailing token ring, then argmax. Everything
stays on the device; nothing syncs with the host."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplerParams:
    """The greedy-path fields of common_params_sampling (reference
    common/common.h); the stochastic samplers are a later slice."""

    temp: float = 0.8
    penalty_last_n: int = 64
    penalty_repeat: float = 1.0
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    logit_bias: tuple[tuple[int, float], ...] = ()
    greedy: bool = False

    @property
    def needs_penalties(self) -> bool:
        return self.penalty_last_n > 0 and (
            self.penalty_repeat != 1.0 or self.penalty_freq != 0.0
            or self.penalty_present != 0.0)


def apply_penalties(logits: torch.Tensor, prev_tokens: torch.Tensor,
                    p: SamplerParams) -> torch.Tensor:
    """Penalties over a trailing window; prev_tokens [W] int, -1 padding."""
    n = logits.shape[-1]
    idx = torch.where(prev_tokens >= 0, prev_tokens,
                      torch.full_like(prev_tokens, n)).to(torch.int64)
    counts = torch.zeros(n + 1, dtype=logits.dtype, device=logits.device)
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=logits.dtype))
    counts = counts[:n]
    present = counts > 0
    if p.penalty_repeat != 1.0:
        penal = torch.where(logits > 0, logits / p.penalty_repeat,
                            logits * p.penalty_repeat)
        logits = torch.where(present, penal, logits)
    logits = logits - counts * p.penalty_freq
    return logits - present.to(logits.dtype) * p.penalty_present


def sample(logits: torch.Tensor, params: SamplerParams,
           prev_tokens: torch.Tensor | None = None) -> torch.Tensor:
    """Draw one token id (0-d int64 tensor on the logits' device). Only the
    greedy path is ported; the stochastic samplers raise."""
    if not (params.greedy or params.temp <= 0.0):
        raise NotImplementedError(
            "only greedy sampling is ported; the stochastic sampler chain "
            "is a later slice")
    if params.logit_bias:
        ids = torch.tensor([t for t, _ in params.logit_bias],
                           device=logits.device)
        vals = torch.tensor([b for _, b in params.logit_bias],
                            dtype=logits.dtype, device=logits.device)
        logits = logits.index_add(0, ids, vals)
    if params.needs_penalties and prev_tokens is not None:
        logits = apply_penalties(logits, prev_tokens, params)
    return torch.argmax(logits)
