"""The sampler chain (counterpart of omni_tpu/runtime/sampler.py, after
llama.cpp's llama-sampling.cpp and common/sampling.cpp): logit bias ->
penalties -> DRY -> top-n-sigma -> top-k -> typical -> top-p -> min-p ->
XTC -> temperature (dynamic with a range) -> draw, or greedy argmax, or
mirostat v1/v2 as the final sampler (stateful mu). Every transform is
plain torch on an f32 logits row; on a CUDA row the whole chain stays on
the device (no `.item()`, no host copy: the decode loop enqueues a chunk
without a sync). The token history for the penalties and DRY is a ring of
the last W tokens, -1 padded.

The draw is argmax(logits + Gumbel noise), which is what
`jax.random.categorical` computes. The noise, and XTC's uniform, come from
a `torch.Generator` on the logits' device, or are passed in (`gumbel`,
`xtc_u`), so that a test can feed JAX's own draws. The thresholds follow
the JAX package: top-k keeps every tie of the k-th logit, top-p keeps the
smallest prefix whose f32 cumulative probability passes p, sorts are
stable.

llama.cpp's infill sampler (`apply_infill_host`) is host numpy, as in the
JAX package; the server's n_probs step is `top_logprobs`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

NEG_INF = float("-inf")
TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class SamplerParams:
    """Mirror of common_params_sampling (llama.cpp common/common.h)."""

    seed: int = 42
    temp: float = 0.8
    dynatemp_range: float = 0.0  # temp-ext
    dynatemp_exponent: float = 1.0
    top_k: int = 40
    top_p: float = 0.95
    min_p: float = 0.05
    typical_p: float = 1.0
    top_n_sigma: float = -1.0
    xtc_probability: float = 0.0
    xtc_threshold: float = 0.10
    penalty_last_n: int = 64
    penalty_repeat: float = 1.0
    penalty_freq: float = 0.0
    penalty_present: float = 0.0
    # DRY repeat suppression (llama_sampler_init_dry)
    dry_multiplier: float = 0.0  # 0 = off
    dry_base: float = 1.75
    dry_allowed_length: int = 2
    dry_breakers: tuple[int, ...] = ()  # token ids that reset n-gram matching
    # static (token_id, bias) pairs (llama_sampler_init_logit_bias)
    logit_bias: tuple[tuple[int, float], ...] = ()
    # mirostat: 0 = off, 1 = v1, 2 = v2 (llama_sampler_init_mirostat{,_v2})
    mirostat: int = 0
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    greedy: bool = False

    @property
    def needs_penalties(self) -> bool:
        return self.penalty_last_n > 0 and (
            self.penalty_repeat != 1.0 or self.penalty_freq != 0.0
            or self.penalty_present != 0.0)

    @property
    def needs_dry(self) -> bool:
        return self.dry_multiplier > 0.0 and self.penalty_last_n > 1


@functools.lru_cache(maxsize=256)
def _const(values: tuple, dtype: torch.dtype, device: torch.device
           ) -> torch.Tensor:
    """A constant tensor, made once per device. On the card it is copied
    from pinned memory without a wait: a copy from pageable memory would
    synchronize with the card's queue."""
    t = torch.tensor(values, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def apply_penalties(logits: torch.Tensor, prev_tokens: torch.Tensor,
                    p: SamplerParams) -> torch.Tensor:
    """Repetition/frequency/presence penalties over the trailing window;
    prev_tokens [W] int, -1 padding."""
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


def apply_logit_bias(logits: torch.Tensor,
                     bias: tuple[tuple[int, float], ...]) -> torch.Tensor:
    """Add each (token, bias); ids outside the row are dropped, negative
    ones count from the end (JAX's `.at[ids].add(mode="drop")`)."""
    n = logits.shape[-1]
    pairs = tuple((t + n if t < 0 else t, b) for t, b in bias
                  if -n <= t < n)
    if not pairs:
        return logits
    ids = _const(tuple(t for t, _ in pairs), torch.int64, logits.device)
    vals = _const(tuple(b for _, b in pairs), logits.dtype, logits.device)
    return logits.index_add(0, ids, vals)


def apply_allowed_mask(logits: torch.Tensor,
                       allowed: torch.Tensor) -> torch.Tensor:
    """Keep only the `allowed` token ids (int, may hold -1 padding): the
    on-device half of grammar-constrained sampling."""
    n = logits.shape[-1]
    keep = torch.zeros(n + 1, dtype=torch.bool, device=logits.device)
    keep[torch.where(allowed >= 0, allowed,
                     torch.full_like(allowed, n)).to(torch.int64)] = True
    return logits.masked_fill(~keep[:n], NEG_INF)


def apply_dry(logits: torch.Tensor, prev_tokens: torch.Tensor,
              p: SamplerParams) -> torch.Tensor:
    """DRY repeat suppression (llama.cpp's dry sampler). For a token z at
    ring position i, m(i) is the longest match between the tokens before
    i and the tail of the context; m >= allowed_length penalizes z by
    multiplier * base^(m - allowed_length). O(W^2) on the device."""
    w = prev_tokens.shape[0]
    dev = logits.device
    prev = prev_tokens.to(torch.int64)
    valid = prev >= 0
    if p.dry_breakers:
        br = _const(tuple(p.dry_breakers), torch.int64, dev)
        is_breaker = (prev[:, None] == br[None, :]).any(-1)
    else:
        is_breaker = torch.zeros_like(valid)
    matchable = valid & ~is_breaker
    # E[t, i] = prev[i - t] == prev[W - t] for the compared lags t = 1..W-1
    ar = torch.arange(w, device=dev)
    t = ar[1:, None]
    src = ar[None, :] - t  # the earlier index
    tail = (w - t).clamp(0, w - 1)  # the context-tail index
    ok = src >= 0
    srcc = src.clamp(min=0)
    eq = ((torch.where(ok, prev[srcc], torch.full_like(srcc, -2))
           == prev[tail]) & ok & matchable[srcc] & matchable[tail])
    run = torch.cumprod(eq.to(torch.int32), dim=0)  # AND over t' <= t
    m = run.sum(0)  # the longest suffix match before i
    length = torch.where(valid & (m >= p.dry_allowed_length), m,
                         torch.full_like(m, -1))
    expo = (length - p.dry_allowed_length).to(torch.float32)
    pen = torch.where(length >= 0,
                      p.dry_multiplier * torch.pow(
                          torch.full_like(expo, p.dry_base), expo),
                      torch.zeros_like(expo))
    n = logits.shape[-1]
    idx = torch.where(valid, prev, torch.full_like(prev, n))
    per_tok = torch.zeros(n + 1, dtype=torch.float32, device=dev).scatter_reduce(
        0, idx, pen, reduce="amax", include_self=True)[:n]
    return logits - per_tok


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest logits and every tie of the k-th."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k).values[-1]
    return logits.masked_fill(logits < kth, NEG_INF)


def apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Keep the smallest prefix (by logit) whose cumulative probability
    passes top_p, the boundary token included."""
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, descending=True, stable=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, -1), 0)
    keep = torch.cat([torch.ones(1, dtype=torch.bool, device=logits.device),
                      cum[:-1] < top_p])
    # a masked min, not an index: a 0-d index tensor would be read on the
    # host
    thresh = sorted_logits.masked_fill(~keep, float("inf")).min()
    return logits.masked_fill(logits < thresh, NEG_INF)


def apply_min_p(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    if min_p <= 0.0:
        return logits
    probs = torch.softmax(logits, -1)
    return logits.masked_fill(probs < probs.max() * min_p, NEG_INF)


def _entropy(logits: torch.Tensor) -> tuple[torch.Tensor, ...]:
    logp = torch.log_softmax(logits, -1)
    probs = torch.exp(logp)
    ent = -torch.where(probs > 0, probs * logp, torch.zeros_like(probs)).sum()
    return logp, probs, ent


def apply_typical(logits: torch.Tensor, typ_p: float) -> torch.Tensor:
    """Locally typical sampling (llama_sampler_init_typical)."""
    if typ_p >= 1.0:
        return logits
    logp, probs, ent = _entropy(logits)
    shifted = torch.abs(-logp - ent)
    order = torch.sort(shifted, stable=True).indices  # ascending deviation
    cum = torch.cumsum(probs[order], 0)
    keep_sorted = torch.cat([
        torch.ones(1, dtype=torch.bool, device=logits.device), cum[:-1] < typ_p])
    keep = torch.zeros_like(keep_sorted).scatter(0, order, keep_sorted)
    return logits.masked_fill(~keep, NEG_INF)


def apply_top_n_sigma(logits: torch.Tensor, n_sigma: float) -> torch.Tensor:
    if n_sigma <= 0.0:
        return logits
    valid = logits > NEG_INF
    zero = torch.zeros_like(logits)
    mx = logits.max()
    mean = torch.where(valid, logits, zero).mean()
    std = torch.sqrt(torch.where(valid, (logits - mean) ** 2, zero).mean())
    return logits.masked_fill(logits < mx - n_sigma * std, NEG_INF)


def apply_xtc(logits: torch.Tensor, u: torch.Tensor,
              p: SamplerParams) -> torch.Tensor:
    """Exclude top choices: when the uniform `u` falls below
    xtc_probability, drop every token of probability >= threshold but the
    least probable of them."""
    if p.xtc_probability <= 0.0:
        return logits
    probs = torch.softmax(logits, -1)
    above = probs >= p.xtc_threshold
    fire = u < p.xtc_probability
    min_above = torch.where(above, probs,
                            torch.full_like(probs, float("inf"))).min()
    drop = above & (probs > min_above) & fire & (above.sum() > 1)
    return logits.masked_fill(drop, NEG_INF)


def apply_temp(logits: torch.Tensor, p: SamplerParams) -> torch.Tensor:
    if p.dynatemp_range > 0.0:
        # entropy-scaled dynamic temperature (llama_sampler_init_temp_ext)
        # lo, hi and hi - lo in f32, as the JAX package rounds them
        lo = np.float32(max(0.0, p.temp - p.dynatemp_range))
        span = float(np.float32(p.temp + p.dynatemp_range) - lo)
        _, _, ent = _entropy(logits)
        n_valid = (logits > NEG_INF).sum().to(torch.float32)
        max_ent = torch.log(torch.clamp(n_valid, min=2.0))
        dyn = float(lo) + span * torch.pow(ent / max_ent, p.dynatemp_exponent)
        return logits / torch.clamp(dyn, min=1e-6)
    if p.temp > 0.0:
        return logits / p.temp
    return logits


def gumbel_noise(n: int, generator: torch.Generator | None,
                 device) -> torch.Tensor:
    """[n] f32 Gumbel noise, -log(-log(u)) with u uniform in [tiny, 1):
    `jax.random.gumbel`'s law."""
    u = torch.empty(n, dtype=torch.float32, device=device).uniform_(
        TINY, 1.0, generator=generator)
    return u.log_().neg_().log_().neg_()


def uniform(generator: torch.Generator | None, device) -> torch.Tensor:
    """One f32 uniform in [0, 1), a 0-d tensor on `device`."""
    return torch.rand((), dtype=torch.float32, device=device,
                      generator=generator)


# ---------------------------------------------------------------------------
# mirostat (stateful: mu carries across steps)
# ---------------------------------------------------------------------------

def mirostat_init(params: SamplerParams, device=None) -> torch.Tensor:
    return torch.tensor(2.0 * params.mirostat_tau, dtype=torch.float32,
                        device=device)


_LN2 = torch.log(torch.tensor(2.0)).item()


def sample_mirostat_v2(logits: torch.Tensor, gumbel: torch.Tensor,
                       mu: torch.Tensor, params: SamplerParams):
    """Mirostat v2: truncate the candidates whose surprise exceeds mu,
    draw, then mu -= eta * (surprise - tau). Returns (token, new mu)."""
    logits = logits / max(params.temp, 1e-6)
    surprise = -torch.log_softmax(logits, -1) / _LN2
    top = torch.argmax(logits)
    keep = (surprise <= mu).scatter(0, top[None], True)  # never empty
    tok = torch.argmax(logits.masked_fill(~keep, NEG_INF) + gumbel)
    obs = surprise.gather(0, tok[None])[0]  # no host read of `tok`
    return tok, mu - params.mirostat_eta * (obs - params.mirostat_tau)


def sample_mirostat_v1(logits: torch.Tensor, gumbel: torch.Tensor,
                       mu: torch.Tensor, params: SamplerParams,
                       n_probs: int = 100):
    """Mirostat v1: estimate the Zipf exponent s_hat from the top
    candidates, derive k, then draw from the top k and update mu."""
    n_vocab = logits.shape[-1]
    m = min(n_probs, n_vocab)
    logits = logits / max(params.temp, 1e-6)
    probs = torch.softmax(torch.topk(logits, m).values, -1)
    i = torch.arange(m - 1, dtype=torch.float32, device=logits.device)
    t_i = torch.log((i + 2.0) / (i + 1.0))
    b_i = torch.log(torch.clamp(probs[:-1], min=1e-30)
                    / torch.clamp(probs[1:], min=1e-30))
    s_hat = (t_i * b_i).sum() / torch.clamp((t_i * t_i).sum(), min=1e-9)
    eps = s_hat - 1.0
    k = torch.pow(
        (eps * torch.pow(torch.full_like(mu, 2.0), mu))
        / torch.clamp(1.0 - torch.pow(torch.full_like(eps, float(n_vocab)),
                                      -eps), min=1e-9),
        1.0 / torch.clamp(s_hat, min=1e-6))
    k = torch.clamp(k, 1, n_vocab).to(torch.int32)
    # dynamic-k truncation by rank
    order = torch.sort(-logits, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(n_vocab, device=logits.device))
    tok = torch.argmax(logits.masked_fill(rank >= k, NEG_INF) + gumbel)
    obs = -torch.log_softmax(logits, -1).gather(0, tok[None])[0] / _LN2
    return tok, mu - params.mirostat_eta * (obs - params.mirostat_tau)


def sample(logits: torch.Tensor, params: SamplerParams,
           prev_tokens: torch.Tensor | None = None,
           mu: torch.Tensor | None = None,
           generator: torch.Generator | None = None,
           gumbel: torch.Tensor | None = None,
           xtc_u: torch.Tensor | None = None):
    """Run the chain on one [vocab] f32 row and draw a token id (a 0-d
    int64 tensor on the row's device). With mirostat on and `mu` given,
    returns (token, new mu). The Gumbel noise and XTC's uniform are
    `gumbel` and `xtc_u` where given, else drawn from `generator`."""
    logits = logits.to(torch.float32)
    logits = apply_logit_bias(logits, params.logit_bias)
    if params.needs_penalties and prev_tokens is not None:
        logits = apply_penalties(logits, prev_tokens, params)
    if params.needs_dry and prev_tokens is not None:
        logits = apply_dry(logits, prev_tokens, params)

    if params.greedy or params.temp <= 0.0:
        tok = torch.argmax(logits)
        return (tok, mu) if mu is not None else tok

    def noise():
        return (gumbel if gumbel is not None
                else gumbel_noise(logits.shape[-1], generator, logits.device))

    if params.mirostat and mu is not None:
        fn = sample_mirostat_v1 if params.mirostat == 1 else sample_mirostat_v2
        return fn(logits, noise(), mu, params)

    logits = apply_top_n_sigma(logits, params.top_n_sigma)
    logits = apply_top_k(logits, params.top_k)
    logits = apply_typical(logits, params.typical_p)
    logits = apply_top_p(logits, params.top_p)
    logits = apply_min_p(logits, params.min_p)
    if params.xtc_probability > 0.0:
        u = xtc_u if xtc_u is not None else uniform(generator, logits.device)
        logits = apply_xtc(logits, u, params)
    logits = apply_temp(logits, params)
    tok = torch.argmax(logits + noise())
    return (tok, mu) if mu is not None else tok


def update_prev_tokens(prev: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """Shift the penalty ring by one token."""
    return torch.cat([prev[1:], token.reshape(1).to(prev.dtype)])


def top_logprobs(logits: torch.Tensor, n: int):
    """The n largest log-probabilities of one logits row and their ids
    (llama-server's n_probs): log_softmax, then top-k, on the row's device.
    Returns (values [n] f32, ids [n] int64)."""
    v, i = torch.topk(torch.log_softmax(logits.to(torch.float32), -1), n)
    return v, i


def apply_infill_host(logits, eog_ids, token_text, top_k: int = 40):
    """Fill-in-middle candidate filter (reference llama_sampler_infill,
    llama-sampling.cpp:2408-2560), host-side over the top-k candidate set
    (the reference runs it after the truncating samplers in the chain):

    1. EOG-dominance switch: if 3*p_eog*n > p_txt, keep only EOG tokens.
    2. Merge candidates whose text is a prefix of another candidate's text
       into the higher-probability one.
    3. Drop non-EOG candidates below p=0.2; if none survive, collapse to a
       single EOG token.

    Returns (ids int32 [m], probs f32 [m]) renormalized, ready to draw.
    A copy of the JAX package's function (host numpy, no device work).
    """
    lg = np.asarray(logits, np.float32)
    k = min(top_k, lg.shape[0])
    ids = np.argpartition(-lg, k - 1)[:k]
    ids = ids[np.argsort(-lg[ids])]
    z = lg[ids] - lg[ids].max()
    p = np.exp(z)
    p /= p.sum()
    is_eog = np.array([int(i) in eog_ids for i in ids])

    p_eog, p_txt = float(p[is_eog].sum()), float(p[~is_eog].sum())
    if 3.0 * p_eog * len(ids) > p_txt:
        ids, p = ids[is_eog], p[is_eog]
        return ids.astype(np.int32), (p / p.sum()).astype(np.float32)

    texts = [token_text(int(i)) if not e else None
             for i, e in zip(ids, is_eog)]
    alive = np.ones(len(ids), bool)
    for i0 in range(len(ids)):
        for i1 in range(len(ids)):
            if i0 == i1 or not alive[i0] or not alive[i1]:
                continue
            t0, t1 = texts[i0], texts[i1]
            if t0 and t1 and len(t0) <= len(t1) and t1.startswith(t0):
                dst, src = (i0, i1) if p[i0] >= p[i1] else (i1, i0)
                p[dst] += p[src]
                p[src] = 0.0
                alive[src] = False

    keep = alive & (is_eog | (p >= 0.2))
    if not (keep & ~is_eog).any():  # no non-EOG survivors -> single EOG
        eid = next(iter(eog_ids)) if eog_ids else int(ids[0])
        return (np.array([eid], np.int32), np.array([1.0], np.float32))
    ids, p = ids[keep], p[keep]
    return ids.astype(np.int32), (p / p.sum()).astype(np.float32)
