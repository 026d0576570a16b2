"""The served decode loop (counterpart of omni_tpu/runtime/loop.py).

`omni_decode_scan` runs up to n_steps sample → classify → decode steps with
every value that decides the next step (token, logits, position, the done
flag) left on the device: the host enqueues the whole chunk without one
sync, and fetches its results once. The JAX package fuses the chunk into
one `lax.scan`; here it is a Python loop of the same n_steps (CUDA graphs
are for a later version).
"""

from __future__ import annotations

from typing import Callable

import torch

from .kv_cache import KVCache
from .sampler import SamplerParams, sample


def omni_decode_scan(forward: Callable, embed: Callable, cfg, params: dict,
                     cache: KVCache,
                     last_logits: torch.Tensor,  # [vocab] f32
                     start_pos: torch.Tensor,  # [] int
                     seq_id: int,
                     prev_tokens: torch.Tensor,  # [W] int penalty ring
                     n_steps: int, sp: SamplerParams,
                     end_ids: tuple[int, ...] = (), listen_id: int = -3,
                     stop_after: int | None = None,
                     done_in: torch.Tensor | None = None,
                     kv_limit: int | None = None):
    """Up to n_steps decode steps; the scan freezes at the first end or
    listen token, or once `stop_after` tokens were sampled. The terminal
    token is sampled but never fed into the KV. `done_in` chains the frozen
    flag from a prior chunk, so a chunk issued before its predecessor's
    results are read is a no-op when the turn already ended.

    Returns (packed [2, n_steps] = stacked (tokens, fed), hiddens
    [n_steps, d], last logits, cache, prev_tokens, pos_out, done_out).
    Every step runs the forward (a frozen step with write_mask False), as
    the scan does."""
    dev = last_logits.device
    end_arr = torch.tensor(end_ids if end_ids else (-2,), device=dev)
    if stop_after is None:
        stop_after = n_steps
    done = (done_in if done_in is not None
            else torch.zeros((), dtype=torch.bool, device=dev))
    all_slots = cache.find_slots(n_steps)
    seq = torch.full((1,), seq_id, dtype=torch.int64, device=dev)
    logits = last_logits.to(torch.float32)
    pos = torch.as_tensor(start_pos, dtype=torch.int64, device=dev)
    prev = prev_tokens
    toks, feds, hiddens = [], [], []
    for i in range(n_steps):
        tok = sample(logits, sp, prev)
        stop_now = done | (end_arr == tok).any() | (tok == listen_id)
        if i >= stop_after:
            stop_now = torch.ones_like(stop_now)
        feed = ~stop_now
        # ring update for every sampled token while live
        prev = torch.where(done, prev, torch.cat([prev[1:], tok[None]]))
        kw = {"kv_limit": kv_limit} if kv_limit is not None else {}
        new_logits, hidden, cache = forward(
            params, cfg, embed(params, tok[None]), pos[None], seq, cache,
            all_slots[i:i + 1], feed[None], **kw)
        logits = torch.where(feed, new_logits[0], logits)
        pos = pos + feed.to(pos.dtype)
        done = stop_now
        toks.append(tok)
        feds.append(feed)
        hiddens.append(hidden[0])
    packed = torch.stack([torch.stack(toks),
                          torch.stack(feds).to(torch.int64)])
    return packed, torch.stack(hiddens), logits, cache, prev, pos, done
