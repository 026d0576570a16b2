"""The decode loops (counterpart of omni_tpu/runtime/loop.py).

`omni_decode_scan` runs up to n_steps sample → classify → decode steps with
every value that decides the next step (token, logits, position, the done
flag) left on the device: the host enqueues the whole chunk without one
sync, and fetches its results once. The JAX package fuses the chunk into
one `lax.scan`; here it is a Python loop of the same n_steps (CUDA graphs
are for a later version). The sampler's noise comes from a
`torch.Generator` on the device, so a stochastic chunk stays sync-free too.

`decode_scan` is the plain fixed-length loop (greedy or temperature/top-k)
and `fused_generate` the host driver of single-stream serving on a
`Context`, chunk by chunk.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from .kv_cache import KVCache
from .sampler import SamplerParams, _const, sample


def _scalar(n: int, device) -> torch.Tensor:
    """A 0-d int64 tensor holding `n`, filled on the device: a copy from
    the host would synchronize with the card's queue."""
    return torch.full((), n, dtype=torch.int64, device=device)


def decode_scan(forward: Callable, embed: Callable, cfg, params: dict,
                cache: KVCache,
                first_token: torch.Tensor,  # [] int, already sampled
                start_pos: torch.Tensor,  # [] int
                seq_id: int,
                generator: torch.Generator | None,
                n_steps: int, greedy: bool = True, temp: float = 0.8,
                top_k: int = 40):
    """n_steps single-token decode steps, each feeding the token sampled
    by the one before. Returns (tokens fed [n_steps], tokens sampled
    [n_steps], hiddens [n_steps, d], cache)."""
    sp = SamplerParams(greedy=greedy, temp=temp, top_k=top_k)
    dev = cache.pos.device
    # one find_slots for the chunk: nothing frees cells inside it
    all_slots = cache.find_slots(n_steps)
    seq = torch.full((1,), seq_id, dtype=torch.int64, device=dev)
    tok = torch.as_tensor(first_token, dtype=torch.int64, device=dev)
    pos = torch.as_tensor(start_pos, dtype=torch.int64, device=dev)
    toks, nxts, hiddens = [], [], []
    for i in range(n_steps):
        logits, hidden, cache = forward(params, cfg, embed(params, tok[None]),
                                        pos[None], seq, cache,
                                        all_slots[i:i + 1])
        nxt = sample(logits[0], sp, generator=generator)
        toks.append(tok)
        nxts.append(nxt)
        hiddens.append(hidden[0])
        tok, pos = nxt, pos + 1
    return torch.stack(toks), torch.stack(nxts), torch.stack(hiddens), cache


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
                     kv_limit: int | None = None,
                     generator: torch.Generator | None = None):
    """Up to n_steps decode steps; the scan freezes at the first end or
    listen token, or once `stop_after` tokens were sampled. The terminal
    token is sampled but never fed into the KV. `done_in` chains the frozen
    flag from a prior chunk, so a chunk issued before its predecessor's
    results are read is a no-op when the turn already ended. The sampler
    draws its noise from `generator` (the context's, on the device).

    Returns (packed [2, n_steps] = stacked (tokens, fed), hiddens
    [n_steps, d], last logits, cache, prev_tokens, pos_out, done_out).
    Every step runs the forward (a frozen step with write_mask False), as
    the scan does."""
    dev = last_logits.device
    # made once per (ids, device): a fresh copy would wait for the queue
    end_arr = _const(tuple(end_ids) or (-2,), torch.int64, dev)
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
        tok = sample(logits, sp, prev, generator=generator)
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


def fused_generate(ctx, last_logits, seq_id: int, max_new: int,
                   stop_tokens: tuple[int, ...] = (), chunk: int = 32,
                   on_token: Callable | None = None,
                   sampler: SamplerParams | None = None,
                   lock=None, pre_chunk: Callable | None = None) -> list[int]:
    """Host driver of single-stream serving on a Context: chunks of `chunk`
    tokens through omni_decode_scan, one host fetch a chunk. Per-request
    sampler state (a generator seeded from seed + seq_id and a fresh
    penalty ring, like a slot launch); `lock` (if given) is held per chunk
    only. Stops on stop_tokens or max_new; the stop token is not in the
    output (Context.generate's rule). on_token(tok, finished) streams."""
    from .context import KVCacheFull

    sp = sampler or ctx.sampler
    guard = lock if lock is not None else contextlib.nullcontext()
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(sp.seed + seq_id)
    prev = torch.full((max(sp.penalty_last_n, 1),), -1, dtype=torch.int64,
                      device=dev)
    out: list[int] = []
    pending: list[int] = []  # one-token delay so the last carries finished
    logits = torch.as_tensor(last_logits, device=dev)
    while len(out) < max_new:
        budget = max_new - len(out)
        with guard:
            if pre_chunk is not None:
                pre_chunk()  # e.g. a context shift before the chunk
            free = ctx.cache.size - ctx.cells_used
            if free < chunk:  # the scan takes `chunk` slots up front
                raise KVCacheFull(
                    f"fused_generate: need {chunk} free KV cells, have {free}")
            kvb = ctx.kv_bucket(max(ctx.kv_high, ctx.cells_used) + chunk)
            packed, _, logits, ctx.cache, prev, _, _ = omni_decode_scan(
                ctx._forward, ctx._embed, ctx.cfg, ctx.params, ctx.cache,
                logits, _scalar(ctx.n_past.get(seq_id, 0), dev),
                seq_id, prev, n_steps=chunk, sp=sp, end_ids=tuple(stop_tokens),
                stop_after=min(budget, chunk), kv_limit=kvb, generator=gen)
            packed_np = packed.cpu().numpy()  # one fetch: (toks, fed)
            toks_np = packed_np[0]
            n_fed = int(packed_np[1].sum())
            ctx.n_past[seq_id] = ctx.n_past.get(seq_id, 0) + n_fed
            ctx.cells_used += n_fed
            ctx.kv_high = max(ctx.kv_high, ctx.cells_used)
        # the fed tokens are the output; the first unfed one is a stop
        # token (left out, as Context.generate does) or the budget stop
        for t in toks_np[:n_fed]:
            out.append(int(t))
            if on_token is not None:
                if pending:
                    on_token(pending.pop(), False)
                pending.append(int(t))
        if n_fed < chunk:
            break
    if on_token is not None and pending:
        on_token(pending.pop(), True)
    return out

