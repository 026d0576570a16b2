"""Continuous batching over the unified KV cache (counterpart of
omni_tpu/runtime/slots.py, itself the counterpart of llama-server's slot
scheduler, tools/server/server.cpp:1618 server_slot, :2508-2548 n_parallel
slots sharing one context, :2560-2564 unified batch, :3683-3692 prompt
batching): N slots map to N sequence ids in ONE KVCache; every scheduler
iteration assembles a mixed ubatch — prompt tokens from slots still
prefilling (up to n_batch) plus one token for each generating slot — runs
ONE decode, then samples per slot. Slot release frees its sequence's cells.

A ubatch of M <= 8 rows runs its quantized matmuls through the decode
kernels (A, C), a larger one through the prefill kernels (B, D): the
dispatcher's `kernel_for`, as in the JAX package. Each slot draws from its
own device `torch.Generator`, seeded with seed + slot id where the JAX slot
seeds `PRNGKey(seed + id)`, and keeps its own penalty ring. A step samples
every slot on the device and fetches the tokens (and the n_probs rows) with
one host copy; grammar masks and the infill filter are host work, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Callable

import numpy as np
import torch

from .context import Batch, Context, KVCacheFull
from .sampler import (SamplerParams, apply_allowed_mask, apply_infill_host,
                      sample, top_logprobs, update_prev_tokens)


class SlotState(enum.Enum):
    IDLE = 0
    PROCESSING_PROMPT = 1
    GENERATING = 2
    DONE = 3


@dataclasses.dataclass
class Slot:
    id: int
    state: SlotState = SlotState.IDLE
    prompt: np.ndarray | None = None
    n_prompt_done: int = 0
    n_past: int = 0
    n_decoded: int = 0
    max_new: int = 128
    sampler: SamplerParams = dataclasses.field(default_factory=SamplerParams)
    prev_tokens: torch.Tensor | None = None  # the penalty ring, on the device
    generator: torch.Generator | None = None  # seeded with seed + id
    out_tokens: list = dataclasses.field(default_factory=list)
    stop_tokens: tuple = ()
    on_token: Callable | None = None  # streaming callback(token_id, text_done)
    grammar: Any = None  # omni_tpu_torch.grammar.Grammar (constrained decoding)
    # lazy grammar (reference grammar_triggers, common/chat.cpp): the
    # constraint stays dormant until a trigger word appears in the output,
    # then activates from the trigger's first character
    grammar_lazy: bool = False
    grammar_triggers: tuple = ()
    grammar_active: bool = True
    grammar_buf: str = ""
    infill: bool = False  # FIM EOG-merge sampler (llama_sampler_infill)
    n_probs: int = 0  # top-n token logprobs per step (server n_probs)
    probs_out: list = dataclasses.field(default_factory=list)
    n_keep: int = 0  # positions protected from context shift
    n_shifted: int = 0  # total positions discarded by context shifts
    t_start: float = 0.0
    t_first_token: float = 0.0


def check_lazy_trigger(buf: str, triggers: tuple) -> int | None:
    """Earliest index in `buf` where any trigger word starts, or None.
    The grammar activates FROM the trigger itself (the reference's
    COMMON_GRAMMAR_TRIGGER_TYPE_WORD semantics)."""
    best = None
    for t in triggers:
        at = buf.find(t)
        if at != -1 and (best is None or at < best):
            best = at
    return best


class SlotScheduler:
    """Drives continuous batching on one Context."""

    def __init__(self, ctx: Context, n_slots: int = 4, n_batch: int = 256,
                 vocab_trie=None, token_text: Callable | None = None,
                 ctx_shift: bool = True):
        self.ctx = ctx
        self.n_batch = n_batch
        self.slots = [Slot(id=i) for i in range(n_slots)]
        # grammar-constrained decoding support (omni_tpu_torch.grammar)
        self.vocab_trie = vocab_trie
        self.token_text = token_text
        # per-slot position budget (reference: n_ctx / n_parallel,
        # tools/server/server.cpp:2508-2548) and shift-on-full policy
        # (server.cpp:2872, :3580-3590 n_discard)
        self.n_ctx_slot = max(ctx.n_ctx // max(n_slots, 1), 8)
        self.ctx_shift = ctx_shift

    # ------------------------------------------------------------- control
    def launch(self, prompt_tokens, max_new: int = 128,
               sampler: SamplerParams | None = None,
               stop_tokens: tuple = (), on_token=None,
               grammar=None, n_probs: int = 0,
               infill: bool = False,
               grammar_lazy: bool = False,
               grammar_triggers: tuple = ()) -> Slot | None:
        """Assign a request to a free slot (launch_slot_with_task)."""
        if len(prompt_tokens) >= self.n_ctx_slot:
            raise ValueError(
                f"prompt of {len(prompt_tokens)} tokens exceeds the per-slot "
                f"context budget {self.n_ctx_slot} (n_ctx/n_slots)")
        dev = self.ctx.device
        for s in self.slots:
            if s.state == SlotState.IDLE:
                if self.ctx.n_past.get(s.id):  # stale KV kept from last task
                    self.ctx.seq_rm(s.id, -1, -1)
                    self.ctx.n_past.pop(s.id, None)
                s.state = SlotState.PROCESSING_PROMPT
                s.prompt = np.asarray(prompt_tokens, np.int32)
                s.n_prompt_done = 0
                s.n_past = 0
                s.n_decoded = 0
                s.max_new = max_new
                s.sampler = sampler or SamplerParams()
                s.prev_tokens = torch.full((max(s.sampler.penalty_last_n, 1),),
                                           -1, dtype=torch.int64, device=dev)
                s.generator = torch.Generator(device=dev).manual_seed(
                    s.sampler.seed + s.id)
                s.out_tokens = []
                s.stop_tokens = tuple(stop_tokens)
                s.on_token = on_token
                s.grammar = grammar.copy() if grammar is not None else None
                s.grammar_lazy = grammar_lazy
                s.grammar_triggers = tuple(grammar_triggers)
                s.grammar_active = not grammar_lazy
                s.grammar_buf = ""
                s.infill = infill
                s.n_probs = n_probs
                s.probs_out = []
                s.t_start = time.time()
                return s
        return None

    def release(self, slot: Slot, free_kv: bool = True) -> None:
        """free_kv=False keeps the sequence's cells (the reference keeps a
        released slot's prompt cache for reuse / slot-save until the slot is
        relaunched)."""
        if free_kv:
            self.ctx.seq_rm(slot.id, -1, -1)
            self.ctx.n_past.pop(slot.id, None)
        slot.state = SlotState.IDLE
        slot.prompt = None

    def has_work(self) -> bool:
        return any(s.state in (SlotState.PROCESSING_PROMPT, SlotState.GENERATING)
                   for s in self.slots)

    # ----------------------------------------------------------- main loop
    def assemble(self):
        """The step's mixed ubatch: (tokens, pos, seq, want_logits) with
        want_logits the (slot, row) pairs to sample, advancing each slot's
        prompt cursor and n_past (a slot at its budget shifts or stops)."""
        tokens, pos, seq, want_logits = [], [], [], []
        for s in self.slots:
            if s.state == SlotState.PROCESSING_PROMPT:
                room = self.n_batch - len(tokens)
                if room <= 0:
                    continue
                part = s.prompt[s.n_prompt_done : s.n_prompt_done + room]
                tokens.extend(part.tolist())
                pos.extend(range(s.n_past, s.n_past + len(part)))
                seq.extend([s.id] * len(part))
                s.n_prompt_done += len(part)
                s.n_past += len(part)
                if s.n_prompt_done >= len(s.prompt):
                    s.state = SlotState.GENERATING
                    want_logits.append((s, len(tokens) - 1))
            elif s.state == SlotState.GENERATING and s.out_tokens:
                if s.n_past + 1 > self.n_ctx_slot:
                    # slot hit its context budget: shift (discard the oldest
                    # half past n_keep, re-base positions) or stop — never
                    # overflow silently (server.cpp:2872, :3580-3590)
                    if not self.ctx_shift:
                        s.state = SlotState.DONE
                        if s.on_token is not None:
                            s.on_token(s.out_tokens[-1], True)
                        continue
                    self._context_shift(s)
                tokens.append(s.out_tokens[-1])
                pos.append(s.n_past)
                seq.append(s.id)
                s.n_past += 1
                want_logits.append((s, len(tokens) - 1))
        return tokens, pos, seq, want_logits

    def step(self) -> None:
        """One update_slots iteration: assemble mixed batch, decode, sample."""
        tokens, pos, seq, want_logits = self.assemble()
        if not tokens:
            return
        batch = Batch(tokens=np.asarray(tokens, np.int32),
                      pos=np.asarray(pos, np.int32),
                      seq_id=np.asarray(seq, np.int32))
        try:
            logits, _ = self.ctx.decode(batch, block=False)
        except KVCacheFull:
            # the POOL is full even though slots are inside their budgets —
            # reclaim KV kept by idle slots (prompt-cache reuse), retry once
            if self.reclaim_idle_kv() == 0:
                raise
            logits, _ = self.ctx.decode(batch, block=False)

        # sample every slot on the device; one fetch brings back each slot's
        # token and n_probs (ids, logprobs) as f64 (ids below 2^53 exact)
        picks, parts = [], []
        for s, row in want_logits:
            lg = logits[row]
            if (s.grammar is not None and s.grammar_active
                    and self.vocab_trie is not None):
                trie = (self.vocab_trie() if callable(self.vocab_trie)
                        else self.vocab_trie)
                allowed = s.grammar.allowed_tokens(trie)
                if s.grammar.eos_allowed:
                    allowed = list(allowed) + [t for t in s.stop_tokens]
                if not allowed:  # parse complete and nothing else legal
                    allowed = list(s.stop_tokens) or [0]
                lg = apply_allowed_mask(lg, torch.as_tensor(
                    allowed, dtype=torch.int64, device=lg.device))
            if s.infill and self.token_text is not None:
                ids, probs = apply_infill_host(
                    lg.float().cpu().numpy(), set(s.stop_tokens),
                    self.token_text,
                    top_k=s.sampler.top_k if s.sampler.top_k > 0 else 40)
                if s.sampler.greedy or s.sampler.temp <= 0:
                    pick = int(np.argmax(probs))
                else:
                    pick = int(torch.multinomial(
                        torch.as_tensor(probs, device=lg.device), 1,
                        generator=s.generator))
                tok = torch.full((), int(ids[pick]), dtype=torch.int64,
                                 device=lg.device)
            else:
                tok = sample(lg, s.sampler, s.prev_tokens, generator=s.generator)
            s.prev_tokens = update_prev_tokens(s.prev_tokens, tok)
            parts.append(tok.reshape(1).to(torch.float64))
            if s.n_probs > 0:  # top-n logprobs (llama-server n_probs)
                top_v, top_i = top_logprobs(lg, s.n_probs)
                parts += [top_i.to(torch.float64), top_v.to(torch.float64)]
            picks.append(s)
        if not picks:  # only prompt rows, none of them a prompt's last
            return
        fetched = torch.cat(parts).cpu().numpy()

        at = 0
        for s in picks:
            tok = int(fetched[at])
            at += 1
            if s.n_probs > 0:
                top_i = fetched[at:at + s.n_probs]
                top_v = fetched[at + s.n_probs:at + 2 * s.n_probs]
                at += 2 * s.n_probs
                s.probs_out.append([(int(i), float(np.float32(v)))
                                    for i, v in zip(top_i, top_v)])
            if (s.grammar is not None and self.token_text is not None
                    and tok not in s.stop_tokens):
                if s.grammar_active:
                    s.grammar.accept(self.token_text(tok))
                else:  # dormant: watch the emitted text for a trigger
                    s.grammar_buf += self.token_text(tok)
                    hit = check_lazy_trigger(s.grammar_buf,
                                             s.grammar_triggers)
                    if hit is not None:
                        s.grammar_active = True
                        s.grammar.accept(s.grammar_buf[hit:])
                        s.grammar_buf = ""
            if s.n_decoded == 0:
                s.t_first_token = time.time()
            s.n_decoded += 1
            stopped = tok in s.stop_tokens or s.n_decoded >= s.max_new
            if s.grammar is not None and s.grammar.exhausted:
                stopped = True
            if tok not in s.stop_tokens:
                s.out_tokens.append(tok)
            if s.on_token is not None:
                s.on_token(tok, stopped)
            if stopped:
                s.state = SlotState.DONE

    def _context_shift(self, s: Slot) -> None:
        """Discard the oldest (n_past - n_keep)/2 positions of the slot's
        sequence and re-base the rest (n_discard semantics of the reference
        server; seq_add applies the K re-rotation)."""
        n_keep = min(max(s.n_keep, 0), s.n_past)
        n_discard = max((s.n_past - n_keep) // 2, 1)
        self.ctx.seq_rm(s.id, n_keep, n_keep + n_discard)
        self.ctx.seq_add(s.id, n_keep + n_discard, s.n_past, -n_discard)
        s.n_past -= n_discard
        s.n_shifted += n_discard

    def reclaim_idle_kv(self) -> int:
        """Free KV cells kept by IDLE slots (released with free_kv=False for
        prompt-cache reuse); returns the number of slots reclaimed."""
        n = 0
        for s in self.slots:
            if s.state == SlotState.IDLE and self.ctx.n_past.get(s.id):
                self.ctx.seq_rm(s.id, -1, -1)
                self.ctx.n_past.pop(s.id, None)
                n += 1
        return n

    def run_until_done(self, max_iters: int = 100000) -> None:
        for _ in range(max_iters):
            if not self.has_work():
                break
            self.step()

    # ------------------------------------------------------------- metrics
    def metrics(self) -> dict:
        return {
            "slots_idle": sum(1 for s in self.slots if s.state == SlotState.IDLE),
            "slots_processing": sum(1 for s in self.slots
                                    if s.state != SlotState.IDLE),
            "kv_cells_used": self.ctx.cache.n_used(),
            "kv_cells_total": self.ctx.cache.size,
        }
