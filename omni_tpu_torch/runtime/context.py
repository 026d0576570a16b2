"""Decode engine (counterpart of omni_tpu/runtime/context.py, itself the
counterpart of llama_context): owns the parameters, the unified KV cache
and the ubatch / kv-read buckets. A `Batch` mirrors llama_batch: token ids
or embeddings, with explicit positions and sequence ids. Every step returns
logits and the last hidden states."""

from __future__ import annotations

import dataclasses
import io
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from .kv_cache import KVCache
from .sampler import SamplerParams, mirostat_init, sample, update_prev_tokens

# ubatch padding buckets (the JAX package compiles one step per bucket; the
# port keeps them so both pad, and so place cells, identically)
BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


def _bucket(n: int, buckets: tuple[int, ...] = BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    step = max(buckets[-1], 1)
    return ((n + step - 1) // step) * step


@dataclasses.dataclass
class Batch:
    """Token-or-embedding ubatch (contract of llama_batch)."""

    tokens: np.ndarray | None = None  # [T] int
    embeds: np.ndarray | torch.Tensor | None = None  # [T, d] float
    pos: np.ndarray | None = None  # [T] int; default = continue the seq
    seq_id: np.ndarray | None = None  # [T] int; default = 0

    def __len__(self) -> int:
        return len(self.tokens) if self.tokens is not None else len(self.embeds)


class KVCacheFull(RuntimeError):
    """A decode would exceed the KV cell pool (silent cell aliasing is
    never acceptable)."""


class Context:
    """One model instance + its KV cache."""

    def __init__(self, cfg, params: dict, forward_fn: Callable,
                 embed_fn: Callable, n_ctx: int = 4096,
                 sampler: SamplerParams | None = None,
                 buckets: tuple[int, ...] = BUCKETS, device=None,
                 kv_dtype=torch.bfloat16):
        """`kv_dtype` is the cell type of the KV pool, as `KVCache.create`
        takes it: torch.bfloat16 (or "bf16"), "q8_0" (or torch.int8) or
        "q4_0" — the server's `--cache-type-k`, which quantizes K and V
        alike."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self._forward = forward_fn
        self._embed = embed_fn
        self.n_ctx = n_ctx
        self.cache = KVCache.create(cfg.n_layers, n_ctx, cfg.n_kv_heads,
                                    cfg.head_dim, self.device, dtype=kv_dtype,
                                    rope_base=cfg.rope_base)
        self.sampler = sampler or SamplerParams()
        # the sampler's randomness: a generator on the device, seeded as the
        # JAX Context seeds its key (the streams differ; the law is the same)
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.sampler.seed)
        self.prev_tokens = torch.full((max(self.sampler.penalty_last_n, 1),),
                                      -1, dtype=torch.int64,
                                      device=self.device)
        self.mu = (mirostat_init(self.sampler, self.device)
                   if self.sampler.mirostat else None)
        self.n_past: dict[int, int] = {}  # per-seq position high-water mark
        # host shadow of the occupied-cell count: guards pool overflow with
        # no device sync on the hot path
        self.cells_used = 0
        self.buckets = tuple(sorted(buckets))
        # ragged-KV read bound: with low-first find_slots the highest
        # occupied cell stays below max(kv_high, cells_used)
        self.kv_high = 0
        self.kv_buckets = tuple(
            b for b in (512, 1024, 2048, 4096, 8192, 16384, 32768)
            if b < n_ctx) + (n_ctx,)

    def kv_bucket(self, need: int) -> int | None:
        """Smallest kv-read bucket covering `need` cells (None = the whole
        pool)."""
        for b in self.kv_buckets:
            if b >= need:
                return b if b < self.cache.size else None
        return None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def decode(self, batch: Batch, return_hidden: bool = False,
               block: bool = True):
        """Run one ubatch. Returns (logits [T, vocab], hidden or None).
        block=False returns without waiting for the device."""
        t = len(batch)
        tb = _bucket(t, self.buckets)
        free = self.cache.size - self.cells_used
        if tb > free:
            raise KVCacheFull(
                f"KV pool exhausted: batch of {t} (padded to {tb}) needs "
                f"{tb} free cells, have {free} of {self.cache.size}; "
                f"free cells with seq_rm first")
        pos = batch.pos if batch.pos is not None else self._auto_pos(batch)
        seq = (batch.seq_id if batch.seq_id is not None
               else np.zeros(t, np.int32))
        dev = self.device
        if batch.tokens is not None:
            toks = np.pad(np.asarray(batch.tokens, np.int64), (0, tb - t))
            x = self._embed(self.params, torch.as_tensor(toks, device=dev))
        else:
            e = torch.as_tensor(batch.embeds, device=dev).to(torch.bfloat16)
            x = torch.nn.functional.pad(e, (0, 0, 0, tb - t))
        pos_p = torch.as_tensor(np.pad(np.asarray(pos, np.int64), (0, tb - t)),
                                device=dev)
        seq_p = torch.as_tensor(np.pad(np.asarray(seq, np.int64), (0, tb - t)),
                                device=dev)
        wmask = torch.as_tensor(np.arange(tb) < t, device=dev)
        # the full pool: ragged reads are the decode loop's (as in the JAX
        # package, where they are opt-in for the bucketed steps)
        slots = self.cache.find_slots(tb)
        logits, hidden, self.cache = self._forward(
            self.params, self.cfg, x, pos_p, seq_p, self.cache, slots, wmask)
        if block:
            self._sync()
        self.cells_used += t  # valid rows only; padding cells stay free
        self.kv_high = max(self.kv_high, self.cells_used)
        seq_np, pos_np = np.asarray(seq), np.asarray(pos)
        for s in np.unique(seq_np):
            if s < 0:  # packed multi-membership rows keep their own books
                continue
            mx = int(np.max(pos_np[seq_np == s]))
            self.n_past[int(s)] = max(self.n_past.get(int(s), 0), mx + 1)
        if return_hidden:
            return logits[:t], hidden[:t]
        return logits[:t], None

    def _auto_pos(self, batch: Batch) -> np.ndarray:
        seq = (batch.seq_id if batch.seq_id is not None
               else np.zeros(len(batch), np.int32))
        pos = np.zeros(len(batch), np.int32)
        counters = dict(self.n_past)
        for i, s in enumerate(np.asarray(seq)):
            pos[i] = counters.get(int(s), 0)
            counters[int(s)] = pos[i] + 1
        return pos

    # ---- KV session ops (llama_memory_* counterparts) ----------------------
    # Each re-syncs the host shadows cells_used and kv_high exactly where
    # the JAX Context does (omni_tpu/runtime/context.py:311-358).
    def sync_cells_used(self) -> int:
        """Re-sync the host-side occupied-cell count from the device (one
        transfer; cold paths only), and the ragged-KV high-water mark
        exactly (the highest occupied cell index + 1)."""
        occupied = self.cache.seq_mask != 0
        idx = torch.arange(1, self.cache.size + 1, device=occupied.device)
        used, high = torch.stack([occupied.sum(),
                                  torch.where(occupied, idx, 0).max()]).tolist()
        self.cells_used, self.kv_high = int(used), int(high)
        return self.cells_used

    def seq_rm(self, seq_id: int, p0: int = -1, p1: int = -1) -> None:
        self.cache.seq_rm(seq_id, p0, p1)
        self.sync_cells_used()

    def seq_cp(self, seq_src: int, seq_dst: int, p0: int = -1,
               p1: int = -1) -> None:
        self.cache.seq_cp(seq_src, seq_dst, p0, p1)  # occupies no new cell

    def seq_rm_all(self, p0: int = -1, p1: int = -1) -> None:
        """llama_memory_seq_rm(seq = -1): drop positions from every seq."""
        self.cache.seq_rm_all(p0, p1)
        self.sync_cells_used()

    def seq_keep(self, seq_id: int) -> None:
        self.cache.seq_keep(seq_id)
        self.sync_cells_used()

    def seq_add(self, seq_id: int, p0: int, p1: int, delta: int) -> None:
        """Shift seq_id's positions in [p0, p1) by `delta`, re-rotating K. A
        negative shift can free cells (positions below 0), so it re-syncs
        cells_used and kv_high."""
        self.cache.seq_add(seq_id, p0, p1, delta)
        if seq_id in self.n_past:
            self.n_past[seq_id] = max(0, self.n_past[seq_id] + int(delta))
        if int(delta) < 0:
            self.sync_cells_used()

    def seq_div(self, seq_id: int, p0: int, p1: int, d: int) -> None:
        self.cache.seq_div(seq_id, p0, p1, d)
        if seq_id in self.n_past:
            self.n_past[seq_id] = self.n_past[seq_id] // int(d)

    def clear_kv(self) -> None:
        self.cache.clear()
        self.n_past.clear()
        self.cells_used = 0
        self.kv_high = 0

    # ---- state save/load (llama_state_{get,set}_data counterparts) ---------
    # The JAX Context's npz layout, array for array: K/V planes (bf16 as
    # its uint16 bit pattern), pos int32, seq_mask uint32, the scales of a
    # quantized pool, n_past as [n, 2] int64 (seq, n_past) rows; a state
    # written by either package loads into the other.
    @staticmethod
    def _to_np(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()

    @staticmethod
    def _from_np(x: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        """`x` as `like`'s dtype, on its device (bf16 from its bits)."""
        x = np.ascontiguousarray(x)
        if like.dtype == torch.bfloat16:
            return torch.from_numpy(x.view(np.int16)).view(
                torch.bfloat16).to(like.device)
        return torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32
                                else x).to(like.device, like.dtype)

    def state_bytes(self) -> bytes:
        c = self.cache
        arrs = {"k": self._to_np(c.k), "v": self._to_np(c.v),
                "pos": self._to_np(c.pos),
                "seq_mask": self._to_np(c.seq_mask).astype(np.uint32)}
        if c.quantized:
            arrs["k_scale"] = self._to_np(c.k_scale)
            arrs["v_scale"] = self._to_np(c.v_scale)
        np_past = np.array(sorted(self.n_past.items()), np.int64).reshape(-1, 2)
        buf = io.BytesIO()
        np.savez(buf, n_past=np_past, **arrs)
        return buf.getvalue()

    def load_state_bytes(self, data: bytes) -> None:
        """Restore a whole-pool state into this context's pool (same shape
        and cell type), then re-sync the host shadows exactly."""
        z = np.load(io.BytesIO(data))
        c = self.cache
        if c.quantized != ("k_scale" in z.files):
            raise ValueError("the state's cell type differs from this pool's")
        names = ("k", "v", "pos", "seq_mask") + (
            ("k_scale", "v_scale") if c.quantized else ())
        for name in names:
            dst = getattr(c, name)
            if tuple(z[name].shape) != tuple(dst.shape):
                raise ValueError(f"state {name} {z[name].shape} does not fit "
                                 f"the pool's {tuple(dst.shape)}")
            dst.copy_(self._from_np(z[name], dst))
        self.n_past = {int(a): int(b) for a, b in z["n_past"]}
        self.sync_cells_used()

    def seq_state_bytes(self, seq_id: int) -> bytes:
        """One sequence's KV cells in position order (the server's slot
        save/restore)."""
        c = self.cache
        owned = ((self._to_np(c.seq_mask) >> seq_id) & 1) != 0
        idx = np.nonzero(owned)[0]
        pos = self._to_np(c.pos)[idx]
        order = np.argsort(pos, kind="stable")
        idx = idx[order]
        ti = torch.as_tensor(idx, device=c.k.device)
        arrs = {"pos": pos[order],
                "k": self._to_np(c.k[:, :, ti]), "v": self._to_np(c.v[:, :, ti]),
                "n_past": np.int64(self.n_past.get(seq_id, 0))}
        if c.quantized:
            arrs["k_scale"] = self._to_np(c.k_scale[:, :, ti])
            arrs["v_scale"] = self._to_np(c.v_scale[:, :, ti])
        buf = io.BytesIO()
        np.savez(buf, **arrs)
        return buf.getvalue()

    def load_seq_state_bytes(self, seq_id: int, data: bytes) -> int:
        """Restore a saved sequence into the lowest free cells under
        `seq_id` (its old cells dropped first); returns the cells restored."""
        z = np.load(io.BytesIO(data))
        n = len(z["pos"])
        if n == 0:
            return 0
        self.seq_rm(seq_id, -1, -1)
        c = self.cache
        free = np.nonzero(self._to_np(c.seq_mask) == 0)[0]
        if len(free) < n:
            raise RuntimeError(f"not enough free KV cells: need {n}, "
                               f"have {len(free)}")
        slots = torch.as_tensor(free[:n], device=c.k.device)
        names = ("k", "v") + (("k_scale", "v_scale") if c.quantized else ())
        for name in names:
            dst = getattr(c, name)
            dst[:, :, slots] = self._from_np(z[name], dst)
        c.pos[slots] = self._from_np(z["pos"], c.pos)
        c.seq_mask[slots] = 1 << seq_id
        self.n_past[seq_id] = int(z["n_past"])
        self.sync_cells_used()
        return n

    # ---- sampling ----------------------------------------------------------
    def sample_token(self, logits_row) -> int:
        """Draw one token with the context's sampler, generator, penalty
        ring and mirostat mu (one host sync: the host loop's path)."""
        row = torch.as_tensor(logits_row, device=self.device)
        if self.mu is not None:
            tok, self.mu = sample(row, self.sampler, self.prev_tokens,
                                  mu=self.mu, generator=self.generator)
        else:
            tok = sample(row, self.sampler, self.prev_tokens,
                         generator=self.generator)
        self.prev_tokens = update_prev_tokens(self.prev_tokens, tok)
        return int(tok)

    def generate(self, prompt_tokens, max_new: int = 64, seq_id: int = 0,
                 stop_tokens: tuple[int, ...] = (),
                 return_hidden: bool = False):
        """Plain autoregressive loop, one decode and one sample per token;
        the first stop token ends it and is not returned."""
        last = self.prefill(prompt_tokens, seq_id)
        out, hiddens = [], []
        tok = self.sample_token(last)
        for _ in range(max_new):
            if tok in stop_tokens:
                break
            out.append(tok)
            logits, hidden = self.decode(
                Batch(tokens=np.array([tok], np.int32),
                      seq_id=np.array([seq_id], np.int32)),
                return_hidden=return_hidden)
            if return_hidden:
                hiddens.append(hidden[0].float().cpu().numpy())
            tok = self.sample_token(logits[0])
        if return_hidden:
            return out, hiddens
        return out

    def prefill(self, tokens, seq_id: int = 0, chunk: int = 256):
        """Chunked prompt ingestion; returns logits of the last position."""
        tokens = np.asarray(tokens, np.int32)
        logits = None
        for i in range(0, len(tokens), chunk):
            part = tokens[i:i + chunk]
            logits, _ = self.decode(Batch(
                tokens=part, seq_id=np.full(len(part), seq_id, np.int32)))
        return logits[-1] if logits is not None else None
