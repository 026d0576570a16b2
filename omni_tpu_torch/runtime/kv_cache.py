"""Unified KV cell pool with llama.cpp session semantics — the bf16 subset
of omni_tpu/runtime/kv_cache.py that the served decode path uses.

A fixed pool of `size` cells per layer; a cell is (pos int, seq_mask
bitset) where bit s means "belongs to sequence s". K/V are head-major
[L, Hkv, S, D]. Cell choice (find_slots) and masks match the JAX cache cell
for cell.

Unlike the JAX cache, which is an immutable pytree, this one is UPDATED IN
PLACE: write_all, commit and seq_rm mutate the tensors and return `self`,
so a step never copies the pool.
"""

from __future__ import annotations

import torch

def seq_bits_of(seq: torch.Tensor) -> torch.Tensor:
    """int seq encoding -> membership bitset (int64). seq >= 0: one id;
    seq < 0: a packed multi-membership mask, bits = -seq."""
    seq = seq.to(torch.int64)
    one = torch.ones_like(seq)
    return torch.where(seq >= 0,
                       torch.bitwise_left_shift(one, seq.clamp(min=0)), -seq)


def primary_seq_bit(seq: torch.Tensor) -> torch.Tensor:
    """The attention sequence of a batch row = lowest set membership bit."""
    bits = seq_bits_of(seq)
    return bits & (-bits)


class KVCache:
    """Per-model cache state (all layers), bf16 cells."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
                 seq_mask: torch.Tensor):
        self.k = k  # [L, Hkv, S, D] bf16
        self.v = v
        self.pos = pos  # [S] int32, -1 = unused
        self.seq_mask = seq_mask  # [S] int64 bitset of owning sequences

    @staticmethod
    def create(n_layers: int, size: int, n_kv_heads: int, head_dim: int,
               device) -> "KVCache":
        shape = (n_layers, n_kv_heads, size, head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=torch.bfloat16, device=device),
            v=torch.zeros(shape, dtype=torch.bfloat16, device=device),
            pos=torch.full((size,), -1, dtype=torch.int32, device=device),
            seq_mask=torch.zeros((size,), dtype=torch.int64, device=device))

    @property
    def size(self) -> int:
        return self.pos.shape[0]

    @property
    def n_kv_heads(self) -> int:
        return self.k.shape[1]

    def find_slots(self, n: int) -> torch.Tensor:
        """Indices of the first `n` free cells ([n] int64), lowest first.
        Cells past the pool's capacity alias slot `size-1`; the caller
        guards real use (no host sync here)."""
        free = self.seq_mask == 0
        rank = torch.cumsum(free.to(torch.int64), 0) - 1
        idx = torch.where(free & (rank < n), rank, torch.full_like(rank, n))
        slots = torch.full((n + 1,), self.size - 1, dtype=torch.int64,
                           device=self.pos.device)
        slots.scatter_(0, idx, torch.arange(self.size, device=idx.device))
        return slots[:n]

    def write_all(self, slots: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> "KVCache":
        """Store ALL layers' per-token K/V ([L, T, Hkv, D]) into `slots`
        with one scatter per pool (the deferred-write path)."""
        self.k[:, :, slots] = k.transpose(1, 2).to(self.k.dtype)
        self.v[:, :, slots] = v.transpose(1, 2).to(self.v.dtype)
        return self

    def commit(self, slots: torch.Tensor, pos: torch.Tensor,
               seq_id: torch.Tensor, valid: torch.Tensor | None = None
               ) -> "KVCache":
        """Mark `slots` as owned. Rows with valid=False write pos=-1 and an
        empty mask (inert padding)."""
        bit = seq_bits_of(seq_id)
        pos = pos.to(torch.int32)
        if valid is not None:
            bit = torch.where(valid, bit, torch.zeros_like(bit))
            pos = torch.where(valid, pos, torch.full_like(pos, -1))
        self.pos[slots] = pos
        self.seq_mask[slots] = bit
        return self

    def read_layer(self, layer: int, limit: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """K/V of one layer, ([Hkv, S, D], [Hkv, S, D]); `limit` returns
        only the first `limit` cells (the ragged-KV read bound)."""
        s = slice(None) if limit is None else slice(0, limit)
        return self.k[layer, :, s], self.v[layer, :, s]

    def _owned(self, seq_id: int) -> torch.Tensor:
        return ((self.seq_mask >> seq_id) & 1) != 0

    def _in_range(self, p0: int, p1: int) -> torch.Tensor:
        lo = torch.iinfo(torch.int32).min if p0 < 0 else p0
        hi = torch.iinfo(torch.int32).max if p1 < 0 else p1
        return (self.pos >= lo) & (self.pos < hi)

    def seq_rm(self, seq_id: int, p0: int = -1, p1: int = -1) -> "KVCache":
        sel = self._owned(seq_id) & self._in_range(p0, p1)
        new_mask = torch.where(sel, self.seq_mask & ~(1 << seq_id),
                               self.seq_mask)
        self.seq_mask.copy_(new_mask)
        self.pos.copy_(torch.where(new_mask == 0,
                                   torch.full_like(self.pos, -1), self.pos))
        return self

    def attn_mask(self, q_pos: torch.Tensor, q_seq: torch.Tensor,
                  limit: int | None = None) -> torch.Tensor:
        """[T, S] bool: query t may attend to cell c (same seq, causal)."""
        sm = self.seq_mask if limit is None else self.seq_mask[:limit]
        cp = self.pos if limit is None else self.pos[:limit]
        owned = (sm[None, :] & primary_seq_bit(q_seq)[:, None]) != 0
        return owned & (sm[None, :] != 0) & (cp[None, :] <= q_pos[:, None])
