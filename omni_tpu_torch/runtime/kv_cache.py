"""Unified KV cell pool with llama.cpp session semantics — the subset of
omni_tpu/runtime/kv_cache.py that the served decode path uses: bf16 cells,
or the quantized cells of `--cache-type-k q8_0 | q4_0`.

A fixed pool of `size` cells per layer; a cell is (pos int, seq_mask
bitset) where bit s means "belongs to sequence s". K/V are head-major
[L, Hkv, S, D]. Cell choice (find_slots) and masks match the JAX cache cell
for cell.

A quantized pool stores each (cell, head) row of D values with one f32
scale (the JAX package's law, not llama.cpp's per-32 blocks): int8 rows
(q8_0), or two logical columns d and d + D/2 per byte, each a nibble biased
+8 (q4_0: planes [L, Hkv, S, D/2] uint8). The codecs match the JAX ones bit
for bit.

Unlike the JAX cache, which is an immutable pytree, this one is UPDATED IN
PLACE: write, write_all, commit and the session operations (seq_rm,
seq_cp, seq_rm_all, seq_keep, clear) mutate the tensors and return `self`,
so a step never copies the pool. seq_rm, seq_cp, seq_rm_all, seq_keep
and clear touch only the cells' (pos, seq_mask) metadata. seq_add and
seq_div move positions and re-rotate K by each cell's delta
(`_apply_pos_change`): on a quantized pool K is dequantized, rotated and
requantized, every cell of every layer, as the JAX cache does it. The
partially roped keys of MLA (the JAX cache's rope_dim > 0) are not ported:
the port's Qwen3Config refuses those models.
"""

from __future__ import annotations

import torch

from ..kernels.rope import rope_shift


# sequences a cell's bitset can name (the JAX cache's MAX_SEQS; the server
# reserves the top two, 30 and 31); the int64 seq_mask holds bit 31 unsigned
MAX_SEQS = 32


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


def kv_bits(dtype) -> int:
    """Cell bit width of a KV dtype as `create` takes it (the JAX package's
    names): torch.bfloat16 or "bf16" 16; torch.int8 or "q8_0" 8; "q4_0" or
    "int4" 4. Raises ValueError for anything else."""
    if isinstance(dtype, str):
        bits = {"bf16": 16, "q8_0": 8, "q4_0": 4, "int4": 4}.get(dtype)
    else:
        bits = {torch.bfloat16: 16, torch.int8: 8}.get(dtype)
    if bits is None:
        raise ValueError(f"KV dtype {dtype!r}: want torch.bfloat16, 'bf16', "
                         "torch.int8, 'q8_0', 'q4_0' or 'int4'")
    return bits


class KVCache:
    """Per-model cache state (all layers)."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
                 seq_mask: torch.Tensor, k_scale: torch.Tensor | None = None,
                 v_scale: torch.Tensor | None = None, bits: int = 16,
                 rope_base: float = 10000.0):
        self.k = k  # [L, Hkv, S, D] bf16 or int8; [L, Hkv, S, D/2] uint8
        self.v = v
        self.k_scale = k_scale  # [L, Hkv, S] f32, set when quantized
        self.v_scale = v_scale
        self.pos = pos  # [S] int32, -1 = unused
        self.seq_mask = seq_mask  # [S] int64 bitset of owning sequences
        self.bits = bits  # 16 (bf16), 8 (int8) or 4 (packed nibbles)
        self.rope_base = rope_base  # K's rotary law, for seq_add / seq_div

    @staticmethod
    def create(n_layers: int, size: int, n_kv_heads: int, head_dim: int,
               device, dtype=torch.bfloat16,
               rope_base: float = 10000.0) -> "KVCache":
        bits = kv_bits(dtype)
        if bits == 4 and head_dim % 2:
            raise ValueError(f"q4_0 cells need an even head_dim, got {head_dim}")
        cell = {16: (head_dim, torch.bfloat16), 8: (head_dim, torch.int8),
                4: (head_dim // 2, torch.uint8)}[bits]
        shape = (n_layers, n_kv_heads, size, cell[0])

        def scales():
            return (torch.zeros(shape[:3], dtype=torch.float32, device=device)
                    if bits < 16 else None)

        return KVCache(
            k=torch.zeros(shape, dtype=cell[1], device=device),
            v=torch.zeros(shape, dtype=cell[1], device=device),
            pos=torch.full((size,), -1, dtype=torch.int32, device=device),
            seq_mask=torch.zeros((size,), dtype=torch.int64, device=device),
            k_scale=scales(), v_scale=scales(), bits=bits, rope_base=rope_base)

    @property
    def size(self) -> int:
        return self.pos.shape[0]

    @property
    def n_kv_heads(self) -> int:
        return self.k.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def n_used(self) -> int:
        """Occupied cells, read from the device (one sync: cold paths)."""
        return int((self.seq_mask != 0).sum())

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

    def write(self, layer: int, slots: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> "KVCache":
        """Store one layer's per-token K/V ([T, Hkv, D]) into `slots`,
        quantized where the pool is (the write-then-read path). JAX's
        `k.at[layer, :, slots]` takes the update token-major; a torch index
        puts the head axis first, hence the transposes."""
        if self.quantized:
            qr = quant_rows4 if self.bits == 4 else quant_rows
            for plane, scales, x in ((self.k, self.k_scale, k),
                                     (self.v, self.v_scale, v)):
                sc, xq = qr(x)
                plane[layer][:, slots] = xq.transpose(0, 1)
                scales[layer][:, slots] = sc.transpose(0, 1)
            return self
        self.k[layer][:, slots] = k.transpose(0, 1).to(self.k.dtype)
        self.v[layer][:, slots] = v.transpose(0, 1).to(self.v.dtype)
        return self

    def write_all(self, slots: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> "KVCache":
        """Store ALL layers' per-token K/V ([L, T, Hkv, D]) into `slots`
        with one scatter per pool (the deferred-write path of bf16 cells;
        a quantized pool takes them layer by layer)."""
        if self.quantized:
            for li in range(k.shape[0]):
                self.write(li, slots, k[li], v[li])
            return self
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
        """K/V of one layer, ([Hkv, S, D], [Hkv, S, D]) bf16, dequantized
        where the pool is quantized (in bf16, as the JAX cache does);
        `limit` returns only the first `limit` cells (the ragged-KV read
        bound)."""
        s = slice(None) if limit is None else slice(0, limit)
        k, v = self.k[layer, :, s], self.v[layer, :, s]
        if not self.quantized:
            return k, v
        ks, vs = self.k_scale[layer, :, s], self.v_scale[layer, :, s]
        if self.bits == 4:
            return dequant4(k, ks), dequant4(v, vs)
        return (k.to(torch.bfloat16) * ks[..., None].to(torch.bfloat16),
                v.to(torch.bfloat16) * vs[..., None].to(torch.bfloat16))

    def layer_planes(self, layer: int, limit: int | None = None):
        """Raw planes of one layer for the flash kernel: (k, v, k_scale,
        v_scale), K/V [Hkv, S, D] (D/2 bytes for q4_0) and scales [Hkv, S]
        (None for bf16 cells). Views of the pool: cells stay contiguous
        within a head, heads keep the pool's stride."""
        s = slice(None) if limit is None else slice(0, limit)
        if self.quantized:
            return (self.k[layer, :, s], self.v[layer, :, s],
                    self.k_scale[layer, :, s], self.v_scale[layer, :, s])
        return self.k[layer, :, s], self.v[layer, :, s], None, None

    def _owned(self, seq_id: int) -> torch.Tensor:
        return ((self.seq_mask >> seq_id) & 1) != 0

    def _in_range(self, p0: int, p1: int) -> torch.Tensor:
        lo = torch.iinfo(torch.int32).min if p0 < 0 else p0
        hi = torch.iinfo(torch.int32).max if p1 < 0 else p1
        return (self.pos >= lo) & (self.pos < hi)

    def seq_rm(self, seq_id: int, p0: int = -1, p1: int = -1) -> "KVCache":
        sel = self._owned(seq_id) & self._in_range(p0, p1)
        return self._drop_emptied(torch.where(sel, self.seq_mask & ~(1 << seq_id),
                                              self.seq_mask))

    def seq_cp(self, seq_src: int, seq_dst: int, p0: int = -1,
               p1: int = -1) -> "KVCache":
        """Add seq_dst to the cells of seq_src in [p0, p1)."""
        sel = self._owned(seq_src) & self._in_range(p0, p1)
        self.seq_mask.copy_(torch.where(sel, self.seq_mask | (1 << seq_dst),
                                        self.seq_mask))
        return self

    def _drop_emptied(self, new_mask: torch.Tensor) -> "KVCache":
        """Store `new_mask` and free (pos = -1) every cell it leaves empty."""
        self.seq_mask.copy_(new_mask)
        self.pos.copy_(torch.where(new_mask == 0,
                                   torch.full_like(self.pos, -1), self.pos))
        return self

    def seq_rm_all(self, p0: int = -1, p1: int = -1) -> "KVCache":
        """Remove the cells in [p0, p1) from every sequence (the seq_id = -1
        form of llama_memory_seq_rm)."""
        sel = self._in_range(p0, p1)
        return self._drop_emptied(torch.where(sel, torch.zeros_like(self.seq_mask),
                                              self.seq_mask))

    def seq_keep(self, seq_id: int) -> "KVCache":
        """Drop every sequence but seq_id."""
        return self._drop_emptied(self.seq_mask & (1 << seq_id))

    def seq_add_delta(self, seq_id: int, p0: int, p1: int,
                      delta: int) -> torch.Tensor:
        """Each cell's position change under `seq_add` ([S]: `delta` on
        seq_id's cells in [p0, p1), else 0), the angle its K turns by."""
        sel = self._owned(seq_id) & self._in_range(p0, p1)
        return sel.to(self.pos.dtype) * delta

    def seq_div_delta(self, seq_id: int, p0: int, p1: int,
                      d: int) -> torch.Tensor:
        """Each cell's position change under `seq_div` ([S])."""
        sel = self._owned(seq_id) & self._in_range(p0, p1)
        return torch.where(sel, self.pos // d - self.pos,
                           torch.zeros_like(self.pos))

    def seq_add(self, seq_id: int, p0: int, p1: int, delta: int) -> "KVCache":
        """Shift the positions of seq_id's cells in [p0, p1) by `delta`
        (context shift) and re-rotate their K; a cell shifted below 0 is
        freed."""
        rot = self.seq_add_delta(seq_id, p0, p1, delta)
        new_pos = self.pos + rot
        return self._apply_pos_change(new_pos, rot,
                                      drop=(rot != 0) & (new_pos < 0))

    def seq_div(self, seq_id: int, p0: int, p1: int, d: int) -> "KVCache":
        """Divide the positions of seq_id's cells in [p0, p1) by `d`
        (floor; self-extend's grouped attention) and re-rotate their K."""
        rot = self.seq_div_delta(seq_id, p0, p1, d)
        return self._apply_pos_change(self.pos + rot, rot,
                                      drop=torch.zeros_like(rot, dtype=torch.bool))

    def _apply_pos_change(self, new_pos: torch.Tensor, rot: torch.Tensor,
                          drop: torch.Tensor) -> "KVCache":
        """Rotate every cell's K by its delta `rot` ([S] int), store
        `new_pos`, free the `drop` cells. A quantized K is dequantized (in
        bf16, `read_layer`), rotated and requantized, every cell (a delta
        of 0 is the identity rotation, but the row is requantized all the
        same, as in the JAX cache); one layer at a time, through a
        cell-major view."""
        for li in range(self.k.shape[0]):
            kf = self.read_layer(li)[0]  # [H, S, D] bf16
            kr = rope_shift(kf.transpose(0, 1), rot,
                            self.rope_base).transpose(0, 1)
            if self.quantized:
                sc, kq = (quant_rows4 if self.bits == 4 else quant_rows)(kr)
                self.k[li] = kq
                self.k_scale[li] = sc
            else:
                self.k[li] = kr
        self.pos.copy_(torch.where(drop, torch.full_like(new_pos, -1), new_pos))
        self.seq_mask.copy_(torch.where(drop, torch.zeros_like(self.seq_mask),
                                        self.seq_mask))
        return self

    def seq_pos_min(self, seq_id: int) -> torch.Tensor:
        """Lowest position of seq_id (int32 max where it owns no cell)."""
        return torch.where(self._owned(seq_id), self.pos,
                           torch.full_like(self.pos,
                                           torch.iinfo(torch.int32).max)).min()

    def seq_pos_max(self, seq_id: int) -> torch.Tensor:
        """Highest position of seq_id (-1 where it owns no cell)."""
        return torch.where(self._owned(seq_id), self.pos,
                           torch.full_like(self.pos, -1)).max()

    def clear(self) -> "KVCache":
        self.pos.fill_(-1)
        self.seq_mask.zero_()
        return self

    def attn_mask(self, q_pos: torch.Tensor, q_seq: torch.Tensor,
                  limit: int | None = None) -> torch.Tensor:
        """[T, S] bool: query t may attend to cell c (same seq, causal)."""
        sm = self.seq_mask if limit is None else self.seq_mask[:limit]
        cp = self.pos if limit is None else self.pos[:limit]
        owned = (sm[None, :] & primary_seq_bit(q_seq)[:, None]) != 0
        return owned & (sm[None, :] != 0) & (cp[None, :] <= q_pos[:, None])


def quant_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization of K/V rows [..., D]: (scale
    [...] f32 = amax/127, 1 for a zero row; int8 round(x/scale), half to
    even) — omni_tpu's `_quant_rows`."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return scale, torch.round(xf / scale[..., None]).to(torch.int8)


def quant_rows4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int4 quantization, packed two logical columns per
    byte: byte d = nibble(col d) | nibble(col d + D/2) << 4, each nibble
    clip(round(x/scale), -8, 7) + 8 with scale = amax/7 — omni_tpu's
    `_quant_rows4`."""
    d = x.shape[-1]
    xf = x.to(torch.float32)
    amax = xf.abs().amax(-1)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.round(xf / scale[..., None]).clamp(-8, 7).to(torch.int32) + 8
    lo, hi = q[..., :d // 2], q[..., d // 2:]
    return scale, (lo | (hi << 4)).to(torch.uint8)


def unpack4(q: torch.Tensor) -> torch.Tensor:
    """Packed [..., D/2] uint8 -> the signed nibbles [..., D] int32 in
    natural column order."""
    qi = q.to(torch.int32)
    return torch.cat([(qi & 0xF) - 8, (qi >> 4) - 8], dim=-1)


def dequant4(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Packed [..., D/2] uint8 + per-row scale -> [..., D] bf16 (the
    product rounded once to bf16, as omni_tpu's `_dequant4`)."""
    return (unpack4(q).to(torch.bfloat16)
            * scale[..., None].to(torch.bfloat16))
