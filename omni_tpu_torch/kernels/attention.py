"""Attention over the unified KV cell pool (counterpart of
omni_tpu/kernels/attention.py): a masked softmax over every cell with GQA
head grouping. The JAX package leaves this to XLA on the bf16 pool, so the
port leaves it to plain PyTorch; a quantized pool goes through the flash
kernel (`pool_attention`). Every product is accumulated in f32: on
the card the operands are rounded to bf16 and go to cuBLAS as they are,
with f32 outputs and K split into chunks (`dequant_matmul.bmm_f32`, the
`preferred_element_type=float32` dot; the bf16 pool is never copied); on
the CPU, which has no kernel for that overload, they stay f32, as the JAX
package computes them off the TPU."""

from __future__ import annotations

import torch

from .dequant_matmul import bmm_f32
from .flash_attention import NEG_INF, flash_decode, heads_major, tokens_major


def _on_cuda(a: torch.Tensor) -> bool:
    return a.is_cuda


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b ([B, M, K] @ [B, K, N]) with f32 accumulation and an f32
    result: bf16 operands on the card, f32 ones on the CPU."""
    if _on_cuda(a):
        return bmm_f32(a.to(torch.bfloat16), b.to(torch.bfloat16))
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def mixed_attention(q: torch.Tensor,  # [T, Hq, D]
                    k_pool: torch.Tensor,  # [Hkv, S, D]
                    v_pool: torch.Tensor,
                    k_cur: torch.Tensor,  # [T, Hkv, D] not yet in the pool
                    v_cur: torch.Tensor,
                    mask_pool: torch.Tensor,  # [T, S] bool
                    mask_cur: torch.Tensor,  # [T, T] bool
                    scale: float | None = None) -> torch.Tensor:
    """Attention over pool ∪ current batch with ONE joint softmax — the
    deferred-write path: the pool is read before this ubatch is written,
    and the batch's own keys ride along as extra columns. Returns
    [T, Hq, D] f32."""
    t, hq, d = q.shape
    hkv = k_pool.shape[0]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qh = heads_major(q, hkv)
    kc = k_cur.transpose(0, 1)  # [Hkv, T, D]
    vc = v_cur.transpose(0, 1)
    sc_pool = _mm(qh, k_pool.transpose(1, 2)) * scale
    sc_cur = _mm(qh, kc.transpose(1, 2)) * scale
    mp = mask_pool.repeat_interleave(g, dim=0)  # [T*G, S]
    mc = mask_cur.repeat_interleave(g, dim=0)  # [T*G, T]
    sc_pool = torch.where(mp[None], sc_pool, NEG_INF)
    sc_cur = torch.where(mc[None], sc_cur, NEG_INF)
    p = torch.softmax(torch.cat([sc_pool, sc_cur], dim=-1), dim=-1)
    s = k_pool.shape[1]
    out = _mm(p[..., :s], v_pool) + _mm(p[..., s:], vc)
    return tokens_major(out, t)


def cache_attention(q: torch.Tensor,  # [T, Hq, D]
                    k: torch.Tensor,  # [Hkv, S, D]
                    v: torch.Tensor,
                    mask: torch.Tensor,  # [T, S] bool
                    scale: float | None = None) -> torch.Tensor:
    """Attention of q over one layer of the pool. Returns [T, Hq, D] f32."""
    t, hq, d = q.shape
    hkv = k.shape[0]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    scores = _mm(heads_major(q, hkv), k.transpose(1, 2)) * scale
    scores = torch.where(mask.repeat_interleave(g, dim=0)[None], scores,
                         NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return tokens_major(_mm(p, v), t)


def pool_attention(q: torch.Tensor, cache, layer: int, mask: torch.Tensor,
                   scale: float | None = None,
                   kv_limit: int | None = None) -> torch.Tensor:
    """Attention of q ([T, Hq, D]) over one layer of the cell pool, as the
    JAX package routes it (attention.py:112-140): a quantized pool goes
    through the flash kernel on its raw planes (on the card the kernel, on
    the CPU its plain law; the JAX package takes `read_layer` +
    `cache_attention` off the TPU), a bf16 pool through `read_layer` +
    `cache_attention`. Returns [T, Hq, D] f32."""
    if cache.quantized:
        k, v, ks, vs = cache.layer_planes(layer, limit=kv_limit)
        return flash_decode(q, k, v, mask, k_scale=ks, v_scale=vs, scale=scale)
    kc, vc = cache.read_layer(layer, limit=kv_limit)
    return cache_attention(q, kc, vc, mask, scale=scale)
