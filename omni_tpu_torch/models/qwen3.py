"""Qwen3 dense decoder (the LLM of MiniCPM-o 4.5) — the dense branch of
omni_tpu/models/qwen3.py: pre-RMSNorm blocks, GQA attention with per-head
q/k RMSNorm, NeoX RoPE, SwiGLU FFN, a separate or tied output head.

The forward runs a flat ubatch of T tokens, each with its own position and
sequence id, against the unified KV cell pool. Parameters are a dict of
tensors and QTensors with the JAX package's names; `load_params` reads them
from a GGUF file.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.nn.functional as F

from ..kernels.attention import mixed_attention, pool_attention
from ..kernels.dequant_matmul import matmul
from ..kernels.fused_ffn import qffn
from ..kernels.norms import rms_norm
from ..kernels.qformats import QTensor, concat_qtensors, load_quantized
from ..kernels.rope import apply_rope
from ..runtime.kv_cache import KVCache, primary_seq_bit, seq_bits_of

# The JAX package's fused-FFN switch (omni_tpu/models/qwen3.py:1264-1283),
# read once at import as dequant_matmul reads its switches: OMNI_FUSED_FFN=1
# sends each layer's gated FFN through kernel I (`qffn`) where the fused
# gate/up weight and the down weight are both quantized and the hidden state
# lies on the card (the JAX package's accelerator backend). Off by default.
FUSED_FFN = os.environ.get("OMNI_FUSED_FFN", "0") == "1"


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    """The dense fields of omni_tpu's Qwen3Config."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    n_vocab: int
    rope_base: float = 1000000.0
    rms_eps: float = 1e-6
    # NeoX halves (qwen3) or adjacent pairs (the LLaMA-arch TTS decoder,
    # which the JAX package sets False for llama, minicpm and minicpmtts)
    rope_neox: bool = True

    @staticmethod
    def from_gguf(kv: dict[str, Any]) -> "Qwen3Config":
        """The dense `qwen3` fields of a GGUF's metadata (the qwen3 branch
        of omni_tpu's Qwen3Config.from_gguf). Raises NotImplementedError,
        naming the architecture or the key, for anything the dense branch
        does not run."""
        arch = kv.get("general.architecture")
        if arch != "qwen3":
            raise NotImplementedError(
                f"architecture {arch!r}: only the dense 'qwen3' is ported")
        for key in _UNPORTED_KEYS:
            v = kv.get(f"{arch}.{key}")
            if isinstance(v, str):
                on = v != "none"
            elif hasattr(v, "__len__"):
                on = any(float(e) for e in v)
            else:
                on = bool(v)
            if on:
                raise NotImplementedError(
                    f"{arch}.{key} = {v!r}: the dense branch does not run it")

        def g(key, default=None):
            v = kv.get(f"{arch}.{key}", default)
            if hasattr(v, "__len__") and not isinstance(v, str):
                raise NotImplementedError(
                    f"{arch}.{key}: per-layer values are not ported")
            return v

        d_model, n_heads = int(g("embedding_length")), int(g("attention.head_count"))
        head_dim = int(g("attention.key_length", d_model // n_heads))
        rope_dim = g("rope.dimension_count")
        if rope_dim is not None and int(rope_dim) != head_dim:
            raise NotImplementedError(
                f"{arch}.rope.dimension_count = {rope_dim}: partial rotary "
                "is not ported")
        return Qwen3Config(
            n_layers=int(g("block_count")), d_model=d_model, n_heads=n_heads,
            n_kv_heads=int(g("attention.head_count_kv", n_heads)),
            head_dim=head_dim, d_ff=int(g("feed_forward_length")),
            n_vocab=(len(kv["tokenizer.ggml.tokens"])
                     if "tokenizer.ggml.tokens" in kv else int(g("vocab_size"))),
            rope_base=float(g("rope.freq_base", 10000.0)),
            rms_eps=float(g("attention.layer_norm_rms_epsilon", 1e-6)))


# metadata the JAX package reads into branches the port has not ported: MoE,
# MLA, sliding windows, ALiBi, softcaps, rope scaling
_UNPORTED_KEYS = (
    "expert_count", "attention.kv_lora_rank", "attention.sliding_window",
    "attention.max_alibi_bias", "attn_logit_softcapping",
    "final_logit_softcapping", "rope.scaling.type", "rope.dimension_sections")

# the tensors of one dense Qwen3 layer: GGUF name -> parameter name
_LAYER_TENSORS = {
    "attn_norm": "attn_norm", "attn_q": "wq", "attn_k": "wk", "attn_v": "wv",
    "attn_output": "wo", "attn_q_norm": "q_norm", "attn_k_norm": "k_norm",
    "ffn_norm": "ffn_norm", "ffn_gate": "w_gate", "ffn_up": "w_up",
    "ffn_down": "w_down"}
_OPTIONAL = ("q_norm", "k_norm")


def fuse_layer(layer: dict) -> dict:
    """Fuse QKV and gate+up into single weights (one kernel launch each)."""
    def cat(ws):
        if isinstance(ws[0], QTensor):
            return concat_qtensors(ws)
        return torch.cat(ws, dim=0)  # dense [N, K]

    out = dict(layer)
    out["wqkv"] = cat([layer["wq"], layer["wk"], layer["wv"]])
    out["w_gateup"] = cat([layer["w_gate"], layer["w_up"]])
    for k in ("wq", "wk", "wv", "w_gate", "w_up"):
        del out[k]
    return out


_RANK_HEAD = {"cls.weight": "cls", "cls.bias": "cls_b",
              "cls.output.weight": "cls_out", "cls.output.bias": "cls_out_b"}


def load_params(reader, fuse: bool = False, device=None) -> dict:
    """GGUF tensors -> the dense Qwen3 parameter dict on `device` (the
    dense subset of omni_tpu's `qwen3.load_params`): Q8_0, Q4_0, Q4_1, Q5_0,
    Q5_1, Q2_K, Q3_K, Q4_K, Q5_K, Q6_K, IQ4_NL, IQ4_XS and MXFP4 weights
    stay quantized (a Q4_0, Q4_1, Q5_0 or Q5_1 weight whose K is no multiple
    of 256 becomes dense bf16, as in the JAX package), F32/F16/BF16 weights
    become dense bf16, the token embedding (Q5_K in a Q5_K_M file, Q4_0 in a
    Q4_0 one, IQ4_NL in an IQ4_NL one, Q2_K in a Q2_K one) is dequantised to
    dense bf16 (as
    keep_q=False does; the JAX package widens it through its numpy
    dequantiser, whose f32 values the port's `dequant` gives bit for bit),
    norms are f32, and `output` is None
    when the head is tied to the embedding. The rank head's `cls`, `cls_b`,
    `cls_out` and `cls_out_b` are dense (bf16 matrices, f32 biases), None
    where the file has none. Other quantized formats raise
    NotImplementedError, as does a tensor the dense branch would not read.
    fuse=True merges QKV and gate+up, which needs one format per group: on
    a Q4_K_M or Q5_K_M layer (Q4_K or Q5_K wq, Q6_K wv) it raises, as the
    JAX package's does."""
    from .. import resolve_device

    device = resolve_device(device)
    n_layers = int(reader.kv[f"{reader.kv['general.architecture']}.block_count"])
    read = {"token_embd.weight", "output_norm.weight", "output.weight",
            *_RANK_HEAD} | {
        f"blk.{i}.{gg}.weight" for i in range(n_layers) for gg in _LAYER_TENSORS}
    extra = sorted(set(reader.tensors) - read)
    if extra:
        raise NotImplementedError(
            f"tensors the dense qwen3 branch does not read: {extra[:8]}")

    def get(name: str, keep_q: bool = True, required: bool = True):
        ti = reader.tensors.get(name)
        if ti is None:
            if required:
                raise KeyError(f"missing tensor {name}")
            return None
        return load_quantized(ti.data, ti.ggml_type, ti.shape, keep_q, device)

    params = {"token_embd": get("token_embd.weight", keep_q=False),
              "output_norm": get("output_norm.weight"),
              "output": get("output.weight", required=False), "layers": []}
    # the optional classification / rank head (reference LLM_TENSOR_CLS{,_OUT};
    # read by the server's RANK pooling), dense as the JAX package loads it
    for name, key in _RANK_HEAD.items():
        params[key] = get(name, keep_q=False, required=False)
    for i in range(n_layers):
        layer = {nm: get(f"blk.{i}.{gg}.weight", required=nm not in _OPTIONAL)
                 for gg, nm in _LAYER_TENSORS.items()}
        params["layers"].append(fuse_layer(layer) if fuse else layer)
    return params


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids -> embeddings [T, d] (bf16)."""
    return params["token_embd"][tokens].to(torch.bfloat16)


def _qkv(lp: dict, cfg: Qwen3Config, hn: torch.Tensor):
    t = hn.shape[0]
    qd = cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    if "wqkv" in lp:
        qkv = matmul(hn, lp["wqkv"])
        q, k, v = qkv[:, :qd], qkv[:, qd:qd + kvd], qkv[:, qd + kvd:]
    else:
        q, k, v = (matmul(hn, lp[w]) for w in ("wq", "wk", "wv"))
    return (q.reshape(t, cfg.n_heads, cfg.head_dim),
            k.reshape(t, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(t, cfg.n_kv_heads, cfg.head_dim))


def _on_cuda(x: torch.Tensor) -> bool:
    return x.is_cuda


def _ffn(lp: dict, cfg: Qwen3Config, hn: torch.Tensor) -> torch.Tensor:
    if "w_gateup" in lp:
        if (FUSED_FFN and isinstance(lp["w_gateup"], QTensor)
                and isinstance(lp["w_down"], QTensor) and _on_cuda(hn)):
            # the whole gated FFN in one kernel (qffn_pallas's law: g and u
            # in f32, h rounded once), as the JAX package's accelerator route
            return qffn(hn, lp["w_gateup"], lp["w_down"], act="silu")
        gu = matmul(hn, lp["w_gateup"])
        gate, up = gu[:, :cfg.d_ff], gu[:, cfg.d_ff:]
    else:
        gate, up = matmul(hn, lp["w_gate"]), matmul(hn, lp["w_up"])
    h_ff = F.silu(gate.to(torch.float32)).to(torch.bfloat16) * up
    return matmul(h_ff, lp["w_down"])


def forward(params: dict, cfg: Qwen3Config,
            x: torch.Tensor,  # [T, d_model] input embeddings
            pos: torch.Tensor,  # [T] int
            seq_id: torch.Tensor,  # [T] int
            cache: KVCache,
            slots: torch.Tensor,  # [T] cell indices from cache.find_slots
            write_mask: torch.Tensor | None = None,  # [T] bool; False = pad
            kv_limit: int | None = None,  # attend over cells [0, kv_limit)
            ) -> tuple[torch.Tensor, torch.Tensor, KVCache]:
    """One decode/prefill step. Returns (logits [T, vocab] f32, hidden
    [T, d_model] f32 — the tap the omni TTS projector reads, the cache).

    bf16 cells, deferred write: every layer attends over the pool as it was
    before this ubatch plus the ubatch's own K/V as extra columns; all
    layers' K/V land in the pool with one scatter at the end. Quantized
    cells, write-then-read (JAX qwen3.py:889-911, 1150-1163): the ubatch's
    cell metadata is committed first, then each layer quantizes its K/V
    into the pool and attends over the pool alone (`pool_attention`, the
    flash kernel). The cache is updated in place.
    """
    t = x.shape[0]
    h = x.to(torch.bfloat16)
    if write_mask is None:
        write_mask = torch.ones((t,), dtype=torch.bool, device=x.device)
    deferred = not cache.quantized
    if deferred:
        mask = cache.attn_mask(pos, seq_id, limit=kv_limit)  # pool only
        mask_cur = ((seq_bits_of(seq_id)[None, :]
                     & primary_seq_bit(seq_id)[:, None]) != 0)
        mask_cur = mask_cur & (pos[None, :] <= pos[:, None]) & write_mask[None, :]
        new_ks, new_vs = [], []
    else:
        # commit first, so the ubatch attends causally to its own cells
        cache.commit(slots, pos, seq_id, valid=write_mask)
        mask = cache.attn_mask(pos, seq_id, limit=kv_limit)  # [T, S]
    for li, lp in enumerate(params["layers"]):
        hn = rms_norm(h, lp["attn_norm"], cfg.rms_eps)
        q, k, v = _qkv(lp, cfg, hn)
        if lp.get("q_norm") is not None:
            q = rms_norm(q, lp["q_norm"], cfg.rms_eps)
        if lp.get("k_norm") is not None:
            k = rms_norm(k, lp["k_norm"], cfg.rms_eps)
        q = apply_rope(q, pos, cfg.rope_base, neox=cfg.rope_neox)
        k = apply_rope(k, pos, cfg.rope_base, neox=cfg.rope_neox)
        if deferred:
            kc, vc = cache.read_layer(li, limit=kv_limit)
            attn = mixed_attention(q, kc, vc, k, v, mask, mask_cur)
            new_ks.append(k)
            new_vs.append(v)
        else:
            # padding rows write into their slots too: the committed
            # metadata leaves those cells free, so they are never attended
            cache.write(li, slots, k, v)
            attn = pool_attention(q, cache, li, mask, kv_limit=kv_limit)
        h = h + matmul(attn.reshape(t, -1), lp["wo"])
        h = h + _ffn(lp, cfg, rms_norm(h, lp["ffn_norm"], cfg.rms_eps))
    if deferred:
        cache.write_all(slots, torch.stack(new_ks), torch.stack(new_vs))
        cache.commit(slots, pos, seq_id, valid=write_mask)
    hidden = rms_norm(h, params["output_norm"], cfg.rms_eps)
    head = params["output"] if params.get("output") is not None \
        else params["token_embd"]
    if head is None:
        # a headless decoder (the TTS read from the converter's names: its
        # logits come from head_code); only the hidden tap is meaningful
        logits = torch.zeros((t, 1), dtype=torch.float32, device=h.device)
    else:
        logits = matmul(hidden, head, out_dtype=torch.float32)
    return logits, hidden.to(torch.float32), cache
