"""The upsampling conformer encoder of Token2Wav: tokens -> pre-mel
features (counterpart of omni_tpu/models/token2wav/conformer.py).

Token embedding [512] -> embed (linear + LN(1e-5), times sqrt(d)) ->
PreLookaheadLayer (conv k4 over the 3 look-ahead frames, leaky ReLU 0.01,
conv k3 with 2 frames of left context, + residual) -> 6 conformer layers
(Espnet relative-position attention and a swish FFN, pre-norm) ->
nearest x2 upsampling and a conv with 4 frames of left context ->
up_embed (linear + LN, times sqrt(d)) -> 4 conformer layers -> LN.

Relative-position attention: score = ((q + u) . k + (q + v) . P(q_pos -
k_pos)) / sqrt(d_head), P the sinusoid [sin, cos] interleaved through
linear_pos. P depends on the distance only, so it is projected once per
distance of the chunk and gathered per (query, key), which is the same
product row for row.

Streaming: each layer keeps its K/V history (stage 1 up to `max_tokens`
rows, stage 2 twice that) and the two conv tails. A chunk attends over the
valid history and itself. As in the JAX package, a chunk whose rows would
run past the history is written at its end (the start clamped) while the
counts keep growing; the counts are host ints.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ... import resolve_device
from ...core import quants


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    d_model: int = 512
    n_heads: int = 8
    d_ff: int = 2048
    n_blocks: int = 6
    n_up_blocks: int = 4
    pre_lookahead: int = 3
    up_stride: int = 2
    ln_eps: float = 1e-5
    max_tokens: int = 320  # stage-1 history cap (tokens, the prompt's too)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


@dataclasses.dataclass
class ConformerState:
    k1: torch.Tensor  # [L1, Tmax, H, D] stage-1 K history
    v1: torch.Tensor
    n1: int
    k2: torch.Tensor  # [L2, 2 Tmax, H, D]
    v2: torch.Tensor
    n2: int
    prelook_tail: torch.Tensor  # [2, d] conv2's left context
    up_tail: torch.Tensor  # [2 up_stride, d] the upsampling conv's

    @staticmethod
    def create(cfg: ConformerConfig, device=None,
               dtype=torch.float32) -> "ConformerState":
        device = resolve_device(device)
        t1, h, d = cfg.max_tokens, cfg.n_heads, cfg.head_dim

        def z(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)

        return ConformerState(
            k1=z(cfg.n_blocks, t1, h, d), v1=z(cfg.n_blocks, t1, h, d), n1=0,
            k2=z(cfg.n_up_blocks, 2 * t1, h, d), v2=z(cfg.n_up_blocks, 2 * t1, h, d),
            n2=0, prelook_tail=z(2, cfg.d_model),
            up_tail=z(cfg.up_stride * 2, cfg.d_model))


def _ln(x, w, b, eps):
    m = x.mean(dim=-1, keepdim=True)
    v = (x - m).square().mean(dim=-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * w + b


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [T, C], w [Cout, Cin, K], VALID."""
    return F.conv1d(x.T[None], w, b)[0].T


def _rel_pe(rel: torch.Tensor, d_model: int) -> torch.Tensor:
    """The sinusoid of each distance: [n, d], sin and cos interleaved."""
    half = d_model // 2
    omega = 1.0 / (10000.0 ** (2.0 * torch.arange(half, device=rel.device) / d_model))
    ang = rel[:, None].to(torch.float32) * omega.to(torch.float32)
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(-1, d_model)


def rel_pos_attention(x: torch.Tensor, lp: dict, cfg: ConformerConfig,
                      k_hist: torch.Tensor, v_hist: torch.Tensor, n_hist: int,
                      offset: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Espnet relative-position MHA over [valid history; chunk]; x [T, d]
    is the chunk after norm_mha. History row j sits at position j, chunk
    row i at offset + i. Returns (out [T, d], the chunk's k and v)."""
    t = x.shape[0]
    h, d = cfg.n_heads, cfg.head_dim
    q = F.linear(x, lp["q_w"], lp["q_b"]).reshape(t, h, d)
    k = F.linear(x, lp["k_w"], lp["k_b"]).reshape(t, h, d)
    v = F.linear(x, lp["v_w"], lp["v_b"]).reshape(t, h, d)
    n_h = min(n_hist, k_hist.shape[0])  # rows past it are masked out
    k_all = torch.cat([k_hist[:n_h].to(k.dtype), k])
    v_all = torch.cat([v_hist[:n_h].to(v.dtype), v])
    dev = x.device
    key_pos = torch.cat([torch.arange(n_h, device=dev),
                         offset + torch.arange(t, device=dev)])
    q_pos = offset + torch.arange(t, device=dev)
    rel = q_pos[:, None] - key_pos[None, :]  # [T, S]
    r0 = -(t - 1)  # the smallest distance: the chunk's first row to its last
    r1 = offset + t - 1 if n_h else t - 1  # the largest: to history row 0
    dists = torch.arange(r0, r1 + 1, device=dev)
    p = F.linear(_rel_pe(dists, cfg.d_model), lp["pos_w"]).reshape(-1, h, d)
    ac = torch.einsum("thd,shd->hts", q + lp["pos_bias_u"], k_all)
    bd_all = torch.einsum("thd,rhd->htr", q + lp["pos_bias_v"], p)  # [H, T, R]
    idx = (rel - r0).expand(h, t, -1)
    bd = torch.gather(bd_all, 2, idx)
    att = torch.softmax((ac + bd) / float(np.sqrt(d)), dim=-1)
    out = torch.einsum("hts,shd->thd", att, v_all)
    return F.linear(out.reshape(t, cfg.d_model), lp["o_w"], lp["o_b"]), k, v


def _push(hist: torch.Tensor, chunk: torch.Tensor, n: int) -> None:
    """Write chunk [L, T, H, D] at row n, the start clamped into the history
    (lax.dynamic_update_slice's rule)."""
    t = chunk.shape[1]
    s = max(0, min(n, hist.shape[1] - t))
    hist[:, s:s + t] = chunk.to(hist.dtype)


def _encoder_stack(x, layers, cfg, k_hist, v_hist, n_hist):
    new_k, new_v = [], []
    for li, lp in enumerate(layers):
        xn = _ln(x, lp["norm_mha_w"], lp["norm_mha_b"], cfg.ln_eps)
        att, kc, vc = rel_pos_attention(xn, lp, cfg, k_hist[li], v_hist[li],
                                        n_hist, n_hist)
        x = x + att
        xn = _ln(x, lp["norm_ff_w"], lp["norm_ff_b"], cfg.ln_eps)
        x = x + F.linear(F.silu(F.linear(xn, lp["ff1_w"], lp["ff1_b"])),
                         lp["ff2_w"], lp["ff2_b"])
        new_k.append(kc)
        new_v.append(vc)
    return x, torch.stack(new_k), torch.stack(new_v)


def encode_chunk(params: dict, cfg: ConformerConfig, xs: torch.Tensor,
                 state: ConformerState, last_chunk: bool = False
                 ) -> tuple[torch.Tensor, ConformerState]:
    """One streaming chunk: token embeddings [T, 512] -> (features
    [2 T', 512], the state, updated in place); T' = T - pre_lookahead, or
    T on the last chunk (zeros stand in for the look-ahead)."""
    scale = float(np.sqrt(cfg.d_model))
    x = _ln(F.linear(xs.to(torch.float32), params["embed_w"], params["embed_b"]),
            params["embed_ln_w"], params["embed_ln_b"], cfg.ln_eps) * scale
    if last_chunk:
        x = torch.cat([x, x.new_zeros((cfg.pre_lookahead, cfg.d_model))])
    y1 = _conv1d(x, params["prelook1_w"], params["prelook1_b"])
    y1 = torch.where(y1 >= 0, y1, 0.01 * y1)  # leaky ReLU
    y1c = torch.cat([state.prelook_tail.to(y1.dtype), y1])
    t1 = y1.shape[0]
    x = _conv1d(y1c, params["prelook2_w"], params["prelook2_b"]) + x[:t1]
    x, k1c, v1c = _encoder_stack(x, params["encoders"], cfg, state.k1, state.v1,
                                 state.n1)
    upc = torch.cat([state.up_tail.to(x.dtype), torch.repeat_interleave(x, 2, dim=0)])
    xu = _conv1d(upc, params["up_conv_w"], params["up_conv_b"])
    x2 = _ln(F.linear(xu, params["up_embed_w"], params["up_embed_b"]),
             params["up_embed_ln_w"], params["up_embed_ln_b"], cfg.ln_eps) * scale
    x2, k2c, v2c = _encoder_stack(x2, params["up_encoders"], cfg, state.k2,
                                  state.v2, state.n2)
    x2 = _ln(x2, params["after_norm_w"], params["after_norm_b"], cfg.ln_eps)
    _push(state.k1, k1c, state.n1)
    _push(state.v1, v1c, state.n1)
    _push(state.k2, k2c, state.n2)
    _push(state.v2, v2c, state.n2)
    state.n1 += t1
    state.n2 += x2.shape[0]
    state.prelook_tail = y1[-2:].to(state.prelook_tail.dtype)
    state.up_tail = upc[-cfg.up_stride * 2:].to(state.up_tail.dtype)
    return x2, state


def f32_getter(reader, device):
    """name -> the GGUF tensor as f32 on `device` (any stored type)."""
    def get(name):
        ti = reader.tensors[name]
        a = quants.dequantize(ti.data, ti.ggml_type, ti.shape)
        return torch.from_numpy(np.array(a, np.float32)).to(device)
    return get


_TOP = {
    "embed_w": "embed.out.0.weight", "embed_b": "embed.out.0.bias",
    "embed_ln_w": "embed.out.1.weight", "embed_ln_b": "embed.out.1.bias",
    "prelook1_w": "pre_lookahead_layer.conv1.weight",
    "prelook1_b": "pre_lookahead_layer.conv1.bias",
    "prelook2_w": "pre_lookahead_layer.conv2.weight",
    "prelook2_b": "pre_lookahead_layer.conv2.bias",
    "up_conv_w": "up_layer.conv.weight", "up_conv_b": "up_layer.conv.bias",
    "up_embed_w": "up_embed.out.0.weight", "up_embed_b": "up_embed.out.0.bias",
    "up_embed_ln_w": "up_embed.out.1.weight", "up_embed_ln_b": "up_embed.out.1.bias",
    "after_norm_w": "after_norm.weight", "after_norm_b": "after_norm.bias",
}
_LAYER = {
    "norm_ff_w": "norm_ff.weight", "norm_ff_b": "norm_ff.bias",
    "norm_mha_w": "norm_mha.weight", "norm_mha_b": "norm_mha.bias",
    "q_w": "self_attn.linear_q.weight", "q_b": "self_attn.linear_q.bias",
    "k_w": "self_attn.linear_k.weight", "k_b": "self_attn.linear_k.bias",
    "v_w": "self_attn.linear_v.weight", "v_b": "self_attn.linear_v.bias",
    "o_w": "self_attn.linear_out.weight", "o_b": "self_attn.linear_out.bias",
    "pos_w": "self_attn.linear_pos.weight",
    "pos_bias_u": "self_attn.pos_bias_u", "pos_bias_v": "self_attn.pos_bias_v",
    "ff1_w": "feed_forward.w_1.weight", "ff1_b": "feed_forward.w_1.bias",
    "ff2_w": "feed_forward.w_2.weight", "ff2_b": "feed_forward.w_2.bias",
}


def load_conformer_params(reader, device=None) -> tuple[dict, ConformerConfig]:
    """The encoder GGUF (token2wav's names) -> (f32 params, config)."""
    get = f32_getter(reader, resolve_device(device))
    p = {k: get(name) for k, name in _TOP.items()}
    for prefix in ("encoders", "up_encoders"):
        p[prefix] = []
        i = 0
        while f"{prefix}.{i}.norm_ff.weight" in reader.tensors:
            p[prefix].append({k: get(f"{prefix}.{i}.{name}")
                              for k, name in _LAYER.items()})
            i += 1
    cfg = ConformerConfig(d_model=int(p["embed_w"].shape[0]),
                          n_blocks=len(p["encoders"]),
                          n_up_blocks=len(p["up_encoders"]),
                          n_heads=int(p["encoders"][0]["pos_bias_u"].shape[0]),
                          d_ff=int(p["encoders"][0]["ff1_w"].shape[0]))
    return p, cfg
