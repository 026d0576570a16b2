"""APM: the streaming Whisper-style audio encoder of MiniCPM-o 4.5
(counterpart of omni_tpu/models/whisper.py).

conv1 (k3, s1, same) + GELU -> conv2 (k3, s2, same) + GELU -> + the
positional table at the offset of the frames already cached -> 24 pre-LN
layers (d 1024, 16 heads, k without bias, GELU MLP) -> final LN ->
projector linear1 (1024 -> 4096) + ReLU + linear2 (4096 -> 4096) ->
AvgPool1d(5, 5) over time. One second of 16 kHz audio is 100 mel frames,
50 conv frames and 10 LLM rows. GELU is the tanh form (ggml_gelu).

Streaming: a K/V cache of `n_audio_ctx` (1,500) conv frames a layer lets
each chunk attend over up to 30 s of audio, with full (non-causal)
attention inside the cached window. The weights are f32, as the JAX
package keeps them; on the card the products and the convolutions must
run in f32: `omni_cli.main` and chip_smoke.py turn TF32 off for both
(`torch.backends.cuda.matmul.allow_tf32`, and
`torch.backends.cudnn.allow_tf32`, whose default is True).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..core import quants
from ..kernels.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_layers: int = 24
    d_model: int = 1024
    n_heads: int = 16
    n_audio_ctx: int = 1500
    n_mels: int = 80
    d_out: int = 4096
    pool: int = 5
    eps: float = 1e-6  # audition.cpp:82

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def from_gguf(kv: dict[str, Any]) -> "WhisperConfig":
        return WhisperConfig(
            n_layers=int(kv.get("encoder_layers", 24)),
            d_model=int(kv.get("d_model", 1024)),
            n_heads=int(kv.get("encoder_attention_heads", 16)),
            n_mels=int(kv.get("n_mel", 80)),
            n_audio_ctx=int(kv.get("n_audio_ctx", 1500)),
            d_out=int(kv.get("audio_projection_dim", 4096)))


@dataclasses.dataclass
class WhisperState:
    """The streaming cache of one audio session: K/V [L, n_audio_ctx, H, Dh]
    and the conv frames cached so far (the positional offset), a host int
    since every chunk's length is known on the host."""

    k: torch.Tensor
    v: torch.Tensor
    n_cached: int = 0

    @staticmethod
    def create(cfg: WhisperConfig, device=None,
               dtype=torch.float32) -> "WhisperState":
        device = resolve_device(device)
        shape = (cfg.n_layers, cfg.n_audio_ctx, cfg.n_heads, cfg.head_dim)
        return WhisperState(torch.zeros(shape, dtype=dtype, device=device),
                            torch.zeros(shape, dtype=dtype, device=device))


def load_params(reader, device=None) -> dict:
    """APM GGUF (the converter's names, convert_apm.py) -> f32 tensors."""
    device = resolve_device(device)

    def get(name):
        if name not in reader.tensors:
            raise KeyError(f"APM tensor missing: {name}")
        ti = reader.tensors[name]
        a = quants.dequantize(ti.data, ti.ggml_type, ti.shape)
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    p = {
        "conv1_w": get("encoder.conv1.weight"),  # [d, n_mels, 3]
        "conv1_b": get("encoder.conv1.bias").reshape(-1),
        "conv2_w": get("encoder.conv2.weight"),  # [d, d, 3]
        "conv2_b": get("encoder.conv2.bias").reshape(-1),
        "pos": get("encoder.positional_embedding"),  # [n_audio_ctx, d]
        "ln_post_w": get("encoder.ln_post.weight"),
        "ln_post_b": get("encoder.ln_post.bias"),
        "proj1_w": get("audio_projector.linear1.weight"),
        "proj1_b": get("audio_projector.linear1.bias"),
        "proj2_w": get("audio_projector.linear2.weight"),
        "proj2_b": get("audio_projector.linear2.bias"),
        "layers": [],
    }
    i = 0
    while f"encoder.blocks.{i}.attn_ln.weight" in reader.tensors:
        b = f"encoder.blocks.{i}."
        p["layers"].append({
            "attn_ln_w": get(b + "attn_ln.weight"),
            "attn_ln_b": get(b + "attn_ln.bias"),
            "wq": get(b + "attn.query.weight"), "bq": get(b + "attn.query.bias"),
            "wk": get(b + "attn.key.weight"),  # no bias (Whisper)
            "wv": get(b + "attn.value.weight"), "bv": get(b + "attn.value.bias"),
            "wo": get(b + "attn.out.weight"), "bo": get(b + "attn.out.bias"),
            "mlp_ln_w": get(b + "mlp_ln.weight"),
            "mlp_ln_b": get(b + "mlp_ln.bias"),
            "w1": get(b + "mlp.0.weight"), "b1": get(b + "mlp.0.bias"),
            "w2": get(b + "mlp.2.weight"), "b2": get(b + "mlp.2.bias"),
        })
        i += 1
    return p


def mel_filters_from_gguf(kv: dict[str, Any]) -> np.ndarray:
    """The [n_mel, n_fft // 2 + 1] filterbank stored as a flat KV array."""
    return np.asarray(kv["filters"], np.float32).reshape(int(kv["n_mel"]), -1)


def _conv1d_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 stride: int) -> torch.Tensor:
    """x [T, Cin], w [Cout, Cin, K] -> [T', Cout], padding K // 2
    (ggml_conv_1d_ph)."""
    y = F.conv1d(x.T[None], w, b, stride=stride, padding=w.shape[-1] // 2)
    return y[0].T


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def encode_chunk(params: dict, cfg: WhisperConfig, mel: torch.Tensor,
                 state: WhisperState) -> tuple[torch.Tensor, WhisperState]:
    """One streaming chunk: mel [T_mel, n_mels] -> (embeddings
    [T_mel // 10, d_out] f32, the state, updated in place). T_mel must be
    even (conv2's stride). As in the JAX package, a chunk whose frames
    would run past the cache is written at the cache's end (the slice
    start clamped) while the valid count keeps growing."""
    x = _gelu(_conv1d_same(mel.to(torch.float32), params["conv1_w"],
                           params["conv1_b"], 1))
    x = _gelu(_conv1d_same(x, params["conv2_w"], params["conv2_b"], 2))
    t = x.shape[0]
    S = cfg.n_audio_ctx
    off = state.n_cached
    start = max(0, min(off, S - t))  # lax.dynamic_slice's clamp
    h = x + params["pos"][start:start + t]
    n_valid = off + t
    n_att = min(n_valid, S)  # cells past it are masked out (weight 0)
    scale = 1.0 / float(np.sqrt(cfg.head_dim))
    H, Dh = cfg.n_heads, cfg.head_dim
    for li, lp in enumerate(params["layers"]):
        hn = layer_norm(h, lp["attn_ln_w"], lp["attn_ln_b"], cfg.eps)
        q = F.linear(hn, lp["wq"], lp["bq"]).reshape(t, H, Dh)
        state.k[li, start:start + t] = F.linear(hn, lp["wk"]).reshape(t, H, Dh)
        state.v[li, start:start + t] = F.linear(hn, lp["wv"], lp["bv"]).reshape(t, H, Dh)
        kc, vc = state.k[li, :n_att].float(), state.v[li, :n_att].float()
        scores = torch.einsum("thd,shd->hts", q, kc) * scale
        att = torch.softmax(scores, dim=-1)
        out = torch.einsum("hts,shd->thd", att, vc)
        h = h + F.linear(out.reshape(t, cfg.d_model), lp["wo"], lp["bo"])
        hn = layer_norm(h, lp["mlp_ln_w"], lp["mlp_ln_b"], cfg.eps)
        h = h + F.linear(_gelu(F.linear(hn, lp["w1"], lp["b1"])), lp["w2"], lp["b2"])
    h = layer_norm(h, params["ln_post_w"], params["ln_post_b"], cfg.eps)
    h = F.linear(torch.relu(F.linear(h, params["proj1_w"], params["proj1_b"])),
             params["proj2_w"], params["proj2_b"])
    n_out = t // cfg.pool  # AvgPool1d(k=5, s=5) over time
    h = h[:n_out * cfg.pool].reshape(n_out, cfg.pool, -1).mean(dim=1)
    state.n_cached = n_valid
    return h, state
