"""The flow-matching estimator of Token2Wav: a causal DiT and the CFM Euler
solver (counterpart of omni_tpu/models/token2wav/dit.py).

fmDiT (in 320, out 80, depth 16, 8 heads of 64, hidden 512, MLP ratio 4):
each block is adaLN-9 modulation (shift, scale and gate of the attention,
the conv block and the MLP) around attention with a per-head LN on q and
k, a causal conv block (conv k -> LN(1e-5) -> mish -> conv k) and a GELU
MLP; the final layer is adaLN-2 + LN without affine + linear. The
timestep embedding: t * 1000 -> a 256-wide [cos | sin] (max period 10000)
-> a SiLU MLP -> 512.

The CFM solver: classifier-free guidance 0.7 with the main and the
guidance branch batched (B = 2), the cosine span t_i = 1 - cos(i / N *
pi / 2), Euler steps x += dt ((1 + cfg) dphi_main - cfg dphi_cfg), x0 =
temperature * N(0, 1) noise. Streaming: per (step, block) K/V caches of
`max_t_cache` frames (bf16) and conv tails, rolled as the JAX package
rolls them once full.

The noise is keyed by frame position, so a recomputed window draws the
same noise. The JAX package folds the frame into PRNGKey(42); the port
draws one table of N(0, 1) rows from a seeded `torch.Generator` on the
host when a state is made (`CFMState.create`; the same table on every
device) and reads row `frame` of it. A state's
frames never pass max_t_cache + a chunk, so the table holds them all.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ... import resolve_device
from .conformer import f32_getter

LN_EPS = 1e-6  # fmDiT kLnEps
CONV_LN_EPS = 1e-5
NOISE_SEED = 42
MAX_CHUNK = 64  # frames of one chunk (56 at most: 28 tokens, 2 frames each)


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    in_channels: int = 320
    out_channels: int = 80
    mlp_ratio: float = 4.0
    depth: int = 16
    num_heads: int = 8
    head_dim: int = 64
    hidden: int = 512
    freq_embed: int = 256
    t_scale: float = 1000.0
    cfg_rate: float = 0.7
    conv_kernel: int = 3
    max_t_cache: int = 600


@dataclasses.dataclass
class CFMState:
    """Streaming caches for every (step, block); B = 2 (guidance)."""

    k: torch.Tensor  # [steps, depth, 2, Tmax, H, D] bf16
    v: torch.Tensor
    conv1: torch.Tensor  # [steps, depth, 2, k - 1, hidden] bf16
    conv2: torch.Tensor
    n: int  # frames cached
    noise: torch.Tensor  # [Tmax + MAX_CHUNK, out_channels] f32, N(0, 1)

    @staticmethod
    def create(cfg: DiTConfig, n_steps: int, device=None,
               dtype=torch.bfloat16, seed: int = NOISE_SEED) -> "CFMState":
        device = resolve_device(device)
        kv = (n_steps, cfg.depth, 2, cfg.max_t_cache, cfg.num_heads, cfg.head_dim)
        tail = (n_steps, cfg.depth, 2, cfg.conv_kernel - 1, cfg.hidden)
        # drawn on the host, so the card and the CPU read the same table
        gen = torch.Generator().manual_seed(seed)
        noise = torch.randn((cfg.max_t_cache + MAX_CHUNK, cfg.out_channels),
                            generator=gen, dtype=torch.float32).to(device)
        return CFMState(
            torch.zeros(kv, dtype=dtype, device=device),
            torch.zeros(kv, dtype=dtype, device=device),
            torch.zeros(tail, dtype=dtype, device=device),
            torch.zeros(tail, dtype=dtype, device=device), 0, noise)


def _ln(x, w=None, b=None, eps=LN_EPS):
    m = x.mean(dim=-1, keepdim=True)
    v = (x - m).square().mean(dim=-1, keepdim=True)
    out = (x - m) * torch.rsqrt(v + eps)
    if w is not None:
        out = out * w
    if b is not None:
        out = out + b
    return out


def _mish(x):
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))  # softplus


def timestep_embedding(t: torch.Tensor, p: dict, cfg: DiTConfig) -> torch.Tensor:
    """t [B] -> [B, hidden]: the [cos | sin] embedding and a SiLU MLP."""
    half = cfg.freq_embed // 2
    freqs = torch.exp(-float(np.log(10000.0))
                      * torch.arange(half, device=t.device, dtype=torch.float32) / half)
    args = (t * cfg.t_scale)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return F.linear(F.silu(F.linear(emb, p["t_mlp1_w"], p["t_mlp1_b"])),
                    p["t_mlp2_w"], p["t_mlp2_b"])


def _causal_conv(x, w, b, tail):
    """x [B, T, C] with its left context tail [B, k - 1, C] -> (y [B, T,
    Cout], the new tail)."""
    xin = torch.cat([tail.to(x.dtype), x], dim=1)
    y = F.conv1d(xin.transpose(1, 2), w, b).transpose(1, 2)
    return y, xin[:, xin.shape[1] - (w.shape[-1] - 1):]


def dit_block(x: torch.Tensor, c: torch.Tensor, bp: dict, cfg: DiTConfig,
              kv_cache, n_cached: int, conv_tails):
    """One block over the chunk x [2, T, hidden] with its caches (kv_cache:
    ([2, Tc, H, D], ...) or None). Returns (x, the chunk's k and v, the new
    conv tails)."""
    b, t, hdim = x.shape
    ch = F.linear(F.silu(c), bp["ada_w"], bp["ada_b"]).reshape(b, 9, 1, hdim)

    def modulate(xn, i_shift, i_scale):
        return xn * (1.0 + ch[:, i_scale]) + ch[:, i_shift]

    xn = modulate(_ln(x), 0, 1)
    nh, hd = cfg.num_heads, cfg.head_dim
    q = _ln(F.linear(xn, bp["q_w"], bp["q_b"]).reshape(b, t, nh, hd),
            bp["qn_w"], bp["qn_b"])
    k = _ln(F.linear(xn, bp["k_w"], bp["k_b"]).reshape(b, t, nh, hd),
            bp["kn_w"], bp["kn_b"])
    v = F.linear(xn, bp["v_w"], bp["v_b"]).reshape(b, t, nh, hd)
    if kv_cache is not None:
        n = min(n_cached, kv_cache[0].shape[1])  # rows past it are masked
        k_all = torch.cat([kv_cache[0][:, :n].to(k.dtype), k], dim=1)
        v_all = torch.cat([kv_cache[1][:, :n].to(v.dtype), v], dim=1)
    else:
        k_all, v_all = k, v
    scores = torch.einsum("bthd,bshd->bhts", q, k_all) / float(np.sqrt(hd))
    att = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", att, v_all).reshape(b, t, hdim)
    x = x + F.linear(out, bp["proj_w"], bp["proj_b"]) * ch[:, 2]

    xn = modulate(_ln(x), 6, 7)
    y, nt1 = _causal_conv(xn, bp["conv1_w"], bp["conv1_b"], conv_tails[0])
    y = _mish(_ln(y, bp["conv_ln_w"], bp["conv_ln_b"], CONV_LN_EPS))
    y, nt2 = _causal_conv(y, bp["conv2_w"], bp["conv2_b"], conv_tails[1])
    x = x + y * ch[:, 8]

    xn = modulate(_ln(x), 3, 4)
    y = F.linear(F.gelu(F.linear(xn, bp["fc1_w"], bp["fc1_b"]), approximate="tanh"),
                 bp["fc2_w"], bp["fc2_b"])
    return x + y * ch[:, 5], k, v, (nt1, nt2)


def dit_forward_chunk(params: dict, cfg: DiTConfig, x, mu, t, spk, cond,
                      step_caches, n_cached: int):
    """One estimator evaluation over [2, T, 80] inputs. Returns (dphi
    [2, T, 80], (k, v, conv1 tail, conv2 tail) stacked over the blocks)."""
    b, t_len, _ = x.shape
    t_embed = timestep_embedding(t, params, cfg)
    spk_t = spk[:, None, :].expand(b, t_len, spk.shape[-1])
    h = F.linear(torch.cat([x, mu, spk_t, cond], dim=-1),
                 params["in_proj_w"], params["in_proj_b"])
    new = ([], [], [], [])
    for i, bp in enumerate(params["blocks"]):
        if step_caches is not None:
            kv = (step_caches["k"][i], step_caches["v"][i])
            tails = (step_caches["conv1"][i], step_caches["conv2"][i])
        else:
            kv = None
            z = h.new_zeros((b, cfg.conv_kernel - 1, cfg.hidden))
            tails = (z, z)
        h, kc, vc, (t1, t2) = dit_block(h, t_embed, bp, cfg, kv, n_cached, tails)
        for lst, a in zip(new, (kc, vc, t1, t2)):
            lst.append(a)
    shift, scale = F.linear(F.silu(t_embed), params["final_ada_w"],
                            params["final_ada_b"]).chunk(2, dim=-1)
    hn = _ln(h) * (1.0 + scale[:, None, :]) + shift[:, None, :]
    y = F.linear(hn, params["final_w"], params["final_b"])
    return y, tuple(torch.stack(lst) for lst in new)


def cosine_t_span(n_steps: int) -> np.ndarray:
    u = np.arange(n_steps + 1) / n_steps
    return (1.0 - np.cos(u * 0.5 * np.pi)).astype(np.float32)


def noise_rows(state: CFMState, t_len: int, temperature: float) -> torch.Tensor:
    """The chunk's x0: rows [n, n + t_len) of the state's table, times the
    temperature, [1, T, C]."""
    return (state.noise[state.n:state.n + t_len] * temperature)[None]


def cfm_solve_chunk(params: dict, cfg: DiTConfig, mu: torch.Tensor,
                    spk: torch.Tensor, state: CFMState, n_timesteps: int = 5,
                    temperature: float = 1.0) -> tuple[torch.Tensor, CFMState]:
    """The Euler solve with guidance of one chunk (mu [T, 80], spk [80]) -> (mel
    [T, 80], the state, its caches updated in place)."""
    t_len = mu.shape[0]
    mu_in = torch.stack([mu, torch.zeros_like(mu)])
    spk_in = torch.stack([spk, torch.zeros_like(spk)])
    cond_in = torch.zeros_like(mu_in)
    x = noise_rows(state, t_len, temperature).expand(2, -1, -1)
    span = cosine_t_span(n_timesteps)
    chunks = ([], [], [], [])
    for s in range(n_timesteps):
        t_val = torch.full((2,), float(span[s]), dtype=torch.float32, device=mu.device)
        dt = float(span[s + 1] - span[s])
        step_cache = {"k": state.k[s], "v": state.v[s],
                      "conv1": state.conv1[s], "conv2": state.conv2[s]}
        dphi, new = dit_forward_chunk(params, cfg, x, mu_in, t_val, spk_in, cond_in,
                                      step_cache, state.n)
        upd = (1.0 + cfg.cfg_rate) * dphi[0] - cfg.cfg_rate * dphi[1]
        x = x + dt * torch.stack([upd, upd])
        for lst, a in zip(chunks, new):
            lst.append(a)
    tmax = cfg.max_t_cache
    n = min(state.n, tmax - t_len)
    for cache, new in ((state.k, chunks[0]), (state.v, chunks[1])):
        if state.n + t_len > tmax:  # full: drop the oldest t_len frames
            cache.copy_(torch.roll(cache, -t_len, dims=3))
        cache[:, :, :, n:n + t_len] = torch.stack(new).to(cache.dtype)
    state.conv1 = torch.stack(chunks[2]).to(state.conv1.dtype)
    state.conv2 = torch.stack(chunks[3]).to(state.conv2.dtype)
    state.n = n + t_len
    return x[0], state


_TOP = {
    "in_proj_w": "estimator.in_proj.weight", "in_proj_b": "estimator.in_proj.bias",
    "t_mlp1_w": "estimator.t_embedder.mlp.0.weight",
    "t_mlp1_b": "estimator.t_embedder.mlp.0.bias",
    "t_mlp2_w": "estimator.t_embedder.mlp.2.weight",
    "t_mlp2_b": "estimator.t_embedder.mlp.2.bias",
    "final_ada_w": "estimator.final_layer.adaLN_modulation.1.weight",
    "final_ada_b": "estimator.final_layer.adaLN_modulation.1.bias",
    "final_w": "estimator.final_layer.linear.weight",
    "final_b": "estimator.final_layer.linear.bias",
}
_BLOCK = {
    "ada_w": "adaLN_modulation.1.weight", "ada_b": "adaLN_modulation.1.bias",
    "q_w": "attn.to_q.weight", "q_b": "attn.to_q.bias",
    "k_w": "attn.to_k.weight", "k_b": "attn.to_k.bias",
    "v_w": "attn.to_v.weight", "v_b": "attn.to_v.bias",
    "qn_w": "attn.q_norm.weight", "qn_b": "attn.q_norm.bias",
    "kn_w": "attn.k_norm.weight", "kn_b": "attn.k_norm.bias",
    "proj_w": "attn.proj.weight", "proj_b": "attn.proj.bias",
    "conv1_w": "conv.block.1.weight", "conv1_b": "conv.block.1.bias",
    "conv_ln_w": "conv.block.3.weight", "conv_ln_b": "conv.block.3.bias",
    "conv2_w": "conv.block.6.weight", "conv2_b": "conv.block.6.bias",
    "fc1_w": "mlp.fc1.weight", "fc1_b": "mlp.fc1.bias",
    "fc2_w": "mlp.fc2.weight", "fc2_b": "mlp.fc2.bias",
}


def load_dit_params(reader, device=None) -> tuple[dict, DiTConfig]:
    """The flow_matching GGUF -> (f32 params, config), the shapes read
    from the tensors as the JAX loader reads them."""
    get = f32_getter(reader, resolve_device(device))
    p = {k: get(name) for k, name in _TOP.items()}
    p["blocks"] = []
    i = 0
    while f"estimator.blocks.{i}.attn.to_q.weight" in reader.tensors:
        p["blocks"].append({k: get(f"estimator.blocks.{i}.{name}")
                            for k, name in _BLOCK.items()})
        i += 1
    hidden = int(p["in_proj_w"].shape[0])
    head_dim = int(p["blocks"][0]["qn_w"].shape[0])
    cfg = DiTConfig(in_channels=int(p["in_proj_w"].shape[1]),
                    out_channels=int(p["final_w"].shape[0]), depth=i,
                    hidden=hidden, conv_kernel=int(p["blocks"][0]["conv1_w"].shape[-1]),
                    num_heads=max(hidden // head_dim, 1), head_dim=head_dim,
                    freq_embed=int(p["t_mlp1_w"].shape[1]))
    return p, cfg
