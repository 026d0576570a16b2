"""Synthetic full-size Qwen3 parameters (counterpart of
omni_tpu/testing_synth.py): random but numerically tame Q4_K planes, made
ON THE DEVICE from a `torch.Generator`, so no multi-GB host-to-device copy
happens. The value ranges are the JAX package's: nibbles 0..255 per byte,
sc 20..63, mn 0..39, d and dm uniform in [1e-5, 1.1e-4), a bf16 embedding
uniform in [-0.02, 0.02). Dense decode speed does not depend on the
values."""

from __future__ import annotations

import torch

from .core.dtypes import GGMLType
from .kernels.qformats import QTensor
from .models.qwen3 import Qwen3Config, fuse_layer

QWEN3_8B = Qwen3Config(
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12288, n_vocab=151748, rope_base=1000000.0, rms_eps=1e-6,
)


def synth_q4k(n: int, k: int, device, generator: torch.Generator) -> QTensor:
    """Random Q4_K QTensor [n, k] in the port's N-major layout."""
    def ints(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, dtype=dtype, device=device,
                             generator=generator)

    def unif(shape):
        return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
            1e-5, 1.1e-4, generator=generator)

    return QTensor(GGMLType.Q4_K, (n, k),
                   q=ints(0, 256, (n, k // 2), torch.uint8),
                   sc=ints(20, 64, (n, k // 32), torch.int8),
                   mn=ints(0, 40, (n, k // 32), torch.int8),
                   d=unif((n, k // 256)), dm=unif((n, k // 256)))


def synth_qwen3_params(cfg: Qwen3Config = QWEN3_8B, device=None,
                       generator: torch.Generator | None = None,
                       fuse: bool = True) -> dict:
    """Parameter dict of a random Q4_K Qwen3 (separate output head) on
    `device`. `generator` must live on that device; default: seed 0."""
    from . import resolve_device

    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d, ff = cfg.d_model, cfg.d_ff
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim

    def q4k(n, k):
        return synth_q4k(n, k, device, generator)

    def norm(n):
        return torch.ones((n,), dtype=torch.float32, device=device)

    params = {
        "token_embd": torch.empty((cfg.n_vocab, d), dtype=torch.bfloat16,
                                  device=device).uniform_(
            -0.02, 0.02, generator=generator),
        "output_norm": norm(d),
        "output": q4k(cfg.n_vocab, d),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": norm(d),
            "wq": q4k(qd, d), "wk": q4k(kvd, d), "wv": q4k(kvd, d),
            "wo": q4k(d, qd),
            "q_norm": norm(cfg.head_dim), "k_norm": norm(cfg.head_dim),
            "ffn_norm": norm(d),
            "w_gate": q4k(ff, d), "w_up": q4k(ff, d), "w_down": q4k(d, ff),
        }
        params["layers"].append(fuse_layer(layer) if fuse else layer)
    return params
