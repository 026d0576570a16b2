"""VPM: the SigLip2 vision encoder and MiniCPM-V's resampler (counterpart
of omni_tpu/models/siglip.py).

Patch embedding 3 -> 1152 (14 x 14, stride 14, bias), learned positions
picked by 70 x 70 bucket coordinates (vision.cpp:1955-1972), 26 pre-LN
layers (d 1152, 16 heads, GELU-tanh FFN 4304, q/k/v biases), post-LN; then
the resampler: kv_proj 1152 -> 4096 (no bias), 64 learned queries, one
multi-head attention at d 4096 (heads of 128) whose K is ln_kv(v) plus a
2D sincos table at the slice's patch grid (vision.cpp:1714-1797), out
projection, ln_post and proj. One image or slice -> 64 rows x 4096.

Plain functions on tensors, as models/whisper.py: f32 weights, as the JAX
package keeps them, and f32 products (`F.linear`, einsum attention and
softmax; the JAX package runs these in XLA, outside any Pallas kernel).
The patch embedding is a reshape and one product (its stride is its
kernel, its padding VALID), so the patches stay in the JAX order (row
major) and no convolution library is called. On the card TF32 must be off
for the f32 law (`omni_cli.main` and chip_smoke.py turn it off).

GGUF names per the converter (convert_vpm.py: "v.blk.N.*",
"resampler.*"); the historical ffn_up/ffn_down swap is detected by shape
as the reference loader does (vision.cpp:1015-1026).
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
class SigLipConfig:
    n_layers: int = 26
    d_model: int = 1152
    n_heads: int = 16
    d_ff: int = 4304
    patch_size: int = 14
    image_size: int = 980
    d_out: int = 4096
    n_queries: int = 64
    pos_buckets: int = 70
    eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def from_gguf(kv: dict[str, Any]) -> "SigLipConfig":
        g = lambda k, d: kv.get(f"clip.vision.{k}", d)
        return SigLipConfig(
            n_layers=int(g("block_count", 26)),
            d_model=int(g("embedding_length", 1152)),
            n_heads=int(g("attention.head_count", 16)),
            d_ff=int(g("feed_forward_length", 4304)),
            patch_size=int(g("patch_size", 14)),
            image_size=int(g("image_size", 980)),
            n_queries=int(kv.get("clip.minicpmv_query_num", 64)),
            d_out=int(g("projection_dim", 4096)),
        )


def _swap_up_down(lp: dict) -> dict:
    """The historical converter name swap: "up" must map d -> ff."""
    if lp["w_up"].shape[1] != lp["ln1_w"].shape[0]:
        lp["w_up"], lp["w_down"] = lp["w_down"], lp["w_up"]
        lp["b_up"], lp["b_down"] = lp["b_down"], lp["b_up"]
    return lp


def load_params(reader, device=None) -> dict:
    """VPM GGUF -> f32 tensors under the JAX package's names; `patch_w`
    viewed as the product's weight [d, 3 * p * p] in (c, kh, kw) order.
    `pre_ln_w`/`pre_ln_b` are None where the file has no pre-LN."""
    device = resolve_device(device)

    def get(name, required=True):
        if name not in reader.tensors:
            if required:
                raise KeyError(f"VPM tensor missing: {name}")
            return None
        ti = reader.tensors[name]
        a = quants.dequantize(ti.data, ti.ggml_type, ti.shape)
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    p = {
        "patch_w": get("v.patch_embd.weight"),  # [d, 3, p, p]
        "patch_b": get("v.patch_embd.bias"),
        "pos": get("v.position_embd.weight"),  # [buckets^2, d]
        "post_ln_w": get("v.post_ln.weight"), "post_ln_b": get("v.post_ln.bias"),
        "pre_ln_w": get("v.pre_ln.weight", False),
        "pre_ln_b": get("v.pre_ln.bias", False),
        "rs_query": get("resampler.query"),  # [n_queries, d_out]
        "rs_kv_proj": get("resampler.kv.weight"),  # [d_out, d]
        "rs_q_w": get("resampler.attn.q.weight"), "rs_q_b": get("resampler.attn.q.bias"),
        "rs_k_w": get("resampler.attn.k.weight"), "rs_k_b": get("resampler.attn.k.bias"),
        "rs_v_w": get("resampler.attn.v.weight"), "rs_v_b": get("resampler.attn.v.bias"),
        "rs_o_w": get("resampler.attn.out.weight"), "rs_o_b": get("resampler.attn.out.bias"),
        "rs_ln_q_w": get("resampler.ln_q.weight"), "rs_ln_q_b": get("resampler.ln_q.bias"),
        "rs_ln_kv_w": get("resampler.ln_kv.weight"), "rs_ln_kv_b": get("resampler.ln_kv.bias"),
        "rs_ln_post_w": get("resampler.ln_post.weight"),
        "rs_ln_post_b": get("resampler.ln_post.bias"),
        "rs_proj": get("resampler.proj.weight"),  # [d_out, d_out]
        "layers": [],
    }
    p["patch_w"] = p["patch_w"].reshape(p["patch_w"].shape[0], -1)
    i = 0
    while f"v.blk.{i}.ln1.weight" in reader.tensors:
        b = f"v.blk.{i}."
        p["layers"].append(_swap_up_down({
            "ln1_w": get(b + "ln1.weight"), "ln1_b": get(b + "ln1.bias"),
            "wq": get(b + "attn_q.weight"), "bq": get(b + "attn_q.bias", False),
            "wk": get(b + "attn_k.weight"), "bk": get(b + "attn_k.bias", False),
            "wv": get(b + "attn_v.weight"), "bv": get(b + "attn_v.bias", False),
            "wo": get(b + "attn_out.weight"), "bo": get(b + "attn_out.bias", False),
            "ln2_w": get(b + "ln2.weight"), "ln2_b": get(b + "ln2.bias"),
            "w_up": get(b + "ffn_up.weight"), "b_up": get(b + "ffn_up.bias", False),
            "w_down": get(b + "ffn_down.weight"),
            "b_down": get(b + "ffn_down.bias", False),
        }))
        i += 1
    return p


# ---------------------------------------------------------------------------
# position embeddings (host, numpy)
# ---------------------------------------------------------------------------

def bucket_positions(h_patches: int, w_patches: int, buckets: int = 70) -> np.ndarray:
    """The learned positions' indices: each patch's row and column
    interpolated onto a buckets x buckets grid, row major
    (vision.cpp:1955-1972)."""
    bh = np.floor(buckets * np.arange(h_patches) / h_patches).astype(np.int32)
    bw = np.floor(buckets * np.arange(w_patches) / w_patches).astype(np.int32)
    return (bh[:, None] * buckets + bw[None, :]).reshape(-1)


def sincos_pos_embed_2d(embed_dim: int, w: int, h: int) -> np.ndarray:
    """The resampler's K-side 2D sincos table at the slice's patch grid,
    as vision.cpp's get_2d_sincos_pos_embed(embed_dim, {w, h}) with its
    w-major flatten (vision.cpp:1758-1797), which transposes the grid: row
    i (of w * h) is patch (i // w, i % w) of the h x w grid, its first half
    the sincos of the column i % w, its second half of the row i // w.
    Returns [w * h, embed_dim] f32."""
    half = embed_dim // 2
    quarter = half // 2
    omega = 1.0 / (10000.0 ** (np.arange(quarter, dtype=np.float64) / quarter))
    out_a = np.arange(w, dtype=np.float64)[:, None, None] * omega  # [w, 1, q]
    out_b = np.arange(h, dtype=np.float64)[None, :, None] * omega  # [1, h, q]
    emb_a = np.concatenate([np.sin(out_a), np.cos(out_a)], -1)
    emb_b = np.concatenate([np.sin(out_b), np.cos(out_b)], -1)
    emb = np.concatenate([np.broadcast_to(emb_a, (w, h, half)),
                          np.broadcast_to(emb_b, (w, h, half))], axis=-1)
    return emb.transpose(1, 0, 2).reshape(h * w, embed_dim).astype(np.float32)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float) -> torch.Tensor:
    """q [T, H, D], k/v [S, H, D] -> [T, H * D]: softmax(q k^T * scale) v
    in f32."""
    att = torch.softmax(torch.einsum("thd,shd->hts", q, k) * scale, dim=-1)
    return torch.einsum("hts,shd->thd", att, v).reshape(q.shape[0], -1)


def patch_rows(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """[H, W, 3] -> [hp * wp, 3 * patch * patch]: the patches row major,
    each in (c, kh, kw) order (the weight's OIHW layout)."""
    hp, wp = pixels.shape[0] // patch, pixels.shape[1] // patch
    x = pixels[:hp * patch, :wp * patch].reshape(hp, patch, wp, patch, 3)
    return x.permute(0, 2, 4, 1, 3).reshape(hp * wp, 3 * patch * patch)


def encode_image(params: dict, cfg: SigLipConfig, pixels: torch.Tensor,
                 pos_ids: torch.Tensor, k_pos_embed: torch.Tensor) -> torch.Tensor:
    """One image or slice -> [n_queries, d_out] f32.

    pixels: [H, W, 3] normalized f32, H and W multiples of the patch size;
    pos_ids: [n_patches] bucket indices; k_pos_embed: [n_patches, d_out]."""
    x = patch_rows(pixels.to(torch.float32), cfg.patch_size)
    n = x.shape[0]
    h = F.linear(x, params["patch_w"], params["patch_b"]) + params["pos"][pos_ids]
    if params.get("pre_ln_w") is not None:
        h = layer_norm(h, params["pre_ln_w"], params["pre_ln_b"], cfg.eps)

    H, Dh = cfg.n_heads, cfg.head_dim
    scale = 1.0 / float(np.sqrt(Dh))
    for lp in params["layers"]:
        hn = layer_norm(h, lp["ln1_w"], lp["ln1_b"], cfg.eps)
        q = F.linear(hn, lp["wq"], lp["bq"]).reshape(n, H, Dh)
        k = F.linear(hn, lp["wk"], lp["bk"]).reshape(n, H, Dh)
        v = F.linear(hn, lp["wv"], lp["bv"]).reshape(n, H, Dh)
        h = h + F.linear(_attend(q, k, v, scale), lp["wo"], lp["bo"])
        hn = layer_norm(h, lp["ln2_w"], lp["ln2_b"], cfg.eps)
        up = F.gelu(F.linear(hn, lp["w_up"], lp["b_up"]), approximate="tanh")
        h = h + F.linear(up, lp["w_down"], lp["b_down"])
    h = layer_norm(h, params["post_ln_w"], params["post_ln_b"], cfg.eps)

    # the resampler
    v = F.linear(h, params["rs_kv_proj"])  # no bias
    q = layer_norm(params["rs_query"], params["rs_ln_q_w"], params["rs_ln_q_b"], cfg.eps)
    v = layer_norm(v, params["rs_ln_kv_w"], params["rs_ln_kv_b"], cfg.eps)
    k = v + k_pos_embed
    d_head = min(128, cfg.d_out)
    n_head = max(cfg.d_out // d_head, 1)
    Q = F.linear(q, params["rs_q_w"], params["rs_q_b"]).reshape(-1, n_head, d_head)
    K = F.linear(k, params["rs_k_w"], params["rs_k_b"]).reshape(n, n_head, d_head)
    V = F.linear(v, params["rs_v_w"], params["rs_v_b"]).reshape(n, n_head, d_head)
    out = F.linear(_attend(Q, K, V, 1.0 / float(np.sqrt(d_head))),
                   params["rs_o_w"], params["rs_o_b"])
    out = layer_norm(out, params["rs_ln_post_w"], params["rs_ln_post_b"], cfg.eps)
    return F.linear(out, params["rs_proj"])


def encode_image_np(params: dict, cfg: SigLipConfig, pixels_np: np.ndarray) -> torch.Tensor:
    """Host wrapper: a normalized f32 [H, W, 3] array -> [n_queries, d_out]
    on the params' device (the bucket ids and the sincos table made on the
    host, as the JAX package's `encode_image_np`)."""
    dev = params["pos"].device
    hp = pixels_np.shape[0] // cfg.patch_size
    wp = pixels_np.shape[1] // cfg.patch_size
    pos_ids = torch.from_numpy(bucket_positions(hp, wp, cfg.pos_buckets).astype(np.int64))
    pe = torch.from_numpy(sincos_pos_embed_2d(cfg.d_out, wp, hp))
    pixels = torch.from_numpy(np.ascontiguousarray(pixels_np, np.float32))
    return encode_image(params, cfg, pixels.to(dev), pos_ids.to(dev), pe.to(dev))
