"""Fused quantized gated FFN: kernel I and its plain version.

Counterpart of `omni_tpu/kernels/fused_ffn.py::qffn_pallas`: the whole
gated FFN of a layer, `down(act(x·Wg) ∘ (x·Wu))`, in one call, the gate and
up weights fused as one [2F, K] QTensor (gate rows first) and the down
weight [N, F] a QTensor of any format, independent of the gate/up one. The
law is the TPU kernel's:
- x rounded to bf16, every weight dequantised and rounded once to bf16
  (`dequant_tile`'s law, `qformats.dequant`);
- g and u summed in f32 and never rounded;
- h = act(g)·u in f32, rounded to bf16 once; act is SiLU (g·logistic(g))
  or the tanh form of GELU (`jax.nn.gelu(approximate=True)`);
- the down product summed in f32 over all of F, cast once to `out_dtype`.
It is not the law of the unfused composition, which rounds g and u, then
act(g), to bf16 before the product.

On a CUDA tensor `qffn` launches kernel I (`csrc/qffn.cu`: one launch over
chunks of F that writes an f32 partial per chunk, a second that sums them
in chunk order) or raises; on a CPU tensor it runs `qffn_plain`.
"""

from __future__ import annotations

import math

import torch

from ..core.dtypes import GGMLType
from .qformats import PLANES, QUANTIZED, QTensor, check_qtensor, dequant, tile_granule

ACTS = {"silu": 0, "gelu_tanh": 1}
CHUNK = 256  # columns of F per block of kernel I (one K step of the down weight)

# kernel I's launches (both of its launches count as one), and per
# (gate/up, down) format pair, e.g. "Q4_0/Q4_1"; a run resets and reads them
launches = {"qffn": 0}
qffn_launches: dict[str, int] = {}

# kernel I's f32 partials [chunks, M, N] per (device, M, N, chunks), kept so
# that a decode step allocates nothing new
_workspace: dict[tuple, torch.Tensor] = {}


def reset_launches() -> None:
    launches["qffn"] = 0
    qffn_launches.clear()


def pair_name(gu: QTensor, down: QTensor) -> str:
    """The key of a (gate/up, down) format pair in `qffn_launches`."""
    return f"{GGMLType(gu.ggml_type).name}/{GGMLType(down.ggml_type).name}"


def _on_cuda(x: torch.Tensor) -> bool:
    return x.is_cuda


def _check(x: torch.Tensor, gu: QTensor, down: QTensor, act: str, out_dtype) -> None:
    if not (isinstance(gu, QTensor) and isinstance(down, QTensor)):
        raise ValueError("qffn takes QTensor weights; a dense FFN is a composition "
                         "of dense dots")
    check_qtensor(gu, *QUANTIZED)
    check_qtensor(down, *QUANTIZED)
    n_out, f = down.shape
    if x.dim() != 2 or x.shape[1] != gu.shape[1] or gu.shape[0] != 2 * f:
        raise ValueError(f"qffn: x {tuple(x.shape)}, gate/up {gu.shape} and down "
                         f"{down.shape} do not make an FFN")
    for qt in (gu, down):  # F holds whole blocks of both formats, as in qffn_pallas
        if f % tile_granule(qt.ggml_type):
            raise ValueError(f"qffn: F={f} is not a multiple of "
                             f"{GGMLType(qt.ggml_type).name}'s granule "
                             f"{tile_granule(qt.ggml_type)}")
    if act not in ACTS:
        raise ValueError(f"qffn: act {act!r}, want one of {sorted(ACTS)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"qffn: out_dtype {out_dtype}: want bfloat16 or float32")


def gated(g: torch.Tensor, u: torch.Tensor, act: str) -> torch.Tensor:
    """act(g)·u in f32, in the TPU kernel's order: (g·logistic(g))·u, or
    (g·(0.5·(1 + tanh(√(2/π)·(g + 0.044715·g³)))))·u."""
    if act == "silu":
        return g * torch.sigmoid(g) * u
    inner = math.sqrt(2 / math.pi) * (g + 0.044715 * (g * g * g))
    return g * (0.5 * (1.0 + torch.tanh(inner))) * u


def qffn_plain(x: torch.Tensor, gu: QTensor, down: QTensor, act: str = "silu",
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel I's law in plain PyTorch (qffn_pallas's): bf16 x and weights,
    g and u in f32, h = bf16(act(g)·u), the down product in f32."""
    f = down.shape[1]
    xb = x.to(torch.bfloat16).to(torch.float32)
    w = dequant(gu, torch.bfloat16).to(torch.float32)
    g, u = xb @ w[:f].T, xb @ w[f:].T
    del w
    h = gated(g, u, act).to(torch.bfloat16).to(torch.float32)
    return (h @ dequant(down, torch.bfloat16).to(torch.float32).T).to(out_dtype)


def workspace(device, m: int, n: int, chunks: int) -> torch.Tensor:
    """Kernel I's f32 partials [chunks, m, n] on `device`, made once per
    shape."""
    key = (str(device), m, n, chunks)
    ws = _workspace.get(key)
    if ws is None:
        ws = _workspace[key] = torch.empty((chunks, m, n), dtype=torch.float32,
                                           device=device)
    return ws


def _launch(x: torch.Tensor, gu: QTensor, down: QTensor, act: str,
            out_dtype) -> torch.Tensor:
    """Launch kernel I on the current stream (CUDA tensors only). The entry
    takes the gate, up and down planes (q, sc, mn, d, dm, qh each, null
    where the format has none); up is rows [F, 2F) of the fused weight."""
    x = x.to(torch.bfloat16).contiguous()
    n_out, f = down.shape
    gate = [getattr(gu, nm) for nm in PLANES]
    up = [None if p is None else p[f:] for p in gate]
    dn = [getattr(down, nm) for nm in PLANES]
    if any(p is not None and p.device != x.device for p in gate + dn):
        raise ValueError("qffn: x and weight planes on different devices")
    if x.data_ptr() % 16 or any(p.data_ptr() % 16 for p in (gu.q, up[0], down.q)):
        raise ValueError("qffn: x and q planes must be 16-byte aligned")
    if any(p is not None and p.data_ptr() % 2 for p in (gu.qh, up[5], down.qh)):
        raise ValueError("qffn: qh planes must be 2-byte aligned")  # read in 16-bit words
    from . import _build

    fn = _build.load()["qffn"]
    m, k = x.shape
    chunks = -(-f // CHUNK)
    part = workspace(x.device, m, n_out, chunks)
    out = torch.empty((m, n_out), dtype=out_dtype, device=x.device)
    rc = fn(x.data_ptr(), *(0 if p is None else p.data_ptr() for p in gate + up + dn),
            part.data_ptr(), out.data_ptr(), m, k, f, n_out, int(gu.ggml_type),
            int(down.ggml_type), ACTS[act], int(out_dtype == torch.float32),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qffn launch failed: CUDA error {rc}")
    launches["qffn"] += 1
    key = pair_name(gu, down)
    qffn_launches[key] = qffn_launches.get(key, 0) + 1
    return out


def qffn(x: torch.Tensor, gu: QTensor, down: QTensor, act: str = "silu",
         out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel I (replaces qffn_pallas): the gated FFN of x [M, K] through the
    fused gate/up weight gu [2F, K] and down [N, F], any M, each weight in
    any of the thirteen formats the JAX package keeps quantized. On a CUDA
    tensor it launches the kernel or raises; on a CPU tensor it runs
    `qffn_plain`."""
    _check(x, gu, down, act, out_dtype)
    if _on_cuda(x):
        return _launch(x, gu, down, act, out_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"qffn: unsupported device {x.device}")
    return qffn_plain(x, gu, down, act, out_dtype)
