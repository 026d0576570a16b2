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

h lives in device memory as bf16 between two passes, which rounds it
exactly as the law does.

On a CUDA tensor `qffn` launches kernel I (`csrc/qffn.cu`) or raises; on a
CPU tensor it runs `qffn_plain`. Kernel I is two passes, a gated pass that
writes h = bf16(act(g)·u) to a workspace and a down pass, in one of two
regimes, a plain branch on M (`qffn_plan`):
- M <= GP_MAX_M (8), decode: register-dequant GEMVs. Each block forms the
  bf16 weights of 16 rows in registers (qstage.cuh's weight formula) and
  feeds them to the tensor cores with x; the gated pass takes the gate and
  up rows of eight h columns, the down pass 16 output rows, summing over
  all of F in f32.
- M > 8, prefill: `csrc/qmma.cuh`'s pipelined mainloop, shared with
  kernels B and D: over the fused [2F, K] weight into f32 g|u, a small
  pass to h, then over h against the down weight; each with its split
  count from `dequant_matmul.gemm_splits`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.dtypes import GGMLType
from . import dequant_matmul as dm
from .qformats import PLANES, QUANTIZED, QTensor, check_qtensor, dequant, tile_granule

ACTS = {"silu": 0, "gelu_tanh": 1}

# kernel I's launches (both of its passes count as one), and per
# (gate/up, down) format pair, e.g. "Q4_0/Q4_1"; a run resets and reads them
launches = {"qffn": 0}
qffn_launches: dict[str, int] = {}

# kernel I's workspaces per (device, bytes), kept so that a decode step
# allocates nothing new and a call can be captured in a CUDA graph
_workspace: dict[tuple, torch.Tensor] = {}


class QffnPlan(NamedTuple):
    """How kernel I runs one call: its regime ("gemv": the register-dequant
    passes at M <= GP_MAX_M; "gemm": qmma.cuh's mainloop), the mainloop's
    split counts of the gate/up and down passes (1 in the gemv regime) and
    the workspace bytes (csrc/qffn.cu: h bf16 [M, F]; for "gemm" then g|u
    f32 [M, 2F] and the larger pass's split partials)."""
    regime: str
    splits_gu: int
    splits_dn: int
    workspace_bytes: int


def qffn_plan(m: int, n: int, k: int, f: int, t_gu: GGMLType,
              t_dn: GGMLType) -> QffnPlan:
    """Kernel I's plan for x [m, k], the fused gate/up weight [2f, k] of
    format `t_gu` and the down weight [n, f] of format `t_dn`. The regime
    is a plain branch on m, the same as csrc/qffn.cu's (kGemvMaxM)."""
    for dim, qt in ((k, t_gu), (f, t_gu), (f, t_dn)):
        if dim % tile_granule(qt):
            raise ValueError(f"qffn: {dim} is not a multiple of "
                             f"{GGMLType(qt).name}'s granule {tile_granule(qt)}")
    h_bytes = 2 * m * f
    if m <= dm.GP_MAX_M:
        return QffnPlan("gemv", 1, 1, h_bytes)
    s_gu = dm.gemm_splits(m, 2 * f, k, t_gu)
    s_dn = dm.gemm_splits(m, n, f, t_dn)
    part = max(dm.gemm_workspace_bytes(m, 2 * f, k, s_gu, False),
               dm.gemm_workspace_bytes(m, n, f, s_dn, False))
    return QffnPlan("gemm", s_gu, s_dn, h_bytes + 4 * 2 * m * f + part)


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


def workspace(device, nbytes: int) -> torch.Tensor:
    """A kernel I workspace of `nbytes` on `device`, made once per size (the
    two passes of a call run in order on one stream, and so do calls)."""
    key = (str(device), nbytes)
    ws = _workspace.get(key)
    if ws is None:
        ws = _workspace[key] = torch.empty(nbytes, dtype=torch.uint8, device=device)
    return ws


def _planes(name: str, x: torch.Tensor, qt: QTensor) -> list:
    """The data pointers of qt's six planes (0 where the format has none),
    after checking that each lies on x's device, contiguous and aligned as
    kernel I reads it: q in 16-byte loads, qh in 16-bit words."""
    planes = [getattr(qt, nm) for nm in PLANES]
    for nm, p in zip(PLANES, planes):
        if p is None:
            continue
        if p.device != x.device:
            raise ValueError(f"qffn: x and {name}'s planes on different devices")
        if not p.is_contiguous():
            raise ValueError(f"qffn: {name}'s {nm} plane is not contiguous")
        if p.data_ptr() % {"q": 16, "qh": 2}.get(nm, 1):
            raise ValueError(f"qffn: {name}'s {nm} plane is misaligned")
    return [0 if p is None else p.data_ptr() for p in planes]


def passes(x: torch.Tensor, gu: QTensor, down: QTensor, act: str = "silu",
           out_dtype=torch.bfloat16):
    """Kernel I's two passes for one call on CUDA tensors, each a callable
    of no arguments that launches it on the current stream and raises on a
    failed launch: (plan, gated pass, down pass, out). The gated pass writes
    h to the workspace, the down pass reads it and writes `out`. `qffn` runs
    both in turn; they are apart so that each can be timed."""
    x = x.to(torch.bfloat16).contiguous()
    if x.data_ptr() % 16:
        raise ValueError("qffn: x must be 16-byte aligned")
    n_out, f = down.shape
    m, k = x.shape
    gate, dn = _planes("gate/up", x, gu), _planes("down", x, down)
    from . import _build

    fns = _build.load()
    plan = qffn_plan(m, n_out, k, f, gu.ggml_type, down.ggml_type)
    ws = workspace(x.device, plan.workspace_bytes)
    out = torch.empty((m, n_out), dtype=out_dtype, device=x.device)

    def run(entry: str, *args) -> None:
        rc = fns[entry](*args, torch.cuda.current_stream(x.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")

    def gated_pass() -> None:
        run("qffn_gated", x.data_ptr(), *gate, ws.data_ptr(), m, k, f,
            int(gu.ggml_type), ACTS[act], plan.splits_gu)

    def down_pass() -> None:
        run("qffn_down", ws.data_ptr(), *dn, out.data_ptr(), m, f, n_out,
            int(down.ggml_type), int(out_dtype == torch.float32), plan.splits_dn)

    return plan, gated_pass, down_pass, out


def _launch(x: torch.Tensor, gu: QTensor, down: QTensor, act: str,
            out_dtype) -> torch.Tensor:
    """Launch kernel I's two passes on the current stream (CUDA tensors
    only); one launch in the counts."""
    _, gated_pass, down_pass, out = passes(x, gu, down, act, out_dtype)
    gated_pass()
    down_pass()
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
