"""Quantized matmul: the `matmul` dispatcher and the port's matmul kernels.

Counterpart of `omni_tpu/kernels/dequant_matmul.py`. On a CUDA tensor a
weight goes to a kernel written by hand for Hopper, chosen as the JAX
dispatcher chooses its Pallas kernel (`matmul`, dequant_matmul.py:665-672),
under the same three switches, read once at import (`GP_DECODE`,
`GP_SMALLM`, `SH_PREFILL` below):
- the gp path, where `GP_DECODE` is on, the weight is `gp_supported` (M =
  1..8, K % 2048 == 0 for the K-quants and IQ4_XS, K % 256 == 0 for Q8_0,
  the legacy and the other codebook formats: `_gp_min_tk`) and M == 1 or
  `GP_SMALLM` is on: kernel A `q4k_gemv` for Q4_K, kernel G `q5k_gemv` for
  Q5_K (A's template with the high bit), A's legacy branches `q4_0_gemv`,
  `q4_1_gemv`, `q5_0_gemv` and `q5_1_gemv` (a scale per 32 in place of
  d·sc), kernel C `q6k_gemv` for Q6_K, kernel E `q8_0_gemv` for Q8_0, E's
  codebook entries `iq4_nl_gemv`, `mxfp4_gemv` and `iq4_xs_gemv`
  (csrc/codebook_gemv.cu: kernel A's design on nibble-index planes, the
  codebook applied in registers; dl = d, or d·sc per 32 for IQ4_XS) for
  the codebook formats, and kernel H `q2k_gemv` and `q3k_gemv` for Q2_K
  and Q3_K (2-bit quarters, a scale per 16; all replace
  qmatmul_gp_pallas);
- else the sh path, where `SH_PREFILL` is on and the weight is
  `sh_supported` (M > 8, the halves-packed formats Q4_K, Q5_K, Q4_0, Q4_1,
  Q5_0 and Q5_1 at the same K multiples): kernel B `q4k_gemm`, and its
  branches `q5k_gemm`, `q4_0_gemm`, `q4_1_gemm`, `q5_0_gemm` and
  `q5_1_gemm` (replace qmatmul_splith_pallas);
- else kernel D `qgemm`, the generic dequant-GEMM, at any M, for all
  thirteen formats (replaces qmatmul_pallas; its launches of every format
  count under "qgemm", and each format's also in `qgemm_launches`). With
  the switches at their defaults that is every prefill (M > 8) of a
  codebook, Q6_K, Q8_0, Q2_K or Q3_K weight, an IQ4_NL or MXFP4 weight
  with K % 256 != 0 (their granule is 32), and a K-quant or IQ4_XS one
  with K % 2048 != 0, at any M. A legacy weight reaches D only with a
  switch off: its planes need K % 256 == 0, the load policy widens any
  other to bf16, and every such weight is gp- or sh-supported.
Kernels B and D run one pipelined mainloop (csrc/qmma.cuh). Where an
[M, N] output has too few 64 x 64 tiles to fill the card, the wrapper
splits K across blocks (`gemm_splits`) and hands the kernel an f32
workspace for the partials (`gemm_workspace_bytes`), made per call; the
kernel sums them in split order, so the result is the same bit for bit
from run to run. The mma.sync GEMVs, kernels A, C, H and E's codebook
entries, never split K (`gemv_plan`): one block per 16-row tile, one
launch, and no workspace.
Every format the JAX package keeps quantized has a kernel on every route;
a QTensor of another format raises NotImplementedError on the card. Each
kernel has a plain PyTorch version of the same law beside it: the wrapper
runs it only for a tensor that lies on the CPU, and on a CUDA tensor it
launches the kernel or raises. Off the card the dispatcher runs kernel D's
plain law, which is `qmatmul_xla`'s: dequantise to bf16, then a dot with
f32 accumulation.

A dense weight (bf16) is a plain product, which the JAX package leaves to
XLA: bf16 operands, f32 accumulation. On the card that is cuBLAS with bf16
operands and f32 outputs (`bmm_f32`), K split into chunks that each sum
into fresh f32 outputs, as kernels B and D split theirs; no f32 copy of the
weight is made.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..core.dtypes import GGMLType
from .qformats import (CODEBOOK, LEGACY, LOWBIT, PLANES, QUANTIZED, QTensor,
                       check_qtensor, dequant, int8_group_scales, int8_values,
                       kquant_values, lowbit_group_scales, lowbit_values,
                       q4k_group_scales, q6k_group_scales, tile_granule)

# The JAX dispatcher's switches (omni_tpu/kernels/dequant_matmul.py:25-32),
# read once at import with its defaults: OMNI_GP_DECODE=0 sends decode to
# the generic kernel, OMNI_GP_SMALLM=0 keeps the gp path to M = 1,
# OMNI_SH_PREFILL=0 sends the halves-packed prefill to the generic kernel.
GP_DECODE = os.environ.get("OMNI_GP_DECODE", "1") == "1"
GP_SMALLM = os.environ.get("OMNI_GP_SMALLM", "1") == "1"
SH_PREFILL = os.environ.get("OMNI_SH_PREFILL", "1") == "1"

GP_MAX_M = 8  # decode rows kernels A, C, E, G and H take (the TPU's _GP_MAX_M)
# the K multiple of the gp and sh paths per format (the TPU kernels'
# `_gp_min_tk`: 2048 where a plane has one row per 256 elements, else 256)
GP_MIN_K = {GGMLType.Q4_K: 2048, GGMLType.Q5_K: 2048, GGMLType.Q6_K: 2048,
            GGMLType.Q8_0: 256, **dict.fromkeys(LEGACY, 256),
            GGMLType.IQ4_NL: 256, GGMLType.MXFP4: 256, GGMLType.IQ4_XS: 2048,
            **dict.fromkeys(LOWBIT, 2048)}
# the name of kernel A's (M = 1..8) and kernel B's (M > 8) wrapper and C
# entry point for each halves-packed format
HALVES_GEMV = {GGMLType.Q4_K: "q4k_gemv", GGMLType.Q5_K: "q5k_gemv",
               **{t: f"{t.name.lower()}_gemv" for t in LEGACY}}
HALVES_GEMM = {GGMLType.Q4_K: "q4k_gemm", GGMLType.Q5_K: "q5k_gemm",
               **{t: f"{t.name.lower()}_gemm" for t in LEGACY}}

# the name of the wrapper and C entry point of each of kernel E's codebook
# entries (M = 1..8)
CODEBOOK_GEMV = {t: f"{t.name.lower()}_gemv" for t in CODEBOOK}
# the name of kernel H's wrapper and C entry point for each 2- or 3-bit
# K-quant (M = 1..8)
LOWBIT_GEMV = {GGMLType.Q2_K: "q2k_gemv", GGMLType.Q3_K: "q3k_gemv"}
# the mma.sync GEMVs, kernel A's entries, E's codebook entries, kernel C
# and kernel H's entries: one launch plan (`gemv_plan`)
MMA_GEMV = {**HALVES_GEMV, **CODEBOOK_GEMV, GGMLType.Q6_K: "q6k_gemv",
            **LOWBIT_GEMV}

# kernel launches, one count per wrapper; a run resets and reads them
launches = dict.fromkeys([*HALVES_GEMV.values(), *HALVES_GEMM.values(),
                          "q6k_gemv", "qgemm", "q8_0_gemv", *CODEBOOK_GEMV.values(),
                          *LOWBIT_GEMV.values()], 0)

# the C entry point of kernel D for each format: all thirteen
_QGEMM_ENTRY = {GGMLType.Q4_K: "qgemm_q4k", GGMLType.Q5_K: "qgemm_q5k",
                GGMLType.Q6_K: "qgemm_q6k", GGMLType.Q8_0: "qgemm_q8_0",
                GGMLType.Q2_K: "qgemm_q2k", GGMLType.Q3_K: "qgemm_q3k",
                **{t: f"qgemm_{t.name.lower()}" for t in (*CODEBOOK, *LEGACY)}}
assert set(_QGEMM_ENTRY) == set(QUANTIZED)
# kernel D's launches per format (their sum is launches["qgemm"])
qgemm_launches = {t.name: 0 for t in _QGEMM_ENTRY}

# the prefill GEMMs' work units (csrc/qmma.cuh): 64 x 64 output tiles, K in
# steps of 256 elements, walked by a persistent grid of one block per SM on
# the H100's 132 SMs; a split keeps at least GEMM_MIN_STEPS steps
GEMM_TILE, GEMM_STEP, GEMM_SMS, GEMM_MIN_STEPS = 64, 256, 132, 2
# kernel B's formats with a side term (the residual ml − t·dl is not
# identically zero: for Q4_0 and Q5_0 t is 8 and 16 exactly)
SIDE_TERM = (GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q4_1, GGMLType.Q5_1)


def gemm_units(m: int, n: int) -> int:
    """Kernel B's or D's work units per split of an [m, k] x [n, k] call."""
    return -(-n // GEMM_TILE) * -(-m // GEMM_TILE)


def gemm_splits(m: int, n: int, k: int, qtype: GGMLType) -> int:
    """How many ranges of K steps kernel B or D splits an [m, k] x [n, k]
    product into: of the powers of two that leave every split
    GEMM_MIN_STEPS steps (or 1), the one whose busiest SM is done first,
    counting ceil(steps / splits) steps and one more for its epilogue per
    unit it walks, and the smallest of those (each split more writes and
    sums another [m, n] of f32 partials). `qtype`'s K granule must divide
    k; every format steps through K 256 elements at a time (the last step
    of a 32-granule format, Q8_0, IQ4_NL or MXFP4, may be ragged)."""
    if k % tile_granule(qtype):
        raise ValueError(f"K={k} is not a multiple of {GGMLType(qtype).name}'s "
                         f"granule {tile_granule(qtype)}")
    units, steps = gemm_units(m, n), -(-k // GEMM_STEP)

    def busiest(splits: int) -> int:
        return -(-units * splits // GEMM_SMS) * (-(-steps // splits) + 1)

    best = 1
    splits = 2
    while splits * GEMM_MIN_STEPS <= steps:
        if busiest(splits) < busiest(best):
            best = splits
        splits *= 2
    return best


# the launch of the mma.sync GEMVs (MMA_GEMV: kernel A, csrc/q4k_gemv.cu;
# E's codebook entries, csrc/codebook_gemv.cu; kernel C, csrc/q6k_gemv.cu;
# kernel H, csrc/lowbit_gemv.cu): a block owns GEMV_ROWS weight rows (the M
# of mma.m16n8k16) over all of K, whose steps its warps share out; the
# kernel picks its warps itself
GEMV_ROWS = 16


class GemvPlan(NamedTuple):
    """An mma.sync GEMV's launch for an [m, k] x [n, k] call."""
    rows: int  # weight rows a block owns
    splits: int  # blocks along K of each row tile
    workspace_bytes: int  # device memory the wrapper makes for the call

    def blocks(self, n: int) -> int:
        """The grid: row tiles x splits."""
        return -(-n // self.rows) * self.splits


def gemv_plan(m: int, n: int, k: int, qtype: GGMLType) -> GemvPlan:
    """The plan of the mma.sync GEMV of `qtype` (MMA_GEMV: kernel A for a
    halves-packed format, E's codebook entries for IQ4_NL, IQ4_XS and
    MXFP4, kernel C for Q6_K, kernel H for Q2_K and Q3_K) for an [m, k] x
    [n, k] call: one block per GEMV_ROWS-row tile, K not split at any
    shape, so a call is one launch with no workspace (0 bytes). At N = 1024
    (wk, wv: 64 tiles for GEMM_SMS SMs) a split in two was no faster for
    Q4_K and Q4_0 on the H100 and 7 % faster for Q5_K (PERF.md section
    6)."""
    if not 1 <= m <= GP_MAX_M:
        raise ValueError(f"the mma.sync GEMVs take M = 1..{GP_MAX_M}, got {m}")
    if qtype not in MMA_GEMV:
        raise ValueError(f"no mma.sync GEMV takes {GGMLType(qtype).name}")
    if k < 256 or k % 256:
        raise ValueError(f"K={k} is not a positive multiple of 256")
    return GemvPlan(GEMV_ROWS, 1, 0)


def gemm_workspace_bytes(m: int, n: int, k: int, splits: int, side: bool) -> int:
    """The f32 workspace kernel B or D takes (qmma.cuh workspace_floats):
    kernel B's x group sums [m, k/32] where it has a side term, then the
    split partials [splits, m, n] where splits > 1."""
    return 4 * ((m * (k // 32) if side else 0) + (splits * m * n if splits > 1 else 0))


def reset_launches() -> None:
    for counts in (launches, qgemm_launches):
        for name in counts:
            counts[name] = 0


def _on_cuda(x: torch.Tensor) -> bool:
    return x.is_cuda


def _check(x: torch.Tensor, qt: QTensor, out_dtype, *types: GGMLType) -> None:
    check_qtensor(qt, *types)
    if x.dim() != 2 or x.shape[1] != qt.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not match weight {qt.shape}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype}: want bfloat16 or float32")


def _launch(name: str, entry: str, x: torch.Tensor, qt: QTensor,
            out_dtype) -> torch.Tensor:
    """Launch C entry point `entry` of kernel `name` on the current stream
    (CUDA tensors only). Every entry takes the six planes in PLANES order
    (q, sc, mn, d, dm, qh); those a format lacks go as null pointers."""
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous bfloat16, got {x.dtype}")
    planes = tuple(getattr(qt, nm) for nm in PLANES)
    if any(p is not None and p.device != x.device for p in planes):
        raise ValueError(f"{name}: x and weight planes on different devices")
    if x.data_ptr() % 16 or qt.q.data_ptr() % 16:
        raise ValueError(f"{name}: x and q must be 16-byte aligned")
    if qt.qh is not None and qt.qh.data_ptr() % 2:
        # the kernels read qh in 16-bit words
        raise ValueError(f"{name}: qh must be 2-byte aligned")
    from . import _build

    fn = _build.load()[entry]
    m, k = x.shape
    n = qt.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    args = [x.data_ptr(), *(0 if p is None else p.data_ptr() for p in planes),
            out.data_ptr()]
    if name == "qgemm" or name in HALVES_GEMM.values():
        # the prefill GEMMs: the split count and a workspace of this call's
        # own (no cached buffer, which graph capture or a second stream
        # would share)
        splits = gemm_splits(m, n, k, qt.ggml_type)
        side = name != "qgemm" and qt.ggml_type in SIDE_TERM
        nbytes = gemm_workspace_bytes(m, n, k, splits, side)
        ws = (torch.empty(nbytes // 4, dtype=torch.float32, device=x.device)
              if nbytes else None)
        args += [0 if ws is None else ws.data_ptr(), m, n, k, splits]
    else:
        args += [m, n, k]
    rc = fn(*args, int(out_dtype == torch.float32),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    launches[name] += 1
    if name == "qgemm":
        qgemm_launches[GGMLType(qt.ggml_type).name] += 1
    return out


def _run(name: str, entry: str, plain, x: torch.Tensor, qt: QTensor,
         out_dtype) -> torch.Tensor:
    """The kernel on a CUDA tensor, its plain version on a CPU one."""
    if _on_cuda(x):
        return _launch(name, entry, x, qt, out_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return plain(x, qt, out_dtype)


def _check_gemv_m(name: str, x: torch.Tensor) -> None:
    if not 1 <= x.shape[0] <= GP_MAX_M:
        raise ValueError(f"{name} takes M = 1..{GP_MAX_M}, got {x.shape[0]}")


def q4k_gemv_plain(x: torch.Tensor, qt: QTensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel A's law in plain PyTorch (the group law of qmatmul_gp_pallas),
    and that of its Q5_K (kernel G) and legacy branches: per 32-group
    P = x_bf16 · q (the raw values: nibbles, or 0..31 with the high bit),
    out = Σ_g dl·P − ml·xs with xs the group sums of x_bf16, all in f32;
    dl and ml as `q4k_group_scales` gives them."""
    m, k = x.shape
    n = qt.shape[0]
    g = k // 32
    xb = x.to(torch.bfloat16).to(torch.float32).reshape(m, g, 32)
    q = kquant_values(qt).to(torch.float32).reshape(n, g, 32)
    p = torch.einsum("mgk,ngk->mng", xb, q)  # [M, N, G]
    dl, ml = q4k_group_scales(qt)  # [N, G]
    xs = xb.sum(-1)  # [M, G]
    out = (dl[None] * p - ml[None] * xs[:, None, :]).sum(-1)
    return out.to(out_dtype)


# kernel G's law and the legacy branches' are kernel A's: the values are
# 0..31, exact in bf16, and only dl and ml differ
q5k_gemv_plain = q4_0_gemv_plain = q4_1_gemv_plain = q4k_gemv_plain
q5_0_gemv_plain = q5_1_gemv_plain = q4k_gemv_plain


def q4k_centered(qt: QTensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B's weights, of a weight whose q plane is superblock-local
    halves: (w = bf16((q − t)·dl) [N, K] with t = ml/dl, 0 where dl = 0;
    the residual ml − t·dl [N, K/32] in f32). This is `_sh_scales`'s law
    for all six formats: for Q4_0 and Q5_0, 8d/d and 16d/d are 8 and 16
    exactly and the residual is 0; for Q4_1 and Q5_1, t = −m/d and the
    residual −m − t·d carries the whole −m where d = 0."""
    dl, ml = q4k_group_scales(qt)
    nz = dl != 0
    t = torch.where(nz, ml / torch.where(nz, dl, torch.ones_like(dl)),
                    torch.zeros_like(dl))
    q = kquant_values(qt).to(torch.float32)
    w = ((q - t.repeat_interleave(32, 1)) * dl.repeat_interleave(32, 1)
         ).to(torch.bfloat16)
    return w, ml - t * dl


def q4k_gemm_plain(x: torch.Tensor, qt: QTensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel B's law in plain PyTorch (the centered law of
    qmatmul_splith_pallas): the centered bf16 weights in a dot with f32
    accumulation, and the residual ml − t·dl folded back through the group
    sums of x."""
    m, k = x.shape
    w, ml_res = q4k_centered(qt)
    acc = x.to(torch.bfloat16).to(torch.float32) @ w.to(torch.float32).T
    xs = x.to(torch.float32).reshape(m, k // 32, 32).sum(-1)
    return (acc - xs @ ml_res.T).to(out_dtype)


# the other branches' law is kernel B's, q carrying its high bit in the
# five-bit formats (the TPU kernel's `five_bit`)
q5k_gemm_plain = q4_0_gemm_plain = q4_1_gemm_plain = q4k_gemm_plain
q5_0_gemm_plain = q5_1_gemm_plain = q4k_gemm_plain


def q6k_gemv_plain(x: torch.Tensor, qt: QTensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel C's law in plain PyTorch (the Q6_K group law of
    qmatmul_gp_pallas, `_gp_slice`): per 16-group P = x_bf16 · (q − 32),
    out = Σ_g (d·sc)·P, all in f32."""
    m, k = x.shape
    n = qt.shape[0]
    g = k // 16
    xb = x.to(torch.bfloat16).to(torch.float32).reshape(m, g, 16)
    q = qt.q.to(torch.float32).reshape(n, g, 16)
    p = torch.einsum("mgk,ngk->mng", xb, q)  # [M, N, G]
    return (q6k_group_scales(qt)[None] * p).sum(-1).to(out_dtype)


def q8_0_gemv_plain(x: torch.Tensor, qt: QTensor,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel E's law in plain PyTorch (the int8-plane group law of
    qmatmul_gp_pallas, `_gp_slice`): per 32-group P = x_bf16 · q over the
    int8 values q (`int8_values`: Q8_0's plane, or a codebook weight's
    indexes through its codebook), exact products summed in f32, then
    out = Σ_g dl·P, all in f32; dl = d (Q8_0, IQ4_NL, MXFP4) or the f32
    product d·sc (IQ4_XS), as `int8_group_scales` gives it."""
    m, k = x.shape
    n = qt.shape[0]
    g = k // 32
    xb = x.to(torch.bfloat16).to(torch.float32).reshape(m, g, 32)
    q = int8_values(qt).to(torch.float32).reshape(n, g, 32)
    p = torch.einsum("mgk,ngk->mng", xb, q)  # [M, N, G]
    return (int8_group_scales(qt)[None] * p).sum(-1).to(out_dtype)


# E's codebook entries run kernel E's law on the decoded values: they are
# integers of at most 7 bits, exact in bf16, and only IQ4_XS's dl differs
codebook_gemv_plain = q8_0_gemv_plain
iq4_nl_gemv_plain = mxfp4_gemv_plain = iq4_xs_gemv_plain = codebook_gemv_plain


def q2k_gemv_plain(x: torch.Tensor, qt: QTensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel H's law in plain PyTorch (the Q2_K and Q3_K group law of
    qmatmul_gp_pallas, `_gp_slice`): per 16-group P = x_bf16 · q (the raw
    values: Q2_K 0..3, Q3_K quarter + 4·hbit − 4), out = Σ_g dl·P − ml·xs
    with xs the group sums of x_bf16 (Q2_K only: Q3_K has no min), all in
    f32; dl and ml as `lowbit_group_scales` gives them."""
    m, k = x.shape
    n = qt.shape[0]
    g = k // 16
    xb = x.to(torch.bfloat16).to(torch.float32).reshape(m, g, 16)
    q = lowbit_values(qt).to(torch.float32).reshape(n, g, 16)
    p = torch.einsum("mgk,ngk->mng", xb, q)  # [M, N, G]
    dl, ml = lowbit_group_scales(qt)  # [N, G]
    out = dl[None] * p
    if ml is not None:
        out = out - ml[None] * xb.sum(-1)[:, None, :]
    return out.sum(-1).to(out_dtype)


# kernel H's Q3_K branch runs the same law: no min term, signed values
q3k_gemv_plain = q2k_gemv_plain


def qgemm_plain(x: torch.Tensor, qt: QTensor,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel D's law in plain PyTorch (qmatmul_pallas with dequant_tile):
    each weight dequantised in f32 and rounded once to bf16 (uncentered for
    Q4_K, Q5_K and Q2_K: bf16(q·dl − ml); bf16(q·d) for Q8_0, IQ4_NL and
    MXFP4 (q the codebook value); bf16(q·(d·sc)) for IQ4_XS, Q6_K and
    Q3_K; bf16((q − 8)·d) and bf16((q − 16)·d) for Q4_0 and Q5_0,
    bf16(q·d + m) for Q4_1 and Q5_1), then a dot with bf16 x in f32."""
    w = dequant(qt, torch.bfloat16).to(torch.float32)
    return (x.to(torch.bfloat16).to(torch.float32) @ w.T).to(out_dtype)


def _halves_gemv(t: GGMLType, what: str):
    """The wrapper of kernel A's branch for halves-packed format `t`
    (M = 1..8), named as its C entry point."""
    name = HALVES_GEMV[t]

    def wrapper(x: torch.Tensor, qt: QTensor,
                out_dtype=torch.bfloat16) -> torch.Tensor:
        _check(x, qt, out_dtype, t)
        _check_gemv_m(name, x)
        return _run(name, name, q4k_gemv_plain, x, qt, out_dtype)

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = (f"{what} (replaces qmatmul_gp_pallas for {t.name}): "
                       "M = 1..8.")
    return wrapper


def _halves_gemm(t: GGMLType, what: str):
    """The wrapper of kernel B's branch for halves-packed format `t`
    (M > 8), named as its C entry point."""
    name = HALVES_GEMM[t]

    def wrapper(x: torch.Tensor, qt: QTensor,
                out_dtype=torch.bfloat16) -> torch.Tensor:
        _check(x, qt, out_dtype, t)
        if x.shape[0] <= GP_MAX_M:
            raise ValueError(f"{name} takes M > {GP_MAX_M}, got {x.shape[0]}")
        return _run(name, name, q4k_gemm_plain, x, qt, out_dtype)

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = (f"{what} (replaces qmatmul_splith_pallas for "
                       f"{t.name}): M > 8.")
    return wrapper


q4k_gemv = _halves_gemv(GGMLType.Q4_K, "Kernel A")
q5k_gemv = _halves_gemv(GGMLType.Q5_K, "Kernel G, kernel A's Q5_K branch")
q4_0_gemv = _halves_gemv(GGMLType.Q4_0, "Kernel A's Q4_0 branch")
q4_1_gemv = _halves_gemv(GGMLType.Q4_1, "Kernel A's Q4_1 branch")
q5_0_gemv = _halves_gemv(GGMLType.Q5_0, "Kernel A's Q5_0 branch")
q5_1_gemv = _halves_gemv(GGMLType.Q5_1, "Kernel A's Q5_1 branch")
q4k_gemm = _halves_gemm(GGMLType.Q4_K, "Kernel B")
q5k_gemm = _halves_gemm(GGMLType.Q5_K, "Kernel B's Q5_K branch")
q4_0_gemm = _halves_gemm(GGMLType.Q4_0, "Kernel B's Q4_0 branch")
q4_1_gemm = _halves_gemm(GGMLType.Q4_1, "Kernel B's Q4_1 branch")
q5_0_gemm = _halves_gemm(GGMLType.Q5_0, "Kernel B's Q5_0 branch")
q5_1_gemm = _halves_gemm(GGMLType.Q5_1, "Kernel B's Q5_1 branch")


def q6k_gemv(x: torch.Tensor, qt: QTensor,
             out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel C (replaces qmatmul_gp_pallas for Q6_K): M = 1..8."""
    _check(x, qt, out_dtype, GGMLType.Q6_K)
    _check_gemv_m("q6k_gemv", x)
    return _run("q6k_gemv", "q6k_gemv", q6k_gemv_plain, x, qt, out_dtype)


def q8_0_gemv(x: torch.Tensor, qt: QTensor,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel E (replaces qmatmul_gp_pallas for Q8_0): M = 1..8, K % 32."""
    _check(x, qt, out_dtype, GGMLType.Q8_0)
    _check_gemv_m("q8_0_gemv", x)
    return _run("q8_0_gemv", "q8_0_gemv", q8_0_gemv_plain, x, qt, out_dtype)


def _codebook_gemv(t: GGMLType):
    """The wrapper of kernel E's entry for codebook format `t` (M = 1..8,
    K % 256), named as its C entry point."""
    name = CODEBOOK_GEMV[t]

    def wrapper(x: torch.Tensor, qt: QTensor,
                out_dtype=torch.bfloat16) -> torch.Tensor:
        _check(x, qt, out_dtype, t)
        _check_gemv_m(name, x)
        if x.shape[1] % 256:
            raise ValueError(f"{name} takes K % 256 == 0, got K = {x.shape[1]}")
        return _run(name, name, codebook_gemv_plain, x, qt, out_dtype)

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = (f"Kernel E's {t.name} entry (replaces qmatmul_gp_pallas "
                       f"for {t.name}): M = 1..8, K % 256.")
    return wrapper


iq4_nl_gemv = _codebook_gemv(GGMLType.IQ4_NL)
iq4_xs_gemv = _codebook_gemv(GGMLType.IQ4_XS)
mxfp4_gemv = _codebook_gemv(GGMLType.MXFP4)


def _lowbit_gemv(t: GGMLType):
    """The wrapper of kernel H's branch for Q2_K or Q3_K (M = 1..8), named
    as its C entry point."""
    name = LOWBIT_GEMV[t]

    def wrapper(x: torch.Tensor, qt: QTensor,
                out_dtype=torch.bfloat16) -> torch.Tensor:
        _check(x, qt, out_dtype, t)
        _check_gemv_m(name, x)
        return _run(name, name, q2k_gemv_plain, x, qt, out_dtype)

    wrapper.__name__ = wrapper.__qualname__ = name
    wrapper.__doc__ = (f"Kernel H's {t.name} branch (replaces qmatmul_gp_pallas "
                       f"for {t.name}): M = 1..8, K % 256.")
    return wrapper


q2k_gemv = _lowbit_gemv(GGMLType.Q2_K)
q3k_gemv = _lowbit_gemv(GGMLType.Q3_K)


def qgemm(x: torch.Tensor, qt: QTensor,
          out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel D (replaces qmatmul_pallas for all thirteen formats): any M,
    any K that holds whole blocks of the format's granule (256 for the
    K-quants, the legacy formats and IQ4_XS, 32 for Q8_0, IQ4_NL and
    MXFP4)."""
    _check(x, qt, out_dtype, *_QGEMM_ENTRY)
    return _run("qgemm", _QGEMM_ENTRY[qt.ggml_type], qgemm_plain, x, qt,
                out_dtype)


_GEMV = {GGMLType.Q4_K: q4k_gemv, GGMLType.Q5_K: q5k_gemv,
         GGMLType.Q4_0: q4_0_gemv, GGMLType.Q4_1: q4_1_gemv,
         GGMLType.Q5_0: q5_0_gemv, GGMLType.Q5_1: q5_1_gemv,
         GGMLType.Q6_K: q6k_gemv, GGMLType.Q8_0: q8_0_gemv,
         GGMLType.IQ4_NL: iq4_nl_gemv, GGMLType.IQ4_XS: iq4_xs_gemv,
         GGMLType.MXFP4: mxfp4_gemv, GGMLType.Q2_K: q2k_gemv,
         GGMLType.Q3_K: q3k_gemv}
_GEMM = {GGMLType.Q4_K: q4k_gemm, GGMLType.Q5_K: q5k_gemm,
         GGMLType.Q4_0: q4_0_gemm, GGMLType.Q4_1: q4_1_gemm,
         GGMLType.Q5_0: q5_0_gemm, GGMLType.Q5_1: q5_1_gemm}


def gp_supported(m: int, qt: QTensor) -> bool:
    """The JAX `gp_supported`: M = 1..8 and K a multiple of the format's
    gp granule."""
    t = qt.ggml_type
    return 1 <= m <= GP_MAX_M and t in _GEMV and qt.shape[1] % GP_MIN_K[t] == 0


def sh_supported(m: int, qt: QTensor) -> bool:
    """The JAX `sh_supported`: M > 8 on a halves-packed format with K a
    multiple of its granule."""
    t = qt.ggml_type
    return m > GP_MAX_M and t in _GEMM and qt.shape[1] % GP_MIN_K[t] == 0


def kernel_for(m: int, qt: QTensor):
    """The kernel wrapper the card runs for an [m, K] x and weight `qt`,
    in the JAX dispatcher's order under its switches (dequant_matmul.py:
    665-672): gp, then sh, then the generic kernel D; None for a format
    with no planes in the port."""
    if GP_DECODE and gp_supported(m, qt) and (m == 1 or GP_SMALLM):
        return _GEMV[qt.ggml_type]
    if SH_PREFILL and sh_supported(m, qt):
        return _GEMM[qt.ggml_type]
    return qgemm if qt.ggml_type in _QGEMM_ENTRY else None


# K per cuBLAS product of a dense dot on the card. One tensor-core
# accumulation over the whole K rounds 7.3e-4-3.8e-3 of the bf16 outputs
# of Qwen3-8B's dense dots otherwise than the f64 law, the f32 law 0-3.7e-4;
# chunks of 256 (the split accumulation of kernels B and D) read 0-3.7e-4,
# chunks of 512 up to 9.8e-4 (`python -m omni_tpu_torch.dense_split_probe`,
# NVIDIA H100 80GB HBM3, 700.00 W).
SPLIT_K = 256


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for bf16 a [B, M, K] and b [B, K, N] on the card, an f32
    [B, M, N]: cuBLAS sums each SPLIT_K-element chunk of K into a fresh f32
    output (`out_dtype=torch.float32`: f32 accumulators, whatever
    allow_bf16_reduced_precision_reduction says, though the tensor cores'
    adds drift from the f32 law over a long K), and the chunks are added
    with f32 adds. Where B = 1 and SPLIT_K divides K the chunks are the
    batch of one product, as views of the operands; otherwise one product
    per chunk."""
    k = a.shape[-1]
    if k <= SPLIT_K:
        return torch.bmm(a, b, out_dtype=torch.float32)
    if a.shape[0] == 1 and k % SPLIT_K == 0:
        c = k // SPLIT_K
        parts = torch.bmm(a[0].unflatten(1, (c, SPLIT_K)).transpose(0, 1),
                          b[0].unflatten(0, (c, SPLIT_K)), out_dtype=torch.float32)
        return parts.sum(0, keepdim=True)
    out = torch.bmm(a[..., :SPLIT_K], b[:, :SPLIT_K], out_dtype=torch.float32)
    for k0 in range(SPLIT_K, k, SPLIT_K):
        out += torch.bmm(a[..., k0:k0 + SPLIT_K], b[:, k0:k0 + SPLIT_K],
                         out_dtype=torch.float32)
    return out


def dense_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    """The dense dot's law in plain PyTorch: both operands widened to f32
    (bf16 products are exact in f32), summed in f32."""
    return (x.to(w.dtype).to(torch.float32) @ w.to(torch.float32).T).to(out_dtype)


def dense_matmul(x: torch.Tensor, w: torch.Tensor,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """x @ w.T for a plain [N, K] weight, the JAX package's law:
    dot_general(x in w's dtype, w, preferred_element_type=f32), cast to
    out_dtype. On the card the operands go to cuBLAS as they are
    (`bmm_f32`); nothing is widened. The CPU has no kernel for cuBLAS's
    f32-output overload, so there the plain version runs."""
    if not _on_cuda(x):
        return dense_matmul_plain(x, w, out_dtype)
    return bmm_f32(x.to(w.dtype)[None], w.T[None])[0].to(out_dtype)


def matmul(x: torch.Tensor, w, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Unified linear: `w` is a QTensor or a plain [N, K] tensor."""
    if isinstance(w, QTensor):
        if not _on_cuda(x):
            return qgemm_plain(x, w, out_dtype)
        kernel = kernel_for(x.shape[0], w)
        if kernel is None:
            raise NotImplementedError(
                f"no CUDA kernel for {GGMLType(w.ggml_type).name} at M = "
                f"{x.shape[0]}, K = {w.shape[1]}: the port's matmul kernels "
                "take the thirteen formats the JAX package keeps quantized "
                f"({', '.join(t.name for t in QUANTIZED)}) on every route")
        return kernel(x.to(torch.bfloat16).contiguous(), w, out_dtype)
    return dense_matmul(x, w, out_dtype)
