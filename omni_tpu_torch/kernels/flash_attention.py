"""Flash-decode attention over the KV cell pool (counterpart of
omni_tpu/kernels/flash_attention.py): the kernel the quantized KV cache
attends through.

`flash_decode` takes T·G query rows per KV head against the head-major
pool [Hkv, S, D] under a [T, S] mask, in one online softmax, the law of the
Pallas kernels `flash_decode` (bf16 and int8 cells) and `_flash_decode4`
(packed int4 cells):
- q is rounded to bf16; int8 cells and int4 nibbles (minus their +8 bias)
  enter the dot as they are, exact in bf16;
- sc = (q·k)·scale, then ·ks[c] for quantized cells (the per-cell K scale
  folded into the score columns); masked entries are -1e30, a finite
  number, so a row masked everywhere comes out as the mean of V;
- per tile of cells: m = max(m, max sc), p = exp(sc − m), l from the
  unscaled p, then p·vs[c] (the V scale folded into p's columns) rounded to
  bf16 before the p·V dot, f32 accumulation;
- out = acc / max(l, 1e-30), f32 [T, Hq, D].

On a CUDA tensor the wrapper launches the hand-written kernel
(`csrc/flash_decode.cu`: tensor-core tiles, a decode and a prefill regime,
split-S with the splits merged by the last one to finish at decode and by
a second launch at prefill) or raises; on a CPU tensor it runs
`flash_decode_plain`, the same law over the Pallas kernel's tiles
(512 cells, halved until they divide S). Both round p against their own
running maximum, so they differ by those bf16 roundings.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..runtime.kv_cache import unpack4

NEG_INF = -1e30
BLOCK_S = 512  # the Pallas kernel's tile of cells (`block_s`)
HEAD_DIMS = (64, 128)  # the head widths the kernel is built for

# the CUDA kernel's work split (csrc/flash_decode.cu): a block of WARPS
# warps streams one split of a head's cells, TILE cells at a time through
# STAGES ring slots. Up to DECODE_ROWS rows per head (T = 1 or 2 at G = 4)
# take the decode regime: one 16-row fragment whose first rows are real,
# the warps sharing out each tile's cells, the splits merged by the last to
# arrive (one launch); more rows take the prefill regime: each warp 16
# rows, a block BLOCK_ROWS rows, every warp over every cell, the splits
# merged by a second launch.
WARPS, TILE, STAGES = 4, 64, 3
DECODE_ROWS = 8
BLOCK_ROWS = 16 * WARPS
# blocks to aim for when splitting the cells, in both regimes: 132 SMs
# times the two blocks an SM holds at once (208-219 registers a thread at
# prefill, 124-182 at decode; 60-104 KB of shared memory), so that every
# split runs in the first wave (flash_plan_probe: 1-4 a SM)
TARGET_BLOCKS = 132 * 2
MAX_SPLITS = 64  # the kernel's most splits (the merge's weights fit in shared memory)

# kernel launches, one count per wrapper; a run resets and reads them
launches = {"flash_decode": 0, "flash_decode4": 0}

_ENTRY = {16: "flash_decode_bf16", 8: "flash_decode_i8", 4: "flash_decode_i4"}
REGIMES = ("decode", "prefill")  # the C entries' regime argument, 0 and 1
# the arrival counters per device (`counters`)
_counters: dict[str, torch.Tensor] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _on_cuda(x: torch.Tensor) -> bool:
    return x.is_cuda


def tile_cells(s: int, block_s: int = BLOCK_S) -> int:
    """The Pallas kernel's tile: min(block_s, S), halved until it divides S."""
    ts = min(block_s, s)
    while s % ts:
        ts //= 2
    return ts


def cell_bits(k: torch.Tensor, k_scale: torch.Tensor | None) -> int:
    """16 for bf16 cells, 8 for int8, 4 for packed uint8 nibbles."""
    if k_scale is None:
        return 16
    return 4 if k.dtype == torch.uint8 else 8


def cells_f32(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Raw cells [..., S, D] (D/2 bytes for int4) -> their values in f32,
    scales not applied: bf16 values, int8 values, or the nibbles − 8."""
    return (unpack4(x) if bits == 4 else x).to(torch.float32)


def heads_major(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """[T, Hq, D] -> [Hkv, T*G, D] (row r = t*G + g)."""
    t, hq, d = q.shape
    g = hq // hkv
    return q.reshape(t, hkv, g, d).permute(1, 0, 2, 3).reshape(hkv, t * g, d)


def tokens_major(out: torch.Tensor, t: int) -> torch.Tensor:
    """[Hkv, T*G, D] -> [T, Hq, D]."""
    hkv, tg, d = out.shape
    g = tg // t
    return out.reshape(hkv, t, g, d).permute(1, 0, 2, 3).reshape(t, hkv * g, d)


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: torch.Tensor, k_scale: torch.Tensor | None = None,
                       v_scale: torch.Tensor | None = None,
                       scale: float | None = None) -> torch.Tensor:
    """The flash law in plain PyTorch, tile by tile as the Pallas kernels
    run it (see the module docstring). Returns [T, Hq, D] f32."""
    t, hq, d = q.shape
    hkv, s = k.shape[:2]
    g = hq // hkv
    bits = cell_bits(k, k_scale)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qh = heads_major(q.to(torch.bfloat16), hkv).to(torch.float32)
    rows = mask.repeat_interleave(g, dim=0)  # [T*G, S]
    m = torch.full((hkv, t * g, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((hkv, t * g, d), dtype=torch.float32, device=q.device)
    ts = tile_cells(s)
    for c0 in range(0, s, ts):
        c = slice(c0, c0 + ts)
        sc = qh @ cells_f32(k[:, c], bits).transpose(1, 2) * scale
        if bits < 16:
            sc = sc * k_scale[:, None, c]
        sc = torch.where(rows[None, :, c], sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1, keepdim=True)
        if bits < 16:
            p = p * v_scale[:, None, c]
        acc = acc * corr + (p.to(torch.bfloat16).to(torch.float32)
                            @ cells_f32(v[:, c], bits))
        m = m_new
    return tokens_major(acc / l.clamp(min=1e-30), t)


def _check(q, k, v, mask, k_scale, v_scale) -> int:
    """Shapes, dtypes, devices and layouts the kernel takes; returns the
    cell bits. Raises ValueError on anything else."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"want q [T, Hq, D], k and v [Hkv, S, D]: got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    t, hq, d = q.shape
    hkv, s, dk = k.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the kernel takes {HEAD_DIMS}")
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} KV heads")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("give both k_scale and v_scale, or neither")
    bits = cell_bits(k, k_scale)
    want = {16: (torch.bfloat16, d), 8: (torch.int8, d), 4: (torch.uint8, d // 2)}
    if (k.dtype, dk) != want[bits] or v.dtype != k.dtype:
        raise ValueError(f"cells {k.dtype} of width {dk}: with{'out' if bits == 16 else ''} "
                         f"scales they must be {want[bits][0]} of width {want[bits][1]}")
    if tuple(mask.shape) != (t, s) or mask.dtype != torch.bool:
        raise ValueError(f"mask {tuple(mask.shape)} {mask.dtype}: want [{t}, {s}] bool")
    tensors = [q, k, v, mask]
    if bits < 16:
        for sc in (k_scale, v_scale):
            if tuple(sc.shape) != (hkv, s) or sc.dtype != torch.float32:
                raise ValueError(f"scales {tuple(sc.shape)} {sc.dtype}: want "
                                 f"[{hkv}, {s}] float32")
        tensors += [k_scale, v_scale]
    if len({x.device for x in tensors}) != 1:
        raise ValueError("q, cells, mask and scales lie on different devices")
    # cells contiguous within each head; heads may keep a pool's stride
    if any(x.stride(2) != 1 or x.stride(1) != dk for x in (k, v)) or (
            bits < 16 and any(x.stride(1) != 1 for x in (k_scale, v_scale))):
        raise ValueError("cells and scales must be contiguous within each head")
    if k.stride(0) != v.stride(0) or (
            bits < 16 and k_scale.stride(0) != v_scale.stride(0)):
        raise ValueError("k and v (and their scales) must share a head stride")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    return bits


class FlashPlan(NamedTuple):
    """How kernel F runs one call: its regime ("decode": rows per head <=
    DECODE_ROWS, one row block; "prefill": row blocks of BLOCK_ROWS), the
    cells of each split (a whole number of tiles, the last split ragged)
    and the splits."""
    regime: str
    per_split: int
    nsplit: int

    def row_blocks(self, rows: int) -> int:
        return 1 if self.regime == "decode" else -(-rows // BLOCK_ROWS)

    def workspace_floats(self, rows: int, hkv: int, d: int) -> int:
        """The splits' partials (acc [D], m, l per head, split and row) the
        kernel writes; none with one split."""
        return hkv * self.nsplit * rows * (d + 2) if self.nsplit > 1 else 0

    def counters(self, rows: int, hkv: int) -> int:
        """The arrival counters of the decode regime's merge, one per head;
        none with one split or at prefill (a second launch merges there)."""
        return hkv if self.nsplit > 1 and self.regime == "decode" else 0


def split_plan(rows: int, hkv: int, s: int) -> FlashPlan:
    """The kernel's work split for T·G = `rows` query rows per head over S
    cells: the regime, then enough splits that Hkv × row blocks × splits
    reaches TARGET_BLOCKS, each at least one tile, at most MAX_SPLITS."""
    regime = "decode" if rows <= DECODE_ROWS else "prefill"
    units = hkv * (1 if regime == "decode" else -(-rows // BLOCK_ROWS))
    want = min(MAX_SPLITS, max(1, -(-TARGET_BLOCKS // units)))
    per = -(-max(TILE, -(-s // want)) // TILE) * TILE
    return FlashPlan(regime, per, -(-s // per))


def shared_bytes(bits: int, d: int) -> int:
    """Shared memory of one block (csrc/flash_decode.cu, `Layout`): STAGES
    ring slots (bf16 K and V tiles of TILE padded rows; or raw rows and
    their f32 scales), then for quantized cells the widened bf16 tiles."""
    tile = TILE * (2 * d + 16)
    if bits == 16:
        return STAGES * 2 * tile
    row = d if bits == 8 else d // 2
    return STAGES * (2 * TILE * row + 2 * TILE * 4) + 2 * tile


def counters(device, n: int) -> torch.Tensor:
    """The kernel's arrival counters on `device`, at least n, made zeroed
    once per device (grown when a call needs more) and left zeroed by every
    launch; calls run in order on one stream."""
    key = str(device)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = _counters[key] = torch.zeros(max(n, 4096), dtype=torch.int32,
                                           device=device)
    return buf


def _launch(bits: int, q, k, v, mask, k_scale, v_scale, scale: float):
    t, hq, d = q.shape
    hkv, s = k.shape[:2]
    g = hq // hkv
    qb = q.to(torch.bfloat16).contiguous()
    if qb.data_ptr() % 4:  # the kernel reads q two columns at a time
        qb = qb.clone()
    itemsize = k.element_size()
    if any(x.data_ptr() % 16 for x in (k, v)) or (k.stride(0) * itemsize) % 16:
        raise ValueError("cells must start 16-byte aligned in every head")
    plan = split_plan(t * g, hkv, s)
    out = torch.empty((t, hq, d), dtype=torch.float32, device=q.device)
    # the splits' partials, and the counters of the split that merges them
    ws = torch.empty((max(1, plan.workspace_floats(t * g, hkv, d)),),
                     dtype=torch.float32, device=q.device)
    cnt = counters(q.device, plan.counters(t * g, hkv))
    from . import _build

    fn = _build.load()[_ENTRY[bits]]
    quant = bits < 16
    rc = fn(qb.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            k_scale.data_ptr() if quant else 0,
            v_scale.data_ptr() if quant else 0, out.data_ptr(), ws.data_ptr(),
            cnt.data_ptr(), t, hkv, g, s, d, k.stride(0),
            k_scale.stride(0) if quant else 0, scale,
            REGIMES.index(plan.regime), plan.per_split, plan.nsplit,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{_ENTRY[bits]} launch failed: CUDA error {rc}")
    launches["flash_decode4" if bits == 4 else "flash_decode"] += 1
    return out


def flash_decode(q: torch.Tensor,  # [T, Hq, D]
                 k: torch.Tensor,  # [Hkv, S, D] bf16 / int8, [Hkv, S, D/2] uint8
                 v: torch.Tensor,
                 mask: torch.Tensor,  # [T, S] bool
                 k_scale: torch.Tensor | None = None,  # [Hkv, S] f32
                 v_scale: torch.Tensor | None = None,
                 scale: float | None = None) -> torch.Tensor:
    """Attention of q over one layer's raw planes, [T, Hq, D] f32 (replaces
    the Pallas `flash_decode`, flash_attention.py:141, for bf16 and int8
    cells, counted as "flash_decode", and `_flash_decode4`, :217, for packed
    int4 cells, counted as "flash_decode4"). The kernel on CUDA tensors,
    its plain version on CPU ones."""
    bits = _check(q, k, v, mask, k_scale, v_scale)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if _on_cuda(k):
        return _launch(bits, q, k, v, mask, k_scale, v_scale, scale)
    if k.device.type != "cpu":
        raise ValueError(f"flash_decode: unsupported device {k.device}")
    return flash_decode_plain(q, k, v, mask, k_scale, v_scale, scale)
