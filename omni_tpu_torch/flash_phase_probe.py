"""Where one kernel F launch spends its time, block by block, on the card.

    python -m omni_tpu_torch.flash_phase_probe   # from the repository root

Builds a copy of csrc/flash_decode.cu in which thread 0 of every block of
`flash_kernel` writes the card's global timer (%globaltimer, ns) at its
phases, runs one call at each of chip_smoke.py's FLASH_TIMES shapes for each
cell type (after three warm calls), and prints the card's name and power
limit, then one JSON line per call: for each phase the minimum, median and
maximum over the blocks, in microseconds from the first block's start.
Phases: start, first tile landed, loop end, the block's output or partials
written, and at decode with splits the arrival (partials fenced), the last
block's turn and the end of its merge. At prefill the merge is a second
launch (`merge_kernel`), not stamped: `written` is then the last phase. The
timer ticks in steps of ~0.26 us.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from unittest import mock

import numpy as np
import torch

from .kernels import _build
from .kernels import flash_attention as fa

PHASES = ("start", "first_tile", "loop_end", "written", "fenced", "last_in", "merged")
MAX_BLOCKS = 1 << 16


def stamped_source() -> str:
    """csrc/flash_decode.cu with a timer write at each of PHASES."""
    src = (_build.CSRC / "flash_decode.cu").read_text()
    stamps = [
        ("namespace {\n", """__device__ unsigned long long g_stamp[%d * 8];
#define STAMP(k) do { if (threadIdx.x == 0) { \\
  const size_t b_ = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x; \\
  unsigned long long t_; asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t_)); \\
  if (b_ < %d) g_stamp[b_ * 8 + (k)] = t_; } } while (0)
""" % (MAX_BLOCKS, MAX_BLOCKS), True),
        ("  extern __shared__ __align__(16) uint8_t smem[];\n  __shared__ bool last;\n",
         "  STAMP(0);\n", True),
        ("    __syncthreads();  // tile it in every thread's view; every warp done with it - 1\n",
         "    if (it == 0) STAMP(1);\n", True),
        ("  cp_async_wait<0>();  // the last (empty) groups\n", "  STAMP(2);\n", True),
        ("  // one split: done; prefill: merge_kernel merges the splits\n", "  STAMP(3);\n",
         False),
        ("  __threadfence();  // this block's partials before its arrival\n  __syncthreads();\n",
         "  STAMP(4);\n", True),
        ("  if (!last) return;\n", "  STAMP(5);\n", False),
        ("  if (threadIdx.x == 0) *counter = 0u;  // ready for the next call\n",
         "  STAMP(6);\n", True),
    ]
    for anchor, add, after in stamps:
        if src.count(anchor) != 1:
            raise RuntimeError(f"flash_decode.cu: anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + add if after else add + anchor)
    return src + """
extern "C" int fd_stamps(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamp, (size_t)n * 8 * sizeof(unsigned long long));
}
extern "C" int fd_clear() {
  static unsigned long long z[%d * 8];
  return (int)cudaMemcpyToSymbol(g_stamp, z, sizeof(z));
}
""" % MAX_BLOCKS


def build() -> ctypes.CDLL:
    out = _build.build_dir() / "phase_probe"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "flash_stamped.cu", out / "flash_stamped.so"
    cu.write_text(stamped_source())
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True)
    return ctypes.CDLL(str(so))


def main() -> int:
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("flash_phase_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lib = build()
    fns = {}
    for entry, argtypes in _build.SOURCES["flash_decode.cu"].items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[entry] = fn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    hq, hkv, _ = cs.FLASH_HEADS
    with mock.patch.object(_build, "load", lambda: fns):
        for bits, cells in ((16, "bf16"), (8, "int8"), (4, "int4")):
            for t, s in cs.FLASH_TIMES:
                args = cs.flash_inputs(bits, t, s, dev, gen)
                plan = fa.split_plan(t * hq // hkv, hkv, s)
                for _ in range(3):
                    fa.flash_decode(*args)
                torch.cuda.synchronize()
                lib.fd_clear()
                fa.flash_decode(*args)
                torch.cuda.synchronize()
                n = plan.nsplit * plan.row_blocks(t * hq // hkv) * hkv
                buf = np.zeros(n * 8, dtype=np.uint64)
                if lib.fd_stamps(buf.ctypes.data, n) != 0:
                    raise RuntimeError("reading the stamps failed")
                st = buf.reshape(n, 8)[:, :len(PHASES)].astype(np.float64)
                rel = np.where(st > 0, st - st[:, 0].min(), np.nan) / 1e3
                row = {"cells": cells, "t": t, "s": s, "regime": plan.regime,
                       "nsplit": plan.nsplit, "blocks": n}
                for i, name in enumerate(PHASES):
                    v = rel[:, i][~np.isnan(rel[:, i])]
                    if len(v):
                        row[name] = [round(float(x), 2) for x in
                                     (v.min(), np.median(v), v.max())]
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
