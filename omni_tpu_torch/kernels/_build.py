"""Build and bind the port's CUDA kernels.

Each `csrc/*.cu` file has a plain C interface and includes no PyTorch
header (only the port's own `csrc/*.cuh`), so `nvcc` builds it in seconds.
The sources are compiled at first use, all at once (one `nvcc` process per
source, started together), into `omni_tpu_torch/build/<hash of sources,
headers and flags>/`, and loaded with `ctypes`. A later process with the same sources reuses the libraries.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# a matmul entry point: (x, q, sc, mn, d, dm, qh, out, m, n, k, out_f32,
# stream); the planes a format lacks go as null pointers
MATMUL_ARGS = [_P] * 8 + [_I] * 4 + [_P]
# a prefill GEMM entry point, kernel B's and D's (the mainloop of
# csrc/qmma.cuh): (x, q, sc, mn, d, dm, qh, out, workspace, m, n, k, splits,
# out_f32, stream)
GEMM_ARGS = [_P] * 9 + [_I] * 5 + [_P]
# a flash-decode entry point: (q, k, v, mask, k_scale, v_scale, out,
# workspace, counters, t, hkv, g, s, d, head_stride, scale_stride, scale,
# regime, per_split, nsplit, stream)
FLASH_ARGS = ([_P] * 9 + [_I] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_float]
              + [_I] * 3 + [_P])
# kernel I's two passes (csrc/qffn.cu): qffn_gated (x, the fused gate/up
# weight's six planes, workspace, m, k, f, type, act, splits, stream) and
# qffn_down (workspace, the down weight's six planes, out, m, f, n, type,
# out_f32, splits, stream)
QFFN_ARGS = [_P] * 8 + [_I] * 6 + [_P]
# each source, its C entry points (one per kernel, format or cell type) and
# their argument types; every entry returns cudaError_t as int
SOURCES = {
    "q4k_gemv.cu": dict.fromkeys(
        ("q4k_gemv", "q5k_gemv", "q4_0_gemv", "q4_1_gemv", "q5_0_gemv",
         "q5_1_gemv"), MATMUL_ARGS),
    "q4k_gemm.cu": dict.fromkeys(
        ("q4k_gemm", "q5k_gemm", "q4_0_gemm", "q4_1_gemm", "q5_0_gemm",
         "q5_1_gemm"), GEMM_ARGS),
    "q6k_gemv.cu": {"q6k_gemv": MATMUL_ARGS},
    "q8_0_gemv.cu": {"q8_0_gemv": MATMUL_ARGS},
    "codebook_gemv.cu": dict.fromkeys(
        ("iq4_nl_gemv", "iq4_xs_gemv", "mxfp4_gemv"), MATMUL_ARGS),
    "lowbit_gemv.cu": dict.fromkeys(("q2k_gemv", "q3k_gemv"), MATMUL_ARGS),
    "qgemm.cu": dict.fromkeys(
        ("qgemm_q4k", "qgemm_q5k", "qgemm_q6k", "qgemm_q8_0", "qgemm_iq4_nl",
         "qgemm_iq4_xs", "qgemm_mxfp4", "qgemm_q2k", "qgemm_q3k", "qgemm_q4_0",
         "qgemm_q4_1", "qgemm_q5_0", "qgemm_q5_1"), GEMM_ARGS),
    "flash_decode.cu": dict.fromkeys(
        ("flash_decode_bf16", "flash_decode_i8", "flash_decode_i4"), FLASH_ARGS),
    "qffn.cu": dict.fromkeys(("qffn_gated", "qffn_down"), QFFN_ARGS)}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, else on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.access(cand, os.X_OK):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_dir() -> Path:
    """Where this version of the sources builds: BUILD/<hash of sources,
    the headers they include (csrc/*.cuh) and flags>."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in [*SOURCES, *sorted(p.name for p in CSRC.glob("*.cuh"))]:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD / h.hexdigest()[:16]


def _build(jobs: dict[Path, list[str]]) -> None:
    """Compile each missing library `so` from its nvcc command (all
    started together); raises RuntimeError with nvcc's output on a failed
    build."""
    procs = {}
    for so, cmd in jobs.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs[so] = (tmp, subprocess.Popen(
            [*cmd, "-o", str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    errors = []
    for so, (tmp, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{so.name}: nvcc exit {p.returncode}\n"
                          f"{log.decode(errors='replace')}")
        else:
            os.replace(tmp, so)  # atomic: a concurrent build sees a whole file
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))


def _bind(so: Path, entries: dict) -> dict[str, Callable[..., int]]:
    lib = ctypes.CDLL(str(so))
    fns = {}
    for entry, argtypes in entries.items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[entry] = fn
    return fns


@functools.cache
def load() -> dict[str, Callable[..., int]]:
    """Compile (if needed) and load every kernel library; returns
    {entry point name: its C function}. Raises RuntimeError with nvcc's
    output on a failed build."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    _build({out_dir / (Path(name).stem + ".so"): [nvcc(), *NVCC_FLAGS, str(CSRC / name)]
            for name in SOURCES})
    fns = {}
    for name, entries in SOURCES.items():
        fns.update(_bind(out_dir / (Path(name).stem + ".so"), entries))
    return fns
