"""Kernel I's decode launch shape (`Shape` in csrc/qffn.cu) against fixed
ones, on the card.

    python -m omni_tpu_torch.qffn_shape_probe

Builds copies of csrc/qffn.cu whose `Shape` is one fixed launch shape for
every format (the chunks of each row a lane keeps in flight, the warps of
a block and the blocks per SM of the gated and of the down pass) beside
the source as it is, then times each build's two decode passes at M = 1
and 8, at Qwen3-8B's FFN shape, for a halves-packed, a low-bit, a Q6_K,
the Q8_0 and a codebook format, in a CUDA graph over weight copies larger
than the L2, after holding its output to `qffn_plain`'s. Prints the
card's name and power limit, then one JSON line per reading: the evidence
for `Shape`.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
from unittest import mock

import torch

from .core.dtypes import GGMLType
from .kernels import _build
from .kernels import fused_ffn as ff
from .testing_synth import synth_quant

# name: (chunks in flight, gated warps, gated blocks per SM, down warps,
# down blocks per SM)
SHAPES = {"u1-g4x4-d16x1": (1, 4, 4, 16, 1), "u1-g4x5-d8x2": (1, 4, 5, 8, 2),
          "u2-g4x4-d8x2": (2, 4, 4, 8, 2), "u2-g4x1-d8x1": (2, 4, 1, 8, 1)}
PAIRS = [("Q4_K", "Q4_K"), ("Q2_K", "Q2_K"), ("Q4_0", "Q4_0"), ("Q4_K", "Q6_K"),
         ("Q8_0", "Q8_0"), ("IQ4_XS", "IQ4_XS")]
K, F = 4096, 12288  # Qwen3-8B: d_model, d_ff
N_LAYERS = 36
L2_FLUSH_BYTES = 100 * 2**20


def shape_source(u: int, gw: int, gb: int, dw: int, db: int) -> str:
    """csrc/qffn.cu with `Shape` fixed to one launch shape."""
    src = (_build.CSRC / "qffn.cu").read_text()
    fixed = ("template <int QT>\nstruct Shape {\n"
             f"  static constexpr int kU = {u};\n"
             "  __host__ __device__ static constexpr int warps(bool gated) "
             f"{{ return gated ? {gw} : {dw}; }}\n"
             "  __host__ __device__ static constexpr int blocks(bool gated) "
             f"{{ return gated ? {gb} : {db}; }}\n}};")
    out, n = re.subn(r"template <int QT>\nstruct Shape \{.*?\n\};", fixed, src, flags=re.S)
    if n != 1:
        raise RuntimeError("qffn.cu: no `struct Shape` to replace")
    return out


def build_shapes() -> dict:
    """{shape name: kernel I's two entry points} for the source as it is
    ("source") and for each of SHAPES, built in parallel."""
    out_dir = _build.build_dir() / "qffn_shapes"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, shape in SHAPES.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(shape_source(*shape))
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    builds = {"source": {e: _build.load()[e] for e in ("qffn_gated", "qffn_down")}}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc exit {p.returncode}\n{log.decode()}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        builds[name] = {}
        for entry in ("qffn_gated", "qffn_down"):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = _build.QFFN_ARGS, ctypes.c_int
            builds[name][entry] = fn
    return builds


def graph_ms(fn, iters: int = 24) -> float:
    """Mean device time of fn(i), i = 0..iters-1, replayed in a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("qffn_shape_probe needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    builds = build_shapes()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for t_gu, t_dn in PAIRS:
        one = (synth_quant(GGMLType[t_gu], 2 * F, K, dev, gen),
               synth_quant(GGMLType[t_dn], K, F, dev, gen))
        planes = one[0].nbytes + one[1].nbytes
        ws = [one] + [(synth_quant(GGMLType[t_gu], 2 * F, K, dev, gen),
                       synth_quant(GGMLType[t_dn], K, F, dev, gen))
                      for _ in range(L2_FLUSH_BYTES // planes)]
        for m in (1, 8):
            x = torch.randn((m, K), device=dev, generator=gen).to(torch.bfloat16)
            want = ff.qffn_plain(x, *one).float()
            for name, fns in builds.items():
                with mock.patch.object(_build, "load", return_value=fns):
                    got = ff.qffn(x, *one).float()
                    runs = [ff.passes(x, *w) for w in ws]
                    t_g = graph_ms(lambda i: runs[i % len(runs)][1]())
                    t_d = graph_ms(lambda i: runs[i % len(runs)][2]())
                    del runs
                err = ((got - want).abs().max() / want.abs().max()).item()
                print(json.dumps({"shape": name, "pair": f"{t_gu}/{t_dn}", "m": m,
                                  "gated_ms": t_g, "down_ms": t_d,
                                  "per_token_ms": (t_g + t_d) * N_LAYERS,
                                  "max_rel_err": err}), flush=True)
        del ws, one


if __name__ == "__main__":
    main()
