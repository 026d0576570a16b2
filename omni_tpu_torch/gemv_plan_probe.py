"""Kernel A's launch choices (csrc/q4k_gemv.cu) against the alternatives,
on the card.

    python -m omni_tpu_torch.gemv_plan_probe

Builds copies of csrc/q4k_gemv.cu with 8 warps a block at every shape
(`kManyWarps` = 8), with the weight bytes read through L1 (an `__ldg` in
place of the source's `ld.global.nc.L1::no_allocate`), and with both,
beside the source as it is; then times each build at Qwen3-8B's decode
shapes (N x K) for Q4_K, Q5_K and Q4_0, at M = 1 (and 8 at wo and the
head), in a CUDA graph over weight copies larger than the L2, after
holding its output to `q4k_gemv_plain`'s. Prints the card's name and
power limit, then one JSON line per reading: the evidence for kManyWarps
and for the weight load that bypasses L1.
"""

from __future__ import annotations

import json
import re
import subprocess
from unittest import mock

import torch

from .core.dtypes import GGMLType, row_nbytes
from .kernels import _build
from .kernels import dequant_matmul as dm
from .testing_synth import synth_quant

# name: (kManyWarps, weight bytes through L1)
VARIANTS = {"source": None, "warps8": (8, False), "via-l1": (4, True),
            "warps8-via-l1": (8, True)}
SHAPES = {"wk": (1024, 4096), "wo": (4096, 4096), "wqkv": (6144, 4096),
          "down": (4096, 12288), "gateup": (24576, 4096), "head": (151748, 4096)}
FORMATS = (GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q4_0)
L2_FLUSH_BYTES = 100 * 2**20
HBM_BYTES_PER_S = 3.35e12


# the source's weight load, and the L1 load the via-l1 copies put there
NO_ALLOC_LOAD = re.compile(r'asm volatile\("ld\.global\.nc\.L1::no_allocate\.v2\.u32.*?\)\);',
                           re.S)
L1_LOAD = "w.q[r][h] = __ldg(qp + 4 * h);"


def variant_source(many: int, via_l1: bool) -> str:
    """csrc/q4k_gemv.cu with kManyWarps set and, where `via_l1`, the weight
    bytes read through L1."""
    src = (_build.CSRC / "q4k_gemv.cu").read_text()
    src, a = re.subn(r"constexpr int kManyWarps = \d+;", f"constexpr int kManyWarps = {many};",
                     src)
    b = 1
    if via_l1:
        src, b = NO_ALLOC_LOAD.subn(L1_LOAD, src)
    if (a, b) != (1, 1):
        raise RuntimeError("q4k_gemv.cu: no kManyWarps or weight load to set")
    return src


def build_variants() -> dict:
    """{variant: kernel A's six entry points} for the source as it is and
    for each setting of VARIANTS, built in parallel."""
    out_dir = _build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, setting in VARIANTS.items():
        if setting is None:
            continue
        src = out_dir / f"q4k_gemv.probe-{name}.cu"
        src.write_text(variant_source(*setting))
        jobs[out_dir / f"q4k_gemv.probe-{name}.so"] = [
            _build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), str(src)]
    _build._build(jobs)
    libs = {"source": {}}
    for (name, _), so in zip(((n, s) for n, s in VARIANTS.items() if s is not None), jobs):
        libs[name] = _build._bind(so, _build.SOURCES["q4k_gemv.cu"])
    return libs


def graph_ms(fn, iters: int = 24) -> float:
    """Mean device time of fn(i), i = 0..iters-1, replayed in one CUDA graph."""
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


def weights(fmt: GGMLType, n: int, k: int, dev, gen) -> list:
    """Copies of one random weight, enough to stream more than the L2."""
    w0 = synth_quant(fmt, n, k, dev, gen)
    return [w0] + [synth_quant(fmt, n, k, dev, gen)
                   for _ in range(min(7, L2_FLUSH_BYTES // w0.q.nbytes))]


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    own = _build.load()
    libs = build_variants()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for fmt in FORMATS:
        name = dm.HALVES_GEMV[fmt]
        kern = getattr(dm, name)
        for shape, (n, k) in SHAPES.items():
            ws = weights(fmt, n, k, dev, gen)
            w0 = ws[0]
            out_dtype = torch.float32 if shape == "head" else torch.bfloat16
            for m in ((1, 8) if shape in ("wo", "head") else (1,)):
                x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
                want = dm.q4k_gemv_plain(x, w0, torch.float32)
                nbytes = n * row_nbytes(fmt, k) + m * k * 2 + m * n * out_dtype.itemsize
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                times = {}
                for rep in range(2):  # the variants in turn, twice; the least
                    for var, lib in libs.items():
                        with mock.patch.object(_build, "load", return_value={**own, **lib}):
                            if rep == 0:
                                got = kern(x, w0, torch.float32)
                                torch.cuda.synchronize()
                                err = ((got - want).abs().max() / want.abs().max()).item()
                                if not err < 1e-3:
                                    raise SystemExit(f"{var} {name} {shape}: off by {err}")
                            t = graph_ms(lambda i: kern(x, ws[i % len(ws)], out_dtype))
                        times[var] = min(times.get(var, float("inf")), t)
                blocks = dm.gemv_plan(m, n, k, fmt).blocks(n)
                for var, t in times.items():
                    print(json.dumps({"variant": var, "fmt": fmt.name, "shape": shape, "n": n,
                                      "k": k, "m": m, "ms": t, "bound_ms": bound,
                                      "share": bound / t, "blocks": blocks, "card": smi}),
                          flush=True)
            del ws, w0


if __name__ == "__main__":
    main()
