"""The launch choices of the mma.sync GEMVs, kernel A (csrc/q4k_gemv.cu),
kernel E's codebook entries (csrc/codebook_gemv.cu), kernel C
(csrc/q6k_gemv.cu) and kernel H (csrc/lowbit_gemv.cu), against the
alternatives, on the card.

    python -m omni_tpu_torch.gemv_plan_probe [--source X.cu ...] [--against FILE]

Builds copies of each source with other settings (SOURCES): 8 (or 2)
warps a block where the row tiles fill two waves (`kManyWarps`), kernels
C's and H's 2-warp tier off (`kFewWarps` = 4), the
weight bytes read through L1 or past it (an `__ldg` in place of an
`ld.global.nc.L1::no_allocate`, or the reverse), three blocks an SM
(`__launch_bounds__`), kernel C's steps of weight bytes in flight
(`kStages`), beside the source as it is; then times each build at
Qwen3-8B's decode shapes (N x K) for up to three of its formats (Q4_K, Q5_K and Q4_0;
IQ4_NL, IQ4_XS and MXFP4; Q6_K; Q2_K and Q3_K), at M = 1 (and 8 at wo and
the head), in a CUDA graph over weight copies larger than the L2, after
holding its output to its plain version's. `--against FILE` adds FILE,
another version of the one source named (the parent commit's, say,
unpacked with `git archive`), as the variant "against": two versions
timed in turns in one process. Prints the card's name and power limit,
then one JSON line per reading: the evidence for kManyWarps and for the
weight load that bypasses L1 or not.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path
from unittest import mock

import torch

from .core.dtypes import GGMLType, row_nbytes
from .kernels import _build
from .kernels import dequant_matmul as dm
from .testing_synth import synth_quant

SHAPES = {"wk": (1024, 4096), "wo": (4096, 4096), "wqkv": (6144, 4096),
          "gate": (12288, 4096), "down": (4096, 12288), "gateup": (24576, 4096),
          "head": (151748, 4096)}
L2_FLUSH_BYTES = 100 * 2**20
HBM_BYTES_PER_S = 3.35e12

# the edits a variant makes to a source: (pattern matching once, its
# replacement)
NO_ALLOC_LOAD = r'asm volatile\("ld\.global\.nc\.L1::no_allocate\..*?\)\);'


def many_warps(v: int) -> tuple[str, str]:
    return r"constexpr int kManyWarps = \d+;", f"constexpr int kManyWarps = {v};"


def few_warps(v: int) -> tuple[str, str]:
    return r"constexpr int kFewWarps = \d+;", f"constexpr int kFewWarps = {v};"


def min_blocks(v: int) -> tuple[str, str]:
    return (r"__launch_bounds__\(kMaxWarps \* 32, \d+\)",
            f"__launch_bounds__(kMaxWarps * 32, {v})")


def stages(v: int) -> tuple[str, str]:
    return r"constexpr int kStages = \d+;", f"constexpr int kStages = {v};"


def past_l1(load: str, reg: str, ptr: str) -> tuple[str, str]:
    """The 4-byte weight load `load` (`reg = __ldg(ptr);`) made to bypass
    L1."""
    return (re.escape(load),
            'asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];\\n"\n'
            f'                   : "=r"({reg})\n'
            f'                   : "l"({ptr}));')


# each source: the formats it is timed on, and its variants beside it
SOURCES = {
    "q4k_gemv.cu": ((GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q4_0), {
        "warps8": (many_warps(8),),
        "via-l1": ((NO_ALLOC_LOAD, "w.q[r][h] = __ldg(qp + 4 * h);"),),
        "warps8-via-l1": (many_warps(8),
                          (NO_ALLOC_LOAD, "w.q[r][h] = __ldg(qp + 4 * h);"))}),
    "codebook_gemv.cu": ((GGMLType.IQ4_NL, GGMLType.IQ4_XS, GGMLType.MXFP4), {
        "warps8": (many_warps(8),),
        "no-alloc": (past_l1("b.q[r][i] = __ldg(qp + 4 * i);", "b.q[r][i]", "qp + 4 * i"),),
        "blocks3": (min_blocks(3),)}),
    "q6k_gemv.cu": ((GGMLType.Q6_K,), {
        "warps8": (many_warps(8),),
        "warps2": (many_warps(2),),
        "few4": (few_warps(4),),
        "stages2": (stages(2),),
        "stages4": (stages(4),),
        "blocks3": (min_blocks(3),)}),
    "lowbit_gemv.cu": ((GGMLType.Q2_K, GGMLType.Q3_K), {
        "warps8": (many_warps(8),),
        "warps2": (many_warps(2),),
        "few4": (few_warps(4),),
        "no-alloc": (past_l1("b.q[r][c] = __ldg(qp + 4 * c);", "b.q[r][c]", "qp + 4 * c"),),
        "blocks3": (min_blocks(3),)}),
}
# the elements of K a warp takes at a time, where not a superblock's 256
STEP = {"q6k_gemv.cu": 128}


def block_warps(n: int, k: int, warps: tuple[int, int | None], step: int = 256) -> int:
    """The warps a block of a source runs (its block_warps), for its
    (kManyWarps, kFewWarps or None): one a step of `step` elements, at most
    8; kManyWarps where the 16-row tiles fill two waves of blocks on the
    card's 132 SMs; kFewWarps where they all fit on the card at once at
    kFewWarps a block (16 / warps blocks an SM) but not at kManyWarps."""
    many, few = warps
    tiles, most = -(-n // dm.GEMV_ROWS), 8
    if tiles >= 2 * dm.GEMM_SMS:
        on_card = lambda w: dm.GEMM_SMS * (16 // w)  # noqa: E731
        most = few if few and on_card(many) < tiles <= on_card(few) else many
    return min(k // step, most)


def warp_constants(text: str) -> tuple[int, int | None]:
    """(kManyWarps, kFewWarps or None) of a source's text."""
    few = re.search(r"kFewWarps = (\d+)", text)
    return (int(re.search(r"kManyWarps = (\d+)", text).group(1)),
            int(few.group(1)) if few else None)


def edits(source: str, variant: str) -> list[tuple[str, str]]:
    """(text of the source, its replacement) for each edit of `variant`;
    raises RuntimeError where a pattern does not match exactly once."""
    src = (_build.CSRC / source).read_text()
    out = []
    for pattern, repl in SOURCES[source][1][variant]:
        found = list(re.finditer(pattern, src, re.S))
        if len(found) != 1:
            raise RuntimeError(f"{source}: {pattern!r} matches {len(found)} times")
        out.append((found[0].group(0), repl))
    return out


def variant_source(source: str, variant: str) -> str:
    """csrc/`source` with the edits of `variant`."""
    src = (_build.CSRC / source).read_text()
    for old, new in edits(source, variant):
        src = src.replace(old, new)
    return src


def build_variants(source: str, against: str | None = None) -> dict:
    """{variant: the source's entry points} for the source as it is, for
    each of its variants and, as "against", for the file `against`, built
    in parallel."""
    out_dir = _build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = source.removesuffix(".cu")
    jobs = {}
    texts = {name: variant_source(source, name) for name in SOURCES[source][1]}
    if against:
        texts["against"] = Path(against).read_text()
    for name, text in texts.items():
        src = out_dir / f"{stem}.probe-{name}.cu"
        src.write_text(text)
        jobs[name] = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), str(src)]
    _build._build({out_dir / f"{stem}.probe-{name}.so": cmd for name, cmd in jobs.items()})
    libs = {"source": {}}
    for name in jobs:
        libs[name] = _build._bind(out_dir / f"{stem}.probe-{name}.so", _build.SOURCES[source])
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
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", choices=sorted(SOURCES), action="append",
                    help="the source(s) to probe (default: all)")
    ap.add_argument("--against", help="another version of the one --source, "
                                      "timed as the variant 'against'")
    args = ap.parse_args()
    sources = args.source or list(SOURCES)
    if args.against and len(sources) != 1:
        ap.error("--against takes exactly one --source")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    own = _build.load()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for source in sources:
        libs = build_variants(source, args.against)
        # each build's warp constants (None for the other version: its
        # launch is its own)
        many = {name: warp_constants(variant_source(source, name))
                for name in SOURCES[source][1]}
        many["source"] = warp_constants((_build.CSRC / source).read_text())
        many["against"] = None
        for fmt in SOURCES[source][0]:
            probe(fmt, libs, many, own, smi, dev, gen, STEP.get(source, 256))


def probe(fmt: GGMLType, libs: dict, many: dict, own: dict, smi: str, dev, gen,
          step: int) -> None:
    """Time format `fmt`'s entry in each build of `libs` (whose warp
    constants are `many`, each warp taking `step` elements of K at a time)
    at SHAPES."""
    name = dm.MMA_GEMV[fmt]
    kern, plain = getattr(dm, name), getattr(dm, name + "_plain")
    for shape, (n, k) in SHAPES.items():
        ws = weights(fmt, n, k, dev, gen)
        w0 = ws[0]
        out_dtype = torch.float32 if shape == "head" else torch.bfloat16
        for m in ((1, 8) if shape in ("wo", "head") else (1,)):
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            want = plain(x, w0, torch.float32)
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
                ours = many[var] is not None
                print(json.dumps({"variant": var, "fmt": fmt.name, "shape": shape, "n": n,
                                  "k": k, "m": m, "ms": t, "bound_ms": bound,
                                  "share": bound / t, "blocks": blocks if ours else None,
                                  "warps": block_warps(n, k, many[var], step) if ours
                                  else None, "card": smi}),
                      flush=True)
        del ws, w0


if __name__ == "__main__":
    main()
