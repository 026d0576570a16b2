"""The registers, spills and instructions of the mma.sync GEMVs, kernel A
(csrc/q4k_gemv.cu), kernel E's codebook entries (csrc/codebook_gemv.cu),
kernel C (csrc/q6k_gemv.cu) and kernel H (csrc/lowbit_gemv.cu), from their
compiler, on the machine with the card.

    python -m omni_tpu_torch.gemv_sass_probe

Compiles each source with `-Xptxas -v` and prints, for each instantiation
(format, aligned planes or not), the registers and spill bytes ptxas
reports; then disassembles its library (`cuobjdump -sass`) and counts the
instructions of each kernel's superblock loop (the longest predicated
backward branch: its two-buffer body holds two steps of a warp), by opcode. A
warp's step is 16 rows x 256 weights (a superblock; kernel C's is 128),
128 a lane, so the loop's instructions over 256 (kernel C's over 128) are
its instructions a weight. Prints one JSON line per kernel.
"""

from __future__ import annotations

import json
import re
import subprocess
from collections import Counter
from pathlib import Path

from .kernels import _build

# each source and its formats in the order of its Fmt enum (one format: no
# enum)
SOURCES = {"q4k_gemv.cu": ("Q4_K", "Q5_K", "Q4_0", "Q4_1", "Q5_0", "Q5_1"),
           "codebook_gemv.cu": ("IQ4_NL", "IQ4_XS", "MXFP4"),
           "q6k_gemv.cu": ("Q6_K",),
           "lowbit_gemv.cu": ("Q2_K", "Q3_K")}
# the weights of a row a warp's step covers, where not a superblock's 256
STEP = {"q6k_gemv.cu": 128}


def kernel_name(mangled: str, formats: tuple) -> str:
    """'Q4_K aligned' for gemv_kernel<Fmt 0, true> of a source whose Fmt
    enum lists `formats` (gemv_kernel<true> where it has one format)."""
    m = re.search(r"(?:FmtE(\d)E)?Lb([01])E", mangled)
    fmt = formats[int(m.group(1) or 0)]
    return f"{fmt} {'aligned' if m.group(2) == '1' else 'bytewise'}"


def ptxas(source: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)}."""
    out = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS[:-3], "-Xptxas", "-v", "-c",
         str(_build.CSRC / source), "-o", "/dev/null"],
        capture_output=True, text=True, check=True)
    res, name, spills = {}, None, (0, 0)
    for line in (out.stdout + out.stderr).splitlines():
        if "Compiling entry function" in line and "gemv_kernel" in line:
            name = kernel_name(line, SOURCES[source])
        elif name and "spill stores" in line:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line).groups()
            spills = (int(st), int(ld))
        elif name and "Used" in line and "registers" in line:
            res[name] = (int(re.search(r"Used (\d+) registers", line).group(1)), *spills)
            name = None
    return res


def loops(so: Path, formats: tuple) -> dict:
    """{kernel: (instructions of its longest loop, Counter of opcodes)}."""
    sass = subprocess.run([str(Path(_build.nvcc()).parent / "cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    res = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        if "gemv_kernel" not in fn.split("\n")[0]:
            continue
        ins = [(int(m.group(1), 16), m.group(2)) for m in
               re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
        # a loop's back edge is a predicated branch (an unpredicated one back
        # is the return from an out-of-line block)
        back = [(a, int(t.group(1), 16)) for a, i in ins
                for t in [re.search(r"^@!?U?P\w+ BRA[^0-9]*0x([0-9a-f]+)", i)]
                if t and int(t.group(1), 16) < a]
        end, start = max(back, key=lambda b: b[0] - b[1])
        body = [i for a, i in ins if start <= a <= end]
        ops = Counter(i.split()[1 if i.startswith("@") else 0].split(".")[0] for i in body)
        res[kernel_name(fn.split("\n")[0], formats)] = (len(body), ops)
    return res


def main() -> None:
    _build.load()
    for source, formats in SOURCES.items():
        regs = ptxas(source)
        so = _build.build_dir() / (Path(source).stem + ".so")
        step = STEP.get(source, 256)
        for name, (n, ops) in sorted(loops(so, formats).items()):
            r, st, ld = regs.get(name, (None, None, None))
            print(json.dumps({"source": source, "kernel": name, "registers": r,
                              "spill_store_bytes": st, "spill_load_bytes": ld,
                              "loop_instructions": n, "per_step": n / 2,
                              "step_weights": step, "per_weight": n / step,
                              "top": ops.most_common(12)}),
                  flush=True)


if __name__ == "__main__":
    main()
