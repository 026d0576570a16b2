"""Kernel F's split target (`flash_attention.TARGET_BLOCKS`) against other
ones, on the card.

    python -m omni_tpu_torch.flash_plan_probe   # from the repository root

Times kernel F for each cell type at chip_smoke.py's FLASH_TIMES shapes
(Qwen3-8B's 32 query heads over 8 KV heads of 128; T = 1 over 512 to
32,768 cells, T = 64 over 512 and 2,048) under each target of blocks in
TARGETS, in a CUDA graph over copies of the planes larger than the L2, as
chip_smoke.py times it, after holding the output to `flash_decode_plain`'s
within chip_smoke.py's limit. Prints the card's name and power limit, then
one JSON line per reading: the evidence for the target.
"""

from __future__ import annotations

import json
import subprocess
from unittest import mock

import torch

from .kernels import flash_attention as fa

# blocks to aim for: 1, 2, 3 and 4 per SM of the 132
TARGETS = (132, 264, 396, 528)


def main() -> int:
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("flash_plan_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    hq, hkv, _ = cs.FLASH_HEADS
    for bits, cells in ((16, "bf16"), (8, "int8"), (4, "int4")):
        for t, s in cs.FLASH_TIMES:
            q, k, v, mask, ks, vs = cs.flash_inputs(bits, t, s, dev, gen)
            planes = [x for x in (k, v, ks, vs) if x is not None]
            nbytes = sum(x.nbytes for x in planes)
            pool = [(k, v, ks, vs)] + [
                tuple(None if x is None else x.clone() for x in (k, v, ks, vs))
                for _ in range(min(127, cs.L2_FLUSH_BYTES // nbytes))]
            _, exact_abs = cs.flash_law_f64(q, k, v, mask, ks, vs, with_abs=True)
            limit = cs.FLASH_RTOL * exact_abs + cs.FLASH_FLOOR * exact_abs.max()
            want = fa.flash_decode_plain(q, k, v, mask, ks, vs)
            seen = set()
            for target in TARGETS:
                with mock.patch.object(fa, "TARGET_BLOCKS", target):
                    plan = fa.split_plan(t * hq // hkv, hkv, s)
                    if plan in seen:
                        continue
                    seen.add(plan)
                    got = fa.flash_decode(q, k, v, mask, ks, vs)
                    ok = bool(((got - want).abs() <= limit).all())
                    ms = cs.graph_ms(lambda i: fa.flash_decode(
                        q, *pool[i % len(pool)][:2], mask, *pool[i % len(pool)][2:]),
                        max(24, len(pool)))
                print(json.dumps({"cells": cells, "t": t, "s": s, "target": target,
                                  "regime": plan.regime, "per_split": plan.per_split,
                                  "nsplit": plan.nsplit, "ms": ms, "within_limit": ok}),
                      flush=True)
            del pool
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
