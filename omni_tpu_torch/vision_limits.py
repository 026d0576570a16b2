"""The readings behind the limit of chip_smoke.py's card-vs-CPU check of
the VPM, on the card.

    python -m omni_tpu_torch.vision_limits [--seeds 0 1 2 3 4]

For each seed it writes the full-width VPM (26 x 1152 SigLip layers and the
64 x 4096 resampler, random F16 weights, `testing_synth.write_vpm_gguf`),
loads it on the card and on the CPU, and encodes one normalized 224 x 224
array drawn from the seed (16 x 16 = 256 patches) with `siglip.encode_image`
on both, as chip_smoke.py's check does. The gap is max|card - CPU| /
max|CPU| over the 64 x 4096 rows, for the sound port and with a fault
planted on the card:
- TF32 products (`torch.backends.cuda.matmul.allow_tf32`);
- the sincos table's grid transposed (row (r, c) given the table of
  (c, r): the reference's w-major flatten undone; on a square slice
  swapping the table's w and h arguments changes nothing, so this is the
  w/h fault a square slice can show);
- the learned positions' bucket ids one bucket row off (+70, the last row
  clamped).
Prints a line per seed and, as the last line, a JSON object of every
reading.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile

import numpy as np
import torch

SIDE = 224  # the checked array's side: 16 x 16 patches


def check_inputs(cfg, seed: int):
    """The checked array (normalized f32 [SIDE, SIDE, 3], uniform in [-1,
    1) as a 0.5/0.5-normalized image is), its bucket ids and sincos table,
    on the CPU."""
    from .models import siglip

    rng = np.random.default_rng(seed)
    px = torch.from_numpy(rng.uniform(-1, 1, (SIDE, SIDE, 3)).astype(np.float32))
    n = SIDE // cfg.patch_size
    ids = torch.from_numpy(siglip.bucket_positions(n, n, cfg.pos_buckets).astype(np.int64))
    pe = torch.from_numpy(siglip.sincos_pos_embed_2d(cfg.d_out, n, n))
    return px, ids, pe


def encode(params, cfg, px, ids, pe, dev, fault=None) -> torch.Tensor:
    """`siglip.encode_image` on `dev` (a fault planted where named), the
    rows on the CPU in f32."""
    from .models import siglip

    n = SIDE // cfg.patch_size
    if fault == "sincos_transposed":
        pe = pe.reshape(n, n, -1).transpose(0, 1).reshape(n * n, -1)
    if fault == "buckets_one_row_off":
        ids = torch.clamp(ids + cfg.pos_buckets, max=cfg.pos_buckets ** 2 - 1)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = fault == "tf32"
    try:
        out = siglip.encode_image(params, cfg, px.to(dev), ids.to(dev), pe.to(dev))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return out.float().cpu()


def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want|."""
    return float((got - want).abs().max() / want.abs().max())


FAULTS = ("tf32", "sincos_transposed", "buckets_one_row_off")


def readings(path: str, seed: int, dev) -> dict:
    """The gap of the sound port and of each fault."""
    from .core.gguf import GGUFReader
    from .models import siglip

    reader = GGUFReader(path)
    cfg = siglip.SigLipConfig.from_gguf(reader.kv)
    card = siglip.load_params(reader, device=dev)
    cpu = siglip.load_params(reader, device="cpu")
    reader.close()
    inputs = check_inputs(cfg, seed)
    want = encode(cpu, cfg, *inputs, "cpu")
    return {k: gap(encode(card, cfg, *inputs, dev, None if k == "sound" else k), want)
            for k in ("sound",) + FAULTS}


def main() -> None:
    from .testing_synth import write_vpm_gguf

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    res = {"card": smi, "seeds": args.seeds, "vpm": []}
    for seed in args.seeds:
        with tempfile.TemporaryDirectory(prefix="vision_limits_") as tmp:
            write_vpm_gguf(f"{tmp}/vpm.gguf", torch.Generator(device=dev).manual_seed(seed))
            r = readings(f"{tmp}/vpm.gguf", seed, dev)
        res["vpm"].append(r)
        print(f"seed {seed} ({smi}): VPM card vs CPU, of max|row| {json.dumps(r)}",
              flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
