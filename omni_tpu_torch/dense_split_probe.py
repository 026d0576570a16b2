"""The dense dot's rounding and time against the size of its K chunks, on
the card.

    python -m omni_tpu_torch.dense_split_probe

At each unfused Qwen3-8B weight shape (random bf16 weights of RMS 0.025,
M = 1, 8 and 64) it reads, for cuBLAS with bf16 operands and f32 outputs
over the whole K ("unsplit"), over chunks of 256, 512 and 1024 (each chunk
a fresh f32 output, the chunks added in f32; 256 is the port's
`dequant_matmul.SPLIT_K`) and for the widened-f32 product (the law in
plain PyTorch), the share of bf16 outputs rounded otherwise than the law
in f64 (at the f32-output head: of the outputs rounded to bf16), and the
time of each at M = 1 and 64 in a CUDA graph over weight copies larger
than the L2. Then the same shares for attention's probabilities-by-V
product over a strided pool slice: unsplit, the port's `bmm_f32`, widened.
Prints one JSON line per reading and a summary per variant.
"""

from __future__ import annotations

import json

import torch

from .kernels import dequant_matmul as dm

F32 = torch.float32
SHAPES = {"wq": (4096, 4096), "wk": (1024, 4096), "gate": (12288, 4096),
          "down": (4096, 12288), "output": (151748, 4096)}
# calls of each shape per decode token (M = 1) or 64-token ubatch (M = 64)
CALLS = {"wq": 72, "wk": 72, "gate": 72, "down": 36, "output": 1}
L2_FLUSH_BYTES = 100 * 2**20


def unsplit(x, w):
    return torch.mm(x, w.T, out_dtype=F32)


def split(c: int):
    def f(x, w):
        n_c = x.shape[1] // c
        return torch.bmm(x.unflatten(1, (n_c, c)).transpose(0, 1),
                         w.T.unflatten(0, (n_c, c)), out_dtype=F32).sum(0)
    return f


def widened(x, w):
    return x.float() @ w.float().T


VARIANTS = {"unsplit": unsplit, "split256": split(256), "split512": split(512),
            "split1024": split(1024), "widened": widened}


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
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flips(got: torch.Tensor, exact: torch.Tensor) -> float:
    return (got.bfloat16() != exact.bfloat16()).float().mean().item()


def main() -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    print(json.dumps({"torch": torch.__version__, "device": torch.cuda.get_device_name(0),
                      "split_k": dm.SPLIT_K}), flush=True)
    worst = {v: 0.0 for v in VARIANTS}
    worst["port"] = 0.0
    for nm, (n, k) in SHAPES.items():
        w = torch.randn((n, k), device=dev, generator=gen).mul_(0.025).bfloat16()
        for m in (1, 8, 64):
            x = torch.randn((m, k), device=dev, generator=gen).bfloat16()
            exact = x.double() @ w.double().T
            row = {v: flips(f(x, w), exact) for v, f in VARIANTS.items()}
            row["port"] = flips(dm.dense_matmul(x, w, F32), exact)
            for v in worst:
                worst[v] = max(worst[v], row[v])
            print(json.dumps({"shape": nm, "m": m, "flips": row}), flush=True)
        del w
        torch.cuda.empty_cache()
    per = {m: {v: 0.0 for v in VARIANTS} for m in (1, 64)}
    for nm, (n, k) in SHAPES.items():
        ws = [torch.randn((n, k), device=dev, generator=gen).bfloat16()
              for _ in range(1 + min(7, L2_FLUSH_BYTES // (2 * n * k)))]
        for m in (1, 64):
            x = torch.randn((m, k), device=dev, generator=gen).bfloat16()
            row = {v: graph_ms(lambda i, f=f: f(x, ws[i % len(ws)]),
                               3 if v == "widened" else 24)
                   for v, f in VARIANTS.items()}
            for v in row:
                per[m][v] += row[v] * CALLS[nm]
            print(json.dumps({"shape": nm, "m": m, "ms": row}), flush=True)
        del ws
        torch.cuda.empty_cache()
    att = {}
    hkv, n_ctx, d = 8, 2048, 128
    pool = torch.randn((2, hkv, n_ctx, d), device=dev, generator=gen).bfloat16()
    for s in (512, 2048):
        v = pool[1, :, :s]  # a layer's cells, strided as the pool's
        for rows in (4, 256):  # decode (G = 4) and a 64-token ubatch
            p = torch.softmax(3 * torch.randn((hkv, rows, s), device=dev,
                                              generator=gen), -1).bfloat16()
            exact = p.double() @ v.double()
            att[f"S={s},rows={rows}"] = {
                "unsplit": flips(torch.bmm(p, v, out_dtype=F32), exact),
                "port": flips(dm.bmm_f32(p, v), exact),
                "widened": flips(p.float() @ v.float(), exact)}
    print(json.dumps({"attention_flips": att}), flush=True)
    print(json.dumps({"worst_flips": worst,
                      "ms_per_token_m1": per[1], "ms_per_ubatch_m64": per[64]}),
          flush=True)


if __name__ == "__main__":
    main()
