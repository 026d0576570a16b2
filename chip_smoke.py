#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port `omni_tpu_torch` on one NVIDIA GPU.

    python3 chip_smoke.py [--prompts N]

Builds the port's CUDA kernels from `omni_tpu_torch/csrc/` and holds each
against its plain PyTorch version at every Qwen3-8B shape of the served
paths (and reads both against the kernel's law evaluated in f64). Then it drives two paths at full width and depth (all 36 layers,
random weights made on the card from a seed), each through
`OmniPipeline.stream_prefill` / `stream_decode`:
1. an all-Q4_K Qwen3-8B synthesised in the port's planes, fused QKV and
   gate+up (kernels A and B);
2. a Q4_K_M Qwen3-8B GGUF written to a temporary directory (about 5 GB,
   deleted at exit) and loaded back through the port's GGUF reader and
   `qwen3.load_params`, unfused: Q4_K through kernels A and B, Q6_K through
   kernels C and D.
For each path it checks the launches of every kernel per decode step and
per 64-token ubatch, and that its logits agree with the plain path: within
1e-3 of max|logit| on the all-Q4_K model; on the Q4_K_M model, whose
logits sit at the bf16 noise floor, within twice the plain path's own
distance from the same forward with every matmul's law in f64 (over N
prompts, 3 by default). Last it
times each kernel beside its bound. One flushed line per phase, each with
its seconds and the running total. The second-to-last lines are the card as
nvidia-smi reports it and a JSON `{"kernels": [...]}` line; the last line
is {"ok": true, "device": {...}}. Without a CUDA device, or outside a
checkout of the repository, it fails before printing any result.

Imports nothing of JAX or of the JAX package `omni_tpu`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from unittest import mock

T_START = time.perf_counter()

# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_OPS_PER_S = 989e12

# Qwen3-8B weight shapes, N x K: the Q4_K ones of the fused all-Q4_K path
# (fused wqkv and gate+up), and the Q6_K ones of a Q4_K_M checkpoint
SHAPES = {"wqkv": (6144, 4096), "wo": (4096, 4096), "gateup": (24576, 4096),
          "down": (4096, 12288), "output": (151748, 4096)}
Q6_SHAPES = {"wv": (1024, 4096), "down": (4096, 12288), "output": (151748, 4096)}
# the Q4_K shapes of the unfused Q4_K_M path that the fused ones leave out
# (wq is wo's shape, w_up gate's); checked against the plain versions only
Q4_UNFUSED_SHAPES = {"wk": (1024, 4096), "gate": (12288, 4096)}
# a Q4_K weight whose K is no multiple of 2048 (kernel D's Q4_K branch; the
# shape of tests/test_qkernels.py::test_qmatmul_gp_odd_k_divisor)
ODD_K_SHAPE = (4096, 1280)
GEMV_MS = (1, 2, 3, 8)
GEMM_MS = (64, 256)
QGEMM_MS = (1, 64, 256)
L2_FLUSH_BYTES = 100 * 2**20
# kernel vs plain: both run the same law with f32 sums in another order,
# so a bf16 output may round one way or the other: 2 bf16 ulps of |want|
# (2 x 2**-7 relative at worst), plus a floor of 1e-3 x max|want| for the
# f32 order differences near zero. Measured: 1 ulp at most.
KERNEL_RTOL, KERNEL_FLOOR = 2**-6, 1e-3
# served logits vs the plain path, relative to max|logit|: the two differ
# by those flips, carried through 36 layers (measured 7.6e-5); the argmax
# of every row must agree too
LOGITS_REL_TOL = 1e-3
# The Q4_K_M model's signed Q6_K head gives logits with no common part (max
# ~11), where bf16 rounding alone moves the plain path as far from its law
# in f64 as 1.3e-3 of max|logit|. There the kernel path's RMS distance from
# the f64 path (every matmul's law in f64: law_f64), over the rows of
# N_PROMPTS_Q4KM prompts, must stay within F64_FACTOR of the plain path's
# own, and the argmax of every row must agree with the plain path's. One
# prompt is too few: its distance turns on a handful of bf16 flips, and
# the ratio per prompt read 1.1-3.4.
F64_FACTOR = 2.0
N_PROMPTS_Q4KM = 3

N_CTX, N_PREFILL, N_DECODE, N_TEACHER = 2048, 64, 128, 8
N_LAYERS = 36  # full depth: nothing is cut
# Q4_K_M Qwen3-8B (llama.cpp's rules): the output head and attn_v, ffn_down
# of 18 of the 36 layers are Q6_K, the other weights Q4_K
N_Q6K, N_Q4K = 37, 216

KERNELS = {
    "q4k_gemv": {"route": "cuda", "source": "omni_tpu_torch/csrc/q4k_gemv.cu",
                 "replaces": "omni_tpu/kernels/dequant_matmul.py:333"},
    "q4k_gemm": {"route": "cuda", "source": "omni_tpu_torch/csrc/q4k_gemm.cu",
                 "replaces": "omni_tpu/kernels/dequant_matmul.py:565"},
    "q6k_gemv": {"route": "cuda", "source": "omni_tpu_torch/csrc/q6k_gemv.cu",
                 "replaces": "omni_tpu/kernels/dequant_matmul.py:333"},
    "qgemm": {"route": "cuda", "source": "omni_tpu_torch/csrc/qgemm.cu",
              "replaces": "omni_tpu/kernels/dequant_matmul.py:103"},
}


def phase(name: str, t0: float, msg: str = "") -> None:
    now = time.perf_counter()
    print(f"[phase {name}] {now - t0:.2f} s (total {now - T_START:.1f} s)"
          + (f" {msg}" if msg else ""), flush=True)


class BenchTokenizer:
    """bench.py's tokenizer: byte ids, no special or end tokens, so every
    turn runs to its token budget."""

    class _V:
        token_to_id: dict = {}
        eos_id = None

        @staticmethod
        def is_eog(tid):
            return False

    vocab = _V()

    def encode(self, text, add_special=False, parse_special=True):
        return [b % 1000 for b in text.encode()]

    def decode(self, ids):
        return "".join(chr(97 + int(i) % 26) for i in ids)


def limit_ratio(got, want) -> float:
    """Largest |got - want| over its limit (KERNEL_RTOL |want| +
    KERNEL_FLOOR max|want|); the kernel agrees where it is <= 1."""
    want_abs = want.abs()
    limit = KERNEL_RTOL * want_abs + KERNEL_FLOOR * want_abs.max()
    return ((got - want).abs() / limit).max().item()


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` runs, after one warm-up, by
    CUDA events around the launches (host enqueue time included)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of fn(i), i = 0..iters-1, captured in one CUDA graph
    and replayed, so the host's enqueue time between launches drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(m: int, n: int, k: int, weight_bytes: int,
             out_dtype) -> tuple[float, str]:
    """Least time for one call: bytes (the weight's `weight_bytes`, and x
    and out, each once) over HBM bandwidth vs operations over the bf16
    tensor-core peak (the operands are bf16 x and weights the tensor cores
    take as bf16). The weight bytes are those of the port's planes (Q4_K
    0.594 B per element, Q6_K 1.078 B) for the bound, those of the GGUF
    blocks (0.5625 and 0.8203 B) for the format's bound."""
    out_b = 4 if str(out_dtype).endswith("float32") else 2
    nbytes = weight_bytes + m * k * 2 + m * n * out_b
    ops = 2.0 * m * n * k
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_TENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def law_f64(name: str, x, qt, out_dtype):
    """Kernel `name`'s law evaluated in f64: the same bf16 x and the same
    weights (rounded to bf16 where the law rounds them), sums without
    rounding, one rounding to out_dtype at the end."""
    import torch

    from omni_tpu_torch.kernels import dequant_matmul as dm
    from omni_tpu_torch.kernels.qformats import (dequant, q4k_group_scales,
                                                 q6k_group_scales, unpack_sb_halves)

    f64 = torch.float64
    xd = x.to(torch.bfloat16).to(f64)
    if name == "q4k_gemv":  # the group law; q·dl − ml is exact in f64
        dl, ml = (a.to(f64).repeat_interleave(32, 1) for a in q4k_group_scales(qt))
        out = xd @ (unpack_sb_halves(qt.q).to(f64) * dl - ml).T
    elif name == "q4k_gemm":
        w, ml_res = dm.q4k_centered(qt)
        xs = xd.reshape(x.shape[0], -1, 32).sum(-1)
        out = xd @ w.to(f64).T - xs @ ml_res.to(f64).T
    elif name == "q6k_gemv":
        dl = q6k_group_scales(qt).to(f64).repeat_interleave(16, 1)
        out = xd @ (qt.q.to(f64) * dl).T
    elif name == "qgemm":
        out = xd @ dequant(qt, torch.bfloat16).to(f64).T
    else:
        raise ValueError(f"no law for kernel {name!r}")
    return out.to(out_dtype)


def plain_law(name: str, x, qt, out_dtype):
    """Kernel `name`'s plain PyTorch version."""
    from omni_tpu_torch.kernels import dequant_matmul as dm

    return getattr(dm, name + "_plain")(x, qt, out_dtype)


@contextmanager
def matmuls_by(qwen3_mod, dm, law):
    """Run the forward with each kernel replaced by law(kernel name, x, w,
    out_dtype) under the same dispatch (plain_law or law_f64), for the
    logits references."""
    from omni_tpu_torch.kernels.qformats import QTensor

    def mm(x, w, out_dtype=None):
        import torch

        out_dtype = out_dtype or torch.bfloat16
        if not isinstance(w, QTensor):
            return dm.matmul(x, w, out_dtype)
        return law(dm.kernel_for(x.shape[0], w).__name__,
                   x.to(torch.bfloat16), w, out_dtype)

    with mock.patch.object(qwen3_mod, "matmul", mm):
        yield


def check_kernel(name, kern, plain, qt, shape_name, m, out_dtype, gen, max_err):
    """Kernel `name` against its plain version on a random [m, K] x; both
    are also read against the law in f64 (bf16 outputs: the share rounded
    otherwise; f32 outputs: max|d| over max|law|)."""
    import torch

    x = torch.randn((m, qt.shape[1]), device=qt.q.device,
                    generator=gen).to(torch.bfloat16)
    got = kern(x, qt, out_dtype).float()
    want = plain(x, qt, out_dtype).float()
    exact = law_f64(name, x, qt, out_dtype).float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    worst = limit_ratio(got, want)
    max_err[name] = max(max_err[name], err)
    ok = bool(torch.isfinite(got).all()) and worst <= 1.0
    if out_dtype == torch.bfloat16:
        vs = [(a != exact).float().mean().item() for a in (got, want)]
        vs_what = "bf16 outputs rounded otherwise than the f64 law"
    else:
        vs = [((a - exact).abs().max() / exact.abs().max()).item()
              for a in (got, want)]
        vs_what = "max|d| / max|f64 law|"
    print(f"  {name} {qt.ggml_type.name} {shape_name} {qt.shape[0]}x{qt.shape[1]}"
          f" M={m}: max|d|={err:.3g} max|want|={want.abs().max().item():.3g},"
          f" worst |d|/limit {worst:.3g} (limit {KERNEL_RTOL:g}|want| + "
          f"{KERNEL_FLOOR:g} max|want|) {'ok' if ok else 'FAIL'}; {vs_what}: "
          f"kernel {vs[0]:.3g}, plain {vs[1]:.3g}", flush=True)
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version")


def serve_turn(label, cfg, params, dev, dm, qwen3, want_step, want_ubatch, rng):
    """The main path: one served turn (session-init prefill of a 64-char
    prompt, a 32-token warm turn, a warm 64-token prefill ubatch, a timed
    N_DECODE-token turn) with every launch count set to 0 just before it
    and read just after. Checks the launches of each kernel in every
    single-token decode step (want_step) and in the 64-token ubatch
    (want_ubatch). The prompt and the ubatch's tokens are drawn from host
    generator `rng`. Returns (the path's launches, its numbers)."""
    import torch

    from omni_tpu_torch.omni.pipeline import OmniPipeline, SessionConfig
    from omni_tpu_torch.runtime import Batch, Context, SamplerParams

    calls = []  # (rows, launches of that forward call), in order

    def counted_forward(params, cfg, x, *a, **kw):
        before = dict(dm.launches)
        out = qwen3.forward(params, cfg, x, *a, **kw)
        calls.append((x.shape[0], {k: v - before[k] for k, v in dm.launches.items()}))
        return out

    llm = Context(cfg, params, counted_forward, qwen3.embed, n_ctx=N_CTX,
                  sampler=SamplerParams(greedy=True), device=dev)
    pipe = OmniPipeline(llm, BenchTokenizer(),
                        SessionConfig(max_preserved_context=N_CTX))
    prompt = "".join(chr(65 + int(c)) for c in torch.randint(0, 26, (N_PREFILL,),
                                                             generator=rng))
    texts = []

    def drain():
        while True:
            try:
                ev = pipe.text_out.get_nowait()
            except queue.Empty:
                return
            texts.append(ev.get("content", ""))

    dm.reset_launches()  # the main path starts here
    t1 = time.perf_counter()
    pipe.stream_prefill(index=0, system_prompt=prompt)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t1) * 1e3
    t1 = time.perf_counter()
    pipe.stream_decode(round_idx=0, max_new_tokens=32)
    drain()
    warm_turn_s = time.perf_counter() - t1
    pipe.warm_decode()
    cont = torch.randint(0, 1000, (N_PREFILL,), generator=rng).numpy()
    llm.decode(Batch(tokens=cont))
    t1 = time.perf_counter()
    logits, hidden = llm.decode(Batch(tokens=cont), return_hidden=True)
    warm_prefill_ms = (time.perf_counter() - t1) * 1e3
    ubatch = calls[-1][1]
    if not (torch.isfinite(logits).all() and torch.isfinite(hidden).all()
            and tuple(logits.shape) == (N_PREFILL, cfg.n_vocab)
            and tuple(hidden.shape) == (N_PREFILL, cfg.d_model)):
        raise SystemExit("prefill logits/hidden are not finite or misshapen")
    n_before = len(calls)
    texts.clear()
    t1 = time.perf_counter()
    pipe.stream_decode(round_idx=1, max_new_tokens=N_DECODE)
    torch.cuda.synchronize()
    turn_s = time.perf_counter() - t1
    drain()
    launches = dict(dm.launches)  # the main path ends here
    steps = [c for t, c in calls[n_before:] if t == 1]
    decode_ms_per_token = turn_s * 1e3 / N_DECODE
    text = "".join(texts)
    print(f"  {label}: prefill (session init, incl. first use) {prefill_ms:.1f} "
          f"ms; warm turn {warm_turn_s:.2f} s; warm {N_PREFILL}-token prefill "
          f"{warm_prefill_ms:.2f} ms, launches {ubatch}; timed turn {N_DECODE} "
          f"tokens {turn_s:.3f} s = {decode_ms_per_token:.3f} ms/token; "
          f"{len(steps)} single-token steps, launches per step "
          f"{steps[0] if steps else None}; text {len(text)} chars", flush=True)
    bad = [c for c in steps if c != want_step]
    if bad or len(steps) < N_DECODE - 1:
        raise SystemExit(f"decode steps: want {want_step} launches in each of "
                         f">= {N_DECODE - 1} steps, got {len(steps)} steps, "
                         f"{len(bad)} differing, e.g. {bad[:1]}")
    if ubatch != want_ubatch:
        raise SystemExit(f"64-token ubatch launches {ubatch} != {want_ubatch}")
    if len(text) < N_DECODE - 1:
        raise SystemExit(f"the turn emitted {len(text)} chars for {N_DECODE} tokens")
    return launches, {"launches_per_decode_step": steps[0],
                      "launches_per_64_token_ubatch": ubatch,
                      "decode_ms_per_token": decode_ms_per_token,
                      "warm_prefill_ms": warm_prefill_ms,
                      "session_init_prefill_ms": prefill_ms,
                      "layers": cfg.n_layers}


def teacher_forced(cfg, params, dev, dm, qwen3, prompts, against: str) -> dict:
    """Logits of the kernel path, the plain path and the f64 path (every
    matmul's law in f64) over each prompt of `prompts` (token arrays): a
    prefill and N_TEACHER decode steps fed the kernel path's own greedy
    tokens. Fails on any argmax disagreement with the plain path, and past
    the limit `against` names: "plain", kernel vs plain within
    LOGITS_REL_TOL of max|logit| on every prompt; "f64", the kernel path's
    RMS distance from the f64 path over the rows of all prompts within
    F64_FACTOR of the plain path's. Returns the readings."""
    import torch

    from omni_tpu_torch.runtime import Batch, Context, SamplerParams

    def run(tokens, forced=None):
        ctx = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=N_CTX,
                      sampler=SamplerParams(greedy=True), device=dev)
        lg, _ = ctx.decode(Batch(tokens=tokens))
        rows, fed = [lg[-1].float()], []
        for i in range(N_TEACHER):
            tok = int(torch.argmax(rows[-1])) if forced is None else forced[i]
            fed.append(tok)
            lg, _ = ctx.decode(Batch(tokens=[tok]))
            rows.append(lg[-1].float())
        return torch.stack(rows), fed

    per, diffs, bad = [], {"kernel": [], "plain": []}, []
    for i, tokens in enumerate(prompts):
        got, fed = run(tokens)
        with matmuls_by(qwen3, dm, plain_law):
            want, _ = run(tokens, fed)
        with matmuls_by(qwen3, dm, law_f64):
            exact, _ = run(tokens, fed)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        scale_f64 = exact.abs().max().item()
        r = {"rel": err / scale,
             "argmax_agree": int((got.argmax(-1) == want.argmax(-1)).sum()),
             "argmax_agree_f64": int((got.argmax(-1) == exact.argmax(-1)).sum()),
             "max_logit": scale_f64}
        for side, a in (("kernel", got), ("plain", want)):
            d = (a - exact) / scale_f64
            diffs[side].append(d)
            r[f"{side}_vs_f64_rel"] = d.abs().max().item()
            r[f"{side}_vs_f64_rms"] = d.pow(2).mean().sqrt().item()
        per.append(r)
        print(f"  teacher-forced logits, prompt {i}, prefill + {N_TEACHER} decode "
              f"steps: kernel vs plain max|d|={err:.4g}, max|ref|={scale:.4g}, "
              f"rel {r['rel']:.3g}; argmax agrees {r['argmax_agree']}/"
              f"{N_TEACHER + 1} (with the f64 path {r['argmax_agree_f64']}); vs "
              f"the f64 path, max|d| / max|logit| kernel "
              f"{r['kernel_vs_f64_rel']:.3g}, plain {r['plain_vs_f64_rel']:.3g}, "
              f"rms(d) / max|logit| kernel {r['kernel_vs_f64_rms']:.3g}, plain "
              f"{r['plain_vs_f64_rms']:.3g}", flush=True)
        if not torch.isfinite(got).all():
            bad.append(f"prompt {i}: logits not finite")
        if r["argmax_agree"] != N_TEACHER + 1:
            bad.append(f"prompt {i}: argmax agrees {r['argmax_agree']}/{N_TEACHER + 1}")
        if against == "plain" and r["rel"] > LOGITS_REL_TOL:
            bad.append(f"prompt {i}: rel {r['rel']:.3g} > {LOGITS_REL_TOL}")
    rms = {side: torch.cat(d).pow(2).mean().sqrt().item() for side, d in diffs.items()}
    ratio = rms["kernel"] / max(rms["plain"], 1e-30)
    print(f"  teacher-forced logits over {len(prompts)} prompt(s): rms(d) / "
          f"max|logit| vs the f64 path, kernel {rms['kernel']:.3g}, plain "
          f"{rms['plain']:.3g}, ratio {ratio:.3g}; limit: "
          + (f"rel <= {LOGITS_REL_TOL} per prompt" if against == "plain"
             else f"ratio <= {F64_FACTOR}"), flush=True)
    if against == "f64" and ratio > F64_FACTOR:
        bad.append(f"rms ratio {ratio:.3g} > {F64_FACTOR}")
    if bad:
        raise SystemExit("served logits disagree with the plain path: " + "; ".join(bad))
    return {"prompts": per, "kernel_vs_f64_rms": rms["kernel"],
            "plain_vs_f64_rms": rms["plain"], "rms_ratio": ratio}


def time_kernels(name, kern, plain, weights, ms, gen, synth, rows) -> None:
    """Time kernel `name`, its plain version and torch.matmul on the weight
    pre-dequantised to bf16, at each shape and M, beside the bound."""
    import torch

    from omni_tpu_torch.core.dtypes import row_nbytes
    from omni_tpu_torch.kernels.qformats import dequant

    for nm, qt in weights.items():
        out_dtype = torch.float32 if nm == "output" else torch.bfloat16
        n, k = qt.shape
        # enough weight copies to stream > 2x the 50 MB L2 per round, as the
        # decode path streams every layer's weights from HBM
        ws = [qt] + [synth(n, k, qt.q.device, gen)
                     for _ in range(min(7, L2_FLUSH_BYTES // qt.nbytes))]
        w_bf16 = [dequant(w, torch.bfloat16) for w in ws]  # library operands
        for m in ms:
            x = torch.randn((m, k), device=qt.q.device, generator=gen).to(torch.bfloat16)
            t_k = graph_ms(lambda i: kern(x, ws[i % len(ws)], out_dtype), 24)
            t_p = cuda_ms(lambda: plain(x, qt, out_dtype), 3)
            t_l = graph_ms(lambda i: torch.matmul(x, w_bf16[i % len(ws)].T), 24)
            b, by = bound_ms(m, n, k, qt.nbytes, out_dtype)
            fb, _ = bound_ms(m, n, k, n * row_nbytes(qt.ggml_type, k), out_dtype)
            rows.append({"kernel": name, "shape": nm, "n": n, "k": k, "m": m,
                         "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                         "bound_ms": b, "bound_by": by, "format_bound_ms": fb})
            print(f"  {name} {qt.ggml_type.name} {nm} {n}x{k} M={m}: {t_k:.4f} ms,"
                  f" plain {t_p:.4f}, torch.matmul(bf16) {t_l:.4f}, bound "
                  f"{b:.4f} ({by}), {b / t_k:.1%} of bound; format's bound "
                  f"{fb:.4f}, {fb / t_k:.1%}", flush=True)
        del ws, w_bf16


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prompts", type=int, default=N_PROMPTS_Q4KM,
                    help="prompts of the Q4_K_M teacher-forced check (each "
                         "64 random tokens; the first ones are the default run's)")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from omni_tpu_torch.core.dtypes import GGMLType
    from omni_tpu_torch.core.gguf import GGUFReader
    from omni_tpu_torch.kernels import _build
    from omni_tpu_torch.kernels import dequant_matmul as dm
    from omni_tpu_torch.kernels.qformats import QTensor, repack, upload
    from omni_tpu_torch.models import qwen3
    from omni_tpu_torch.testing_synth import (QWEN3_8B, synth_q4k, synth_q6k,
                                              synth_qwen3_params, write_qwen3_gguf)

    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 dots stay f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = QWEN3_8B
    if cfg.n_layers != N_LAYERS:
        raise SystemExit(f"expected {N_LAYERS} layers, got {cfg.n_layers}")

    # ---- environment -------------------------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    phase("environment", t0, f"torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {kind!r} count "
          f"{torch.cuda.device_count()} nvidia-smi {smi!r}")

    # ---- build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    phase("build", t0, f"nvcc {', '.join(_build.SOURCES)} -> {_build.build_dir()}")

    # ---- kernels vs their plain versions at the paths' shapes --------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(1)
    weights = {nm: synth_q4k(n, k, dev, gen) for nm, (n, k) in SHAPES.items()}
    q6_weights = {nm: synth_q6k(n, k, dev, gen) for nm, (n, k) in Q6_SHAPES.items()}
    max_err = {name: 0.0 for name in KERNELS}
    q4_unfused = {nm: synth_q4k(n, k, dev, gen)
                  for nm, (n, k) in Q4_UNFUSED_SHAPES.items()}
    for group, cases in (
            ({**weights, **q4_unfused},
             (("q4k_gemv", GEMV_MS), ("q4k_gemm", GEMM_MS))),
            (q6_weights, (("q6k_gemv", GEMV_MS), ("qgemm", QGEMM_MS))),
            ({"odd_k": synth_q4k(*ODD_K_SHAPE, dev, gen)}, (("qgemm", (1, 64)),))):
        for nm, qt in group.items():
            out_dtype = torch.float32 if nm == "output" else torch.bfloat16
            for name, ms in cases:
                for m in ms:
                    check_kernel(name, getattr(dm, name), getattr(dm, name + "_plain"),
                                 qt, nm, m, out_dtype, gen, max_err)
    del q4_unfused
    phase("kernels-vs-plain", t0, json.dumps(max_err))

    # ---- path 1: all-Q4_K Qwen3-8B, fused (kernels A and B) ----------------
    t0 = time.perf_counter()
    params = synth_qwen3_params(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                                fuse=True)
    torch.cuda.synchronize()
    phase("synthesise", t0, f"Qwen3-8B Q4_K {cfg.n_layers} layers d_model "
          f"{cfg.d_model} d_ff {cfg.d_ff} vocab {cfg.n_vocab}, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    t0 = time.perf_counter()
    per_step = 4 * cfg.n_layers + 1
    zero = {name: 0 for name in KERNELS}
    rng = torch.Generator().manual_seed(0)
    launches_q4k, stats = serve_turn(
        "all-Q4_K fused", cfg, params, dev, dm, qwen3,
        {**zero, "q4k_gemv": per_step}, {**zero, "q4k_gemm": per_step}, rng)
    phase("served-turn", t0, json.dumps({"launches": launches_q4k, **stats}))
    t0 = time.perf_counter()
    tf = teacher_forced(cfg, params, dev, dm, qwen3,
                        [torch.randint(0, 1000, (N_PREFILL,), generator=rng).numpy()],
                        "plain")
    del params
    torch.cuda.empty_cache()
    phase("teacher-forced", t0, json.dumps(tf))

    # ---- path 2: Q4_K_M Qwen3-8B from a GGUF file (kernels A, B, C, D) -----
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = os.path.join(tmp, "qwen3-8b-q4_k_m.gguf")
        t0 = time.perf_counter()
        types = write_qwen3_gguf(path, cfg, "Q4_K_M",
                                 torch.Generator(device=dev).manual_seed(0))
        size = os.path.getsize(path)
        phase("gguf-write", t0, f"{path}: {size / 1e9:.3f} GB, "
              f"{sum(t == GGMLType.Q6_K for t in types.values())} Q6_K tensors")

        t0 = time.perf_counter()
        reader = GGUFReader(path)
        cfg_file = qwen3.Qwen3Config.from_gguf(reader.kv)
        # the file holds the float fields as f32
        if cfg_file != dataclasses.replace(
                cfg, rope_base=float(np.float32(cfg.rope_base)),
                rms_eps=float(np.float32(cfg.rms_eps))):
            raise SystemExit(f"from_gguf read {cfg_file}, wrote {cfg}")
        params = qwen3.load_params(reader, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        qts = [w for lp in params["layers"] for w in lp.values()
               if isinstance(w, QTensor)] + [params["output"]]
        n_q6 = sum(w.ggml_type == GGMLType.Q6_K for w in qts)
        n_q4 = sum(w.ggml_type == GGMLType.Q4_K for w in qts)
        if (n_q6, n_q4) != (N_Q6K, N_Q4K):
            raise SystemExit(f"{n_q6} Q6_K and {n_q4} Q4_K weights, want "
                             f"{N_Q6K} and {N_Q4K}")
        # the loaded planes equal a repack of the same blocks on the host
        for name, w in (("blk.0.attn_q.weight", params["layers"][0]["wq"]),
                        ("blk.0.attn_v.weight", params["layers"][0]["wv"])):
            ti = reader.tensors[name]
            ref = repack(upload(ti.data, "cpu"), ti.ggml_type, ti.shape)
            if w.ggml_type != ti.ggml_type or any(
                    not torch.equal(p.cpu(), getattr(ref, nm))
                    for nm, p in w.planes().items()):
                raise SystemExit(f"{name}: loaded planes differ from its blocks")
        reader.close()
        phase("gguf-load", t0, f"{load_s:.2f} s; {n_q4} Q4_K + {n_q6} Q6_K "
              f"weights, {sum(w.nbytes for w in qts) / 1e9:.3f} GB of planes, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")

    t0 = time.perf_counter()
    want_step = {"q4k_gemv": N_Q4K, "q6k_gemv": N_Q6K, "q4k_gemm": 0, "qgemm": 0}
    want_ubatch = {"q4k_gemv": 0, "q6k_gemv": 0, "q4k_gemm": N_Q4K, "qgemm": N_Q6K}
    rng = torch.Generator().manual_seed(0)
    launches_q4km, stats = serve_turn("Q4_K_M from GGUF", cfg, params, dev, dm,
                                      qwen3, want_step, want_ubatch, rng)
    phase("served-turn-q4km", t0, json.dumps({"launches": launches_q4km, **stats}))
    t0 = time.perf_counter()
    tf = teacher_forced(cfg, params, dev, dm, qwen3,
                        [torch.randint(0, 1000, (N_PREFILL,), generator=rng).numpy()
                         for _ in range(args.prompts)], "f64")
    del params
    torch.cuda.empty_cache()
    phase("teacher-forced-q4km", t0, json.dumps(tf))
    launches = {k: launches_q4k[k] + launches_q4km[k] for k in KERNELS}
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel was never launched on the main paths: {launches}")

    # ---- times at the paths' shapes ----------------------------------------
    t0 = time.perf_counter()
    rows = []
    time_kernels("q4k_gemv", dm.q4k_gemv, dm.q4k_gemv_plain, weights, GEMV_MS,
                 gen, synth_q4k, rows)
    time_kernels("q4k_gemm", dm.q4k_gemm, dm.q4k_gemm_plain, weights, GEMM_MS,
                 gen, synth_q4k, rows)
    time_kernels("q6k_gemv", dm.q6k_gemv, dm.q6k_gemv_plain, q6_weights, GEMV_MS,
                 gen, synth_q6k, rows)
    time_kernels("qgemm", dm.qgemm, dm.qgemm_plain, q6_weights, QGEMM_MS,
                 gen, synth_q6k, rows)
    phase("times", t0)

    # per kernel, the sum over the calls of one served token (M=1) or one
    # 64-token prefill ubatch (M=64): A and B over the all-Q4_K path's
    # fused calls, C and D over the Q6_K calls of the Q4_K_M path
    q4k_calls = {"wqkv": cfg.n_layers, "wo": cfg.n_layers,
                 "gateup": cfg.n_layers, "down": cfg.n_layers, "output": 1}
    q6k_calls = {"wv": N_Q6K // 2, "down": N_Q6K // 2, "output": 1}
    q4k_work = "36 layers x (wqkv, wo, gateup, down) + output"
    q6k_work = ("M=1 (C) or M=64 (D): 18 x (wv, down) + output of Q4_K_M "
                "Qwen3-8B")
    entries = []
    for name, m, calls, work in (
            ("q4k_gemv", 1, q4k_calls, f"M=1, {q4k_work}"),
            ("q4k_gemm", 64, q4k_calls, f"M=64, {q4k_work}"),
            ("q6k_gemv", 1, q6k_calls, q6k_work),
            ("qgemm", 64, q6k_calls, q6k_work)):
        sel = [r for r in rows if r["kernel"] == name and r["m"] == m]
        tot = {key: sum(r[key] * calls[r["shape"]] for r in sel)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                           "format_bound_ms")}
        by = {"bytes": 0.0, "operations": 0.0}
        for r in sel:
            by[r["bound_by"]] += r["bound_ms"] * calls[r["shape"]]
        entries.append({"name": name, **KERNELS[name], "launches": launches[name],
                        "launches_by_path": {"all_q4k_fused": launches_q4k[name],
                                             "q4_k_m_gguf": launches_q4km[name]},
                        "max_abs_err": max_err[name], "ms": tot["ms"],
                        "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                        "bound_by": max(by, key=by.get),
                        "library_ms": tot["library_ms"],
                        "format_bound_ms": tot["format_bound_ms"], "work": work})

    print(smi, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
