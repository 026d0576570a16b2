#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port `omni_tpu_torch` on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `omni_tpu_torch/csrc/`, holds each
against its plain PyTorch version at every Qwen3-8B shape of the served
path, serves a full-width Qwen3-8B Q4_K turn (all 36 layers, random weights
made on the card from a seed) through `OmniPipeline.stream_prefill` /
`stream_decode`, checks that the turn went through both kernels and that
its logits agree with the plain path, and times each kernel beside its
bound. One flushed line per phase, each with its seconds and the running
total. The second-to-last lines are the card as nvidia-smi reports it and
a JSON `{"kernels": [...]}` line; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside a checkout
of the repository, it fails before printing any result.

Imports nothing of JAX or of the JAX package `omni_tpu`.
"""

from __future__ import annotations

import json
import queue
import subprocess
import sys
import time
from contextlib import contextmanager
from unittest import mock

T_START = time.perf_counter()

# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_OPS_PER_S = 989e12

# Qwen3-8B weight shapes on the served path (fused wqkv and gate+up), N x K
SHAPES = {"wqkv": (6144, 4096), "wo": (4096, 4096), "gateup": (24576, 4096),
          "down": (4096, 12288), "output": (151748, 4096)}
GEMV_MS = (1, 2, 3, 8)
L2_FLUSH_BYTES = 100 * 2**20
GEMM_MS = (64, 256)
# kernel vs plain: both run the same law with f32 sums in another order,
# so a bf16 output may round one way or the other: 2 bf16 ulps of |want|
# (2 x 2**-7 relative at worst), plus a floor of 1e-3 x max|want| for the
# f32 order differences near zero. Measured: 1 ulp at most.
KERNEL_RTOL, KERNEL_FLOOR = 2**-6, 1e-3
# served logits vs the plain path, relative to max|logit|: the two differ
# by those flips, carried through 36 layers (measured 7.6e-5); the argmax
# of every row must agree too
LOGITS_REL_TOL = 1e-3

N_CTX, N_PREFILL, N_DECODE, N_TEACHER = 2048, 64, 128, 8
N_LAYERS = 36  # full depth: nothing is cut

KERNELS = {
    "q4k_gemv": {"route": "cuda", "source": "omni_tpu_torch/csrc/q4k_gemv.cu",
                 "replaces": "omni_tpu/kernels/dequant_matmul.py:333"},
    "q4k_gemm": {"route": "cuda", "source": "omni_tpu_torch/csrc/q4k_gemm.cu",
                 "replaces": "omni_tpu/kernels/dequant_matmul.py:565"},
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


def bound_ms(m: int, qt, out_dtype) -> tuple[float, str]:
    """Least time for one call: bytes (the weight planes as the port stores
    them, 0.594 B per element, and x and out, each once) over HBM bandwidth
    vs operations over the bf16 tensor-core peak (the operands are bf16 x
    and 4-bit weights, which tensor cores take as bf16)."""
    n, k = qt.shape
    out_b = 4 if str(out_dtype).endswith("float32") else 2
    nbytes = qt.nbytes + m * k * 2 + m * n * out_b
    ops = 2.0 * m * n * k
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_TENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextmanager
def plain_matmuls(qwen3_mod, dm):
    """Run the forward with each kernel replaced by its plain version (the
    same dispatch by M), for the logits reference."""
    from omni_tpu_torch.kernels.qformats import QTensor

    def plain(x, w, out_dtype=None):
        import torch

        out_dtype = out_dtype or torch.bfloat16
        if not isinstance(w, QTensor):
            return dm.matmul(x, w, out_dtype)
        fn = dm.q4k_gemv_plain if x.shape[0] <= dm.GP_MAX_M else dm.q4k_gemm_plain
        return fn(x.to(torch.bfloat16), w, out_dtype)

    with mock.patch.object(qwen3_mod, "matmul", plain):
        yield


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from omni_tpu_torch.kernels import _build
    from omni_tpu_torch.kernels import dequant_matmul as dm
    from omni_tpu_torch.kernels.qformats import dequant
    from omni_tpu_torch.models import qwen3
    from omni_tpu_torch.omni.pipeline import OmniPipeline, SessionConfig
    from omni_tpu_torch.runtime import Batch, Context, SamplerParams
    from omni_tpu_torch.testing_synth import QWEN3_8B, synth_q4k, synth_qwen3_params

    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 dots stay f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. environment ----------------------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    phase("environment", t0, f"torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {kind!r} count "
          f"{torch.cuda.device_count()} nvidia-smi {smi!r}")

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    phase("build", t0, f"nvcc {', '.join(_build.SOURCES)} -> {_build.build_dir()}")

    # ---- 3. kernels vs their plain versions at the path's shapes -----------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(1)
    weights = {nm: synth_q4k(n, k, dev, gen) for nm, (n, k) in SHAPES.items()}
    max_err = {name: 0.0 for name in KERNELS}
    for nm, qt in weights.items():
        out_dtype = torch.float32 if nm == "output" else torch.bfloat16
        k = qt.shape[1]
        for name, ms, kern, plain in (
                ("q4k_gemv", GEMV_MS, dm.q4k_gemv, dm.q4k_gemv_plain),
                ("q4k_gemm", GEMM_MS, dm.q4k_gemm, dm.q4k_gemm_plain)):
            for m in ms:
                x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
                got = kern(x, qt, out_dtype).float()
                want = plain(x, qt, out_dtype).float()
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                worst = limit_ratio(got, want)
                max_err[name] = max(max_err[name], err)
                ok = bool(torch.isfinite(got).all()) and worst <= 1.0
                print(f"  {name} {nm} {qt.shape[0]}x{k} M={m}: max|d|={err:.3g}"
                      f" max|want|={want.abs().max().item():.3g}, worst |d|/limit"
                      f" {worst:.3g} (limit {KERNEL_RTOL:g}|want| + "
                      f"{KERNEL_FLOOR:g} max|want|) {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    raise SystemExit(f"{name} disagrees with its plain version")
    phase("kernels-vs-plain", t0, json.dumps(max_err))

    # ---- 4. served turn ------------------------------------------------------
    t0 = time.perf_counter()
    cfg = QWEN3_8B
    if cfg.n_layers != N_LAYERS:
        raise SystemExit(f"expected {N_LAYERS} layers, got {cfg.n_layers}")
    params = synth_qwen3_params(cfg, dev, torch.Generator(device=dev).manual_seed(0),
                                fuse=True)
    torch.cuda.synchronize()
    phase("synthesise", t0, f"Qwen3-8B {cfg.n_layers} layers d_model "
          f"{cfg.d_model} d_ff {cfg.d_ff} vocab {cfg.n_vocab}, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")

    n_fwd = {"m1": 0, "other": 0}

    def counted_forward(params, cfg, x, *a, **kw):
        n_fwd["m1" if x.shape[0] == 1 else "other"] += 1
        return qwen3.forward(params, cfg, x, *a, **kw)

    llm = Context(cfg, params, counted_forward, qwen3.embed, n_ctx=N_CTX,
                  sampler=SamplerParams(greedy=True), device=dev)
    pipe = OmniPipeline(llm, BenchTokenizer(),
                        SessionConfig(max_preserved_context=N_CTX))
    rng = torch.Generator().manual_seed(0)
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
    t1 = time.perf_counter()
    pipe.warm_decode()
    torch.cuda.synchronize()
    warm_decode_s = time.perf_counter() - t1
    cont = torch.randint(0, 1000, (N_PREFILL,), generator=rng).numpy()
    llm.decode(Batch(tokens=cont))
    t1 = time.perf_counter()
    logits, hidden = llm.decode(Batch(tokens=cont), return_hidden=True)
    warm_prefill_ms = (time.perf_counter() - t1) * 1e3
    if not (torch.isfinite(logits).all() and torch.isfinite(hidden).all()
            and tuple(logits.shape) == (N_PREFILL, cfg.n_vocab)
            and tuple(hidden.shape) == (N_PREFILL, cfg.d_model)):
        raise SystemExit("prefill logits/hidden are not finite or misshapen")
    m1_before, gemv_before = n_fwd["m1"], dm.launches["q4k_gemv"]
    texts.clear()
    t1 = time.perf_counter()
    pipe.stream_decode(round_idx=1, max_new_tokens=N_DECODE)
    torch.cuda.synchronize()
    turn_s = time.perf_counter() - t1
    drain()
    launches = dict(dm.launches)  # the main path ends here
    decode_ms_per_token = turn_s * 1e3 / N_DECODE
    m1_steps = n_fwd["m1"] - m1_before
    gemv_turn = launches["q4k_gemv"] - gemv_before
    per_token = gemv_turn / max(m1_steps, 1)
    text = "".join(texts)
    print(f"  prefill (session init, incl. first use) {prefill_ms:.1f} ms; warm "
          f"turn {warm_turn_s:.2f} s; warm_decode {warm_decode_s:.2f} s; warm "
          f"{N_PREFILL}-token prefill {warm_prefill_ms:.2f} ms; timed turn "
          f"{N_DECODE} tokens {turn_s:.3f} s = {decode_ms_per_token:.3f} "
          f"ms/token; M=1 forward steps {m1_steps}; q4k_gemv launches "
          f"{gemv_turn} = {per_token:g}/step; text {len(text)} chars",
          flush=True)
    want_per_token = 4 * cfg.n_layers + 1
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel was never launched on the main path: {launches}")
    if gemv_turn != want_per_token * m1_steps or m1_steps < N_DECODE - 1:
        raise SystemExit(f"decode launches {gemv_turn} != {want_per_token} x "
                         f"{m1_steps} M=1 steps")
    if len(text) < N_DECODE - 1:
        raise SystemExit(f"the turn emitted {len(text)} chars for {N_DECODE} tokens")
    phase("served-turn", t0, json.dumps(
        {"launches": launches, "gemv_per_decode_step": per_token,
         "decode_ms_per_token": decode_ms_per_token,
         "warm_prefill_ms": warm_prefill_ms, "layers": cfg.n_layers}))

    # teacher-forced logits: kernel path vs the plain path, same weights
    t0 = time.perf_counter()
    tokens = torch.randint(0, 1000, (N_PREFILL,), generator=rng).numpy()

    def teacher_run(forced=None):
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

    got, fed = teacher_run()
    with plain_matmuls(qwen3, dm):
        want, _ = teacher_run(fed)
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    agree = int((got.argmax(-1) == want.argmax(-1)).sum())
    print(f"  teacher-forced logits over prefill + {N_TEACHER} decode steps: "
          f"max|d|={err:.4g}, max|ref|={scale:.4g}, rel {err / scale:.3g} "
          f"(tol {LOGITS_REL_TOL}); argmax agrees {agree}/{N_TEACHER + 1}",
          flush=True)
    if not (torch.isfinite(got).all() and err <= LOGITS_REL_TOL * scale
            and agree == N_TEACHER + 1):
        raise SystemExit("served logits disagree with the plain path")
    del llm, pipe
    torch.cuda.empty_cache()
    phase("teacher-forced", t0, f"rel {err / scale:.3g}")

    # ---- 5. times at the path's shapes -------------------------------------
    t0 = time.perf_counter()
    rows = []
    for nm, qt in weights.items():
        out_dtype = torch.float32 if nm == "output" else torch.bfloat16
        n, k = qt.shape
        # enough weight copies to stream > 2x the 50 MB L2 per round, as the
        # decode path streams every layer's weights from HBM
        ws = [qt] + [synth_q4k(n, k, dev, gen)
                     for _ in range(min(7, L2_FLUSH_BYTES // qt.nbytes))]
        w_bf16 = [dequant(w, torch.bfloat16) for w in ws]  # library operands
        for name, ms, kern, plain in (
                ("q4k_gemv", GEMV_MS, dm.q4k_gemv, dm.q4k_gemv_plain),
                ("q4k_gemm", GEMM_MS, dm.q4k_gemm, dm.q4k_gemm_plain)):
            for m in ms:
                x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
                t_k = graph_ms(lambda i: kern(x, ws[i % len(ws)], out_dtype), 24)
                t_p = cuda_ms(lambda: plain(x, qt, out_dtype), 3)
                t_l = graph_ms(lambda i: torch.matmul(x, w_bf16[i % len(ws)].T), 24)
                b, by = bound_ms(m, qt, out_dtype)
                rows.append({"kernel": name, "shape": nm, "n": n, "k": k, "m": m,
                             "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                             "bound_ms": b, "bound_by": by})
                print(f"  {name} {nm} {n}x{k} M={m}: {t_k:.4f} ms, plain "
                      f"{t_p:.4f}, torch.matmul(bf16) {t_l:.4f}, bound "
                      f"{b:.4f} ({by}), {b / t_k:.1%} of bound", flush=True)
        del ws, w_bf16
    phase("times", t0)

    # one served token (M=1: 36 layers x 4 matmuls + the head) and one
    # 64-token prefill ubatch (M=64) per kernel, summed over the path's calls
    per_call = {"wqkv": cfg.n_layers, "wo": cfg.n_layers, "gateup": cfg.n_layers,
                "down": cfg.n_layers, "output": 1}
    entries = []
    for name, m in (("q4k_gemv", 1), ("q4k_gemm", 64)):
        sel = [r for r in rows if r["kernel"] == name and r["m"] == m]
        tot = {key: sum(r[key] * per_call[r["shape"]] for r in sel)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        by = {"bytes": 0.0, "operations": 0.0}
        for r in sel:
            by[r["bound_by"]] += r["bound_ms"] * per_call[r["shape"]]
        entries.append({"name": name, **KERNELS[name], "launches": launches[name],
                        "max_abs_err": max_err[name], "ms": tot["ms"],
                        "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                        "bound_by": max(by, key=by.get),
                        "library_ms": tot["library_ms"],
                        "work": f"M={m}, 36 layers x (wqkv, wo, gateup, down) + output"})

    print(smi, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
