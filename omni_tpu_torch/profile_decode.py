"""Where a served decode step's time goes, on the card.

    python -m omni_tpu_torch.profile_decode

Synthesises Qwen3-8B Q4_K on the card (all 36 layers, seed 0), prefills a
64-token prompt, runs one untraced decode chunk of `omni_decode_scan`, then
traces two more with torch.profiler: STEP_SIZE single-token steps each,
under the KV bucket the pipeline would pick. Prints the wall time per step,
the device time summed over kernels, their ratio (the device's busy share;
the rest is the device waiting for the host), the device kernels per step,
and the kernels that take the most device time.
"""

from __future__ import annotations

import time

import torch


def main() -> None:
    from torch.profiler import ProfilerActivity, profile

    from .kernels import dequant_matmul as dm
    from .models import qwen3
    from .omni.pipeline import STEP_SIZE
    from .runtime import Context, SamplerParams
    from .runtime.loop import omni_decode_scan
    from .testing_synth import QWEN3_8B, synth_qwen3_params

    dev = torch.device("cuda")
    cfg = QWEN3_8B
    params = synth_qwen3_params(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    ctx = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=2048,
                  sampler=SamplerParams(greedy=True), device=dev)
    logits = ctx.prefill(list(range(64)))
    chunks = 2
    # the KV bucket the pipeline's turn would pick for these cells
    kvb = ctx.kv_bucket(64 + (chunks + 1) * STEP_SIZE)

    def chunk(logits, pos):
        _, _, logits, ctx.cache, _, pos, _ = omni_decode_scan(
            qwen3.forward, qwen3.embed, cfg, params, ctx.cache, logits, pos,
            0, ctx.prev_tokens, n_steps=STEP_SIZE, sp=ctx.sampler, kv_limit=kvb)
        return logits, pos

    pos = torch.tensor(64, device=dev)
    logits, pos = chunk(logits, pos)  # warm-up
    torch.cuda.synchronize()
    dm.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(chunks):
            logits, pos = chunk(logits, pos)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n_steps = chunks * STEP_SIZE
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    n_kernels = sum(e.count for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"layers {cfg.n_layers}: {n_steps} decode steps, wall "
          f"{wall_ms / n_steps:.3f} ms/step, device busy "
          f"{dev_us / 1e3 / n_steps:.3f} ms/step ({dev_us / 1e3 / wall_ms:.1%} "
          f"busy), {n_kernels / n_steps:.0f} device kernels/step, launches "
          f"{dict(dm.launches)}")
    rows = sorted((e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)[:12]
    for e in rows:
        print(f"  {e.self_device_time_total / 1e3 / n_steps:8.3f} ms/step "
              f"{e.count / n_steps:6.1f}/step  {e.key[:90]}")


if __name__ == "__main__":
    main()
