"""Where the spoken round's module time goes, on the card.

    python -m omni_tpu_torch.profile_spoken

Writes the full-width APM, TTS and Token2Wav files (random F16 weights,
seed 0, `testing_synth`) to a temporary directory and loads them on the
card, then times each module alone, after two warm calls, and traces one
more call with torch.profiler: the APM over a 1 s chunk, a 25-code TTS
scan (`tts_decode_scan` after a 13-row condition) and one Token2Wav window
of 28 codes. Prints per module the wall time, the device time summed over
kernels, the kernel launches, and the ops that take the most device time
and the most host time.
"""

from __future__ import annotations

import subprocess
import tempfile
import time

import numpy as np
import torch


def main() -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .cli.omni_cli import make_audio_encoder
    from .core.gguf import GGUFReader
    from .models import qwen3
    from .models import tts as tts_mod
    from .models.token2wav import Token2Wav
    from .runtime import Batch, Context
    from .runtime.loop import _scalar
    from .testing_synth import write_apm_gguf, write_token2wav_ggufs, write_tts_gguf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory(prefix="profile_spoken_") as tmp:
        gen = torch.Generator(device=dev).manual_seed(0)
        write_apm_gguf(f"{tmp}/apm.gguf", gen)
        write_tts_gguf(f"{tmp}/tts.gguf", gen)
        paths = write_token2wav_ggufs(f"{tmp}/token2wav", gen)
        encode = make_audio_encoder(f"{tmp}/apm.gguf", dev)
        reader = GGUFReader(f"{tmp}/tts.gguf")
        params, extras = tts_mod.load_params(reader, device=dev)
        cfg = tts_mod.config_from_gguf(reader.kv)
        t2w = Token2Wav.from_gguf(*(paths[k] for k in (
            "t2w_encoder", "t2w_flow", "t2w_extra", "t2w_vocoder", "t2w_prompt")),
            device=dev)
    ctx = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=2048, device=dev)
    _, hidden = ctx.decode(Batch(embeds=torch.randn((13, cfg.d_model), device=dev) * 0.1),
                           return_hidden=True)
    draws = torch.Generator(device=dev).manual_seed(0)
    wav = (0.3 * np.sin(2 * np.pi * 220 * np.arange(16000) / 16000)).astype(np.float32)
    codes = np.random.default_rng(0).integers(0, 6561, 28)

    def scan():
        return tts_mod.tts_decode_scan(params, cfg, extras, ctx.cache, hidden[-1],
                                       _scalar(13, dev), 25, generator=draws)[0].cpu()

    for name, fn in (("APM, a 1 s chunk", lambda: encode(wav).cpu()),
                     ("TTS, a 25-code scan", scan),
                     ("Token2Wav, a 28-code window", lambda: t2w.feed_window(codes))):
        fn()
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ka = prof.key_averages()
        device_ms = sum(e.device_time for e in prof.events()
                        if e.device_type == DeviceType.CUDA) / 1e3
        launches = sum(e.count for e in ka if e.key.startswith("cu") and "Launch" in e.key)
        print(f"== {name}: wall {wall * 1e3:.1f} ms, device {device_ms:.1f} ms "
              f"(kernel time summed), {launches} kernel launches", flush=True)
        print(ka.table(sort_by="self_device_time_total", row_limit=12,
                       max_name_column_width=60), flush=True)
        print(ka.table(sort_by="self_cpu_time_total", row_limit=8,
                       max_name_column_width=60), flush=True)


if __name__ == "__main__":
    main()
