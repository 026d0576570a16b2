"""The readings behind the limits of chip_smoke.py's two card-vs-CPU checks
of the spoken round, on the card.

    python -m omni_tpu_torch.spoken_limits [--seeds 0 1 2 3 4]

For each seed it writes the full-width TTS and Token2Wav files (random F16
weights, `testing_synth`), loads them on the card and on the CPU, and reads
each check's gap as chip_smoke.py computes it, for the sound port and with
a fault planted on the card:
- the TTS teacher-forced gap (`forced_gap`): N_STEPS codes drawn on the card
  after a condition of 10 random LLM tokens and hidden states, then the
  audio logits along them on the card and on the CPU (`forced_logits`), the
  largest over the steps of max|card - CPU| / max|CPU|. Faults: the rotary
  pairs of the other layout (`rope_neox` flipped), the head in f32 instead
  of the bf16 dot, TF32 dots;
- the Token2Wav window gap: one window of 3 silence codes and 25 random
  codes after the prompt's priming, max|card - CPU| over the wave, beside
  the CPU wave's RMS and its share of samples at the +-0.99 clamp
  (`wave_stats`). Faults: the CFM noise table drawn on the card, the
  table's rows one frame off, TF32 dots.
Prints a line per seed and, as the last line, a JSON object of every
reading.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import tempfile

import numpy as np
import torch

N_STEPS = 25  # teacher-forced TTS steps, as chip_smoke.py's check
N_TEXT = 10  # LLM tokens in the condition: one TTS chunk
LLM_D = 4096  # the LLM's width, the condition's input
T2W_FILES = ("t2w_encoder", "t2w_flow", "t2w_extra", "t2w_vocoder", "t2w_prompt")


def forced_logits(cfg, params, extras, cond, codes, device, logits=None) -> torch.Tensor:
    """The TTS's audio logits along `codes`, teacher-forced after the
    condition `cond`: [len(codes), n_codes] f32 on the CPU. `logits` maps
    (extras, hidden [d]) to logits; `tts.audio_logits` by default."""
    from .models import qwen3
    from .models import tts as tts_mod
    from .runtime import Batch, Context

    logits = logits or tts_mod.audio_logits
    ctx = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=256, device=device)
    _, h = ctx.decode(Batch(embeds=cond.to(device)), return_hidden=True)
    out = []
    for c in codes:
        out.append(logits(extras, h[-1]).float().cpu())
        _, h = ctx.decode(Batch(embeds=extras["emb_code_bf16"][int(c)][None]),
                          return_hidden=True)
    return torch.stack(out)


def forced_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest over the steps of max|got - want| / max|want|."""
    return float(((got - want).abs().amax(1) / want.abs().amax(1)).max())


def wave_stats(wave) -> dict:
    """A wave's RMS and its share of samples at the vocoder's clamp."""
    from .models.token2wav import hifigan

    w = np.abs(np.asarray(wave, np.float64))
    return {"rms": float(np.sqrt(np.mean(w ** 2))),
            "clamped": float(np.mean(w >= np.float32(hifigan.AUDIO_LIMIT)))}


@contextlib.contextmanager
def tf32_dots():
    """TF32 for f32 matmuls and convolutions, inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def f32_head(extras, hidden):
    return hidden.float() @ extras["head_code"].float().T


def tts_readings(path: str, seed: int, dev) -> dict:
    """The teacher-forced gap of the sound port and of each fault."""
    from .core.gguf import GGUFReader
    from .models import qwen3
    from .models import tts as tts_mod
    from .runtime import Batch, Context
    from .runtime.loop import _scalar

    reader = GGUFReader(path)
    cfg = tts_mod.config_from_gguf(reader.kv)
    card = tts_mod.load_params(reader, device=dev)
    cpu = tts_mod.load_params(GGUFReader(path), device="cpu")
    g = torch.Generator(device=dev).manual_seed(seed)
    n_text = min(150000, card[1]["emb_text"].shape[0])
    ids = torch.randint(0, n_text, (N_TEXT,), generator=g, device=dev)
    hid = torch.randn((N_TEXT, LLM_D), generator=g, device=dev)
    cond = tts_mod.build_condition(card[1], ids, hid, True,
                                   tts_mod.speaker_embed(card[1]))
    ctx = Context(cfg, card[0], qwen3.forward, qwen3.embed, n_ctx=256, device=dev)
    _, h0 = ctx.decode(Batch(embeds=cond), return_hidden=True)
    codes = tts_mod.tts_decode_scan(card[0], cfg, card[1], ctx.cache, h0[-1],
                                    _scalar(ctx.n_past[0], dev), N_STEPS,
                                    first_chunk=True, generator=g)[0].cpu().numpy()
    codes = codes[codes >= 0]
    want = forced_logits(cfg, *cpu, cond, codes, "cpu")
    flipped = dataclasses.replace(cfg, rope_neox=not cfg.rope_neox)
    out = {"sound": forced_gap(forced_logits(cfg, *card, cond, codes, dev), want),
           "rope_flipped": forced_gap(forced_logits(flipped, *card, cond, codes, dev),
                                      want),
           "f32_head": forced_gap(forced_logits(cfg, *card, cond, codes, dev,
                                                logits=f32_head), want)}
    with tf32_dots():
        out["tf32"] = forced_gap(forced_logits(cfg, *card, cond, codes, dev), want)
    return out


def t2w_readings(paths: dict, seed: int, dev) -> dict:
    """The window gap of the sound port and of each fault, and the CPU
    wave's RMS and clamped share."""
    from .models.token2wav import Token2Wav, dit
    from .omni.pipeline import SILENCE_TOKEN, T2W_LOOKAHEAD, T2W_MAIN

    files = [paths[k] for k in T2W_FILES]
    rng = np.random.default_rng(seed)
    toks = np.concatenate([np.full(T2W_LOOKAHEAD, SILENCE_TOKEN),
                           rng.integers(0, 6561, T2W_MAIN)])
    want = Token2Wav.from_gguf(*files, device="cpu").feed_window(toks)

    def card(fault=None):
        t2w = Token2Wav.from_gguf(*files, device=dev)
        st = t2w.cfm_state
        if fault == "noise_on_card":
            st.noise = torch.randn(st.noise.shape, device=dev, generator=torch.Generator(
                device=dev).manual_seed(dit.NOISE_SEED))
        if fault == "noise_one_frame_off":
            st.noise = torch.roll(st.noise, -1, 0)
        if fault == "tf32":
            with tf32_dots():
                return t2w.feed_window(toks)
        return t2w.feed_window(toks)

    out = {k: float(np.abs(card(None if k == "sound" else k) - want).max())
           for k in ("sound", "noise_on_card", "noise_one_frame_off", "tf32")}
    return {**out, **wave_stats(want)}


def main() -> None:
    from .testing_synth import write_token2wav_ggufs, write_tts_gguf

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
    res = {"card": smi, "seeds": args.seeds, "tts": [], "t2w": []}
    for seed in args.seeds:
        with tempfile.TemporaryDirectory(prefix="spoken_limits_") as tmp:
            gen = torch.Generator(device=dev).manual_seed(seed)
            write_tts_gguf(f"{tmp}/tts.gguf", gen)
            paths = write_token2wav_ggufs(f"{tmp}/token2wav", gen)
            tts = tts_readings(f"{tmp}/tts.gguf", seed, dev)
            t2w = t2w_readings(paths, seed, dev)
        res["tts"].append(tts)
        res["t2w"].append(t2w)
        print(f"seed {seed} ({smi}): TTS teacher-forced gap of max|logit| "
              f"{json.dumps(tts)}; Token2Wav window max|diff| {json.dumps(t2w)}",
              flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
