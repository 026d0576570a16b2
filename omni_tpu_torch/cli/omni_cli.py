"""omni-cli, the omni pipeline's command line (counterpart of
omni_tpu/cli/omni_cli.py and of the reference's tools/omni/omni-cli.cpp):
the module GGUFs are found beside the LLM's ({dir}/{LLM}.gguf,
{dir}/audio/*audio*.gguf, {dir}/vision/*vision*.gguf, {dir}/tts/*tts*.gguf
and the Token2Wav files under {dir}/token2wav/), and `--test PREFIX N`
runs the test-case runner: N rounds ({PREFIX}1.wav, with --omni also
{PREFIX}1.jpg, ...) prefilled, one response, its text printed and its
waves written to {output}/round_000/tts_wav/wav_N.wav with a
generation_done.flag.

    python -m omni_tpu_torch.cli.omni_cli -m DIR/llm.gguf --test PREFIX N \
        [--omni [--max-slice-nums 9]] [--duplex]

`--omni` loads the VPM (images sliced LLaVA-UHD style, `omni/image.py`),
`--duplex` runs a duplex session (<unit>s, <|speak|>/<|listen|>, the
26-token cap and the unit window). Runs on the card, with TF32 off for the
f32 modules; `--device cpu` runs the plain CPU path.
"""

from __future__ import annotations

import argparse
import glob
import os
import queue
import sys
import time


def resolve_model_paths(llm_path: str) -> dict:
    """The module files of the model directory that holds `llm_path`."""
    base = os.path.dirname(os.path.abspath(llm_path))

    def find(sub, pat):
        hits = sorted(glob.glob(os.path.join(base, sub, pat)))
        return hits[0] if hits else None

    return {
        "llm": llm_path,
        "audio": find("audio", "*audio*.gguf"),
        "vision": find("vision", "*vision*.gguf"),
        "tts": find("tts", "*tts*.gguf"),
        "projector": find("tts", "*projector*.gguf"),
        "t2w_encoder": find("token2wav", "*encoder*.gguf"),
        "t2w_flow": find("token2wav", "*flow_matching*.gguf"),
        "t2w_extra": find("token2wav", "*flow_extra*.gguf"),
        "t2w_vocoder": find("token2wav", "*hifigan*.gguf"),
        "t2w_prompt": find("token2wav", "*prompt_cache*.gguf"),
    }


def make_audio_encoder(path: str, device=None):
    """The APM file -> a callable wav [n] f32 at 16 kHz -> LLM rows
    [n / 1600, d] on the device, with its streaming state."""
    import torch

    from ..core.gguf import GGUFReader
    from ..models import whisper
    from ..omni import audio as audio_pre

    reader = GGUFReader(path)
    cfg = whisper.WhisperConfig.from_gguf(reader.kv)
    params = whisper.load_params(reader, device=device)
    filters = whisper.mel_filters_from_gguf(reader.kv)
    state = whisper.WhisperState.create(cfg, device=device)
    dev = params["pos"].device

    def audio_encoder(wav):
        mel = torch.from_numpy(audio_pre.log_mel_spectrogram(wav, filters))
        emb, _ = whisper.encode_chunk(params, cfg, mel.to(dev), state)
        return emb

    audio_encoder.cfg, audio_encoder.params = cfg, params
    audio_encoder.filters, audio_encoder.state = filters, state
    return audio_encoder


def make_vision_encoder(path: str, max_slice_nums: int = 9, device=None):
    """The VPM file -> a callable uint8 [H, W, 3] image (and an optional
    `max_slice_nums`, -1 or None: `max_slice_nums` here) -> a list of LLM
    rows [64, d] on the device, the overview then each slice, normalized
    with the file's image mean and std."""
    from ..core.gguf import GGUFReader
    from ..models import siglip
    from ..omni import image as image_pre

    reader = GGUFReader(path)
    cfg = siglip.SigLipConfig.from_gguf(reader.kv)
    params = siglip.load_params(reader, device=device)
    mean = list(reader.kv.get("clip.vision.image_mean", [0.5] * 3))
    std = list(reader.kv.get("clip.vision.image_std", [0.5] * 3))
    reader.close()
    default_msn = max_slice_nums

    def vision_encoder(img, max_slice_nums=None):
        msn = default_msn if max_slice_nums is None or max_slice_nums < 0 \
            else max_slice_nums
        parts = image_pre.preprocess_uhd(img, mean, std, max_slice_nums=msn)
        return [siglip.encode_image_np(params, cfg, p) for p in parts]

    vision_encoder.cfg, vision_encoder.params = cfg, params
    vision_encoder.mean, vision_encoder.std = mean, std
    return vision_encoder


def build_pipeline(paths: dict, args, device=None, llm=None, tokenizer=None,
                   modules=None):
    """The LLM, the APM, the VPM (with --omni), the TTS and Token2Wav from
    `paths` into an OmniPipeline (duplex with --duplex; TTS on where its
    files are found). An LLM `Context` already loaded may be passed with
    its tokenizer instead of paths["llm"], and a pipeline already built
    as `modules`, whose APM, TTS and Token2Wav are taken over instead of
    loaded again."""
    from ..core.gguf import GGUFReader
    from ..models import qwen3
    from ..omni.pipeline import OmniPipeline, SessionConfig
    from ..runtime import Context, SamplerParams
    from ..tokenizer import build_tokenizer

    tok = tokenizer
    if llm is None:
        print(f"loading LLM: {paths['llm']}")
        reader = GGUFReader(paths["llm"])
        cfg = qwen3.Qwen3Config.from_gguf(reader.kv)
        llm = Context(cfg, qwen3.load_params(reader, device=device), qwen3.forward,
                      qwen3.embed, n_ctx=args.ctx_size, device=device,
                      sampler=SamplerParams(temp=args.temp, greedy=args.temp <= 0))
        tok = build_tokenizer(reader.kv)
        reader.close()

    omni = getattr(args, "omni", False)
    vision_encoder = None
    if paths.get("vision") and omni:
        print(f"loading VPM: {paths['vision']}")
        vision_encoder = make_vision_encoder(
            paths["vision"], getattr(args, "max_slice_nums", 9), device)
    config = SessionConfig(duplex=getattr(args, "duplex", False),
                           media_type=2 if omni else 1)
    if modules is not None:
        config.use_tts = modules.tts_ctx is not None
        return OmniPipeline(llm, tok, config, tts_ctx=modules.tts_ctx,
                            tts_extras=modules.tts_extras, token2wav=modules.t2w,
                            audio_encoder=modules.audio_encoder,
                            vision_encoder=vision_encoder)

    audio_encoder = None
    if paths.get("audio") and not args.no_audio:
        print(f"loading APM: {paths['audio']}")
        audio_encoder = make_audio_encoder(paths["audio"], device)

    tts_ctx = tts_extras = t2w = None
    if paths.get("tts") and not args.no_tts and paths.get("t2w_encoder"):
        from ..models import tts as tts_mod
        from ..models.token2wav import Token2Wav

        print(f"loading TTS: {paths['tts']}")
        treader = GGUFReader(paths["tts"])
        tparams, tts_extras = tts_mod.load_params(treader, device=device)
        tts_ctx = Context(tts_mod.config_from_gguf(treader.kv), tparams,
                          qwen3.forward, qwen3.embed, n_ctx=args.ctx_size,
                          device=device)
        print("loading Token2Wav GGUFs")
        t2w = Token2Wav.from_gguf(paths["t2w_encoder"], paths["t2w_flow"],
                                  paths["t2w_extra"], paths["t2w_vocoder"],
                                  paths.get("t2w_prompt"), device=device)
    config.use_tts = tts_ctx is not None
    return OmniPipeline(llm, tok, config, tts_ctx=tts_ctx, tts_extras=tts_extras,
                        token2wav=t2w, audio_encoder=audio_encoder,
                        vision_encoder=vision_encoder)


def run_test_cases(pipe, prefix: str, n_rounds: int, out_dir: str,
                   max_new_tokens: int | None = None) -> dict:
    """The test-case runner (omni-cli.cpp:158-196): session init with a
    second of silence as the reference voice, rounds {prefix}1 ..
    {prefix}N prefilled (each its .wav and, where the pipeline has the
    VPM, its .jpg; a round needs one of them), one response; its text
    printed and its waves written to {out_dir}/round_000/tts_wav/wav_N.wav,
    then generation_done.flag. WAV files are read as 16 kHz mono
    (`load_wav_mono_16k`, which resamples). Returns {"text", "waves",
    "seconds"}."""
    import numpy as np

    from ..omni.audio import load_wav_mono_16k, write_wav
    from ..omni.image import load_image

    pipe.stream_prefill(index=0, system_prompt="You are a helpful assistant.",
                        ref_audio=np.zeros(16000, np.float32))
    for i in range(1, n_rounds + 1):
        wav_path, jpg_path = f"{prefix}{i}.wav", f"{prefix}{i}.jpg"
        audio = load_wav_mono_16k(wav_path) if os.path.exists(wav_path) else None
        image = (load_image(jpg_path) if os.path.exists(jpg_path)
                 and pipe.vision_encoder is not None else None)
        if audio is None and image is None:
            raise FileNotFoundError(wav_path)
        print(f"[round {i}] prefill audio={'y' if audio is not None else 'n'} "
              f"image={'y' if image is not None else 'n'}")
        pipe.stream_prefill(audio=audio, image=image, index=i)

    round_dir = os.path.join(out_dir, "round_000", "tts_wav")
    os.makedirs(round_dir, exist_ok=True)
    t0 = time.time()
    pipe.stream_decode(round_idx=0, max_new_tokens=max_new_tokens)
    text = []
    while True:
        ev = pipe.text_out.get()
        if ev.get("content"):
            print(ev["content"], end="", flush=True)
            text.append(ev["content"])
        if ev.get("stop"):
            break
    pipe.wait_idle()
    waves = []
    while True:
        try:
            waves.append(pipe.wav_out.get_nowait())
        except queue.Empty:
            break
    for i, wave in enumerate(waves):
        write_wav(os.path.join(round_dir, f"wav_{i}.wav"), wave)
    open(os.path.join(out_dir, "round_000", "generation_done.flag"), "w").close()
    seconds = time.time() - t0
    print(f"\n[done] {len(''.join(text))} chars, {len(waves)} wav chunks, "
          f"{seconds:.1f}s -> {round_dir}")
    return {"text": "".join(text), "waves": waves, "seconds": seconds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("omni-cli")
    ap.add_argument("-m", "--model", required=True, help="LLM GGUF path")
    ap.add_argument("--test", nargs=2, metavar=("PREFIX", "N"), required=True,
                    help="test cases: wav prefix and round count")
    ap.add_argument("--omni", action="store_true", help="vision: load the VPM")
    ap.add_argument("--duplex", action="store_true", help="a duplex session")
    ap.add_argument("--max-slice-nums", type=int, default=9)
    ap.add_argument("--no-tts", action="store_true")
    ap.add_argument("--no-audio", action="store_true")
    ap.add_argument("-c", "--ctx-size", type=int, default=4096)
    ap.add_argument("--temp", type=float, default=0.7)
    ap.add_argument("-n", "--max-new-tokens", type=int, default=None)
    ap.add_argument("-o", "--output-dir", default="./omni_out")
    ap.add_argument("--device", default=None, help="cpu for the plain path")
    args = ap.parse_args(argv)
    # the f32 modules (APM, VPM, Token2Wav) hold the f32 law: no TF32 in
    # their products nor in cuDNN's convolutions, whose default is TF32
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe = build_pipeline(resolve_model_paths(args.model), args, args.device)
    try:
        run_test_cases(pipe, args.test[0], int(args.test[1]), args.output_dir,
                       args.max_new_tokens)
    finally:
        pipe.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
