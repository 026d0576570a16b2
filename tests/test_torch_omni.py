"""One spoken round of the port's pipeline (omni_tpu_torch.omni.pipeline,
driven by omni_tpu_torch.cli.omni_cli as `omni-cli --test`) against
omni_tpu's on the JAX package's tiny model directory
(`write_tiny_model_dir`: a 2-layer LLM with a byte vocabulary, the tiny
APM, TTS and Token2Wav): two wav rounds in (one at 22.05 kHz stereo,
resampled), a greedy reply of at most 8 tokens, its one TTS chunk to the
code cap, and every Token2Wav window.

Held: the LLM's text ids are the same; the APM's rows and the TTS
conditions agree within tolerance; the JAX pipeline's Token2Wav windows
(its codes, fed to a fresh port session on the same noise table) give the
same waves; both write the same round files. The TTS draws its codes from
each package's own generator, so the two rounds' codes differ: the cap
(SIMPLEX_AUDIO_CAP, 60 here in both pipelines instead of 500, since the
tiny head has no audio_eos) makes their counts equal. Images, duplex and a
saved duplex session are held in tests/test_torch_vision.py and
tests/test_torch_duplex.py."""

import argparse
import os
import time
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import compilation_cache

import omni_tpu.omni.pipeline as jpipeline
from omni_tpu.cli import omni_cli as jcli
from omni_tpu.models import tts as jtts
from omni_tpu.models.token2wav import dit as jdit
from omni_tpu.testing_gguf import write_tiny_model_dir
import omni_tpu_torch.omni.pipeline as tpipeline
from omni_tpu_torch.cli import omni_cli as tcli
from omni_tpu_torch.models import tts as ttts
from omni_tpu_torch.models.token2wav import Token2Wav
from omni_tpu_torch.models.token2wav import dit as tdit

AUDIO_CAP = 60
MAX_NEW = 8
ROWS_RTOL = 1e-4  # the APM's f32 rows, of max|row|
# the conditions read the LLM's hidden taps, bf16 in both packages, which
# XLA's fused steps round otherwise in the last bit now and then
COND_RTOL = 2e-2  # of max|condition|
WAVE_ATOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def jax_setup():
    """No compile-cache entries from the JAX calls; the JAX CFM reads the
    port's noise table (see tests/test_torch_token2wav.py); the code cap
    of both pipelines at AUDIO_CAP; one intra-op thread."""
    old = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    table = jnp.asarray(tdit.CFMState.create(
        tdit.DiTConfig(out_channels=16, max_t_cache=600), 5, "cpu").noise.numpy())

    def noise(c, t_len, start_frame, temperature):
        return (jax.lax.dynamic_slice(table, (start_frame, 0), (t_len, c))
                * temperature)[None]

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdit, "_noise", noise)
        mp.setattr(jpipeline, "SIMPLEX_AUDIO_CAP", AUDIO_CAP)
        mp.setattr(tpipeline, "SIMPLEX_AUDIO_CAP", AUDIO_CAP)
        jax.clear_caches()
        yield
    torch.set_num_threads(n_threads)
    jax.clear_caches()
    jax.config.update("jax_enable_compilation_cache", old)
    compilation_cache.reset_cache()


def _write_wav(path, x, rate, channels=1):
    pcm = (np.clip(np.repeat(x[:, None], channels, 1), -1, 1) * 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


ARGS = argparse.Namespace(ctx_size=512, temp=0.0, no_audio=False, no_tts=False,
                          omni=False, duplex=False, max_slice_nums=9)


def _recorder(log, key, real):
    def rec(*a, **kw):
        out = real(*a, **kw)
        log.setdefault(key, []).append((a, kw, out))
        return out
    return rec


def _jax_round(llm, prefix, out_dir):
    """The JAX pipeline's round, writing its own round files (output_dir),
    waited for until its generation_done.flag is written and it is idle."""
    from omni_tpu.omni.audio import load_wav_mono_16k

    pipe = jcli.build_pipeline(jcli.resolve_model_paths(llm), ARGS)
    pipe.cfg.output_dir = out_dir
    pipe.cfg.fused_decode = False
    log = {}
    pipe.audio_encoder = _recorder(log, "rows", pipe.audio_encoder)
    pipe._tts_generate = _recorder(log, "tts", pipe._tts_generate)
    pipe.t2w.feed_window = _recorder(log, "t2w", pipe.t2w.feed_window)
    text = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtts, "build_condition", _recorder(log, "cond", jtts.build_condition))
        # the decode loop op by op (the host loop, one decode a token):
        # XLA's jitted steps round a bf16 logit otherwise than op by op now
        # and then, and this tiny model meets a near tie within its 8 greedy
        # tokens; everything else runs jitted
        loop = pipe._decode_loop_host

        def op_by_op(*a):
            with jax.disable_jit():
                return loop(*a)

        pipe._decode_loop_host = op_by_op
        try:
            pipe.stream_prefill(index=0, system_prompt="You are a helpful assistant.",
                                ref_audio=np.zeros(16000, np.float32))
            for i in (1, 2):
                pipe.stream_prefill(audio=load_wav_mono_16k(f"{prefix}{i}.wav"), index=i)
            pipe.stream_decode(round_idx=0, max_new_tokens=MAX_NEW)
            while True:
                ev = pipe.text_out.get(timeout=120)
                text.append(ev.get("content", ""))
                if ev.get("stop"):
                    break
            flag = os.path.join(out_dir, "round_000", "generation_done.flag")
            t_end = time.monotonic() + 600
            while not os.path.exists(flag) or pipe.busy():
                assert time.monotonic() < t_end and pipe.last_error is None
                time.sleep(0.01)
        finally:
            pipe.shutdown()
    return log, "".join(text)


def _port_round(llm, prefix, out_dir):
    """The port's round through omni-cli's `run_test_cases`, the pipeline
    writing its own round files too (output_dir, beside omni-cli's)."""
    pipe = tcli.build_pipeline(tcli.resolve_model_paths(llm), ARGS, device="cpu")
    pipe.cfg.output_dir = out_dir + "_pipeline"
    log = {}
    pipe.audio_encoder = _recorder(log, "rows", pipe.audio_encoder)
    pipe._tts_generate = _recorder(log, "tts", pipe._tts_generate)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttts, "build_condition", _recorder(log, "cond", ttts.build_condition))
        try:
            res = tcli.run_test_cases(pipe, prefix, 2, out_dir, MAX_NEW)
        finally:
            pipe.shutdown()
    return log, res


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_omni")
    llm = write_tiny_model_dir(base / "model")
    t = np.arange(16000) / 16000
    _write_wav(str(base / "case_1.wav"), 0.3 * np.sin(2 * np.pi * 300 * t), 16000)
    t2 = np.arange(22050) / 22050
    _write_wav(str(base / "case_2.wav"), 0.2 * np.sin(2 * np.pi * 180 * t2), 22050, 2)
    prefix = str(base / "case_")
    return {"jax": _jax_round(llm, prefix, str(base / "jax_out")),
            "port": _port_round(llm, prefix, str(base / "port_out")),
            "llm": llm, "base": base}


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def test_text_ids_as_jax(rounds):
    (jlog, jtext), (tlog, res) = rounds["jax"], rounds["port"]
    jids = [a[0].token_ids for a, _, _ in jlog["tts"]]
    tids = [a[0].token_ids for a, _, _ in tlog["tts"]]
    assert tids == jids and len(tids) == 1 and tids[0]
    assert res["text"] == jtext != ""


def test_audio_rows_as_jax(rounds):
    """Three encoder calls each (the reference voice, two rounds), in order:
    the same rows, the streaming state carried across them."""
    jrows = [np.asarray(o) for _, _, o in rounds["jax"][0]["rows"]]
    trows = [o.numpy() for _, _, o in rounds["port"][0]["rows"]]
    assert [r.shape for r in trows] == [r.shape for r in jrows] == [(10, 64)] * 3
    for got, want in zip(trows, jrows):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=ROWS_RTOL * np.abs(want).max())


def test_tts_conditions_as_jax(rounds):
    """The one chunk's condition: the speaker embedding from the reference
    voice's hidden states, the text tokens with their hidden taps, text_eos
    and audio_bos."""
    (jc,), (tc,) = rounds["jax"][0]["cond"], rounds["port"][0]["cond"]
    want, got = np.asarray(jc[2]), tc[2].numpy()
    n_text = len(rounds["port"][0]["tts"][0][0][0].token_ids)
    assert got.shape == want.shape == (1 + n_text + 2, 32)  # spk, text, eos, bos
    np.testing.assert_allclose(got, want, rtol=0, atol=COND_RTOL * np.abs(want).max())


def test_wav_from_jax_windows(rounds):
    """The JAX round's Token2Wav windows (codes and final flags) into a
    fresh port session from the same files: the same waves; and each
    package's round has AUDIO_CAP codes in the same windows."""
    jwin = rounds["jax"][0]["t2w"]
    assert len(jwin) == 3 and [kw.get("is_final", False) for _, kw, _ in jwin] == \
        [False, False, True]
    paths = tcli.resolve_model_paths(rounds["llm"])
    t2w = Token2Wav.from_gguf(paths["t2w_encoder"], paths["t2w_flow"],
                              paths["t2w_extra"], paths["t2w_vocoder"],
                              paths["t2w_prompt"], device="cpu")
    for a, kw, want in jwin:
        got = t2w.feed_window(np.asarray(a[0]), **kw)
        np.testing.assert_allclose(got, want, rtol=0, atol=WAVE_ATOL)
    tcodes = rounds["port"][0]["tts"][0][2]
    assert len(tcodes) == AUDIO_CAP == sum(
        len(c) for _, _, c in rounds["jax"][0]["tts"])
    waves = rounds["port"][1]["waves"]
    assert [len(w) for w in waves] == [len(w) for _, _, w in jwin]
    assert all(np.isfinite(w).all() and np.abs(w).max() <= 0.99 for w in waves)


def test_round_files_as_jax(rounds):
    """omni-cli's files and the pipeline's own (output_dir) as the JAX
    pipeline's, and omni-cli's waves the pipeline's bytes."""
    base = rounds["base"]
    want = _files(base / "jax_out")
    assert want == ["round_000/generation_done.flag"] + [
        f"round_000/tts_wav/wav_{i}.wav" for i in range(3)]
    assert _files(base / "port_out") == _files(base / "port_out_pipeline") == want
    for f in want[1:]:
        assert (open(base / "port_out" / f, "rb").read()
                == open(base / "port_out_pipeline" / f, "rb").read())


def test_second_scan_waits_for_first_window(rounds, tmp_path, monkeypatch):
    """The first chunk's second TTS scan is issued only after Token2Wav has
    rendered the turn's first window (`_hold_for_token2wav`); an idle
    pipeline does not hold, and a stopped turn ends the hold."""
    pipe = tcli.build_pipeline(tcli.resolve_model_paths(rounds["llm"]), ARGS,
                               device="cpu")
    order = []
    scan, feed = ttts.tts_decode_scan, pipe.t2w.feed_window

    def logged_scan(*a, **kw):
        order.append("scan")
        return scan(*a, **kw)

    def logged_feed(*a, **kw):
        out = feed(*a, **kw)
        order.append("window")
        return out

    monkeypatch.setattr(ttts, "tts_decode_scan", logged_scan)
    pipe.t2w.feed_window = logged_feed
    try:
        tcli.run_test_cases(pipe, str(rounds["base"] / "case_"), 1,
                            str(tmp_path / "out"), MAX_NEW)
        assert order[:3] == ["scan", "window", "scan"]
        assert order.count("scan") == 3 and order.count("window") == 3
        assert pipe._hold_for_token2wav()
        pipe.stop_speak()
        assert not pipe._hold_for_token2wav()
    finally:
        pipe.shutdown()
