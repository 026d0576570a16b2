"""The port's APM (omni_tpu_torch.models.whisper) and its audio reader
(omni_tpu_torch.omni.audio) against omni_tpu's on the JAX package's tiny
APM fixture (`write_tiny_apm`): the log-mel spectrogram, the loaders, and
`encode_chunk` over three consecutive one-second chunks, so the streaming
K/V cache and the positional offset are held, once inside the cache and
once with the third chunk clamped at its end."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import compilation_cache

from omni_tpu.core import GGUFReader as JaxReader
from omni_tpu.models import whisper as jw
from omni_tpu.omni import audio as jaudio
from omni_tpu.testing_gguf import write_tiny_apm
from omni_tpu_torch.core.gguf import GGUFReader
from omni_tpu_torch.models import whisper as tw
from omni_tpu_torch.omni import audio as taudio

# f32 throughout: XLA's and torch's f32 dots and convolutions sum in other
# orders, so the embeddings agree to a few ulp of their scale
EMB_RTOL = 1e-4  # of max|embedding|
MEL_ATOL = 1e-5  # the log-mel lies in about [-1, 2]


@pytest.fixture(scope="module", autouse=True)
def no_compile_cache():
    """Keep the JAX reference calls from writing compile-cache entries into
    the tracked omni_tpu/_warmcache/."""
    old = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", old)
    compilation_cache.reset_cache()


@pytest.fixture(scope="module", params=[300, 120], ids=["inside", "clamped"])
def apm(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_apm") / "apm.gguf"
    write_tiny_apm(path, n_audio_ctx=request.param, seed=3)
    jr, tr = JaxReader(path), GGUFReader(path)
    return (jw.WhisperConfig.from_gguf(jr.kv), jw.load_params(jr),
            jw.mel_filters_from_gguf(jr.kv), tw.WhisperConfig.from_gguf(tr.kv),
            tw.load_params(tr, device="cpu"), tw.mel_filters_from_gguf(tr.kv))


def _audio(seed, seconds=1.0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.3 * np.sin(2 * np.pi * 220 * t) +
            0.05 * rng.standard_normal(len(t))).astype(np.float32)


def test_config_and_params_as_jax(apm):
    jcfg, jp, jf, tcfg, tp, tf = apm
    assert dataclass_fields(jcfg) == dataclass_fields(tcfg)
    np.testing.assert_array_equal(jf, tf)
    assert len(tp["layers"]) == len(jp["layers"]) == jcfg.n_layers
    for name in ("conv1_w", "pos", "proj2_b"):
        np.testing.assert_array_equal(np.asarray(jp[name]), tp[name].numpy())
    np.testing.assert_array_equal(np.asarray(jp["layers"][1]["wk"]),
                                  tp["layers"][1]["wk"].numpy())


def dataclass_fields(c):
    import dataclasses

    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}


@pytest.mark.parametrize("seconds", [1.0, 0.37])
def test_log_mel_as_jax(apm, seconds, monkeypatch):
    """The numpy law of both packages (the JAX package's native library
    switched off, so its numpy path is the reference)."""
    monkeypatch.setenv("OMNI_NATIVE", "0")
    filters = apm[2]
    x = _audio(1, seconds)
    want = jaudio.log_mel_spectrogram(x, filters)
    got = taudio.log_mel_spectrogram(x, filters)
    assert got.shape == want.shape == (round(len(x) / 160), filters.shape[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_ATOL)
    np.testing.assert_array_equal(taudio.hann_window(), jaudio.hann_window())


@pytest.mark.parametrize("rate,width,ch", [(16000, 2, 1), (24000, 2, 2),
                                           (8000, 4, 1), (44100, 1, 1)])
def test_wav_round_trip_as_jax(tmp_path, monkeypatch, rate, width, ch):
    """The reader resamples to 16 kHz mono as the JAX package's numpy path
    does; the writer writes the same bytes."""
    import wave

    monkeypatch.setenv("OMNI_NATIVE", "0")
    rng = np.random.default_rng(rate)
    x = rng.uniform(-0.9, 0.9, (rate // 10, ch))
    scale = {1: 127, 2: 32767, 4: 2**31 - 1}[width]
    raw = np.round(x * scale).astype({1: np.int16, 2: np.int16, 4: np.int32}[width])
    if width == 1:
        raw = (raw + 128).astype(np.uint8)
    path = str(tmp_path / "in.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(ch)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(raw.tobytes())
    got = taudio.load_wav_mono_16k(path)
    np.testing.assert_array_equal(got, jaudio.load_wav_mono_16k(path))
    assert got.dtype == np.float32 and abs(len(got) - 1600) <= 1
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    taudio.write_wav(a, got * 1.5)
    jaudio.write_wav(b, got * 1.5)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_encode_three_chunks_as_jax(apm, monkeypatch):
    """Three consecutive 1 s chunks through each package's encoder, each
    with its own streaming state: every chunk's 10 rows agree, and so do
    the caches and the offset."""
    monkeypatch.setenv("OMNI_NATIVE", "0")
    jcfg, jp, filters, tcfg, tp, _ = apm
    js = jw.WhisperState.create(jcfg)
    ts = tw.WhisperState.create(tcfg, device="cpu")
    for i in range(3):
        mel = taudio.log_mel_spectrogram(_audio(10 + i), filters)
        want, js = jw.encode_chunk(jp, jcfg, jnp.asarray(mel), js)
        got, ts = tw.encode_chunk(tp, tcfg, torch.from_numpy(mel), ts)
        want = np.asarray(want)
        assert got.shape == want.shape == (10, jcfg.d_out)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=EMB_RTOL * scale)
        assert ts.n_cached == int(js.n_cached) == 50 * (i + 1)
    np.testing.assert_allclose(ts.k.numpy(), np.asarray(js.k), rtol=0,
                               atol=EMB_RTOL * np.abs(np.asarray(js.k)).max())


def same_tree(got, want, path=""):
    """The port's tree `got` from `from_jax_params` equals the port's own
    loader's `want`, tensor for tensor (dtype, shape, bits); keys the JAX
    tree holds as None and the port's does not carry are left out."""
    if isinstance(got, dict):
        got = {k: v for k, v in got.items() if v is not None or k in want}
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in got:
            same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            same_tree(a, b, f"{path}[{i}]")
    elif got is None:
        assert want is None, path
    else:
        assert (got.dtype, got.shape) == (want.dtype, want.shape), path
        assert torch.equal(got, want), path


def test_from_jax_params_as_loader(apm):
    """`convert.from_jax_params` carries the JAX APM tree across as the
    port's loader reads the file."""
    from omni_tpu_torch.convert import from_jax_params

    jp, tp = apm[1], apm[4]
    same_tree(from_jax_params(jax.tree_util.tree_map(np.asarray, jp), "cpu"), tp)
