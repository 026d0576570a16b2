"""The port's Token2Wav (omni_tpu_torch.models.token2wav) against omni_tpu's
on the JAX package's tiny fixture (`write_tiny_token2wav`: a d 32
conformer of 2 + 1 blocks, a depth-2 DiT at 16 mel channels, a tiny
HiFiGAN2, a prompt cache of 30 tokens): the loaders, the conformer over
consecutive chunks (the last one final), one CFM chunk, the vocoder with
and without a cached source, and three consecutive `feed_window` calls
after the prompt's priming, the last one final, so the caches, the roll
of full histories and the crossfade are held.

The CFM's noise is position-keyed in both packages but drawn otherwise
(threefry in JAX, a seeded torch.Generator table here): the JAX solver is
fed the port's table through `monkeypatch` on `ditm._noise`, its jit
caches cleared around it, which changes nothing on disk."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import compilation_cache

from omni_tpu.models import token2wav as jt2w
from omni_tpu.models.token2wav import conformer as jconf
from omni_tpu.models.token2wav import dit as jdit
from omni_tpu.models.token2wav import hifigan as jhg
from omni_tpu.testing_gguf import write_tiny_token2wav
from omni_tpu_torch.models import token2wav as tt2w
from omni_tpu_torch.models.token2wav import conformer as tconf
from omni_tpu_torch.models.token2wav import dit as tdit
from omni_tpu_torch.models.token2wav import hifigan as thg
from test_torch_whisper import same_tree

# f32 end to end but the DiT's bf16 K/V caches, which both packages round
# alike; XLA and torch sum their f32 dots in other orders
FEAT_RTOL = 1e-4  # conformer features and mel, of max|x|
WAVE_ATOL = 2e-4  # waves lie within +-0.99


@pytest.fixture(scope="module", autouse=True)
def jax_on_port_noise():
    """No compile-cache entries from the JAX calls, and the JAX solver's
    x0 read from the port's noise table (row = frame)."""
    old = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    table = jnp.asarray(tdit.CFMState.create(
        tdit.DiTConfig(out_channels=16, max_t_cache=600), 5, "cpu").noise.numpy())

    def noise(c, t_len, start_frame, temperature):
        return (jax.lax.dynamic_slice(table, (start_frame, 0), (t_len, c))
                * temperature)[None]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdit, "_noise", noise)
        jax.clear_caches()
        yield
    jax.clear_caches()
    jax.config.update("jax_enable_compilation_cache", old)
    compilation_cache.reset_cache()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_tiny_token2wav(tmp_path_factory.mktemp("torch_t2w"), seed=4)


def _both(files, prompt=True):
    """(JAX session, port session) from the same files."""
    args = [files[k] for k in ("t2w_encoder", "t2w_flow", "t2w_extra", "t2w_vocoder")]
    pc = files["t2w_prompt"] if prompt else None
    return (jt2w.Token2Wav.from_gguf(*args, pc),
            tt2w.Token2Wav.from_gguf(*args, pc, device="cpu"))


def _close(got, want, rtol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(),
                               err_msg=what)


def test_loaders_as_jax(files):
    j, t = _both(files, prompt=False)
    assert dataclasses.asdict(t.enc_cfg) == dataclasses.asdict(j.enc_cfg)
    assert dataclasses.asdict(t.dit_cfg) == dataclasses.asdict(j.dit_cfg)
    np.testing.assert_array_equal(t.enc_p["encoders"][1]["pos_w"].numpy(),
                                  np.asarray(j.enc_p["encoders"][1]["pos_w"]))
    np.testing.assert_array_equal(t.dit_p["blocks"][1]["conv2_w"].numpy(),
                                  np.asarray(j.dit_p["blocks"][1]["conv2_w"]))
    for key in ("rb4_c1", "rbs2_c2"):
        for (tw, tb), (jw, jb) in zip(t.voc_p[key], j.voc_p[key]):
            np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(t.spk80.numpy(), np.asarray(j.spk80))


def test_from_jax_params_as_loaders(files):
    """`convert.from_jax_params` carries the JAX conformer, DiT, flow
    extras and HiFiGAN trees across as the port's loaders read the files."""
    from omni_tpu_torch.convert import from_jax_params

    j, t = _both(files, prompt=False)
    for jp, tp in ((j.enc_p, t.enc_p), (j.dit_p, t.dit_p), (j.extra, t.extra),
                   (j.voc_p, t.voc_p)):
        same_tree(from_jax_params(jax.tree_util.tree_map(np.asarray, jp), "cpu"), tp)


def test_conformer_chunks_as_jax(files, max_tokens=40):
    """Three 28-token chunks, the last final: each chunk's features agree,
    and so do the histories and the tails; at max_tokens 40 the first two
    chunks fit the history and the third is written clamped at its end."""
    j, t = _both(files, prompt=False)
    jcfg = dataclasses.replace(j.enc_cfg, max_tokens=max_tokens)
    tcfg = dataclasses.replace(t.enc_cfg, max_tokens=max_tokens)
    js, ts = jconf.ConformerState.create(jcfg), tconf.ConformerState.create(tcfg, "cpu")
    rng = np.random.default_rng(0)
    for i in range(3):
        toks = rng.integers(0, 5000, tt2w.DT)
        last = i == 2
        jx, js = jconf.encode_chunk(j.enc_p, jcfg, j.extra["input_embedding"][toks],
                                    js, last_chunk=last)
        tx, ts = tconf.encode_chunk(t.enc_p, tcfg, t.extra["input_embedding"][
            torch.from_numpy(toks)], ts, last_chunk=last)
        _close(tx, jx, FEAT_RTOL, f"chunk {i}")
        assert (ts.n1, ts.n2) == (int(js.n1), int(js.n2))
    _close(ts.k1, js.k1, FEAT_RTOL, "k1")
    _close(ts.v2, js.v2, FEAT_RTOL, "v2")
    _close(ts.up_tail, js.up_tail, FEAT_RTOL, "up tail")


def test_cfm_chunks_as_jax(files, max_t_cache=64):
    """Two CFM chunks (5 steps, guidance 0.7) on the port's noise: the mel
    and the caches agree; at max_t_cache 64 the first chunk fits the
    caches and the second rolls them."""
    j, t = _both(files, prompt=False)
    jcfg = dataclasses.replace(j.dit_cfg, max_t_cache=max_t_cache)
    tcfg = dataclasses.replace(t.dit_cfg, max_t_cache=max_t_cache)
    js, ts = jdit.CFMState.create(jcfg, 5), tdit.CFMState.create(tcfg, 5, "cpu")
    rng = np.random.default_rng(1)
    for i in range(2):
        mu = rng.standard_normal((50, 16)).astype(np.float32)
        jm, js = jdit.cfm_solve_chunk(j.dit_p, jcfg, jnp.asarray(mu), j.spk80, js, 5, 1.0)
        tm, ts = tdit.cfm_solve_chunk(t.dit_p, tcfg, torch.from_numpy(mu), t.spk80, ts,
                                      5, 1.0)
        _close(tm, jm, FEAT_RTOL, f"chunk {i}")
        assert ts.n == int(js.n)
    # bf16 caches: a value within FEAT_RTOL may round to the next bf16
    for got, want in ((ts.k, js.k), (ts.conv2, js.conv2)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=2 ** -7, atol=FEAT_RTOL)


def test_vocoder_as_jax(files, cached=True):
    """The vocoder over 58 mel frames (the 8 cached and 50 new) with the
    previous window's 3,840 source samples (a window without them is held
    by the feed test's first window): the wave, the source and the STFT
    and its inverse agree."""
    j, t = _both(files, prompt=False)
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((58, 16)).astype(np.float32)
    src = (rng.uniform(-0.5, 0.5, thg.SOURCE_CACHE).astype(np.float32)
           if cached else None)
    jw, js = jhg.vocode(j.voc_p, jnp.asarray(mel),
                        None if src is None else jnp.asarray(src))
    tw, ts = thg.vocode(t.voc_p, torch.from_numpy(mel),
                        None if src is None else torch.from_numpy(src))
    assert tw.shape == (58 * 480,)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=WAVE_ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=WAVE_ATOL)
    r, i = thg.stft16(ts)
    jr, ji = jhg.stft16(js)
    _close(r, jr, FEAT_RTOL, "stft real")
    _close(thg.istft16(r, i), jhg.istft16(jr, ji), FEAT_RTOL, "istft")


def test_feed_three_windows_as_jax(files):
    """The prompt's 30 tokens primed (replayed), then three windows of 28
    codes, the last one final and 19 codes long: every wave agrees, with
    its crossfade, and the caches and tails after each (full histories,
    clamped or rolled, are held by the conformer and CFM tests above)."""
    j, t = _both(files)
    assert t.enc_state.n1 == int(j.enc_state.n1) > 0
    assert t.cfm_state.n == int(j.cfm_state.n) > 0
    rng = np.random.default_rng(3)
    for i, n in enumerate((28, 28, 19)):
        toks = rng.integers(0, 5000, n)
        final = i == 2
        jw = j.feed_window(toks, is_final=final)
        tw = t.feed_window(toks, is_final=final)
        assert tw.shape == jw.shape
        np.testing.assert_allclose(tw, jw, rtol=0, atol=WAVE_ATOL, err_msg=f"window {i}")
        _close(t.mel_cache, j.mel_cache, FEAT_RTOL, f"mel cache {i}")
        np.testing.assert_allclose(t.speech_cache, j.speech_cache, rtol=0, atol=WAVE_ATOL)
        assert t.cfm_state.n == int(j.cfm_state.n)
    assert len(tw) == (8 + 19 * 2) * 480


def test_fade_and_windowing_as_jax(files):
    x = np.linspace(-1, 1, 5000, dtype=np.float32)
    tail = np.cos(np.arange(3840, dtype=np.float32))
    np.testing.assert_array_equal(tt2w._fade_in_out(x, tail), jt2w._fade_in_out(x, tail))
    with pytest.raises(ValueError):
        _both(files, prompt=False)[1].feed_window(np.zeros(29, np.int64))


def test_packed_prompt_cache_as_jax(files, tmp_path):
    """A prompt_cache.gguf with the packed cache tensors (the JAX session's
    own export after priming by replay) imported by both packages: the
    same states, and the same first window."""
    j, _ = _both(files)
    path = str(tmp_path / "packed-prompt_cache.gguf")
    j.export_prompt_cache(path)
    args = [files[k] for k in ("t2w_encoder", "t2w_flow", "t2w_extra", "t2w_vocoder")]
    j = jt2w.Token2Wav.from_gguf(*args, path)
    t = tt2w.Token2Wav.from_gguf(*args, path, device="cpu")
    assert (t.enc_state.n1, t.enc_state.n2, t.cfm_state.n) == (
        int(j.enc_state.n1), int(j.enc_state.n2), int(j.cfm_state.n))
    np.testing.assert_array_equal(t.enc_state.k2.numpy(), np.asarray(j.enc_state.k2))
    np.testing.assert_array_equal(t.cfm_state.v.float().numpy(),
                                  np.asarray(j.cfm_state.v, np.float32))
    np.testing.assert_array_equal(t.spk80.numpy(), np.asarray(j.spk80))
    toks = np.random.default_rng(5).integers(0, 5000, 28)
    np.testing.assert_allclose(t.feed_window(toks), j.feed_window(toks), rtol=0,
                               atol=WAVE_ATOL)
