"""Duplex and vision sessions of the port's OmniPipeline against omni_tpu's,
both built by their omni-cli's `build_pipeline` (--omni) on the JAX
package's tiny model directory (`write_tiny_model_dir`: a 2-layer LLM with
a byte vocabulary, the tiny APM and VPM): session init with a second of
silence as the voice, then three chunks (audio and a 600 x 400 image,
three parts; five 300 x 200 frames under high_refresh, the main frame and
a 2 x 2 stack; audio alone), one turn to the 26-token cap and past it, a
fourth chunk, a second turn whose end drops units (`_enforce_unit_window`).
Variants: duplex on the fused loop, duplex on the host loop, simplex with
vision on the fused loop.

Held: the fed sequence of marker tokens and rows (spied at `llm.decode`)
and the rows themselves; the sampled tokens (the port teacher-forced with
omni_tpu's draws, its own argmax held to JIT_LOGITS_ATOL where it differs,
as tests/test_torch_session.py does); the forced <|chunk_eos|></unit> at
the cap, the sample that breached it never fed; the unit registry, rounds,
n_past and every cell's position and owner after each turn; a saved
duplex session loading both ways; the duplex TTS chunk's codes (cap 26, no
audio_eos) on omni_tpu's Gumbel noise against its pipeline run op by op."""

import argparse
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from jax._src import compilation_cache

import omni_tpu.omni.pipeline as jpipeline
import omni_tpu.runtime.loop as jloop
import omni_tpu_torch.models.tts as ttts
import omni_tpu_torch.omni.pipeline as tpipeline
import omni_tpu_torch.runtime.context as tcontext
import omni_tpu_torch.runtime.loop as tloop
from omni_tpu.cli import omni_cli as jcli
from omni_tpu.testing_gguf import write_tiny_model_dir
from omni_tpu_torch.cli import omni_cli as tcli
from test_torch_model import JIT_LOGITS_ATOL
from test_torch_session import _books as _round_books
from test_torch_session import _drain
from test_torch_tts import _jax_gumbels

ROWS_RTOL = 1e-4  # the APM's and VPM's f32 rows, of max|row|
SYSTEM = "You are a helpful assistant."
TURNS = (60, 30)  # tokens the two turns may sample


def _args(**kw):
    return argparse.Namespace(**{**dict(
        ctx_size=512, temp=0.0, no_audio=False, no_tts=True, omni=True,
        duplex=True, max_slice_nums=9), **kw})


@pytest.fixture(scope="module", autouse=True)
def jax_setup():
    """No compile-cache entries from the JAX calls; one intra-op thread."""
    old = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)
    jax.config.update("jax_enable_compilation_cache", old)
    compilation_cache.reset_cache()


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return jcli.resolve_model_paths(
        write_tiny_model_dir(tmp_path_factory.mktemp("torch_duplex") / "model"))


def _inputs():
    rng = np.random.default_rng(5)
    t = np.arange(16000) / 16000
    audio = [(a * np.sin(2 * np.pi * f * t)).astype(np.float32)
             for a, f in ((0.3, 300), (0.2, 180), (0.25, 240))]
    image = rng.integers(0, 256, (400, 600, 3), dtype=np.uint8)
    frames = [rng.integers(0, 256, (200, 300, 3), dtype=np.uint8) for _ in range(5)]
    return audio, image, frames


def _spy(pipe, feeds, rows):
    """Every token and row block entering the LLM's KV through decode()."""
    real = pipe.llm.decode

    def spy(batch, **kw):
        if batch.tokens is not None:
            feeds.extend(("tok", int(t)) for t in np.asarray(batch.tokens))
        else:
            feeds.append(("emb", len(batch.embeds)))
            e = batch.embeds
            rows.append(e.float().cpu().numpy() if isinstance(e, torch.Tensor)
                        else np.asarray(e, np.float32))
        return real(batch, **kw)

    pipe.llm.decode = spy


def _books(pipe):
    """test_torch_session.py's books and the unit registry."""
    return {**_round_books(pipe),
            "units": [(u.start_pos, u.end_pos) for u in pipe.units]}


def _session(pipe, wait, duplex):
    """The script both packages run; returns the books after each turn and
    the prefill of each chunk, and the marks the window ran under."""
    audio, image, frames = _inputs()
    books = []
    pipe.stream_prefill(index=0, system_prompt=SYSTEM,
                        ref_audio=np.zeros(16000, np.float32))
    pipe.stream_prefill(audio=audio[0], image=image, index=1)
    pipe.cfg.high_refresh = True
    pipe.stream_prefill(frames=frames, index=2)
    pipe.stream_prefill(audio=audio[1], index=3)
    wait(pipe)
    pipe.stream_decode(round_idx=0, max_new_tokens=TURNS[0])
    events = [_drain(pipe)]
    books.append(_books(pipe))
    if duplex:  # the next turn's end goes past high_water: units drop
        n_past = pipe.llm.n_past[0]
        pipe.cfg.high_water, pipe.cfg.low_water = n_past, n_past - 1
    pipe.stream_prefill(audio=audio[2], index=4)
    wait(pipe)
    books.append(_books(pipe))
    pipe.stream_decode(round_idx=1, max_new_tokens=TURNS[1])
    events.append(_drain(pipe))
    books.append(_books(pipe))
    return books, events


def _jax_wait(pipe):
    assert pipe.prefill_done.wait(timeout=300) and pipe.last_error is None


def _port_wait(pipe):
    pipe._wait_prefill()


VARIANTS = {"duplex_fused": (True, True), "duplex_host": (True, False),
            "simplex_fused": (False, True)}


@pytest.fixture(scope="module")
def pipes(model):
    """One pipeline of each package for every variant (the JAX one keeps
    its compiled steps): each session starts from `clean_kvcache` and a
    fresh audio stream."""
    jpipe = jcli.build_pipeline(model, _args())
    tpipe = tcli.build_pipeline(model, _args(), device="cpu")
    yield jpipe, tpipe
    jpipe.shutdown()
    tpipe.shutdown()


def _fresh(pipe, duplex, fused, audio_state):
    pipe.clean_kvcache()
    for name, v in (("duplex", duplex), ("fused_decode", fused), ("high_refresh", False),
                    ("high_water", 4000), ("low_water", 3500)):
        setattr(pipe.cfg, name, v)
    audio_state(pipe.audio_encoder)


def _jax_audio_state(enc):
    """A fresh streaming state in omni_tpu's APM closure ({"s": state})."""
    from omni_tpu.models import whisper as jwhisper

    cells = [c.cell_contents for c in enc.__closure__]
    acfg = next(c for c in cells if isinstance(c, jwhisper.WhisperConfig))
    next(c for c in cells if isinstance(c, dict) and "s" in c)["s"] = \
        jwhisper.WhisperState.create(acfg)


def _port_audio_state(enc):
    enc.state.n_cached = 0


@pytest.fixture(scope="module", params=list(VARIANTS))
def sessions(request, pipes):
    duplex, fused = VARIANTS[request.param]
    jpipe, tpipe = pipes
    # omni_tpu's session, its draws recorded in order
    _fresh(jpipe, duplex, fused, _jax_audio_state)
    jfeeds, jrows, drawn = [], [], []
    _spy(jpipe, jfeeds, jrows)
    real_scan, sample_token = jloop.omni_decode_scan, jpipe.llm.sample_token

    def recording(*a, **kw):
        out = real_scan(*a, **kw)
        drawn.extend(np.asarray(out[0][0]).tolist())
        return out

    def recording_token(row):
        drawn.append(sample_token(row))
        return drawn[-1]

    jpipe.llm.sample_token = recording_token
    try:
        with mock.patch.object(jloop, "omni_decode_scan", recording):
            jbooks, jevents = _session(jpipe, _jax_wait, duplex)
    finally:
        del jpipe.llm.decode, jpipe.llm.sample_token

    # the port's, teacher-forced with those draws
    _fresh(tpipe, duplex, fused, _port_audio_state)
    tfeeds, trows, flips = [], [], []
    _spy(tpipe, tfeeds, trows)
    forced = list(drawn)

    def teacher(logits, *a, **kw):
        want = forced.pop(0)
        own = int(torch.argmax(logits))
        if own != want:
            flips.append(float(logits[own] - logits[want]))
        return torch.tensor(want)

    try:
        with mock.patch.object(tloop, "sample", teacher), \
                mock.patch.object(tcontext, "sample", teacher):
            tbooks, tevents = _session(tpipe, _port_wait, duplex)
    finally:
        del tpipe.llm.decode
    assert not forced, "the port drew fewer tokens than omni_tpu"
    return {"duplex": duplex, "fused": fused, "drawn": drawn, "flips": flips,
            "jax": (jpipe, jfeeds, jrows, jbooks, jevents),
            "port": (tpipe, tfeeds, trows, tbooks, tevents)}


def test_feeds_and_rows_as_jax(sessions):
    """The marker layout of every chunk and turn, token for token, and the
    audio and image rows between the markers."""
    _, jfeeds, jrows, _, _ = sessions["jax"]
    tpipe, tfeeds, trows, _, _ = sessions["port"]
    assert tfeeds == jfeeds
    sp = tpipe.special
    image_parts = [f for f in tfeeds if f == ("emb", 8)]
    assert len(image_parts) == 3 + 1 + 3  # image; main frame; the stack
    if sessions["duplex"]:
        i = tfeeds.index(("tok", sp["<unit>"]))
        assert tfeeds[i:i + 5] == [("tok", sp["<unit>"]), ("tok", sp["<image>"]),
                                   ("emb", 8), ("tok", sp["</image>"]),
                                   ("tok", sp["<slice>"])]
        assert ("tok", sp["<|audio_start|>"]) not in tfeeds[i:]
    else:
        assert ("tok", sp["<unit>"]) not in tfeeds
    assert len(trows) == len(jrows)
    for got, want in zip(trows, jrows):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=ROWS_RTOL * np.abs(want).max())


def test_tokens_as_jax(sessions):
    """Every draw of omni_tpu's session taken by the port, whose own argmax
    differs only at rounding flips; the same text and turn events."""
    print(f"forced steps where the port's own argmax differed: "
          f"{len(sessions['flips'])}, logit gaps {sessions['flips']}")
    assert all(0 <= g <= JIT_LOGITS_ATOL for g in sessions["flips"])
    assert sessions["port"][4] == sessions["jax"][4]


def test_cap_forces_chunk_end_as_jax(sessions):
    """Duplex: the first turn's segment is <|speak|>, 25 sampled tokens fed,
    the 26th replaced by <|chunk_eos|></unit>, which closes the open unit,
    and the next token fed is the 27th draw. Simplex: no cap."""
    tpipe, tfeeds, _, tbooks, _ = sessions["port"]
    sp = tpipe.special
    eos = ("tok", sp["<|chunk_eos|>"])
    if not sessions["duplex"]:
        assert eos not in tfeeds and not tbooks[0]["units"]
        return
    feeds = tfeeds[tfeeds.index(("tok", sp["<|speak|>"])):]
    i = feeds.index(eos)
    assert feeds[i + 1] == ("tok", sp["</unit>"])
    # the unit closed by the cap: <|speak|>, 25 tokens, <|chunk_eos|></unit>
    n_speak = tbooks[0]["units"][-1][1] - (1 + 25 + 2)
    assert ("tok", sp["<|speak|>"]) in tfeeds and n_speak > tbooks[0]["units"][-1][0]
    assert tbooks[0]["units"] == sessions["jax"][3][0]["units"]
    if not sessions["fused"]:  # the host loop feeds every token by decode()
        drawn = sessions["drawn"]
        assert i == 1 + 25 and [t for _, t in feeds[1:i]] == drawn[:25]
        assert feeds[i + 2] == ("tok", drawn[26])


def test_unit_window_as_jax(sessions):
    """After each turn the books equal omni_tpu's; in duplex the second
    turn's end dropped the oldest units (never the n_keep cells) and the
    rest is contiguous from 0 with its K re-rotated."""
    jpipe, _, _, jbooks, _ = sessions["jax"]
    tpipe, _, _, tbooks, _ = sessions["port"]
    for i, (t, j) in enumerate(zip(tbooks, jbooks)):
        assert t == j, i
    last = tbooks[-1]
    pos = sorted(p for p, m in zip(last["pos"], last["seq_mask"]) if m)
    assert pos == list(range(last["n_past"][0]))
    if sessions["duplex"]:
        assert len(last["units"]) < len(tbooks[1]["units"])
        assert last["n_past"][0] >= tpipe.n_keep > 0
        live = np.asarray(jpipe.llm.cache.seq_mask) != 0
        np.testing.assert_allclose(
            tpipe.llm.cache.k.float().numpy()[:, :, live],
            np.asarray(jpipe.llm.cache.k.astype(np.float32))[:, :, live],
            rtol=0, atol=JIT_LOGITS_ATOL)


def test_saved_duplex_session_loads_both_ways(sessions, model):
    """A session (duplex: with its units) saved by either package loads
    into the other's fresh pipeline (the units, the rounds, the config, every cell);
    then one more unit is prefilled alike on both."""
    jpipe, tpipe = sessions["jax"][0], sessions["port"][0]
    args = _args(no_audio=True, omni=False, duplex=False)
    t2 = tcli.build_pipeline(model, args, device="cpu")
    j2 = jcli.build_pipeline(model, args)
    try:
        t2.load_session_state_bytes(jpipe.session_state_bytes())
        j2.load_session_state_bytes(tpipe.session_state_bytes())
        assert _books(t2) == _books(jpipe) and _books(j2) == _books(tpipe)
        assert t2.cfg.duplex == j2.cfg.duplex == sessions["duplex"]
        assert bool(t2.units) == sessions["duplex"]
        np.testing.assert_array_equal(
            t2.llm.cache.k.view(torch.int16).numpy(),
            np.asarray(jpipe.llm.cache.k).view(np.int16))
        for p in (t2, j2):  # one more unit, after the load
            p._eval_text("<unit>")
            p._register_unit_start()
        assert _books(t2)["units"] == _books(j2)["units"]
    finally:
        t2.shutdown()
        j2.shutdown()


def test_end_tokens_as_jax(sessions):
    """The turn-ending tokens under the session's setting (a duplex turn
    does not end on <|tts_eos|>), on the host and in the fused classifier."""
    jpipe, tpipe = sessions["jax"][0], sessions["port"][0]
    assert tpipe._end_ids() == jpipe._end_ids()
    ids = sorted(tpipe.special.values())
    assert [tpipe.is_end_token(t) for t in ids] == [jpipe.is_end_token(t) for t in ids]
    assert tpipe.is_end_token(tpipe.special["<|tts_eos|>"]) != sessions["duplex"]


def test_image_parts_dispatch_as_jax(model):
    """The slice override reaches an encoder that takes it, decided by its
    signature (an error inside the encoder propagates); high_image forces
    2; an encoder returning one array is one part."""
    args = _args(no_audio=True, omni=False)
    jpipe, tpipe = jcli.build_pipeline(model, args), tcli.build_pipeline(
        model, args, device="cpu")
    for p in (jpipe, tpipe):
        seen = []

        def enc(img, max_slice_nums=None):
            seen.append(max_slice_nums)
            return np.zeros((4, 64), np.float32)

        def failing(img, max_slice_nums=None):
            raise TypeError("inside the encoder")

        p.vision_encoder = enc
        p.cfg.high_image = True
        assert len(p._encode_image_parts(np.zeros((8, 8, 3), np.uint8))) == 1
        p.cfg.high_image = False
        p._encode_image_parts(np.zeros((8, 8, 3), np.uint8), max_slice_nums=0)
        assert seen == [2, 0]
        p.vision_encoder = failing
        with pytest.raises(TypeError, match="inside"):
            p._encode_image_parts(np.zeros((8, 8, 3), np.uint8))
        p.shutdown()


def test_prefill_without_its_encoder_raises(model):
    """Audio or an image past index 0 with no encoder for it is refused
    (the JAX pipeline drops it silently)."""
    pipe = tcli.build_pipeline(model, _args(omni=False, no_audio=True), device="cpu")
    try:
        with pytest.raises(ValueError, match="vision encoder"):
            pipe.stream_prefill(image=np.zeros((8, 8, 3), np.uint8), index=1)
        with pytest.raises(ValueError, match="audio encoder"):
            pipe.stream_prefill(audio=np.zeros(1600, np.float32), index=1)
    finally:
        pipe.shutdown()


def test_duplex_tts_chunk_as_jax(model):
    """A duplex text chunk that is not the turn's last: DUPLEX_CHUNK_CAP
    codes (26), none of them audio_eos, in scans of 25 and 1; the port on
    omni_tpu's Gumbel noise (its pipeline key split per scan, then per
    step) gives the JAX pipeline's codes, run op by op."""
    args = _args(no_tts=False, no_audio=True, omni=False)
    jpipe = jcli.build_pipeline(model, args)
    tpipe = tcli.build_pipeline(model, args, device="cpu")
    rng = np.random.default_rng(2)
    hidden = (rng.standard_normal((10, 64)) * 0.5).astype(np.float32)
    ids = [int(i) for i in rng.integers(0, 256, 10)]

    def out(pkg):
        return pkg.LLMOut(text="", token_ids=ids, hidden_states=hidden)

    with jax.disable_jit():
        want = jpipe._tts_generate(out(jpipeline), True)
    key = [jax.random.PRNGKey(0)]
    scan, steps = ttts.tts_decode_scan, []

    def on_jax_noise(*a, **kw):
        key[0], sub = jax.random.split(key[0])
        steps.append((a[6], kw["force_no_eos"]))
        return scan(*a, **{**kw, "generator": None, "gumbels": _jax_gumbels(sub, a[6])})

    with mock.patch.object(ttts, "tts_decode_scan", on_jax_noise):
        got = tpipe._tts_generate(out(tpipeline), True)
    jpipe.shutdown()
    tpipe.shutdown()
    cap, scan_len = tpipeline.DUPLEX_CHUNK_CAP, tpipeline.T2W_MAIN
    assert got == want and len(got) == cap == jpipeline.DUPLEX_CHUNK_CAP
    assert steps == [(scan_len, True), (cap - scan_len, True)]
    assert all(0 <= c < 6561 for c in got)
