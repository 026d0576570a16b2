"""The port's TTS (omni_tpu_torch.models.tts) against omni_tpu's on the JAX
package's tiny TTS fixture (`write_tiny_tts`: a 2-layer d 32 LLaMA-arch
decoder, NORM rotary, with the full 6,562 audio codes so that audio_eos
exists): the loaders, `build_condition` and the speaker embedding, the
decoder teacher-forced on the JAX scan's own codes with the logits held
step by step, the scan fed JAX's own Gumbel noise (the same codes, ring,
position and hidden), the sampling laws (the same filtered support on the
same logits, a chi-square of the port's own draws against softmax of that
support, RAS and the repetition penalty on JAX's noise), and the done
chain (audio_eos freezes a scan; a chained scan is a no-op). The scans
are held against the JAX scan run op by op (`jax.disable_jit()`), where
both packages round every bf16 step alike and the codes, ring and hidden
agree bit for bit; under jit, XLA's fused steps round otherwise in the
last bf16 bit, and the flat random logits of a tiny head turn such a flip
into another draw within a few steps (the teacher-forced test holds the
jitted scan's logits to LOGITS_ATOL instead)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import compilation_cache
from scipy import stats as sps

from omni_tpu.core import GGUFReader as JaxReader
from omni_tpu.models import qwen3 as jq
from omni_tpu.models import tts as jtts
from omni_tpu.runtime import Batch as JaxBatch
from omni_tpu.runtime import Context as JaxContext
from omni_tpu.testing_gguf import write_tiny_tts
from omni_tpu_torch.core.gguf import GGUFReader
from omni_tpu_torch.models import qwen3 as tq
from omni_tpu_torch.models import tts as ttts
from omni_tpu_torch.runtime import Batch, Context
from test_torch_whisper import same_tree

D_LLM = 64
N_CTX = 128
N_STEPS = 25
COND_RTOL = 1e-5  # f32 projector of both packages, of max|condition|
# against the JAX package op by op the bf16 hidden states agree bit for
# bit; the head's f32 sums run in another order (a few f32 ulp)
LOGITS_ATOL = 1e-5  # of max|logit| per step
HIDDEN_ATOL = 2e-2  # of max|hidden| after the jitted JAX prefill (bf16 flips)
CHI2_DRAWS, CHI2_MIN_P = 4000, 1e-4


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


@pytest.fixture(scope="module")
def tts(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_tts") / "tts.gguf"
    write_tiny_tts(path, d_llm=D_LLM, n_codes=ttts.NUM_AUDIO_TOKENS, seed=5)
    jr, tr = JaxReader(path), GGUFReader(path)
    jcfg = jtts.config_from_gguf(jr.kv)
    jp, jx = jtts.load_params(jr)
    tcfg = ttts.config_from_gguf(tr.kv)
    tp, tx = ttts.load_params(tr, device="cpu")
    return jcfg, jp, jx, tcfg, tp, tx


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _condition_inputs(seed, n=10):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 300, n).astype(np.int32),
            rng.standard_normal((n, D_LLM)).astype(np.float32))


def test_config_and_params_as_jax(tts):
    jcfg, jp, jx, tcfg, tp, tx = tts
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.rope_neox is False
    for name in ("wq", "wo", "w_down", "attn_norm"):
        np.testing.assert_array_equal(_np(tp["layers"][1][name]),
                                      _np(jp["layers"][1][name]))
    np.testing.assert_array_equal(_np(tp["token_embd"]), _np(jp["token_embd"]))
    for name in jx:
        np.testing.assert_array_equal(tx[name].numpy(), np.asarray(jx[name]))
    assert tx["head_code_bf16"].dtype == torch.bfloat16


def test_from_jax_params_as_loader(tts):
    """`convert.from_jax_params` carries the JAX decoder and extras across
    as the port's loader reads the file (the extras' bf16 copies by
    `tts.with_bf16`)."""
    from omni_tpu_torch.convert import from_jax_params

    jcfg, jp, jx, tcfg, tp, tx = tts
    tree = jax.tree_util.tree_map(np.asarray, (jp, jx))
    same_tree(from_jax_params(tree[0], "cpu"), tp)
    same_tree(ttts.with_bf16(from_jax_params(tree[1], "cpu")), tx)


@pytest.mark.parametrize("end_of_turn", [False, True])
@pytest.mark.parametrize("voice", ["default", "reference", None])
def test_condition_and_speaker_as_jax(tts, end_of_turn, voice):
    jcfg, jp, jx, tcfg, tp, tx = tts
    toks, hid = _condition_inputs(1)
    ref = np.random.default_rng(2).standard_normal((7, D_LLM)).astype(np.float32)
    if voice is None:
        jspk = tspk = None
    else:
        jspk = jtts.speaker_embed(jx, None if voice == "default" else jnp.asarray(ref))
        tspk = ttts.speaker_embed(tx, None if voice == "default" else torch.from_numpy(ref))
        np.testing.assert_allclose(tspk.numpy(), np.asarray(jspk), rtol=0,
                                   atol=COND_RTOL * np.abs(np.asarray(jspk)).max())
    want = np.asarray(jtts.build_condition(jx, jnp.asarray(toks), jnp.asarray(hid),
                                           end_of_turn, jspk))
    got = ttts.build_condition(tx, torch.from_numpy(toks), torch.from_numpy(hid),
                               end_of_turn, tspk).numpy()
    assert got.shape == want.shape == (10 + (voice is not None) + end_of_turn + 1, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=COND_RTOL * np.abs(want).max())


def _contexts(tts):
    jcfg, jp, jx, tcfg, tp, tx = tts
    return (JaxContext(jcfg, jp, jq.forward, jq.embed, n_ctx=N_CTX),
            Context(tcfg, tp, tq.forward, tq.embed, n_ctx=N_CTX, device="cpu"))


def _prefill(tts, jctx, tctx, seed=3):
    jx, tx = tts[2], tts[5]
    toks, hid = _condition_inputs(seed)
    spk = jtts.speaker_embed(jx)
    cond = jtts.build_condition(jx, jnp.asarray(toks), jnp.asarray(hid), False, spk)
    _, jh = jctx.decode(JaxBatch(embeds=cond), return_hidden=True)
    tcond = ttts.build_condition(tx, torch.from_numpy(toks), torch.from_numpy(hid),
                                 False, ttts.speaker_embed(tx))
    _, th = tctx.decode(Batch(embeds=tcond), return_hidden=True)
    np.testing.assert_allclose(th[-1].numpy(), np.asarray(jh[-1]), rtol=0,
                               atol=HIDDEN_ATOL * np.abs(np.asarray(jh)).max())
    return jh[-1], th[-1]


def _jax_scan(tts, jctx, jh, key, n_steps=N_STEPS, first_chunk=True, done_in=None,
              extras=None, start=None, prev0=None):
    jcfg, jx = tts[0], tts[2] if extras is None else extras
    codes, nv, jctx.cache, _, h, prev, pos, done = jtts.tts_decode_scan(
        jctx.params, jcfg, jx, jctx.cache, jh,
        jnp.int32(jctx.n_past[0] if start is None else start), key,
        n_steps=n_steps, first_chunk=first_chunk, done_in=done_in, prev0=prev0)
    return np.asarray(codes), h, np.asarray(prev), int(pos), bool(done)


def _jax_gumbels(key, n_steps, k=25):
    """The noise of the JAX scan's draws: per step key, sub = split(key),
    categorical(sub, topv) = argmax(topv + gumbel(sub, (k,)))."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, (k,), jnp.float32)))
    return torch.from_numpy(np.stack(out))


@pytest.fixture(scope="module")
def jax_scan_run(tts):
    """The JAX scan op by op from the condition (key 11): its codes, last
    hidden, ring, position and the cells' positions."""
    key = jax.random.PRNGKey(11)
    with jax.disable_jit():
        jctx, _ = _contexts(tts)
        jh, _ = _prefill(tts, jctx, _contexts(tts)[1])
        codes, jhl, jprev, jpos, _ = _jax_scan(tts, jctx, jh, key)
    return key, codes, jhl, jprev, jpos, np.asarray(jctx.cache.pos)


def test_decoder_teacher_forced_on_jax_codes(tts, jax_scan_run):
    """The JAX scan's own codes fed to both decoders one step at a time,
    the JAX one op by op: each step's head_code logits within LOGITS_ATOL
    of their scale."""
    jx, tx = tts[2], tts[5]
    codes = jax_scan_run[1]
    assert (codes >= 0).all()
    with jax.disable_jit():
        jctx, tctx = _contexts(tts)
        jh, th = _prefill(tts, jctx, tctx)
        emb_j = jx["emb_code"].astype(jnp.bfloat16)
        for i, c in enumerate(codes):
            want = np.asarray(jtts.audio_logits(jx, jh.astype(jnp.bfloat16)))
            got = ttts.audio_logits(tx, th.to(torch.bfloat16)).numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=LOGITS_ATOL * np.abs(want).max(),
                                       err_msg=f"step {i}")
            _, jh = jctx.decode(JaxBatch(embeds=emb_j[int(c)][None]),
                                return_hidden=True)
            jh = jh[0]
            _, th = tctx.decode(Batch(embeds=tx["emb_code_bf16"][int(c)][None]),
                                return_hidden=True)
            th = th[0]


def test_scan_on_jax_noise_gives_jax_codes(tts, jax_scan_run):
    """Both scans from the same condition, the port's fed the JAX scan's
    Gumbel noise: the same 25 codes, ring, position, last hidden and
    cells."""
    key, jcodes, jhl, jprev, jpos, jcells = jax_scan_run
    tctx = _contexts(tts)[1]
    with jax.disable_jit():
        th = _prefill(tts, _contexts(tts)[0], tctx)[1]
    codes, cache, hl, prev, pos, done = ttts.tts_decode_scan(
        tctx.params, tctx.cfg, tts[5], tctx.cache, th,
        torch.tensor(tctx.n_past[0]), N_STEPS, first_chunk=True,
        gumbels=_jax_gumbels(key, N_STEPS))
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    np.testing.assert_array_equal(prev.numpy(), jprev)
    assert int(pos) == jpos and not bool(done)
    np.testing.assert_array_equal(_np(hl), _np(jhl))
    np.testing.assert_array_equal(cache.pos.numpy(), jcells)


def test_done_chain_as_jax(tts):
    """head_code's audio_eos row made large in both packages, so the JAX
    scan samples audio_eos inside its 25 steps: on the same noise the port
    emits the same codes, -1 from that step on, its position, ring, hidden
    and cells frozen there; a scan chained on done=True emits only -1 and
    writes nothing, in both packages."""
    jcfg, jp, jx, tcfg, tp, tx = tts
    jx = dict(jx)
    jx["head_code"] = jx["head_code"].at[ttts.AUDIO_EOS_REL].set(
        jx["head_code"][0] * 2.5)
    tx = {**tx, "head_code": torch.from_numpy(np.asarray(jx["head_code"]))}
    tx = ttts.with_bf16(tx)
    key = jax.random.PRNGKey(5)
    with jax.disable_jit():
        jctx, tctx = _contexts(tts)
        jh, th = _prefill(tts, jctx, tctx)
        jcodes, jhl, jprev, jpos, jdone = _jax_scan(tts, jctx, jh, key, extras=jx)
    n_valid = int((jcodes >= 0).sum())
    assert jdone and 0 < n_valid < N_STEPS and (jcodes[n_valid:] == -1).all()
    codes, cache, hl, prev, pos, done = ttts.tts_decode_scan(
        tp, tcfg, tx, tctx.cache, th, torch.tensor(tctx.n_past[0]), N_STEPS,
        first_chunk=True, gumbels=_jax_gumbels(key, N_STEPS))
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    np.testing.assert_array_equal(prev.numpy(), jprev)
    assert int(pos) == jpos == tctx.n_past[0] + n_valid and bool(done)
    np.testing.assert_array_equal(_np(hl), _np(jhl))
    np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(jctx.cache.pos))
    # chained: nothing emitted, nothing written, the state kept
    jc2, _, jprev2, jpos2, jdone2 = _jax_scan(
        tts, jctx, jhl, jax.random.PRNGKey(6), n_steps=5, first_chunk=False,
        done_in=jnp.bool_(True), extras=jx, start=jpos, prev0=jnp.asarray(jprev))
    c2, cache2, h2, prev2, pos2, done2 = ttts.tts_decode_scan(
        tp, tcfg, tx, cache, hl, pos, 5, prev0=prev, done_in=done,
        generator=torch.Generator().manual_seed(0))
    assert (c2.numpy() == -1).all() and (jc2 == -1).all()
    assert bool(done2) and jdone2 and int(pos2) == int(pos) and jpos2 == jpos
    np.testing.assert_array_equal(jprev2, jprev)
    assert torch.equal(h2, hl) and torch.equal(prev2, prev)
    np.testing.assert_array_equal(cache2.pos.numpy(), np.asarray(jctx.cache.pos))


def _logits(seed, n=ttts.NUM_AUDIO_TOKENS, scale=3.0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32) * scale


def _jax_support(logits, prev, skip, force, monkeypatch):
    """The JAX sampler's filtered candidates: its categorical's input."""
    seen = {}
    real = jax.random.categorical

    def spy(key, v, *a, **kw):
        seen["v"] = np.asarray(v)
        return real(key, v, *a, **kw)

    monkeypatch.setattr(jax.random, "categorical", spy)
    tok = jtts.sample_audio_token(jnp.asarray(logits), jax.random.PRNGKey(0),
                                  jnp.asarray(prev), skip_processors=skip,
                                  force_no_eos=force)
    monkeypatch.setattr(jax.random, "categorical", real)
    return seen["v"], int(tok)


@pytest.mark.parametrize("seed,skip,force", [(0, False, False), (1, True, False),
                                             (2, False, True), (3, True, True)])
def test_filtered_support_and_draws_as_jax(seed, skip, force, monkeypatch):
    """The same logits and ring: the same filtered candidates (top-25,
    top-p 0.85, at least 3) in both packages; the port's draw on JAX's
    noise is JAX's code; CHI2_DRAWS of the port's own draws follow softmax
    of the filtered candidates (chi-square p > CHI2_MIN_P)."""
    logits = _logits(seed)
    prev = np.full(16, -1, np.int64)
    top = np.argsort(-logits)[:6]
    prev[-6:] = top  # the penalty reaches the candidates
    if force:
        logits[ttts.AUDIO_EOS_REL] = logits.max() + 1.0
    jv, jtok = _jax_support(logits, prev, skip, force, monkeypatch)
    t = torch.from_numpy(logits)
    v = t / 0.8
    if not skip:
        v = ttts.apply_repetition_penalty(v, torch.from_numpy(prev), 1.05, 16)
    if force:
        v = v.masked_fill(torch.arange(len(v)) == ttts.AUDIO_EOS_REL, float("-inf"))
    tv, ids = ttts.nucleus_support(v, 0.85, 25, 3)
    np.testing.assert_array_equal(np.isfinite(tv.numpy()), np.isfinite(jv))
    np.testing.assert_allclose(tv.numpy()[np.isfinite(jv)], jv[np.isfinite(jv)],
                               rtol=1e-6)
    key = jax.random.PRNGKey(0)
    g = torch.from_numpy(np.asarray(jax.random.gumbel(key, (25,), jnp.float32)))
    assert int(ttts.sample_audio_token(t, torch.from_numpy(prev), skip_processors=skip,
                                       force_no_eos=force, gumbel=g)) == jtok
    gen = torch.Generator().manual_seed(seed)
    draws = [int(ttts.sample_audio_token(t, torch.from_numpy(prev), skip_processors=skip,
                                         force_no_eos=force, generator=gen))
             for _ in range(CHI2_DRAWS)]
    keep = np.isfinite(tv.numpy())
    p = torch.softmax(tv[torch.from_numpy(keep)].double(), 0).numpy()
    cand = ids.numpy()[keep]
    counts = np.array([draws.count(int(c)) for c in cand])
    assert counts.sum() == CHI2_DRAWS  # nothing outside the support
    assert sps.chisquare(counts, p * CHI2_DRAWS).pvalue > CHI2_MIN_P


@pytest.mark.parametrize("repeat", [False, True])
def test_ras_and_penalty_as_jax(repeat):
    """RAS on JAX's two draws' noise gives JAX's code, with the candidate
    repeated in the last 10 codes (the fallback draw) or not; the
    repetition penalty equals JAX's."""
    logits = _logits(9)
    prev = np.full(16, -1, np.int64)
    prev[-3:] = [5, 6, 7]
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    g1 = np.asarray(jax.random.gumbel(k1, (25,), jnp.float32))
    g2 = np.asarray(jax.random.gumbel(k2, (len(logits),), jnp.float32))
    cand = int(np.argmax(np.sort(logits)[::-1][:25] + g1))
    if repeat:
        prev[-1] = np.argsort(-logits)[cand]
    want = int(jtts.ras_sample(jnp.asarray(logits), key, jnp.asarray(prev)))
    got = int(ttts.ras_sample(torch.from_numpy(logits), torch.from_numpy(prev),
                              gumbel=(torch.from_numpy(g1), torch.from_numpy(g2))))
    assert got == want
    fallback = int(np.argmax(logits + g2))
    assert got == (fallback if repeat else int(np.argsort(-logits)[cand]))
    pen = ttts.apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(prev),
                                        1.05, 16).numpy()
    np.testing.assert_array_equal(pen, np.asarray(jtts.apply_repetition_penalty(
        jnp.asarray(logits), jnp.asarray(prev), 1.05, 16)))


def test_spoken_limits_readings_on_the_cpu(tmp_path):
    """`spoken_limits.tts_readings`, the gaps behind chip_smoke.py's TTS
    limit, with the CPU in the card's place at a small width: the sound
    port reads exactly its own logits, a flipped rotary layout reads far
    off, and the f32 head a bf16 rounding away."""
    from omni_tpu_torch import spoken_limits
    from omni_tpu_torch.testing_synth import write_tts_gguf

    path = str(tmp_path / "tts.gguf")
    write_tts_gguf(path, torch.Generator().manual_seed(0), n_layers=2, d_model=256,
                   n_heads=4, d_ff=512, n_text=2000)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = spoken_limits.tts_readings(path, 0, torch.device("cpu"))
    finally:
        torch.set_num_threads(n_threads)
    assert got["sound"] == got["tf32"] == 0.0
    assert got["rope_flipped"] > 0.02  # 0.0386 at this size
    assert 0.0 < got["f32_head"] < 0.01  # 0.0023
