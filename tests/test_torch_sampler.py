"""The port's sampler chain (omni_tpu_torch.runtime.sampler) against
omni_tpu's, op by op on the CPU: each filter's mask, the drawn token under
JAX's own Gumbel noise and XTC uniform (`jax.random.categorical` is
argmax(logits + gumbel)), mirostat's mu, DRY, and the draws' law.

Masks must be equal, except at a token whose deciding quantity, as
omni_tpu computes it in f32 (its probability against min-p's cutoff, the
cumulative probability before it against top-p or typical-p), lies within
4 ulp of the threshold: torch and XLA sum a softmax in different orders.
Such tokens are counted and printed (`-s`): four, top-p's at 0.5 and 0.95
on the row built to put a prefix there (XLA's sum drops the row's tail),
typical-p's at 0.5 and 0.9 on the flat row (1000 equal probabilities)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from jax._src import compilation_cache
from omni_tpu.runtime import sampler as js
from omni_tpu_torch.runtime import Context
from omni_tpu_torch.runtime import sampler as ts

V = 1000


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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: as fast at these tiny shapes, and no contention
    with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows():
    """Logit rows: normal at three scales, integer rows full of ties (at
    the k-th logit too), a row whose top-p prefix sums to 0.95 exactly in
    f64, one with -inf entries, and a flat one."""
    rng = np.random.default_rng(7)
    rows = {f"normal{s}": (rng.standard_normal(V) * s).astype(np.float32)
            for s in (1.0, 3.0, 8.0)}
    rows["ties"] = rng.integers(-4, 5, V).astype(np.float32)
    p = np.full(V, 1e-9)
    p[:3] = (0.5, 0.45, 0.05)
    rows["top_p_edge"] = np.log(p / p.sum()).astype(np.float32)
    x = rng.standard_normal(V).astype(np.float32)
    x[rng.random(V) < 0.5] = -np.inf
    rows["masked"] = x
    rows["flat"] = np.zeros(V, np.float32)
    return rows


ROWS = _rows()


def _ulp(x):
    return np.spacing(np.float32(abs(x)))


def _check_mask(name, want, got, quantity=None, thresh=None):
    """Equal -inf masks, equal kept values; a differing token only where
    `quantity` lies within 4 ulp of `thresh`."""
    wm, gm = np.isneginf(want), np.isneginf(got)
    diff = np.nonzero(wm != gm)[0]
    if len(diff):
        print(f"{name}: {len(diff)} token(s) at the threshold")
        assert quantity is not None
        assert np.all(np.abs(quantity[diff] - thresh) <= 4 * _ulp(thresh)), name
    keep = ~wm & ~gm
    np.testing.assert_array_equal(got[keep], want[keep])


def _before(p_sorted, order):
    """Per token, the f32 cumulative probability of the tokens ahead of it
    in `order` (p_sorted: the probabilities in that order)."""
    cum = np.asarray(jnp.cumsum(p_sorted))
    out = np.empty(len(order), np.float32)
    out[np.asarray(order)] = np.concatenate([[0.0], cum[:-1]])
    return out


@pytest.mark.parametrize("row", list(ROWS))
def test_filter_masks_match_jax(row):
    x = ROWS[row]
    jx, tx = jnp.asarray(x), torch.from_numpy(x.copy())
    for k in (1, 5, 40, V):
        _check_mask(f"top_k {k}", np.asarray(js.apply_top_k(jx, k)),
                    ts.apply_top_k(tx, k).numpy())
    # the deciding quantities as omni_tpu computes them
    desc = jnp.argsort(-jx, stable=True)
    top_p_q = _before(jax.nn.softmax(jx[desc]), desc)
    for p in (0.5, 0.9, 0.95, 1.0):
        _check_mask(f"top_p {p}", np.asarray(js.apply_top_p(jx, p)),
                    ts.apply_top_p(tx, p).numpy(), top_p_q, p)
    probs = np.asarray(jax.nn.softmax(jx))
    for p in (0.0, 0.05, 0.3):
        _check_mask(f"min_p {p}", np.asarray(js.apply_min_p(jx, p)),
                    ts.apply_min_p(tx, p).numpy(), probs, probs.max() * np.float32(p))
    logp = jax.nn.log_softmax(jx)
    ent = -jnp.sum(jnp.where(jnp.exp(logp) > 0, jnp.exp(logp) * logp, 0.0))
    order = jnp.argsort(jnp.abs(-logp - ent), stable=True)
    typical_q = _before(jnp.exp(logp)[order], order)
    for p in (0.5, 0.9, 1.0):
        _check_mask(f"typical {p}", np.asarray(js.apply_typical(jx, p)),
                    ts.apply_typical(tx, p).numpy(), typical_q, p)
    for n in (-1.0, 0.5, 2.0):
        _check_mask(f"top_n_sigma {n}", np.asarray(js.apply_top_n_sigma(jx, n)),
                    ts.apply_top_n_sigma(tx, n).numpy())


@pytest.mark.parametrize("u", [0.1, 0.9])
@pytest.mark.parametrize("row", ["normal3.0", "top_p_edge", "flat"])
def test_xtc_and_temperature_match_jax(row, u):
    x = ROWS[row]
    jx, tx = jnp.asarray(x), torch.from_numpy(x.copy())
    for prob, thr in ((0.5, 0.05), (0.5, 0.4), (0.0, 0.1)):
        kw = dict(xtc_probability=prob, xtc_threshold=thr)
        _check_mask(f"xtc {kw}", np.asarray(js.apply_xtc(
            jx, _uniform_key(u), js.SamplerParams(**kw))),
            ts.apply_xtc(tx, torch.tensor(float(np.asarray(
                jax.random.uniform(_uniform_key(u))))), ts.SamplerParams(**kw)).numpy())
    for kw in (dict(temp=0.8), dict(temp=1.7), dict(temp=0.0)):
        np.testing.assert_array_equal(
            ts.apply_temp(tx, ts.SamplerParams(**kw)).numpy(),
            np.asarray(js.apply_temp(jx, js.SamplerParams(**kw))))
    # the dynamic temperature divides by a function of the row's entropy,
    # a sum over the row that the two libraries order otherwise (on the
    # top-p edge row XLA's sum drops the 1e-6 tail: 2.2e-6 relative)
    for kw in (dict(temp=0.8, dynatemp_range=0.5),
               dict(temp=0.3, dynatemp_range=0.5, dynatemp_exponent=2.0)):
        want = np.asarray(js.apply_temp(jx, js.SamplerParams(**kw)))
        got = ts.apply_temp(tx, ts.SamplerParams(**kw)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def _uniform_key(u):
    """A key whose first uniform lies below or above `u` (the XTC coin)."""
    for i in range(1000):
        k = jax.random.PRNGKey(i)
        if (float(jax.random.uniform(k)) < 0.5) == (u < 0.5):
            return k
    raise AssertionError


PARAMS = {
    "default": {},
    "plain": dict(temp=1.3, top_k=0, top_p=1.0, min_p=0.0),
    "typical_sigma": dict(typical_p=0.9, top_n_sigma=1.5, top_k=0),
    "xtc": dict(xtc_probability=0.5, xtc_threshold=0.02, min_p=0.0),
    "dynatemp": dict(dynatemp_range=0.5, top_p=0.8),
    "penalties_dry": dict(penalty_repeat=1.3, penalty_freq=0.2,
                          penalty_present=0.1, dry_multiplier=0.8,
                          dry_breakers=(3,)),
    "bias": dict(logit_bias=((5, 2.0), (V - 1, -1.0), (-2, 0.5), (V + 3, 9.0))),
    "greedy": dict(greedy=True, penalty_repeat=1.2),
}


def _ring(seed):
    rng = np.random.default_rng(seed)
    prev = np.full(64, -1, np.int32)
    motif = rng.integers(0, 20, 6)
    prev[16:] = np.concatenate([motif] * 8)[:48]  # repeats for DRY
    prev[40] = 3  # a breaker inside the repeats
    return prev


@pytest.mark.parametrize("name", list(PARAMS))
@pytest.mark.parametrize("row", ["normal1.0", "normal3.0", "ties", "masked"])
def test_sample_matches_jax_under_its_draws(name, row):
    """The port's token under JAX's gumbel(k_draw) and uniform(k_xtc)
    equals JAX's `sample` with key k, and `jax.random.categorical` is the
    argmax of logits + that noise."""
    x, prev = ROWS[row], _ring(1)
    jp, tp = js.SamplerParams(**PARAMS[name]), ts.SamplerParams(**PARAMS[name])
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want = int(js.sample(jnp.asarray(x), key, jp, jnp.asarray(prev)))
        k_xtc, k_draw = jax.random.split(key)
        g = np.array(jax.random.gumbel(k_draw, (V,)))
        u = np.array(jax.random.uniform(k_xtc))
        got = int(ts.sample(torch.from_numpy(x.copy()), tp,
                            torch.from_numpy(prev.astype(np.int64)),
                            gumbel=torch.from_numpy(g), xtc_u=torch.from_numpy(u)))
        assert got == want, (name, row, seed)
    cat = jax.random.categorical(k_draw, jnp.asarray(x))
    assert int(cat) == int(np.argmax(x + g))


@pytest.mark.parametrize("version", [1, 2])
def test_mirostat_matches_jax(version):
    rng = np.random.default_rng(11)
    kw = dict(mirostat=version, mirostat_tau=4.0, mirostat_eta=0.2, temp=0.9)
    jp, tp = js.SamplerParams(**kw), ts.SamplerParams(**kw)
    jmu = js.mirostat_init(jp)
    assert float(ts.mirostat_init(tp)) == float(jmu)
    for step in range(12):
        # each step from omni_tpu's mu: the update itself is held to 1e-6
        # (chained over steps the two drift by an ulp of mu a step or so)
        x = (rng.standard_normal(V) * 4).astype(np.float32)
        key = jax.random.PRNGKey(100 + step)
        tmu_in = torch.tensor(float(jmu))
        jtok, jmu = js.sample(jnp.asarray(x), key, jp, mu=jmu)
        g = torch.from_numpy(np.array(jax.random.gumbel(key, (V,))))
        ttok, tmu = ts.sample(torch.from_numpy(x), tp, mu=tmu_in, gumbel=g)
        assert int(ttok) == int(jtok), step
        assert abs(float(tmu) - float(jmu)) <= 1e-6, step


def test_dry_and_penalties_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(V).astype(np.float32)
    for seed, kw in ((1, {}), (2, dict(dry_breakers=(3, 7))),
                     (3, dict(dry_allowed_length=1, dry_base=2.0)),
                     (4, dict(dry_allowed_length=4))):
        prev = _ring(seed)
        p = dict(dry_multiplier=0.8, penalty_repeat=1.1, **kw)
        want = np.asarray(js.apply_dry(jnp.asarray(x), jnp.asarray(prev),
                                       js.SamplerParams(**p)))
        got = ts.apply_dry(torch.from_numpy(x.copy()),
                           torch.from_numpy(prev.astype(np.int64)),
                           ts.SamplerParams(**p)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert (got != x).any()
        want = np.asarray(js.apply_penalties(jnp.asarray(x), jnp.asarray(prev),
                                             js.SamplerParams(**p)))
        got = ts.apply_penalties(torch.from_numpy(x.copy()),
                                 torch.from_numpy(prev.astype(np.int64)),
                                 ts.SamplerParams(**p)).numpy()
        np.testing.assert_array_equal(got, want)


def test_allowed_mask_and_ring_match_jax():
    x = ROWS["normal1.0"]
    allowed = np.array([3, -1, 17, 999, 3, -1], np.int32)
    np.testing.assert_array_equal(
        ts.apply_allowed_mask(torch.from_numpy(x.copy()),
                              torch.from_numpy(allowed)).numpy(),
        np.asarray(js.apply_allowed_mask(jnp.asarray(x), jnp.asarray(allowed))))
    prev = _ring(2)
    np.testing.assert_array_equal(
        ts.update_prev_tokens(torch.from_numpy(prev.astype(np.int64)),
                              torch.tensor(42)).numpy(),
        np.asarray(js.update_prev_tokens(jnp.asarray(prev), jnp.int32(42))))


def test_default_params_sample_and_follow_the_filtered_softmax():
    """SamplerParams() samples on the CPU, reproducibly from its seed, and
    4,000 draws from one row follow softmax of the filtered row (chi-square
    p > 1e-4)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.standard_normal(64) * 2).astype(np.float32))
    sp = ts.SamplerParams()
    draws = []
    for seed in (0, 0):
        gen = torch.Generator().manual_seed(seed)
        draws.append([int(ts.sample(x, sp, generator=gen)) for _ in range(4000)])
    assert draws[0] == draws[1]
    filt = ts.apply_temp(ts.apply_min_p(ts.apply_top_p(
        ts.apply_top_k(x, sp.top_k), sp.top_p), sp.min_p), sp).double()
    p = torch.softmax(filt, -1).numpy()
    seen = np.bincount(draws[0], minlength=64)
    assert seen[p == 0].sum() == 0
    keep = p > 0
    chi = stats.chisquare(seen[keep], p[keep] / p[keep].sum() * len(draws[0]))
    assert chi.pvalue > 1e-4, chi


def test_context_samples_with_its_generator():
    class Cfg:
        n_layers, n_kv_heads, head_dim, rope_base = 1, 1, 8, 1e6

    a = Context(Cfg, None, None, None, n_ctx=16, device="cpu")
    b = Context(Cfg, None, None, None, n_ctx=16, device="cpu")
    row = torch.from_numpy(ROWS["normal3.0"].copy())
    ta = [a.sample_token(row) for _ in range(20)]
    assert ta == [b.sample_token(row) for _ in range(20)]
    assert len(set(ta)) > 1  # stochastic by default
    assert a.prev_tokens[-20:].tolist() == ta
    m = Context(Cfg, None, None, None, n_ctx=16, device="cpu",
                sampler=ts.SamplerParams(mirostat=2))
    mu0 = float(m.mu)
    m.sample_token(row)
    assert float(m.mu) != mu0
