"""The port's fused gated FFN (kernel I's plain law, `fused_ffn.qffn_plain`,
and the fused route of `qwen3._ffn`) against the JAX package's
`qffn_pallas`, run in interpret mode as tests/test_qkernels.py runs it:
every same-format pair of the thirteen formats and four mixed pairs, a tiny
fused Q4_K model carried across with `from_jax_params`, layer by layer and
through one served greedy turn, and the CPU forward that keeps the
composition with the switch on, as the JAX package's CPU forward does.
Everything here runs on the CPU; the CUDA kernel is held against the plain
law on the card (tests/test_torch_cuda.py and chip_smoke.py)."""

import os
from contextlib import contextmanager
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_tpu.core import GGMLType, GGUFReader, quants
from omni_tpu.kernels import dequant as jax_dequant
from omni_tpu.kernels import fused_ffn as jax_fused
from omni_tpu.kernels import repack
from omni_tpu.models import qwen3 as jq
from omni_tpu.runtime import Batch as JaxBatch
from omni_tpu.runtime import Context as JaxContext
from omni_tpu.runtime import SamplerParams as JaxSamplerParams
from omni_tpu.runtime.kv_cache import KVCache as JaxKVCache
from omni_tpu.testing import write_tiny_qwen3
from omni_tpu_torch.convert import from_jax_params
from omni_tpu_torch.kernels import _build, qformats
from omni_tpu_torch.kernels import fused_ffn as ff
from omni_tpu_torch.models import qwen3 as tq
from omni_tpu_torch.omni.pipeline import SIMPLEX_ASSISTANT_PROMPT
from omni_tpu_torch.runtime import Batch, Context, KVCache, SamplerParams
# the module's autouse fixture: no JAX compile-cache writes from this file
from test_torch_kernels import no_compile_cache  # noqa: F401
from test_torch_legacy_quants import _jax_turn, _port_turn
from test_torch_model import JIT_LOGITS_ATOL, SYSTEM_PROMPT, WordTokenizer, _np, _t

Q4_K, Q5_K, Q6_K = GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K
Q4_0, Q4_1, Q5_0, Q5_1 = GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1
# (gate/up format, down format): every same-format pair, and the mixed pairs
# of the Q4_K_M and Q5_K_M recipes (Q6_K down) and of llama.cpp's
# importance-matrix Q4_0 and Q5_0 files (Q4_1 / Q5_1 down)
PAIRS = ([(t, t) for t in qformats.QUANTIZED]
         + [(Q4_K, Q6_K), (Q5_K, Q6_K), (Q4_0, Q4_1), (Q5_0, Q5_1)])
GELU_PAIRS = [(Q4_K, Q6_K), (GGMLType.Q8_0, GGMLType.Q8_0)]
pair_id = lambda p: f"{p[0].name}-{p[1].name}"  # noqa: E731
# kernel I's plain law vs qffn_pallas: the same law with f32 sums in another
# order, so now and then h = bf16(act(g)·u) rounds one ulp apart (one such
# flip moves an output by ~2**-8·|h|·|w|). Measured: 4.8e-4 of max|out| at
# worst over these pairs (K 512, F 768, M 40); the JAX test of the kernel
# against its composition allows 5e-2.
FFN_TOL = 5e-3
K, F = 512, 768  # tests/test_qkernels.py::test_qffn_fused_matches_composition's


def _qt(seed, qtype, n, k):
    """(JAX QTensor, the port's QTensor on the CPU) of a seeded [n, k]
    weight quantized by omni_tpu's encoder."""
    w = np.random.default_rng(seed).standard_normal((n, k), dtype=np.float32)
    jqt = repack(quants.quantize(w, qtype), qtype, (n, k))
    return jqt, from_jax_params(jax.tree_util.tree_map(np.asarray, jqt), "cpu")


def _pallas(x, jgu, jdn, act="silu", out_dtype=jnp.float32):
    """qffn_pallas as the JAX package's own test runs it on the CPU."""
    return np.asarray(jax_fused.qffn_pallas(
        jnp.asarray(x, jnp.bfloat16), jgu, jdn, block_m=32, block_f=256,
        act=act, out_dtype=out_dtype, interpret=True), dtype=np.float32)


def _close(got, want):
    """|got − want| within FFN_TOL of max|want|."""
    err = np.abs(got - want).max() / np.abs(want).max()
    assert np.isfinite(got).all() and err <= FFN_TOL, err


@pytest.mark.parametrize("m", [1, 40], ids=lambda m: f"m{m}")
@pytest.mark.parametrize("pair,act", [(p, "silu") for p in PAIRS]
                         + [(p, "gelu_tanh") for p in GELU_PAIRS],
                         ids=lambda v: pair_id(v) if isinstance(v, tuple) else v)
def test_qffn_plain_matches_pallas(pair, act, m):
    """Kernel I's plain law equals qffn_pallas (interpret mode) on the same
    weights and x, for every gate/up and down format pair, SiLU and
    tanh-GELU, a decode row and a ragged M."""
    t_gu, t_dn = pair
    jgu, pgu = _qt(1, t_gu, 2 * F, K)
    jdn, pdn = _qt(2, t_dn, K, F)
    x = np.random.default_rng(m).standard_normal((m, K), dtype=np.float32) * 0.1
    want = _pallas(x, jgu, jdn, act)
    got = ff.qffn(torch.from_numpy(x), pgu, pdn, act, torch.float32)
    _close(got.numpy(), want)
    bf = ff.qffn(torch.from_numpy(x), pgu, pdn, act)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, got.to(torch.bfloat16))


def test_qffn_refuses_what_qffn_pallas_refuses():
    """A gate/up weight that is not [2F, K] for down [N, F], an F that is no
    multiple of a format's granule, an unknown activation, a dense weight."""
    _, pgu = _qt(1, GGMLType.Q8_0, 2 * 96, 256)
    _, pdn = _qt(2, GGMLType.Q8_0, 256, 96)
    x = torch.zeros((1, 256))
    assert ff.qffn(x, pgu, pdn).shape == (1, 256)  # F = 96: whole Q8_0 blocks
    with pytest.raises(ValueError, match="do not make an FFN"):
        ff.qffn(x, pgu, _qt(2, GGMLType.Q8_0, 256, 128)[1])
    _, q4gu = _qt(1, Q4_K, 2 * 96, 256)
    with pytest.raises(ValueError, match="granule 256"):
        ff.qffn(x, q4gu, pdn)
    with pytest.raises(ValueError, match="act"):
        ff.qffn(x, pgu, pdn, act="relu")
    with pytest.raises(ValueError, match="QTensor"):
        ff.qffn(x, qformats.dequant(pgu), pdn)


# --------------------------------------------------- the wrapper on the card

def _mocked_card(entries):
    """ff.qffn's card path with `entries` (entry point name: function) as
    the built kernel I."""
    return (mock.patch.object(ff, "_on_cuda", return_value=True),
            mock.patch.object(_build, "load", return_value=entries),
            mock.patch.object(torch.cuda, "current_stream",
                              return_value=SimpleNamespace(cuda_stream=0)))


@pytest.mark.parametrize("pair", [(Q4_K, Q6_K), (Q5_0, Q5_1), (GGMLType.Q3_K, GGMLType.IQ4_XS)],
                         ids=pair_id)
def test_qffn_marshals_the_planes_on_a_mocked_card(pair):
    """On the card `qffn` launches kernel I's two passes in turn: the gated
    pass gets x, the fused gate/up weight's planes and the workspace, the
    down pass the workspace, the down weight's planes and the output, each
    with a null pointer exactly where a format has no plane; the shapes,
    the format ids, the activation, the output type and the plan's split
    counts; and the same workspace on every call of a shape. Each call
    counts one launch, under its format pair."""
    t_gu, t_dn = pair
    _, gu = _qt(1, t_gu, 2 * F, K)
    _, dn = _qt(2, t_dn, K, F)
    calls = []

    def entry(name):
        def fn(*a):
            calls.append((name, a))
            return 0
        return fn

    ff.reset_launches()
    card, build, stream = _mocked_card({nm: entry(nm) for nm in ("qffn_gated", "qffn_down")})
    with card, build, stream:
        for m in (3, 12):
            x = torch.zeros((m, K), dtype=torch.bfloat16)
            ff.qffn(x, gu, dn)
            ff.qffn(x, gu, dn, "gelu_tanh", torch.float32)
    assert ff.launches == {"qffn": 4}
    assert ff.qffn_launches == {f"{t_gu.name}/{t_dn.name}": 4}
    assert [nm for nm, _ in calls] == ["qffn_gated", "qffn_down"] * 4
    for i, (nm, a) in enumerate(calls):
        assert len(a) == len(_build.QFFN_ARGS) == 15
        m = 3 if i < 4 else 12
        plan = ff.qffn_plan(m, K, K, F, t_gu, t_dn)
        qt, planes = (gu, a[1:7]) if nm == "qffn_gated" else (dn, a[1:7])
        for j, pn in enumerate(qformats.PLANES):
            p = getattr(qt, pn)
            assert planes[j] == (0 if p is None else p.data_ptr())
        act, f32 = (0, 0) if i % 4 < 2 else (1, 1)
        if nm == "qffn_gated":
            assert a[8:] == (m, K, F, int(t_gu), act, plan.splits_gu, 0)
            ws = a[7]
        else:
            assert a[0] == ws  # h, written by the gated pass
            assert a[8:] == (m, F, K, int(t_dn), f32, plan.splits_dn, 0)
    # one workspace per size: the M = 3 calls share one, the M = 12 calls another
    assert calls[0][1][7] == calls[2][1][7] != calls[4][1][7] == calls[6][1][7]


def test_qffn_on_the_card_launches_or_raises():
    """Where kernel I cannot be built (no nvcc here) `qffn` on the card path
    raises; it never runs the plain version, and counts no launch."""
    _, gu = _qt(1, Q4_K, 2 * 256, 256)
    _, dn = _qt(2, Q6_K, 256, 256)
    ff.reset_launches()
    with mock.patch.object(ff, "_on_cuda", return_value=True), \
            mock.patch.object(_build, "load", side_effect=RuntimeError("nvcc not found")), \
            mock.patch.object(ff, "qffn_plain") as plain:
        with pytest.raises(RuntimeError, match="nvcc"):
            ff.qffn(torch.zeros((1, 256)), gu, dn)
    assert not plain.called and ff.launches == {"qffn": 0} and not ff.qffn_launches


# ------------------------------------------------------- a tiny fused model

_TINY = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
             d_ff=768, n_vocab=320)


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    """A tiny Qwen3 GGUF in Q4_K (a separate Q4_K head) loaded fused by the
    JAX package, and the same parameters carried into the port by
    `from_jax_params`."""
    path = tmp_path_factory.mktemp("fused_ffn") / "tiny_q4k.gguf"
    write_tiny_qwen3(path, qtype=Q4_K, tied_head=False, **_TINY)
    reader = GGUFReader(path)
    jcfg = jq.Qwen3Config.from_gguf(reader.kv)
    jparams = jq.load_params(reader, fuse=True)
    tcfg = tq.Qwen3Config(**{f: getattr(jcfg, f)
                             for f in tq.Qwen3Config.__dataclass_fields__})
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def test_from_jax_params_carries_the_fused_weights(fused):
    """The JAX package's fused parameters (wqkv, w_gateup) carry across as
    they are: the same keys, QTensors of the same format and shape that
    dequantise to the JAX package's weights bit for bit."""
    _, jparams, _, tparams = fused
    for jl, tl in zip(jparams["layers"], tparams["layers"]):
        assert set(jl) == set(tl) and {"wqkv", "w_gateup"} <= set(tl)
        assert not {"wq", "wk", "wv", "w_gate", "w_up"} & set(tl)
        for nm in ("wqkv", "w_gateup", "w_down"):
            assert isinstance(tl[nm], qformats.QTensor)
            assert tl[nm].ggml_type == Q4_K and tl[nm].shape == tuple(jl[nm].shape)
            np.testing.assert_array_equal(qformats.dequant(tl[nm]).numpy(),
                                          np.asarray(jax_dequant(jl[nm])))


class _TpuJax:
    """The JAX package's `jax` as its qwen3 module sees it, with the
    accelerator backend reported: the only check of its fused-FFN route
    that the CPU fails."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@contextmanager
def fused_routes():
    """Both packages take their fused-FFN route on the CPU (test-only
    patches): the JAX package's qwen3 sees an accelerator and
    OMNI_FUSED_FFN=1, its qffn_pallas runs in interpret mode at the JAX
    test's tiles; the port's `_ffn` sees the hidden state on the card, so
    `qffn` runs, which on a CPU tensor is kernel I's plain law. JAX's
    compiled steps are dropped on the way in and out, so no step compiled
    without the route is reused. Yields the calls of each side's kernel."""
    calls = {"jax": 0, "port": 0}
    pallas, port_qffn = jax_fused.qffn_pallas, tq.qffn

    def interp(*a, **kw):
        calls["jax"] += 1
        return pallas(*a, block_m=32, block_f=256, interpret=True, **kw)

    def spy(*a, **kw):
        calls["port"] += 1
        return port_qffn(*a, **kw)

    jax.clear_caches()
    try:
        with mock.patch.object(jq, "jax", _TpuJax()), \
                mock.patch.dict(os.environ, {"OMNI_FUSED_FFN": "1"}), \
                mock.patch.object(jax_fused, "qffn_pallas", interp), \
                mock.patch.object(tq, "FUSED_FFN", True), \
                mock.patch.object(tq, "_on_cuda", return_value=True), \
                mock.patch.object(tq, "qffn", spy):
            yield calls
    finally:
        jax.clear_caches()


def test_fused_route_matches_pallas_layer_by_layer(fused):
    """The port's forward with the fused route taken (a 7-token prefill,
    then one decode token) sends every layer's FFN through `qffn`, and each
    layer's output equals qffn_pallas (interpret mode) on that layer's JAX
    weights and the same input."""
    jcfg, jparams, tcfg, tparams = fused
    seen = []
    real = ff.qffn

    def record(hn, gu, down, act="silu", out_dtype=torch.bfloat16):
        out = real(hn, gu, down, act, out_dtype)
        seen.append((hn, out))
        return out

    tc = KVCache.create(tcfg.n_layers, 64, tcfg.n_kv_heads, tcfg.head_dim, "cpu")
    toks, pos = np.arange(7) * 37 % 300, np.arange(7)
    with mock.patch.object(tq, "FUSED_FFN", True), \
            mock.patch.object(tq, "_on_cuda", return_value=True), \
            mock.patch.object(tq, "qffn", record):
        for step in range(2):
            logits, _, tc = tq.forward(tparams, tcfg, tq.embed(tparams, _t(toks)), _t(pos),
                                       torch.zeros(len(toks), dtype=torch.int64), tc,
                                       tc.find_slots(len(toks)))
            assert torch.isfinite(logits).all()
            toks, pos = np.array([int(torch.argmax(logits[-1]))]), np.array([pos[-1] + 1])
    assert len(seen) == 2 * tcfg.n_layers
    for i, (hn, out) in enumerate(seen):
        lp = jparams["layers"][i % tcfg.n_layers]
        want = _pallas(hn.float().numpy(), lp["w_gateup"], lp["w_down"],
                       out_dtype=jnp.bfloat16)
        _close(out.float().numpy(), want)


def test_cpu_forward_with_the_switch_on_runs_the_composition(fused):
    """With OMNI_FUSED_FFN on, a CPU forward runs the unfused composition, as
    the JAX package's CPU forward does: neither kernel is called and the
    logits equal the switch-off forward's, bit for bit, in each package. A
    dense fused weight stays on the composition on the card path too."""
    jcfg, jparams, tcfg, tparams = fused
    toks, pos = np.arange(5) * 11, np.arange(5)

    def port():
        tc = KVCache.create(tcfg.n_layers, 16, tcfg.n_kv_heads, tcfg.head_dim, "cpu")
        return tq.forward(tparams, tcfg, tq.embed(tparams, _t(toks)), _t(pos),
                          torch.zeros(5, dtype=torch.int64), tc, tc.find_slots(5))[0]

    def ref():
        jc = JaxKVCache.create(jcfg.n_layers, 16, jcfg.n_kv_heads, jcfg.head_dim,
                               rope_base=jcfg.rope_base)
        return _np(jq.forward(jparams, jcfg, jq.embed(jparams, jnp.asarray(toks)),
                              jnp.asarray(pos, jnp.int32), jnp.zeros(5, jnp.int32), jc,
                              jc.find_slots(5))[0])

    off_port, off_ref = port(), ref()
    never = mock.Mock(side_effect=AssertionError("fused kernel called"))
    with mock.patch.object(tq, "FUSED_FFN", True), mock.patch.object(tq, "qffn", never), \
            mock.patch.dict(os.environ, {"OMNI_FUSED_FFN": "1"}), \
            mock.patch.object(jax_fused, "qffn_pallas", never):
        assert torch.equal(port(), off_port)
        np.testing.assert_array_equal(ref(), off_ref)
        lp = dict(tparams["layers"][0])
        lp["w_gateup"], lp["w_down"] = (qformats.dequant(lp[nm], torch.bfloat16)
                                        for nm in ("w_gateup", "w_down"))
        with mock.patch.object(tq, "_on_cuda", return_value=True):
            out = tq._ffn(lp, tcfg, torch.ones((2, tcfg.d_model), dtype=torch.bfloat16))
        assert out.shape == (2, tcfg.d_model)
    assert not never.called


def _tokens(events):
    return [int(t) for e in events for t in e["content"].split()]


def test_fused_turn_matches_jax(fused):
    """A greedy turn of up to 16 tokens served by the port with the fused
    route taken emits the tokens omni_tpu's pipeline emits with its own
    fused route (qffn_pallas in interpret mode), or parts from it only at a
    rounding flip: both contexts, fed omni_tpu's tokens up to the first
    parting, lie within test_torch_model's JIT_LOGITS_ATOL of each other
    (the noise of omni_tpu's jitted steps), each picks its own turn's token
    there, and the port's top-2 margin is below the logit distance."""
    jcfg, jparams, tcfg, tparams = fused

    def jax_ctx():
        return JaxContext(jcfg, jparams, jq.forward, jq.embed, n_ctx=512,
                          sampler=JaxSamplerParams(greedy=True))

    def port_ctx():
        return Context(tcfg, tparams, tq.forward, tq.embed, n_ctx=512,
                       sampler=SamplerParams(greedy=True), device="cpu")

    with fused_routes() as calls:
        want = _tokens(_jax_turn(jax_ctx()))
        got = _tokens(_port_turn(port_ctx()))
        assert calls["jax"] > 0 and calls["port"] >= tcfg.n_layers
        assert len(want) >= 8 and len(got) >= 8
        if got == want:
            return
        first = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
        tok = WordTokenizer()
        feeds = [tok.encode("<|im_start|>system\n" + SYSTEM_PROMPT + "\n<|audio_start|>"),
                 tok.encode("<|audio_end|><|im_end|>\n<|im_start|>user\n"),
                 tok.encode(SIMPLEX_ASSISTANT_PROMPT)] + [[t] for t in want]
        jc, tc = jax_ctx(), port_ctx()
        rows = []  # (jax logits, port logits) whose last row samples token i
        for ids in feeds[:3 + first]:
            rows.append((_np(jc.decode(JaxBatch(tokens=np.asarray(ids)))[0])[-1],
                         tc.decode(Batch(tokens=np.asarray(ids)))[0][-1].numpy()))
    rows = rows[2:]
    for i, (jl, tl) in enumerate(rows):
        assert np.abs(jl - tl).max() <= JIT_LOGITS_ATOL
        assert int(np.argmax(jl)) == want[i]
        assert int(np.argmax(tl)) == (want[i] if i < first else got[i])
    jl, tl = rows[first]
    top2 = np.sort(tl)[-2:]
    assert top2[1] - top2[0] < np.abs(jl - tl).max()


def test_fused_law_is_not_the_composition(fused):
    """The fused law keeps g and u in f32 and rounds h once; the composition
    rounds g, u and act(g) to bf16 first. On the tiny model's first layer
    the two differ (so no check may hold one bitwise against the other),
    while each stays within FFN_TOL of the other's scale."""
    _, _, tcfg, tparams = fused
    lp = tparams["layers"][0]
    hn = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (9, tcfg.d_model), dtype=np.float32)).to(torch.bfloat16)
    fused_out = ff.qffn(hn, lp["w_gateup"], lp["w_down"]).float().numpy()
    comp = tq._ffn(lp, tcfg, hn).float().numpy()
    assert not np.array_equal(fused_out, comp)
    assert np.abs(fused_out - comp).max() <= 5e-2 * np.abs(comp).max()


@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
def test_gated_is_the_jax_activation(act):
    """`gated` computes jax.nn.silu / jax.nn.gelu(approximate=True) times u
    in f32 to within an ulp or two (the libraries' exp and tanh differ)."""
    g = np.random.default_rng(5).standard_normal(4096, dtype=np.float32) * 4
    u = np.random.default_rng(6).standard_normal(4096, dtype=np.float32)
    a = jax.nn.silu(g) if act == "silu" else jax.nn.gelu(g, approximate=True)
    want = np.asarray(a * u)
    got = ff.gated(torch.from_numpy(g), torch.from_numpy(u), act).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_qffn_plain_equals_the_law_spelled_out():
    """qffn_plain is bf16 x and weights, f32 g and u, one bf16 rounding of
    act(g)·u, an f32 down product (a direct numpy spelling, Q4_0/Q4_1)."""
    _, gu = _qt(7, Q4_0, 2 * 256, 256)
    _, dn = _qt(8, Q4_1, 256, 256)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((3, 256), dtype=np.float32))
    xb = x.to(torch.bfloat16).double().numpy()
    w = qformats.dequant(gu, torch.bfloat16).double().numpy()
    wd = qformats.dequant(dn, torch.bfloat16).double().numpy()
    g, u = (xb @ w[:256].T).astype(np.float32), (xb @ w[256:].T).astype(np.float32)
    h = torch.from_numpy(g * (1 / (1 + np.exp(-g))) * u).to(torch.bfloat16).double().numpy()
    want = h @ wd.T
    got = ff.qffn_plain(x, gu, dn, out_dtype=torch.float32).numpy()
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()

