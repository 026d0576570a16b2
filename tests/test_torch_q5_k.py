"""The port's Q5_K slice (omni_tpu_torch) against the JAX package: the Q5_K
codec and planes (the high-bit plane qh included), the plain laws of kernel
G (`q5k_gemv`), of kernel B's Q5_K branch (`q5k_gemm`) and of kernel D's
Q5_K branch against the Pallas kernels in interpret mode, and a tiny
Q5_K_M GGUF file loaded and served greedily by both packages. Everything
here runs on the CPU; the CUDA kernels are held against their plain
versions on the card (tests/test_torch_cuda.py and chip_smoke.py)."""

from types import SimpleNamespace
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omni_tpu.cli import quantize as jax_quantize
from omni_tpu.core import GGMLType, quants
from omni_tpu.core.gguf import GGUFReader as JaxReader
from omni_tpu.kernels import dequant as jax_dequant
from omni_tpu.kernels.dequant_matmul import (qmatmul_gp_pallas, qmatmul_pallas,
                                             qmatmul_splith_pallas)
from omni_tpu.kernels.qformats import dequant_tile
from omni_tpu.kernels.qformats import load_quantized as jax_load
from omni_tpu.models import qwen3 as jq
from omni_tpu.omni.pipeline import OmniPipeline as JaxPipeline
from omni_tpu.omni.pipeline import SessionConfig as JaxSessionConfig
from omni_tpu.runtime import Context as JaxContext
from omni_tpu.runtime import SamplerParams as JaxSamplerParams
from omni_tpu.testing import write_tiny_qwen3
from omni_tpu_torch import testing_synth
from omni_tpu_torch.core import quants as port_quants
from omni_tpu_torch.core.gguf import GGUFReader
from omni_tpu_torch.kernels import dequant_matmul as dm
from omni_tpu_torch.kernels import qformats
from omni_tpu_torch.models import qwen3 as tq
from omni_tpu_torch.omni.pipeline import OmniPipeline, SessionConfig
from omni_tpu_torch.runtime import Context, SamplerParams
from test_torch_gguf import _assert_same_params
# the module's autouse fixture: no JAX compile-cache writes from this file
from test_torch_kernels import ATOL, ORDER_ATOL, RTOL, _x, no_compile_cache  # noqa: F401
from test_torch_kernels import _pair as _any_pair
from test_torch_model import JIT_LOGITS_ATOL, WordTokenizer, _np, _serve

Q5_K = GGMLType.Q5_K


def _pair(seed, n=24, k=4096):
    """(JAX Q5_K QTensor, the port's QTensor on the CPU, the blocks)."""
    return _any_pair(seed, qtype=Q5_K, n=n, k=k)


# ---------------------------------------------------------------- the codec

@pytest.mark.parametrize("n,k", [(16, 512), (24, 1280), (8, 4096)])
def test_q5k_dequant_bit_exact(n, k):
    """The port's numpy oracle, its torch dequant of the converted planes
    and the JAX dequant all equal omni_tpu's block dequantiser bit for
    bit."""
    jqt, pqt, blocks = _pair(n + k, n=n, k=k)
    ref = quants.dequantize(blocks, Q5_K, (n, k))
    np.testing.assert_array_equal(port_quants.dequantize(blocks, Q5_K, (n, k)), ref)
    np.testing.assert_array_equal(qformats.dequant(pqt).numpy(), ref)
    np.testing.assert_array_equal(np.asarray(jax_dequant(jqt)), ref)


@pytest.mark.parametrize("n,k", [(5, 256), (24, 1280), (8, 4096 + 2048)])
def test_q5k_repack_is_the_transpose_of_jax_repack(n, k):
    """The port's torch repack of the 176-byte blocks gives the transposes
    of the JAX package's planes bit for bit, the high-bit plane qh u8
    [N, K/8] included, and dequantises to the reference."""
    jqt, _, blocks = _pair(3 * n + k, n=n, k=k)
    pqt = qformats.repack(torch.from_numpy(blocks.copy()), Q5_K, (n, k))
    qformats.check_qtensor(pqt, Q5_K)
    assert set(pqt.planes()) == set(jqt.planes()) == {"q", "sc", "mn", "d", "dm", "qh"}
    assert pqt.qh.dtype == torch.uint8 and tuple(pqt.qh.shape) == (n, k // 8)
    for nm, a in pqt.planes().items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jqt, nm)).T)
    np.testing.assert_array_equal(qformats.dequant(pqt).numpy(),
                                  quants.dequantize(blocks, Q5_K, (n, k)))


def test_q5k_values_carry_the_high_bit_in_element_order():
    """Bit b of qh byte r is the fifth bit of element 8r+b; the values are
    the nibble plus 16 times that bit, in the file's element order."""
    _, pqt, blocks = _pair(11, n=3, k=512)
    vals = qformats.kquant_values(pqt).numpy()
    want = port_quants.q5k_values(blocks.reshape(-1, 176)).reshape(3, 512)
    np.testing.assert_array_equal(vals, want)
    qh = pqt.qh.numpy()
    np.testing.assert_array_equal(vals[:, 8 * 37 + 5] >> 4, (qh[:, 37] >> 5) & 1)
    assert vals.max() == 31 and 0.3 < (vals >= 16).mean() < 0.7


def test_q5k_load_policy_matches_jax():
    """A 2-D Q5_K tensor stays quantized (the JAX planes, transposed); with
    keep_quantized=False, or 1-D, it dequantises to the JAX values."""
    x = np.random.default_rng(2).standard_normal((4, 512), dtype=np.float32)
    blocks = quants.quantize(x, Q5_K)
    kept = qformats.load_quantized(blocks, Q5_K, (4, 512), device="cpu")
    assert isinstance(kept, qformats.QTensor) and kept.qh is not None
    jkept = jax_load(blocks, Q5_K, (4, 512))
    for nm, a in kept.planes().items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jkept, nm)).T)
    for shape, keep in (((4, 512), False), ((2048,), True)):
        got = qformats.load_quantized(blocks, Q5_K, shape, keep, "cpu")
        want = np.asarray(jax_load(blocks, Q5_K, shape, keep).astype(np.float32))
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_check_qtensor_wants_the_high_bit_plane():
    _, pqt, _ = _pair(1, n=4, k=512)
    qformats.check_qtensor(pqt, Q5_K)
    qh = pqt.qh
    pqt.qh = None
    with pytest.raises(ValueError, match="plane qh"):
        qformats.check_qtensor(pqt, Q5_K)
    pqt.qh = qh[:, :-1].contiguous()
    with pytest.raises(ValueError, match="plane qh"):
        qformats.check_qtensor(pqt, Q5_K)


# ------------------------------------------------------------ the kernels' laws

@pytest.mark.parametrize("k", [4096, 4096 + 2048], ids=lambda k: f"k{k}")
@pytest.mark.parametrize("m", [1, 2, 3, 8], ids=lambda m: f"m{m}")
def test_plain_q5k_gemv_matches_gp_pallas(m, k):
    """Kernel G's plain law == qmatmul_gp_pallas (interpret) for Q5_K on a
    ragged N, within tests/test_qkernels.py's tolerance and ORDER_ATOL."""
    jqt, pqt, _ = _pair(10 * m + k + 5, k=k)
    x = _x(m + 13, m, k)
    want = np.asarray(qmatmul_gp_pallas(jnp.asarray(x), jqt, block_n=16,
                                        out_dtype=jnp.float32, interpret=True))
    got = dm.q5k_gemv(torch.from_numpy(x).to(torch.bfloat16), pqt,
                      torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ORDER_ATOL)


@pytest.mark.parametrize("m", [16, 64], ids=lambda m: f"m{m}")
def test_plain_q5k_gemm_matches_splith_pallas(m):
    """q5k_gemm's plain (centered, five-bit) law ==
    qmatmul_splith_pallas (interpret) on a ragged N at K = 4096."""
    jqt, pqt, _ = _pair(10 * m + 7, k=4096)
    x = _x(m + 17, m, 4096)
    want = np.asarray(qmatmul_splith_pallas(
        jnp.asarray(x), jqt, block_m=64, block_n=16, block_k=2048,
        out_dtype=jnp.float32, interpret=True))
    got = dm.q5k_gemm(torch.from_numpy(x).to(torch.bfloat16), pqt,
                      torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ORDER_ATOL)


@pytest.mark.parametrize("m", [1, 64], ids=lambda m: f"m{m}")
def test_plain_qgemm_q5k_matches_qmatmul_pallas(m):
    """Kernel D's plain Q5_K law (uncentered: bf16(q·dl − ml), then a dot
    in f32) == qmatmul_pallas (interpret) on a ragged N at K = 1280, the
    odd-divisor shape of test_qmatmul_gp_odd_k_divisor."""
    jqt, pqt, _ = _pair(10 * m + 3, k=1280)
    x = _x(m + 19, m, 1280)
    want = np.asarray(qmatmul_pallas(jnp.asarray(x), jqt, block_m=64,
                                     block_n=16, out_dtype=jnp.float32,
                                     interpret=True))
    got = dm.qgemm(torch.from_numpy(x).to(torch.bfloat16), pqt,
                   torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=ORDER_ATOL)


def test_q5k_plain_laws_round_the_weights_as_the_reference():
    """D's plain Q5_K law rounds each weight once, f32(q·dl − ml) to bf16:
    its bf16 weights equal the JAX bf16 dequant bit for bit. B's centered
    weights differ from them, as the TPU kernels' two laws do."""
    jqt, pqt, _ = _pair(4, n=16, k=2048)
    want = np.asarray(dequant_tile(Q5_K, jqt.planes(), jnp.bfloat16)
                      .astype(jnp.float32)).T
    got = qformats.dequant(pqt, torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)
    centered, ml_res = dm.q4k_centered(pqt)
    assert not np.array_equal(centered.float().numpy(), want)
    assert ml_res.abs().max() <= 1e-6 * qformats.q4k_group_scales(pqt)[1].abs().max()


def test_q5k_guard_group_keeps_the_whole_min_in_the_residual():
    """A group with dl = 0 (sc = 0) has t = 0 in the centered law: its
    weights are 0 and the residual carries the whole min ml, as the TPU
    kernel's guard does; the law still equals the uncentered one."""
    _, pqt, _ = _pair(6, n=4, k=2048)
    pqt.sc[1, 3], pqt.mn[1, 3] = 0, 5
    w, ml_res = dm.q4k_centered(pqt)
    _, ml = qformats.q4k_group_scales(pqt)
    assert (w[1, 96:128] == 0).all() and ml_res[1, 3] == ml[1, 3] != 0
    x = torch.from_numpy(_x(2, 16, 2048)).to(torch.bfloat16)
    want = x.double() @ qformats.dequant(pqt).double().T
    got = dm.q5k_gemm(x, pqt, torch.float32).double()
    assert (got - want).abs().max() <= 1e-2 * want.abs().max()


@pytest.mark.parametrize("name,m", [("q5k_gemv", 3), ("q5k_gemm", 16), ("qgemm", 16)])
def test_chip_smoke_f64_law_is_the_q5k_kernels_law(name, m):
    """chip_smoke.py's law_f64 of G, B's Q5_K branch and D-Q5_K equals the
    plain version to f32 noise (the reference of the Q5_K_M teacher-forced
    check), and rounded to bf16 is within the kernel-vs-plain limit."""
    from chip_smoke import law_f64, limit_ratio

    _, pqt, _ = _pair(m + 9, n=40, k=2048)
    x = torch.from_numpy(_x(m, m, 2048)).to(torch.bfloat16)
    plain = getattr(dm, name + "_plain")
    want = plain(x, pqt, torch.float32)
    got = law_f64(name, x, pqt, torch.float32)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert limit_ratio(law_f64(name, x, pqt, torch.bfloat16).float(),
                       plain(x, pqt).float()) <= 1.0


def test_check_kernel_rejects_a_kernel_that_drops_the_high_bit():
    """chip_smoke.check_kernel fails a stand-in q5k_gemv whose qh plane
    reads as zeros (the fault of a missing or misplaced qh pointer: off by
    16·dl on about half the elements), and passes the plain version against
    itself, on the random high bits of testing_synth.synth_q5k."""
    from chip_smoke import check_kernel

    qt = testing_synth.synth_q5k(256, 4096, "cpu", torch.Generator().manual_seed(0))

    def standin(x, w, out_dtype):
        no_hi = qformats.QTensor(w.ggml_type, w.shape, w.q, w.sc, w.mn, w.d, w.dm,
                                 torch.zeros_like(w.qh))
        return dm.q5k_gemv_plain(x, no_hi, out_dtype)

    max_err = {}
    check_kernel("q5k_gemv", dm.q5k_gemv_plain, dm.q5k_gemv_plain, qt, "wq", 1,
                 torch.bfloat16, torch.Generator().manual_seed(3), max_err)
    with pytest.raises(SystemExit, match="disagrees"):
        check_kernel("q5k_gemv", standin, dm.q5k_gemv_plain, qt, "wq", 1,
                     torch.bfloat16, torch.Generator().manual_seed(3), max_err)


def _on_a_mocked_card(fn, *args):
    """fn(*args) with the wrappers taking the card's path and a stand-in
    library whose every entry point launches nothing and returns 0; returns
    (fn's result, the entry points called)."""
    from omni_tpu_torch.kernels import _build

    called = []

    def entry(name):
        return lambda *a: called.append(name) or 0

    lib = {name: entry(name) for entries in _build.SOURCES.values() for name in entries}
    with mock.patch.object(dm, "_on_cuda", return_value=True), \
            mock.patch.object(_build, "load", return_value=lib), \
            mock.patch.object(torch.cuda, "current_stream",
                              return_value=SimpleNamespace(cuda_stream=0)):
        return fn(*args), called


def test_launch_rejects_a_qh_plane_at_an_odd_address():
    """The kernels read qh in 16-bit words: a contiguous qh view at an odd
    storage offset is refused before any launch, with ValueError (on the
    card a misaligned load would be a sticky error of the whole context)."""
    _, pqt, _ = _pair(11, n=8, k=2048)
    flat = torch.zeros(pqt.qh.numel() + 1, dtype=torch.uint8)
    flat[1:] = pqt.qh.reshape(-1)
    pqt.qh = flat[1:].view(pqt.qh.shape)
    assert pqt.qh.is_contiguous() and pqt.qh.data_ptr() % 2 == 1
    qformats.check_qtensor(pqt, Q5_K)
    dm.reset_launches()
    for m in (1, 16):
        x = torch.from_numpy(_x(m, m, 2048)).to(torch.bfloat16)
        for wrapper in (dm.matmul, dm.qgemm):
            with pytest.raises(ValueError, match="qh must be 2-byte aligned"):
                _on_a_mocked_card(wrapper, x, pqt)
    assert not any(dm.launches.values())


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, Q5_K, GGMLType.Q6_K,
                                   GGMLType.Q8_0], ids=lambda t: t.name)
def test_qgemm_launches_count_per_format(qtype):
    """Kernel D counts each launch under "qgemm" and under its format in
    qgemm_launches; the other kernels' launches leave qgemm_launches alone,
    and reset_launches zeroes both."""
    _, pqt, _ = _any_pair(12, qtype=qtype, n=8, k=2048)
    dm.reset_launches()
    for m in (1, 16):  # the gp kernel, then B (Q4_K, Q5_K) or D
        x = torch.from_numpy(_x(m, m, 2048)).to(torch.bfloat16)
        _on_a_mocked_card(dm.matmul, x, pqt)
    x = torch.from_numpy(_x(2, 3, 2048)).to(torch.bfloat16)
    _, called = _on_a_mocked_card(dm.qgemm, x, pqt)
    assert called == [dm._QGEMM_ENTRY[qtype]]
    n_d = 1 + (qtype in (GGMLType.Q6_K, GGMLType.Q8_0))
    assert dm.launches["qgemm"] == n_d and sum(dm.launches.values()) == 3
    assert dm.qgemm_launches == {**dict.fromkeys(dm.qgemm_launches, 0),
                                 qtype.name: n_d}
    dm.reset_launches()
    assert not any(dm.launches.values()) and not any(dm.qgemm_launches.values())


# ------------------------------------------------------ the tiny GGUF file

@pytest.fixture(scope="module")
def q5km_file(tmp_path_factory):
    """The tiny Qwen3 of the JAX package's tools, quantized Q5_K_M by
    `omni-quantize`: layer 1 (of 2) gets Q6_K attn_v and ffn_down, the head
    is Q6_K, every other weight and the token embedding Q5_K."""
    d = tmp_path_factory.mktemp("q5km")
    src, dst = d / "f32.gguf", d / "q5km.gguf"
    write_tiny_qwen3(src, qtype=GGMLType.F32, n_layers=2, d_model=256,
                     n_heads=2, n_kv_heads=1, head_dim=128, d_ff=512,
                     n_vocab=512, tied_head=False)
    jax_quantize.quantize_file(str(src), str(dst), "Q5_K_M")
    return dst


def test_q5km_file_holds_13_q5k_and_3_q6k_tensors(q5km_file):
    types = [ti.ggml_type for ti in GGUFReader(q5km_file).tensors.values()]
    assert types.count(Q5_K) == 13 and types.count(GGMLType.Q6_K) == 3


def test_load_params_q5km_matches_jax(q5km_file):
    """Planes (qh included), the dequantised Q5_K embedding and the norms
    equal the JAX package's, with the Q5_K_M mix of formats."""
    tparams = tq.load_params(GGUFReader(q5km_file), device="cpu")
    _assert_same_params(jq.load_params(JaxReader(q5km_file)), tparams)
    q6 = {(i, k) for i, lp in enumerate(tparams["layers"]) for k, w in lp.items()
          if isinstance(w, qformats.QTensor) and w.ggml_type == GGMLType.Q6_K}
    assert q6 == {(1, "wv"), (1, "w_down")}
    assert tparams["layers"][0]["wv"].ggml_type == Q5_K
    assert tparams["output"].ggml_type == GGMLType.Q6_K
    assert tparams["token_embd"].dtype == torch.bfloat16


def test_greedy_turn_from_the_q5km_file_token_identical(q5km_file):
    """A 16-token greedy turn served from the tiny Q5_K_M file, loaded by
    each package's own reader and loader, emits the same tokens in both,
    omni_tpu's pipeline run op by op (jax.disable_jit).

    omni_tpu's jitted steps are no reference for token identity here: the
    first token of this turn is a near tie of omni_tpu's own, its top-2
    margin 0.0022 under the 0.040 that XLA's fused compile moves the logits
    against the same forward op by op (the noise test_torch_model.py's
    JIT_LOGITS_ATOL bounds), so the jitted turn starts on another token."""
    import jax

    jr = JaxReader(q5km_file)
    jctx = JaxContext(jq.Qwen3Config.from_gguf(jr.kv), jq.load_params(jr),
                      jq.forward, jq.embed, n_ctx=512,
                      sampler=JaxSamplerParams(greedy=True))
    jpipe = JaxPipeline(llm=jctx, tokenizer=WordTokenizer(),
                        config=JaxSessionConfig(duplex=False, use_tts=False,
                                                max_preserved_context=512))
    try:
        with jax.disable_jit():
            want = _serve(jpipe, 1)
    finally:
        jpipe.shutdown()
    tr = GGUFReader(q5km_file)
    tctx = Context(tq.Qwen3Config.from_gguf(tr.kv),
                   tq.load_params(tr, device="cpu"), tq.forward, tq.embed,
                   n_ctx=512, sampler=SamplerParams(greedy=True), device="cpu")
    tpipe = OmniPipeline(tctx, WordTokenizer(),
                         SessionConfig(max_preserved_context=512))
    got = _serve(tpipe, 1)
    assert sum(len(e["content"].split()) for e in got) >= 10
    assert got == want
    assert tctx.n_past == jctx.n_past


def test_jitted_turn_from_the_q5km_file_departs_at_a_rounding_flip(q5km_file):
    """The same turn against omni_tpu's jitted steps: the two streams are
    identical up to the first token where the port's top-2 margin is below
    the logit distance between the two (on this fixture the first token:
    the port's margin 0.013 against a distance of 0.043; omni_tpu's own
    margin there is 0.0022), a rounding flip. Both contexts, fed omni_tpu's tokens up to there, lie
    within test_torch_model's JIT_LOGITS_ATOL (the noise of omni_tpu's
    jitted steps), and each picks its own turn's token on every row."""
    from omni_tpu.runtime import Batch as JaxBatch
    from omni_tpu_torch.omni.pipeline import SIMPLEX_ASSISTANT_PROMPT
    from omni_tpu_torch.runtime import Batch

    jr, tr = JaxReader(q5km_file), GGUFReader(q5km_file)
    jcfg, jparams = jq.Qwen3Config.from_gguf(jr.kv), jq.load_params(jr)
    tcfg, tparams = tq.Qwen3Config.from_gguf(tr.kv), tq.load_params(tr, device="cpu")

    def jax_ctx():
        return JaxContext(jcfg, jparams, jq.forward, jq.embed, n_ctx=512,
                          sampler=JaxSamplerParams(greedy=True))

    def port_ctx():
        return Context(tcfg, tparams, tq.forward, tq.embed, n_ctx=512,
                       sampler=SamplerParams(greedy=True), device="cpu")

    def tokens(events):
        return [int(x) for e in events for x in e["content"].split()]

    jpipe = JaxPipeline(llm=jax_ctx(), tokenizer=WordTokenizer(),
                        config=JaxSessionConfig(duplex=False, use_tts=False,
                                                max_preserved_context=512))
    try:
        want = tokens(_serve(jpipe, 1))
    finally:
        jpipe.shutdown()
    got = tokens(_serve(OmniPipeline(port_ctx(), WordTokenizer(),
                                     SessionConfig(max_preserved_context=512)), 1))
    assert len(want) >= 10 and len(got) >= 10
    if got == want:
        return
    first = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    tok = WordTokenizer()
    feeds = [tok.encode("<|im_start|>system\nyou are a tiny test model"
                        "\n<|audio_start|>"),
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


# ------------------------------------------------- the port's synthetic files

@pytest.mark.parametrize("n_layers", [2, 36])
def test_q5km_recipe_matches_the_jax_quantizer(n_layers):
    """The port's Q5_K_M rules equal the JAX quantizer's for every tensor
    but nothing else: Q6_K head, Q5_K embedding, Q6_K attn_v and ffn_down
    on the use_more_bits layers (18 of 36 on Qwen3-8B)."""
    names = ["output.weight", "token_embd.weight"] + [
        f"blk.{i}.{t}.weight" for i in range(n_layers)
        for t in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate",
                  "ffn_up", "ffn_down")]
    got = [testing_synth.pick_type(nm, "Q5_K_M", Q5_K, n_layers) for nm in names]
    want = [jax_quantize.pick_type(nm, "Q5_K_M", Q5_K, n_layers) for nm in names]
    assert got == want and testing_synth.RECIPES["Q5_K_M"] == Q5_K
    n_q6 = got.count(GGMLType.Q6_K)
    assert n_q6 == {2: 3, 36: 37}[n_layers]
    assert got.count(Q5_K) == len(names) - n_q6


def test_write_qwen3_gguf_q5km_loads_the_same_in_both_packages(tmp_path):
    """The port's random Q5_K_M writer: read the same by both packages,
    Q5_K values over 0..31 with about half the high bits set."""
    cfg = tq.Qwen3Config(n_layers=2, d_model=256, n_heads=2, n_kv_heads=1,
                         head_dim=128, d_ff=512, n_vocab=300)
    path = tmp_path / "synth_q5km.gguf"
    types = testing_synth.write_qwen3_gguf(path, cfg, "Q5_K_M",
                                           torch.Generator().manual_seed(0))
    quant = [t for n, t in types.items() if not n.endswith("norm.weight")]
    assert quant.count(GGMLType.Q6_K) == 3 and quant.count(Q5_K) == 13
    tparams = tq.load_params(GGUFReader(path), device="cpu")
    _assert_same_params(jq.load_params(JaxReader(path)), tparams)
    w = tparams["layers"][0]["w_gate"]
    assert w.ggml_type == Q5_K
    vals = qformats.kquant_values(w)
    assert int(vals.max()) == 31 and 0.45 < (vals >= 16).float().mean() < 0.55
