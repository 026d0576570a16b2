"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips with a reason where there
is no CUDA device; run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

This file imports no JAX (the card's machine has none)."""

from unittest import mock

import pytest
import torch

from chip_smoke import (FLASH_FLOOR, FLASH_RTOL, flash_inputs, flash_law_f64,
                        flip_limit, limit_ratio)
from omni_tpu_torch.kernels import dequant_matmul as dm
from omni_tpu_torch.kernels import flash_attention as fa
from omni_tpu_torch.kernels import fused_ffn as ff
from omni_tpu_torch.kernels import qformats
from omni_tpu_torch.models import qwen3
from omni_tpu_torch.runtime import Batch, Context, SamplerParams
from omni_tpu_torch.core.dtypes import GGMLType
from omni_tpu_torch.core.gguf import GGUFReader
from omni_tpu_torch.testing_synth import (synth_q4k, synth_q5k, synth_q6k,
                                          synth_q8_0, synth_quant,
                                          synth_qwen3_dense_params,
                                          synth_qwen3_params, write_qwen3_gguf)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    return torch.device("cuda")


CASES = [("q4k_gemv", synth_q4k, 1, 6144), ("q4k_gemv", synth_q4k, 8, 6144),
         ("q4k_gemm", synth_q4k, 9, 6144), ("q4k_gemm", synth_q4k, 130, 6144),
         ("q6k_gemv", synth_q6k, 1, 6144), ("q6k_gemv", synth_q6k, 8, 6144),
         ("qgemm", synth_q6k, 1, 6144), ("qgemm", synth_q6k, 130, 6144),
         ("qgemm", synth_q4k, 3, 1280), ("qgemm", synth_q4k, 64, 1280),
         ("q8_0_gemv", synth_q8_0, 1, 4096), ("q8_0_gemv", synth_q8_0, 8, 4096),
         ("q8_0_gemv", synth_q8_0, 3, 1248), ("qgemm", synth_q8_0, 1, 4096),
         ("qgemm", synth_q8_0, 130, 4096), ("qgemm", synth_q8_0, 64, 1248),
         ("q5k_gemv", synth_q5k, 1, 6144), ("q5k_gemv", synth_q5k, 8, 6144),
         ("q5k_gemm", synth_q5k, 9, 6144), ("q5k_gemm", synth_q5k, 130, 6144),
         ("qgemm", synth_q5k, 3, 1280), ("qgemm", synth_q5k, 64, 1280)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,synth,m,k", CASES,
                         ids=[f"{c[0]}-{c[1].__name__[-3:]}-m{c[2]}-k{c[3]}"
                              for c in CASES])
def test_cuda_kernel_matches_plain(card, kernel, synth, m, k):
    """Each kernel against its plain version on a ragged N (1000 rows), at
    a K of whole blocks (1248 = 39 Q8_0 blocks: a ragged last K step of
    kernel D) and both output dtypes; each launch is counted once."""
    gen = torch.Generator(device=card).manual_seed(m)
    qt = synth(1000, k, card, gen)
    x = torch.randn((m, k), device=card, generator=gen).to(torch.bfloat16)
    wrapper = getattr(dm, kernel)
    plain = getattr(dm, kernel + "_plain")
    for out_dtype in (torch.bfloat16, torch.float32):
        n0 = dm.launches[kernel]
        got = wrapper(x, qt, out_dtype).float()
        want = plain(x, qt, out_dtype).float()
        torch.cuda.synchronize()
        assert dm.launches[kernel] == n0 + 1
        # one law, f32 sums in another order: chip_smoke.py's limit
        assert torch.isfinite(got).all() and limit_ratio(got, want) <= 1.0


@pytest.mark.cuda
def test_cuda_forward_goes_through_both_kernels(card):
    """A small Q4_K Qwen3 (K multiples of 2048) prefills and decodes on the
    card through both kernels, with finite logits."""
    cfg = qwen3.Qwen3Config(n_layers=2, d_model=2048, n_heads=16,
                            n_kv_heads=4, head_dim=128, d_ff=4096,
                            n_vocab=1000)
    params = synth_qwen3_params(cfg, card,
                                torch.Generator(device=card).manual_seed(0))
    ctx = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=256,
                  sampler=SamplerParams(greedy=True), device=card)
    dm.reset_launches()
    logits = ctx.prefill(list(range(20)))  # one ubatch of 32 rows: kernel B
    assert torch.isfinite(logits).all()
    for _ in range(3):  # single tokens: kernel A
        tok = int(torch.argmax(logits))
        logits, _ = ctx.decode(Batch(tokens=[tok]))
        logits = logits[0]
        assert torch.isfinite(logits).all()
    per_step = 4 * cfg.n_layers + 1
    assert dm.launches == {**dict.fromkeys(dm.launches, 0),
                           "q4k_gemm": per_step, "q4k_gemv": 3 * per_step}


@pytest.mark.cuda
def test_cuda_q4km_gguf_goes_through_all_four_kernels(card, tmp_path):
    """A small Q4_K_M Qwen3 (K multiples of 2048) written and loaded as a
    GGUF prefills and decodes on the card: Q4_K through kernels A and B,
    Q6_K through C and D, with finite logits."""
    cfg = qwen3.Qwen3Config(n_layers=8, d_model=2048, n_heads=16,
                            n_kv_heads=4, head_dim=128, d_ff=4096,
                            n_vocab=1000)
    path = tmp_path / "q4km.gguf"
    write_qwen3_gguf(path, cfg, "Q4_K_M", torch.Generator(device=card).manual_seed(0))
    params = qwen3.load_params(GGUFReader(path), device=card)
    ctx = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=256,
                  sampler=SamplerParams(greedy=True), device=card)
    dm.reset_launches()
    logits = ctx.prefill(list(range(20)))  # one ubatch of 32 rows: B and D
    assert torch.isfinite(logits).all()
    tok = int(torch.argmax(logits))
    logits, _ = ctx.decode(Batch(tokens=[tok]))  # one token: A and C
    assert torch.isfinite(logits).all()
    # layers 0, 3, 6 and 7 of 8 have Q6_K attn_v and ffn_down, and the
    # head is Q6_K: 9 Q6_K and 7 * 8 + 1 - 9 = 48 Q4_K weights
    assert dm.launches == {**dict.fromkeys(dm.launches, 0), "q4k_gemm": 48,
                           "qgemm": 9, "q4k_gemv": 48, "q6k_gemv": 9}


_SMALL = dict(n_layers=2, d_model=2048, n_heads=16, n_kv_heads=4, head_dim=128,
              d_ff=4096, n_vocab=1000)


@pytest.mark.cuda
def test_cuda_q8_0_gguf_goes_through_kernels_e_and_d(card, tmp_path):
    """A small Q8_0 Qwen3 GGUF (every weight Q8_0, the head too) prefills
    through kernel D and decodes through kernel E, with finite logits."""
    cfg = qwen3.Qwen3Config(**_SMALL)
    path = tmp_path / "q8_0.gguf"
    write_qwen3_gguf(path, cfg, "Q8_0", torch.Generator(device=card).manual_seed(0))
    params = qwen3.load_params(GGUFReader(path), device=card)
    ctx = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=256,
                  sampler=SamplerParams(greedy=True), device=card)
    dm.reset_launches()
    logits = ctx.prefill(list(range(20)))
    assert torch.isfinite(logits).all()
    logits, _ = ctx.decode(Batch(tokens=[int(torch.argmax(logits))]))
    assert torch.isfinite(logits).all()
    n = 7 * cfg.n_layers + 1
    assert dm.launches == {**dict.fromkeys(dm.launches, 0), "qgemm": n,
                           "q8_0_gemv": n}


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,kernel", [(1, 4096, "q5k_gemv"), (64, 4096, "q5k_gemm"),
                                        (1, 1280, "qgemm"), (64, 1280, "qgemm")])
def test_cuda_matmul_routes_q5k_to_its_kernel(card, m, k, kernel):
    """`matmul` on a Q5_K weight on the card raises nothing and counts one
    launch of the kernel the JAX dispatcher's order picks: G at M = 1, B's
    Q5_K branch at M = 64, D's Q5_K branch where K % 2048 != 0 (counted
    under its format too)."""
    gen = torch.Generator(device=card).manual_seed(m + k)
    qt = synth_q5k(300, k, card, gen)
    x = torch.randn((m, k), device=card, generator=gen)
    dm.reset_launches()
    got = dm.matmul(x, qt).float()
    torch.cuda.synchronize()
    assert dm.launches == {**dict.fromkeys(dm.launches, 0), kernel: 1}
    assert dm.qgemm_launches == {**dict.fromkeys(dm.qgemm_launches, 0),
                                 "Q5_K": int(kernel == "qgemm")}
    want = getattr(dm, kernel + "_plain")(x.bfloat16(), qt).float()
    assert torch.isfinite(got).all() and limit_ratio(got, want) <= 1.0


@pytest.mark.cuda
def test_cuda_q5km_gguf_goes_through_g_b_c_and_d(card, tmp_path):
    """A small Q5_K_M Qwen3 (K multiples of 2048) written and loaded as a
    GGUF prefills and decodes on the card: Q5_K through kernel G and B's
    Q5_K branch, Q6_K through C and D, with finite logits."""
    cfg = qwen3.Qwen3Config(**{**_SMALL, "n_layers": 8})
    path = tmp_path / "q5km.gguf"
    write_qwen3_gguf(path, cfg, "Q5_K_M", torch.Generator(device=card).manual_seed(0))
    params = qwen3.load_params(GGUFReader(path), device=card)
    ctx = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=256,
                  sampler=SamplerParams(greedy=True), device=card)
    dm.reset_launches()
    logits = ctx.prefill(list(range(20)))
    assert torch.isfinite(logits).all()
    logits, _ = ctx.decode(Batch(tokens=[int(torch.argmax(logits))]))
    assert torch.isfinite(logits).all()
    # as the Q4_K_M file: 9 Q6_K and 48 Q5_K weights
    assert dm.launches == {**dict.fromkeys(dm.launches, 0), "qgemm": 9,
                           "q5k_gemv": 48, "q5k_gemm": 48, "q6k_gemv": 9}


LEGACY_CASES = [(t, m, k) for t in ("Q4_0", "Q4_1", "Q5_0", "Q5_1")
                for m, k in ((1, 4096), (8, 1280), (9, 1280), (130, 4096))]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,m,k", LEGACY_CASES,
                         ids=[f"{t}-m{m}-k{k}" for t, m, k in LEGACY_CASES])
def test_cuda_legacy_kernel_matches_plain(card, fmt, m, k):
    """Kernel A's (M <= 8) and B's (M > 8) Q4_0, Q4_1, Q5_0 and Q5_1
    branches, through `matmul`, against their plain versions on a ragged N
    (1000 rows), at K = 4096 and at K = 1280 (no multiple of 2048: the
    legacy formats' granule is 256), both output dtypes, on
    testing_synth's blocks (random high bits, m of both signs, some d = 0
    blocks); one launch counted per call, none of kernel D."""
    qtype = GGMLType[fmt]
    gen = torch.Generator(device=card).manual_seed(m + k)
    qt = synth_quant(qtype, 1000, k, card, gen)
    x = torch.randn((m, k), device=card, generator=gen).to(torch.bfloat16)
    kernel = (dm.HALVES_GEMV if m <= 8 else dm.HALVES_GEMM)[qtype]
    plain = getattr(dm, kernel + "_plain")
    for out_dtype in (torch.bfloat16, torch.float32):
        dm.reset_launches()
        got = dm.matmul(x, qt, out_dtype).float()
        want = plain(x, qt, out_dtype).float()
        torch.cuda.synchronize()
        assert dm.launches == {**dict.fromkeys(dm.launches, 0), kernel: 1}
        assert torch.isfinite(got).all() and limit_ratio(got, want) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", ["Q4_0", "Q5_0"])
def test_cuda_legacy_gguf_goes_through_a_b_c_and_d(card, tmp_path, recipe):
    """A small Q4_0 (Q5_0) Qwen3 in the importance-matrix layout (8 layers:
    layer 0's ffn_down Q4_1 / Q5_1, the head Q6_K), written and loaded as a
    GGUF, prefills and decodes on the card: the legacy weights through
    kernel A's and B's branches, the head through C and D, finite
    logits."""
    cfg = qwen3.Qwen3Config(**{**_SMALL, "n_layers": 8})
    path = tmp_path / f"{recipe}.gguf"
    write_qwen3_gguf(path, cfg, recipe, torch.Generator(device=card).manual_seed(0),
                     imatrix=True)
    params = qwen3.load_params(GGUFReader(path), device=card)
    ctx = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=256,
                  sampler=SamplerParams(greedy=True), device=card)
    dm.reset_launches()
    logits = ctx.prefill(list(range(20)))
    assert torch.isfinite(logits).all()
    logits, _ = ctx.decode(Batch(tokens=[int(torch.argmax(logits))]))
    assert torch.isfinite(logits).all()
    low, one = recipe.lower(), recipe.lower()[:3] + "1"
    assert dm.launches == {**dict.fromkeys(dm.launches, 0), "qgemm": 1, "q6k_gemv": 1,
                           f"{low}_gemv": 55, f"{low}_gemm": 55,
                           f"{one}_gemv": 1, f"{one}_gemm": 1}


CODEBOOK_CASES = [(t, m, k) for t in ("IQ4_NL", "IQ4_XS", "MXFP4")
                  for m, k in ((1, 4096), (8, 2048), (9, 4096), (130, 1280))] + [
    ("IQ4_NL", 1, 1056), ("MXFP4", 3, 1056), ("IQ4_XS", 1, 1280)]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,m,k", CODEBOOK_CASES,
                         ids=[f"{t}-m{m}-k{k}" for t, m, k in CODEBOOK_CASES])
def test_cuda_codebook_kernel_matches_plain(card, fmt, m, k):
    """Kernel E's `iq4_nl_gemv`, `iq4_xs_gemv` and `mxfp4_gemv` (M <= 8 with
    K % 256, IQ4_XS K % 2048) and kernel D's IQ4_NL, IQ4_XS and MXFP4
    branches (M > 8, and IQ4_NL/MXFP4 at K = 1056 = 33 blocks, IQ4_XS at
    K = 1280, at any M), through `matmul`, against their plain versions on
    a ragged N (1000 rows), both output dtypes, on testing_synth's blocks;
    one launch counted per call, under the kernel's name (D's also under its
    format); a repeat launch bit-identical."""
    qtype = GGMLType[fmt]
    gen = torch.Generator(device=card).manual_seed(m + k)
    qt = synth_quant(qtype, 1000, k, card, gen)
    x = torch.randn((m, k), device=card, generator=gen).to(torch.bfloat16)
    kernel = dm.kernel_for(m, qt).__name__
    assert kernel == (dm.CODEBOOK_GEMV[qtype] if m <= 8 and k % dm.GP_MIN_K[qtype] == 0
                      else "qgemm")
    plain = getattr(dm, kernel + "_plain")
    for out_dtype in (torch.bfloat16, torch.float32):
        dm.reset_launches()
        got = dm.matmul(x, qt, out_dtype).float()
        want = plain(x, qt, out_dtype).float()
        torch.cuda.synchronize()
        assert dm.launches == {**dict.fromkeys(dm.launches, 0), kernel: 1}
        if kernel == "qgemm":
            assert dm.qgemm_launches[fmt] == 1
        assert torch.isfinite(got).all() and limit_ratio(got, want) <= 1.0
        # every sum is taken in a fixed order: a repeat launch gives the same bits
        assert torch.equal(dm.matmul(x, qt, out_dtype).float(), got)


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", ["IQ4_NL", "IQ4_XS", "MXFP4"])
def test_cuda_codebook_gguf_goes_through_e_c_and_d(card, tmp_path, recipe):
    """A small IQ4_NL (IQ4_XS, MXFP4) Qwen3 (8 layers, K multiples of 2048),
    written and loaded as a GGUF, prefills and decodes on the card: the
    layer weights through kernel E's entry and D's branch of the format,
    the Q6_K head through C and D, finite logits."""
    cfg = qwen3.Qwen3Config(**{**_SMALL, "n_layers": 8})
    path = tmp_path / f"{recipe}.gguf"
    write_qwen3_gguf(path, cfg, recipe, torch.Generator(device=card).manual_seed(0))
    params = qwen3.load_params(GGUFReader(path), device=card)
    ctx = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=256,
                  sampler=SamplerParams(greedy=True), device=card)
    dm.reset_launches()
    logits = ctx.prefill(list(range(20)))
    assert torch.isfinite(logits).all()
    logits, _ = ctx.decode(Batch(tokens=[int(torch.argmax(logits))]))
    assert torch.isfinite(logits).all()
    assert dm.launches == {**dict.fromkeys(dm.launches, 0), "qgemm": 57,
                           "q6k_gemv": 1, f"{recipe.lower()}_gemv": 56}
    assert dm.qgemm_launches == {**dict.fromkeys(dm.qgemm_launches, 0),
                                 recipe: 56, "Q6_K": 1}


LOWBIT_CASES = [(t, m, k) for t in ("Q2_K", "Q3_K")
                for m, k in ((1, 4096), (3, 6144), (8, 2048), (9, 4096), (130, 1280))] + [
    ("Q2_K", 1, 1280), ("Q3_K", 8, 1280)]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,m,k", LOWBIT_CASES,
                         ids=[f"{t}-m{m}-k{k}" for t, m, k in LOWBIT_CASES])
def test_cuda_lowbit_kernel_matches_plain(card, fmt, m, k):
    """Kernel H's `q2k_gemv` and `q3k_gemv` (M <= 8, K % 2048) and kernel
    D's Q2_K and Q3_K branches (M > 8, and K = 1280 at any M), through
    `matmul`, against their plain versions on a ragged N (1000 rows), both
    output dtypes, on testing_synth's blocks (every scale, min and high
    bit random); one launch counted per call, under the kernel's name
    (D's also under its format)."""
    qtype = GGMLType[fmt]
    gen = torch.Generator(device=card).manual_seed(m + k)
    qt = synth_quant(qtype, 1000, k, card, gen)
    x = torch.randn((m, k), device=card, generator=gen).to(torch.bfloat16)
    kernel = dm.kernel_for(m, qt).__name__
    assert kernel == (dm.LOWBIT_GEMV[qtype] if m <= 8 and k % 2048 == 0 else "qgemm")
    plain = getattr(dm, kernel + "_plain")
    for out_dtype in (torch.bfloat16, torch.float32):
        dm.reset_launches()
        got = dm.matmul(x, qt, out_dtype).float()
        want = plain(x, qt, out_dtype).float()
        torch.cuda.synchronize()
        assert dm.launches == {**dict.fromkeys(dm.launches, 0), kernel: 1}
        if kernel == "qgemm":
            assert dm.qgemm_launches[fmt] == 1
        assert torch.isfinite(got).all() and limit_ratio(got, want) <= 1.0
        # every sum is taken in a fixed order: a repeat launch gives the same bits
        assert torch.equal(dm.matmul(x, qt, out_dtype).float(), got)


SWITCHED_CASES = [(t, m) for t in ("Q4_0", "Q4_1", "Q5_0", "Q5_1") for m in (1, 8, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,m", SWITCHED_CASES,
                         ids=[f"{t}-m{m}" for t, m in SWITCHED_CASES])
def test_cuda_switched_legacy_goes_through_d(card, fmt, m):
    """With the gp and sh routes off (OMNI_GP_DECODE=0, OMNI_SH_PREFILL=0)
    a legacy weight goes through kernel D's branch of its format at every
    M, against D's plain version (dequant_tile's bf16 weights), both output
    dtypes; one launch of D counted per call."""
    qtype = GGMLType[fmt]
    gen = torch.Generator(device=card).manual_seed(m)
    qt = synth_quant(qtype, 1000, 4096, card, gen)
    x = torch.randn((m, 4096), device=card, generator=gen).to(torch.bfloat16)
    saved = dm.GP_DECODE, dm.SH_PREFILL
    dm.GP_DECODE = dm.SH_PREFILL = False
    try:
        for out_dtype in (torch.bfloat16, torch.float32):
            dm.reset_launches()
            got = dm.matmul(x, qt, out_dtype).float()
            want = dm.qgemm_plain(x, qt, out_dtype).float()
            torch.cuda.synchronize()
            assert dm.launches == {**dict.fromkeys(dm.launches, 0), "qgemm": 1}
            assert dm.qgemm_launches[fmt] == 1
            assert torch.isfinite(got).all() and limit_ratio(got, want) <= 1.0
    finally:
        dm.GP_DECODE, dm.SH_PREFILL = saved


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", ["Q2_K", "Q3_K"])
def test_cuda_lowbit_gguf_goes_through_h_c_and_d(card, tmp_path, recipe):
    """A small Q2_K (Q3_K) Qwen3 (8 layers, K multiples of 2048), written
    and loaded as a GGUF, prefills and decodes on the card: the layer
    weights through kernel H's entry and D's branch of the format, the Q6_K
    head through C and D, finite logits."""
    cfg = qwen3.Qwen3Config(**{**_SMALL, "n_layers": 8})
    path = tmp_path / f"{recipe}.gguf"
    write_qwen3_gguf(path, cfg, recipe, torch.Generator(device=card).manual_seed(0))
    params = qwen3.load_params(GGUFReader(path), device=card)
    ctx = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=256,
                  sampler=SamplerParams(greedy=True), device=card)
    dm.reset_launches()
    logits = ctx.prefill(list(range(20)))
    assert torch.isfinite(logits).all()
    logits, _ = ctx.decode(Batch(tokens=[int(torch.argmax(logits))]))
    assert torch.isfinite(logits).all()
    assert dm.launches == {**dict.fromkeys(dm.launches, 0), "qgemm": 57,
                           "q6k_gemv": 1, dm.LOWBIT_GEMV[GGMLType[recipe]]: 56}
    assert dm.qgemm_launches == {**dict.fromkeys(dm.qgemm_launches, 0),
                                 recipe: 56, "Q6_K": 1}


@pytest.mark.cuda
def test_cuda_dense_dot_matches_the_widened_product(card):
    """The dense dot on the card (bf16 operands, f32 outputs, K split)
    equals the widened-f32 product within chip_smoke.py's limit, at both
    output dtypes, rounds no more bf16 outputs otherwise than the f64 law
    than flip_limit allows, and a dense model's forward launches no
    hand-written kernel."""
    gen = torch.Generator(device=card).manual_seed(0)
    w = (torch.randn((1000, 4096), device=card, generator=gen) * 0.025).bfloat16()
    for m in (1, 64):
        x = torch.randn((m, 4096), device=card, generator=gen).bfloat16()
        for out_dtype in (torch.bfloat16, torch.float32):
            got = dm.matmul(x, w, out_dtype)
            want = dm.dense_matmul_plain(x, w, out_dtype)
            assert got.dtype == out_dtype
            assert limit_ratio(got.float(), want.float()) <= 1.0
        exact = (x.double() @ w.double().T).bfloat16()
        got, want = dm.matmul(x, w), dm.dense_matmul_plain(x, w)
        share = [(a != exact).float().mean().item() for a in (got, want)]
        assert share[0] <= flip_limit(share[1], got.numel()), share
    cfg = qwen3.Qwen3Config(**_SMALL)
    params = synth_qwen3_dense_params(cfg, card, gen)
    ctx = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=256,
                  sampler=SamplerParams(greedy=True), device=card)
    dm.reset_launches()
    logits = ctx.prefill(list(range(20)))
    logits, _ = ctx.decode(Batch(tokens=[int(torch.argmax(logits))]))
    assert torch.isfinite(logits).all()
    assert not any(dm.launches.values())


FLASH_CASES = [(bits, t, s, heads) for bits in (16, 8, 4)
               for t, s, heads in ((1, 1000, (32, 8, 128)), (5, 300, (32, 8, 128)),
                                   (64, 2048, (32, 8, 128)), (3, 777, (8, 2, 64)),
                                   (2, 1000, (32, 8, 128)), (3, 1000, (32, 8, 128)),
                                   (64, 2000, (32, 8, 128)))]


@pytest.mark.cuda
@pytest.mark.parametrize("bits,t,s,heads", FLASH_CASES,
                         ids=[f"{b}bit-t{t}-s{s}-d{h[2]}" for b, t, s, h in FLASH_CASES])
def test_cuda_flash_matches_plain(card, bits, t, s, heads):
    """Kernel F against its plain version within chip_smoke.py's limit
    (2**-7 of sum p|v| from the f64 law: the two round p against other
    running maxima), finite where a row is masked everywhere, at S that
    are no multiple of 512 or of the kernel's 64-cell tile, at D = 64, and
    on each side of the regime boundary (T = 2 and 3 at G = 4: 8 and 12
    rows per head; 12 and 20 rows are no multiple of 16); one launch
    counted per call."""
    gen = torch.Generator(device=card).manual_seed(t + s)
    args = flash_inputs(bits, t, s, card, gen, heads)
    name = "flash_decode4" if bits == 4 else "flash_decode"
    n0 = fa.launches[name]
    got = fa.flash_decode(*args)
    want = fa.flash_decode_plain(*args)
    exact, exact_abs = flash_law_f64(*args, with_abs=True)
    torch.cuda.synchronize()
    assert fa.launches[name] == n0 + 1
    limit = FLASH_RTOL * exact_abs + FLASH_FLOOR * exact_abs.max()
    assert torch.isfinite(got).all() and ((got - want).abs() <= limit).all()


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 64])
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_cuda_flash_in_a_cuda_graph(card, bits, t):
    """One kernel F call over 2,048 cells captured in a CUDA graph (after a
    warm call that makes the arrival counters) replays to the eager call's
    bits, twice, in both regimes: the splits' partials are merged in split
    order, at decode by whichever split arrives last, which leaves its
    counter at zero, at prefill by a second launch. Two eager calls are
    bit-identical too."""
    gen = torch.Generator(device=card).manual_seed(bits + t)
    args = flash_inputs(bits, t, 2048, card, gen)
    plan = fa.split_plan(t * 4, 8, 2048)
    assert plan.nsplit > 1 and plan.regime == ("decode" if t == 1 else "prefill")
    first = fa.flash_decode(*args)
    again = fa.flash_decode(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fa.flash_decode(*args)
    torch.cuda.current_stream().wait_stream(side)
    counters = fa.counters(first.device, 0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fa.flash_decode(*args)
    graph.replay()
    torch.cuda.synchronize()
    replayed = got.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert fa.counters(first.device, 0) is counters and not counters.any()
    assert torch.equal(first, again)
    assert torch.equal(replayed, first) and torch.equal(got, first)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype,flash", [("q8_0", "flash_decode"),
                                            ("q4_0", "flash_decode4")])
def test_cuda_quantized_kv_forward_goes_through_flash(card, kv_dtype, flash):
    """A small Q4_K Qwen3 over a quantized KV cache prefills and decodes on
    the card with every layer's attention in kernel F, finite logits within
    chip_smoke.py's LOGITS_REL_TOL of max|logit| of the same forward with
    the plain flash law."""
    from chip_smoke import LOGITS_REL_TOL, matmuls_by

    cfg = qwen3.Qwen3Config(**_SMALL)
    params = synth_qwen3_params(cfg, card, torch.Generator(device=card).manual_seed(0))

    def run():
        ctx = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=256,
                      sampler=SamplerParams(greedy=True), device=card,
                      kv_dtype=kv_dtype)
        first = ctx.prefill(list(range(20)))
        nxt, _ = ctx.decode(Batch(tokens=[int(torch.argmax(first))]))
        return torch.stack([first, nxt[0]]).float()

    fa.reset_launches()
    got = run()
    assert fa.launches == {"flash_decode": 0, "flash_decode4": 0,
                           flash: 2 * cfg.n_layers}
    with matmuls_by(qwen3, dm, lambda name, x, w, o: getattr(dm, name)(x, w, o),
                    fa.flash_decode_plain):
        want = run()
    assert torch.isfinite(got).all()
    # the same matmul kernels on both sides: only p's bf16 roundings differ
    assert (got - want).abs().max() <= LOGITS_REL_TOL * want.abs().max()


# kernel I: every same-format pair and the four mixed pairs of the served
# files, at a K of whole 256-superblocks (1024) or, where both formats take
# whole 32-blocks, a ragged K step and N tile (1056); F = 768 (three chunks),
# and F = 800 (a ragged last chunk) for Q8_0/Q8_0
_Q = [t.name for t in qformats.QUANTIZED]
QFFN_PAIRS = [(t, t) for t in _Q] + [("Q4_K", "Q6_K"), ("Q5_K", "Q6_K"),
                                     ("Q4_0", "Q4_1"), ("Q5_0", "Q5_1")]
QFFN_CASES = [(g, d, m) for g, d in QFFN_PAIRS for m in (1, 8, 9, 64, 37)]


def _ffn_weights(card, gen, t_gu, t_dn, k, f):
    return (synth_quant(GGMLType[t_gu], 2 * f, k, card, gen),
            synth_quant(GGMLType[t_dn], k, f, card, gen))


@pytest.mark.cuda
@pytest.mark.parametrize("t_gu,t_dn,m", QFFN_CASES,
                         ids=[f"{g}-{d}-m{m}" for g, d, m in QFFN_CASES])
def test_cuda_qffn_matches_plain(card, t_gu, t_dn, m):
    """Kernel I against its plain law, both output dtypes and both
    activations, in both regimes (M <= 8 the register path, M = 9 the
    first mainloop M); a repeat launch on the same inputs is bit-identical
    (every sum is taken in a fixed order); each call counts one launch,
    under its format pair."""
    int8 = all(t in ("Q8_0", "IQ4_NL", "MXFP4") for t in (t_gu, t_dn))
    k = 1056 if int8 else 1024
    gen = torch.Generator(device=card).manual_seed(m)
    gu, dn = _ffn_weights(card, gen, t_gu, t_dn, k, 768)
    x = torch.randn((m, k), device=card, generator=gen).to(torch.bfloat16)
    ff.reset_launches()
    for act, out_dtype in (("silu", torch.bfloat16), ("gelu_tanh", torch.float32)):
        got = ff.qffn(x, gu, dn, act, out_dtype)
        again = ff.qffn(x, gu, dn, act, out_dtype)
        want = ff.qffn_plain(x, gu, dn, act, out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert torch.isfinite(got).all() and limit_ratio(got.float(), want.float()) <= 1.0
    assert ff.launches == {"qffn": 4} and ff.qffn_launches == {f"{t_gu}/{t_dn}": 4}


@pytest.mark.cuda
def test_cuda_qffn_ragged_chunk(card):
    """F = 800 (Q8_0/Q8_0): the down weight's K steps are ragged (the last
    holds 32 columns, the rest staged as zeros on the mainloop, past the
    row's chunks on the register path)."""
    gen = torch.Generator(device=card).manual_seed(3)
    gu, dn = _ffn_weights(card, gen, "Q8_0", "Q8_0", 1056, 800)
    for m in (1, 9, 64):
        x = torch.randn((m, 1056), device=card, generator=gen).to(torch.bfloat16)
        got = ff.qffn(x, gu, dn, out_dtype=torch.float32)
        want = ff.qffn_plain(x, gu, dn, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and limit_ratio(got, want) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 64])
def test_cuda_qffn_in_a_cuda_graph(card, m):
    """One `qffn` call captured in a CUDA graph (after a warm call that
    makes its workspace) replays to the eager call's bits, in both
    regimes; the capture allocates no new workspace."""
    gen = torch.Generator(device=card).manual_seed(m)
    gu, dn = _ffn_weights(card, gen, "Q4_K", "Q6_K", 1024, 768)
    x = torch.randn((m, 1024), device=card, generator=gen).to(torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        want = ff.qffn(x, gu, dn)
    torch.cuda.current_stream().wait_stream(side)
    n_ws = len(ff._workspace)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = ff.qffn(x, gu, dn)
    graph.replay()
    torch.cuda.synchronize()
    assert len(ff._workspace) == n_ws and torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_qffn_build_failure_raises(card):
    """A CUDA `qffn` whose kernel does not build raises; it never runs the
    plain version."""
    from unittest import mock

    from omni_tpu_torch.kernels import _build

    gen = torch.Generator(device=card).manual_seed(0)
    gu, dn = _ffn_weights(card, gen, "Q4_K", "Q6_K", 1024, 256)
    with mock.patch.object(_build, "load", side_effect=RuntimeError("nvcc failed")), \
            mock.patch.object(ff, "qffn_plain") as plain:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            ff.qffn(torch.zeros((1, 1024), device=card), gu, dn)
    assert not plain.called


@pytest.mark.cuda
@pytest.mark.parametrize("fused_ffn", [False, True], ids=["switch-off", "switch-on"])
def test_cuda_fused_ffn_switch_routes_the_ffn(card, fused_ffn):
    """A small fused Q4_K Qwen3 on the card: with `qwen3.FUSED_FFN` (the
    JAX package's OMNI_FUSED_FFN=1) every layer's FFN is one launch of
    kernel I and only wqkv, wo and the head go through A or B; with it off
    the launches are those of the unfused composition, none of kernel I.
    The logits are finite, and the same kernel I workspace serves every
    decode step."""
    from unittest import mock

    cfg = qwen3.Qwen3Config(**_SMALL)
    params = synth_qwen3_params(cfg, card, torch.Generator(device=card).manual_seed(0))
    with mock.patch.object(qwen3, "FUSED_FFN", fused_ffn):
        ctx = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=256,
                      sampler=SamplerParams(greedy=True), device=card)
        dm.reset_launches()
        ff.reset_launches()
        logits = ctx.prefill(list(range(20)))  # one ubatch of 32 rows
        assert torch.isfinite(logits).all()
        n_ws = len(ff._workspace)
        for _ in range(3):
            logits, _ = ctx.decode(Batch(tokens=[int(torch.argmax(logits))]))
            logits = logits[0]
            assert torch.isfinite(logits).all()
    per = (2 if fused_ffn else 4) * cfg.n_layers + 1
    assert dm.launches == {**dict.fromkeys(dm.launches, 0),
                           "q4k_gemm": per, "q4k_gemv": 3 * per}
    n_ffn = 4 * cfg.n_layers if fused_ffn else 0
    assert ff.launches == {"qffn": n_ffn}
    assert ff.qffn_launches == ({"Q4_K/Q4_K": n_ffn} if fused_ffn else {})
    assert len(ff._workspace) <= n_ws + 1  # the decode rows' one workspace


# kernel B's six entries and kernel D's thirteen (the mainloop of
# csrc/qmma.cuh), each at a K of whole blocks but no multiple of 2048:
# 1280 (five steps), 1248 for the int8-plane formats (a ragged fifth step)
GEMM_ENTRIES = ([(dm.HALVES_GEMM[t], t) for t in dm.HALVES_GEMM]
                + [("qgemm", t) for t in dm._QGEMM_ENTRY])


def _gemm_k(fmt):
    return 1248 if qformats.tile_granule(fmt) == 32 else 1280


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 3], ids=lambda s: f"splits{s}")
@pytest.mark.parametrize("name,fmt", GEMM_ENTRIES,
                         ids=[f"{nm}-{t.name}" for nm, t in GEMM_ENTRIES])
def test_cuda_gemm_matches_plain_at_forced_splits(card, name, fmt, splits):
    """Kernels B and D with the split count forced to 1 (stored from the
    registers) and to 3 (uneven step ranges, partials summed in order), at
    ragged M = 9, 65 and 200 on a ragged N (1000 rows), both output dtypes,
    against their plain versions within chip_smoke.py's limit; a repeat
    launch gives the same bits."""
    k = _gemm_k(fmt)
    gen = torch.Generator(device=card).manual_seed(k + splits)
    qt = synth_quant(fmt, 1000, k, card, gen)
    wrapper, plain = getattr(dm, name), getattr(dm, name + "_plain")
    with mock.patch.object(dm, "gemm_splits", return_value=splits):
        for m in (9, 65, 200):
            x = torch.randn((m, k), device=card, generator=gen).to(torch.bfloat16)
            for out_dtype in (torch.bfloat16, torch.float32):
                got = wrapper(x, qt, out_dtype)
                again = wrapper(x, qt, out_dtype)
                want = plain(x, qt, out_dtype).float()
                torch.cuda.synchronize()
                assert torch.equal(got, again)
                got = got.float()
                assert torch.isfinite(got).all() and limit_ratio(got, want) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("name,fmt,k", [("q4k_gemm", GGMLType.Q4_K, 4096),
                                        ("q5k_gemm", GGMLType.Q5_K, 1280),
                                        ("qgemm", GGMLType.Q8_0, 4096),
                                        ("qgemm", GGMLType.Q6_K, 4096)])
def test_cuda_gemm_in_a_cuda_graph(card, name, fmt, k):
    """One launch of kernel B or D captured in a CUDA graph (split K: the
    workspace is made inside the capture) and replayed on new x gives the
    bits of an eager launch on that x."""
    gen = torch.Generator(device=card).manual_seed(k)
    qt = synth_quant(fmt, 1024, k, card, gen)
    wrapper = getattr(dm, name)
    assert dm.gemm_splits(64, 1024, k, fmt) > 1
    x = torch.randn((64, k), device=card, generator=gen).to(torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up (build, attributes) off the capture
        wrapper(x, qt)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = wrapper(x, qt)
    x.copy_(torch.randn((64, k), device=card, generator=gen))
    graph.replay()
    want = wrapper(x, qt)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


# the mma.sync GEMVs, kernel A's six entries (csrc/q4k_gemv.cu), E's three
# codebook entries (csrc/codebook_gemv.cu), kernel C (csrc/q6k_gemv.cu) and
# kernel H's two (csrc/lowbit_gemv.cu): every format at K = 256 (one
# superblock), 4096 and 12288, C and H also at 2048 (their shortest gp K),
# on ragged N (1000 = 62 row tiles and 8 rows)
GEMV_ENTRIES = ([(t, k) for t in dm.MMA_GEMV for k in (256, 4096, 12288)]
                + [(t, 2048) for t in (GGMLType.Q6_K, *dm.LOWBIT_GEMV)])


def _gemv_flips(got, want, exact):
    """The shares of bf16 outputs the kernel and the plain version round
    otherwise than the f64 law."""
    return [(a != exact).float().mean().item() for a in (got, want)]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,k", GEMV_ENTRIES,
                         ids=[f"{dm.MMA_GEMV[t]}-k{k}" for t, k in GEMV_ENTRIES])
def test_cuda_gemv_matches_plain_at_every_m(card, fmt, k):
    """An mma.sync GEMV entry at M = 1..8 against its plain version within
    chip_smoke.py's limit, both output dtypes; bf16 outputs rounded
    otherwise than the f64 law no more than flip_limit allows; one launch
    counted per call."""
    from chip_smoke import law_f64

    name = dm.MMA_GEMV[fmt]
    gen = torch.Generator(device=card).manual_seed(k)
    qt = synth_quant(fmt, 1000, k, card, gen)
    wrapper, plain = getattr(dm, name), getattr(dm, name + "_plain")
    for m in range(1, 9):
        x = torch.randn((m, k), device=card, generator=gen).to(torch.bfloat16)
        for out_dtype in (torch.bfloat16, torch.float32):
            n0 = dm.launches[name]
            got = wrapper(x, qt, out_dtype).float()
            want = plain(x, qt, out_dtype).float()
            torch.cuda.synchronize()
            assert dm.launches[name] == n0 + 1
            assert torch.isfinite(got).all() and limit_ratio(got, want) <= 1.0
            if out_dtype == torch.bfloat16:
                share = _gemv_flips(got, want, law_f64(name, x, qt, out_dtype).float())
                assert share[0] <= flip_limit(share[1], got.numel()), (m, share)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", list(dm.MMA_GEMV), ids=lambda t: dm.MMA_GEMV[t])
def test_cuda_gemv_misaligned_planes(card, fmt):
    """Planes other than q that start off a vector boundary (views one
    element into their allocation; qh two bytes) run the byte-wise loads of
    the mma.sync GEMV and give the bits of the aligned planes."""
    gen = torch.Generator(device=card).manual_seed(5)
    qt = synth_quant(fmt, 1000, 4096, card, gen)
    planes = {}
    for nm in ("sc", "mn", "d", "dm", "qh"):
        p = getattr(qt, nm)
        if p is not None:
            off = 2 if nm == "qh" else 1
            p = torch.empty(p.numel() + off, dtype=p.dtype, device=card)[off:].view(
                p.shape).copy_(p)
        planes[nm] = p
    off = qformats.QTensor(qt.ggml_type, qt.shape, q=qt.q, **planes)
    wrapper = getattr(dm, dm.MMA_GEMV[fmt])
    x = torch.randn((5, 4096), device=card, generator=gen).to(torch.bfloat16)
    got, want = wrapper(x, off, torch.float32), wrapper(x, qt, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


TAILS = ([(GGMLType.Q4_K, n) for n in (4, 1004, 151748 // 4)]
         + [(t, n) for t in (GGMLType.Q6_K, *dm.LOWBIT_GEMV) for n in (4, 1000)]
         + [(GGMLType.Q6_K, 151748)])


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,n", TAILS, ids=[f"{t.name}-n{n}" for t, n in TAILS])
def test_cuda_gemv_tail_rows(card, fmt, n):
    """N % 16 != 0 (a tile of 4 rows; 12 or 8 tail rows; the head's 4 tail
    rows, at a quarter of its N for kernel A, whole for kernel C): every row
    written, nothing past N, within chip_smoke.py's limit of the plain
    version at M = 3 and 8."""
    name = dm.MMA_GEMV[fmt]
    gen = torch.Generator(device=card).manual_seed(n)
    qt = synth_quant(fmt, n, 4096, card, gen)
    for m in (3, 8):
        x = torch.randn((m, 4096), device=card, generator=gen).to(torch.bfloat16)
        got = getattr(dm, name)(x, qt, torch.float32)
        want = getattr(dm, name + "_plain")(x, qt, torch.float32)
        torch.cuda.synchronize()
        assert got.shape == (m, n) and torch.isfinite(got).all()
        assert limit_ratio(got, want) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", [GGMLType.Q4_K, GGMLType.Q5_1, GGMLType.IQ4_NL,
                                 GGMLType.IQ4_XS, GGMLType.MXFP4, GGMLType.Q6_K,
                                 GGMLType.Q2_K, GGMLType.Q3_K], ids=lambda t: t.name)
@pytest.mark.parametrize("n", [1024, 4096], ids=lambda n: f"n{n}")
def test_cuda_gemv_in_a_cuda_graph(card, fmt, n):
    """An mma.sync GEMV entry captured in a CUDA graph (at N = 1024 64
    blocks of 8 warps, at 4096 256) and replayed on new x gives the bits
    of an eager launch on that x; two eager launches give the same bits."""
    gen = torch.Generator(device=card).manual_seed(n)
    qt = synth_quant(fmt, n, 4096, card, gen)
    wrapper = getattr(dm, dm.MMA_GEMV[fmt])
    x = torch.randn((8, 4096), device=card, generator=gen).to(torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up (build) off the capture
        wrapper(x, qt)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = wrapper(x, qt)
    x.copy_(torch.randn((8, 4096), device=card, generator=gen))
    graph.replay()
    want, again = wrapper(x, qt), wrapper(x, qt)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(want, again)


@pytest.mark.cuda
def test_cuda_gemv_launches_per_step_at_36_layers(card, tmp_path):
    """Qwen3-8B's 36 layers (narrow widths): one fused all-Q4_K decode step
    launches q4k_gemv 4 x 36 + 1 = 145 times, one step of an unfused Q4_K_M
    file 216 times (its 37 Q6_K weights through q6k_gemv)."""
    cfg = qwen3.Qwen3Config(n_layers=36, d_model=2048, n_heads=16, n_kv_heads=4,
                            head_dim=128, d_ff=2048, n_vocab=1000)
    params = synth_qwen3_params(cfg, card, torch.Generator(device=card).manual_seed(0))
    ctx = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=64,
                  sampler=SamplerParams(greedy=True), device=card)
    tok = int(torch.argmax(ctx.prefill([1, 2, 3])))
    dm.reset_launches()
    ctx.decode(Batch(tokens=[tok]))
    assert dm.launches == {**dict.fromkeys(dm.launches, 0), "q4k_gemv": 145}
    del ctx, params
    path = tmp_path / "q4km.gguf"
    write_qwen3_gguf(path, cfg, "Q4_K_M", torch.Generator(device=card).manual_seed(0))
    params = qwen3.load_params(GGUFReader(path), device=card)
    ctx = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=64,
                  sampler=SamplerParams(greedy=True), device=card)
    tok = int(torch.argmax(ctx.prefill([1, 2, 3])))
    dm.reset_launches()
    ctx.decode(Batch(tokens=[tok]))
    assert dm.launches == {**dict.fromkeys(dm.launches, 0), "q4k_gemv": 216,
                           "q6k_gemv": 37}


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", ["Q2_K", "Q3_K"])
def test_cuda_lowbit_launches_per_step_at_36_layers(card, tmp_path, recipe):
    """Qwen3-8B's 36 layers (narrow widths) in a Q2_K (Q3_K) GGUF: one
    decode step launches kernel H's entry 7 x 36 = 252 times and kernel C
    once (the Q6_K head), nothing else."""
    cfg = qwen3.Qwen3Config(n_layers=36, d_model=2048, n_heads=16, n_kv_heads=4,
                            head_dim=128, d_ff=2048, n_vocab=1000)
    path = tmp_path / f"{recipe}.gguf"
    write_qwen3_gguf(path, cfg, recipe, torch.Generator(device=card).manual_seed(0))
    params = qwen3.load_params(GGUFReader(path), device=card)
    ctx = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=64,
                  sampler=SamplerParams(greedy=True), device=card)
    tok = int(torch.argmax(ctx.prefill([1, 2, 3])))
    dm.reset_launches()
    logits, _ = ctx.decode(Batch(tokens=[tok]))
    assert torch.isfinite(logits).all()
    assert dm.launches == {**dict.fromkeys(dm.launches, 0),
                           dm.LOWBIT_GEMV[GGMLType[recipe]]: 252, "q6k_gemv": 1}
