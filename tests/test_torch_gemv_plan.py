"""The launch plan of the mma.sync GEMVs, kernel A (csrc/q4k_gemv.cu),
kernel E's codebook entries (csrc/codebook_gemv.cu), kernel C
(csrc/q6k_gemv.cu) and kernel H (csrc/lowbit_gemv.cu),
`dequant_matmul.gemv_plan`: one block per 16-row tile and no split of K at
every Qwen3-8B decode shape, the wrappers' arguments on a mocked card (no
CUDA here), and the copies gemv_plan_probe builds. This file imports no
JAX."""

import re
from unittest import mock

import pytest
import torch

from omni_tpu_torch.core.dtypes import GGMLType
from omni_tpu_torch.kernels import _build
from omni_tpu_torch.kernels import dequant_matmul as dm
from omni_tpu_torch.testing_synth import synth_quant

# Qwen3-8B's decode weight shapes, N x K (wq and wo, wk and wv, gate and up
# share a shape; wqkv and gateup are the fused ones)
SHAPES = {"wq": (4096, 4096), "wk": (1024, 4096), "wqkv": (6144, 4096),
          "gate": (12288, 4096), "gateup": (24576, 4096), "down": (4096, 12288),
          "head": (151748, 4096)}
FORMATS = tuple(dm.MMA_GEMV)
PLAN = [(nm, m, t) for nm in SHAPES for m in (1, 8) for t in FORMATS]
SMS = 132


@pytest.mark.parametrize("shape,m,qtype", PLAN,
                         ids=[f"{nm}-m{m}-{t.name}" for nm, m, t in PLAN])
def test_gemv_plan_one_block_per_tile_over_all_of_k(shape, m, qtype):
    """One split (K whole, from superblock 0 to its end), no workspace, and
    one block per 16-row tile: the blocks cover N once, the last one
    ragged where N % 16 != 0."""
    n, k = SHAPES[shape]
    p = dm.gemv_plan(m, n, k, qtype)
    assert p == (16, 1, 0)
    blocks = p.blocks(n)
    assert (blocks - 1) * p.rows < n <= blocks * p.rows


@pytest.mark.parametrize("m,n,k,qtype,blocks", [
    (1, 1024, 4096, GGMLType.Q4_K, 64),       # wk, wv: 64 of 132 SMs, K not split
    (8, 1024, 4096, GGMLType.Q5_K, 64),
    (1, 4096, 12288, GGMLType.Q4_0, 256),     # down
    (1, 1000, 1280, GGMLType.Q5_1, 63),       # 62 tiles and 8 rows
    (1, 4, 256, GGMLType.Q4_1, 1),            # one superblock, a tile of 4 rows
    (8, 151748, 4096, GGMLType.Q5_0, 9485),   # the head: 9,484 tiles and 4 rows
    (1, 1024, 4096, GGMLType.IQ4_NL, 64),     # E's codebook entries: the same tiles
    (8, 4096, 12288, GGMLType.IQ4_XS, 256),
    (3, 12288, 4096, GGMLType.MXFP4, 768),
    (1, 1024, 4096, GGMLType.Q6_K, 64),       # kernel C: wv
    (8, 4096, 12288, GGMLType.Q6_K, 256),     # down
    (1, 151748, 4096, GGMLType.Q6_K, 9485),   # the head: 9,484 tiles and 4 rows
    (5, 1000, 2048, GGMLType.Q6_K, 63),       # 62 tiles and 8 rows
    (1, 4, 256, GGMLType.Q2_K, 1),            # kernel H: one superblock, 4 rows
    (8, 1004, 12288, GGMLType.Q2_K, 63),      # 62 tiles and 12 rows
    (1, 12288, 4096, GGMLType.Q3_K, 768),
    (7, 20, 4096, GGMLType.Q3_K, 2),          # a tile and 4 rows
])
def test_gemv_plan_examples(m, n, k, qtype, blocks):
    p = dm.gemv_plan(m, n, k, qtype)
    assert (p.splits, p.workspace_bytes, p.blocks(n)) == (1, 0, blocks)


@pytest.mark.parametrize("m", [0, 9, 64])
def test_gemv_plan_refuses_m_outside_1_to_8(m):
    with pytest.raises(ValueError, match="M = 1..8"):
        dm.gemv_plan(m, 4096, 4096, GGMLType.Q4_K)


@pytest.mark.parametrize("k,qtype", [(1248, GGMLType.Q4_0), (128, GGMLType.Q4_K),
                                     (4096, GGMLType.F16), (4096, GGMLType.Q8_0),
                                     (1056, GGMLType.IQ4_NL), (1056, GGMLType.MXFP4),
                                     (4000, GGMLType.Q6_K), (128, GGMLType.Q2_K),
                                     (1280 + 16, GGMLType.Q3_K)])
def test_gemv_plan_refuses_other_k_and_formats(k, qtype):
    with pytest.raises(ValueError):
        dm.gemv_plan(1, 4096, k, qtype)


GEMV_SOURCES = ["q4k_gemv.cu", "codebook_gemv.cu", "q6k_gemv.cu", "lowbit_gemv.cu"]


@pytest.mark.parametrize("source", GEMV_SOURCES)
def test_gemv_plan_states_the_kernels_constants(source):
    """The C side tiles N by the same rows, and counts the same SMs."""
    src = (_build.CSRC / source).read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kRows"]) == dm.GEMV_ROWS
    assert int(consts["kSms"]) == dm.GEMM_SMS


def _on_a_mocked_card(fn, x, qt):
    """fn(x, qt) with the wrappers taking the card's path and a stand-in
    library that records each entry point's arguments; returns
    ([(entry, args)], the f32 tensors made)."""
    called, made = [], []
    lib = {name: (lambda nm: lambda *a: called.append((nm, a)) or 0)(name)
           for entries in _build.SOURCES.values() for name in entries}
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        if kw.get("dtype") == torch.float32:
            made.append(t)
        return t

    with mock.patch.object(dm, "_on_cuda", return_value=True), \
            mock.patch.object(_build, "load", return_value=lib), \
            mock.patch.object(dm.torch, "empty", side_effect=empty), \
            mock.patch.object(torch.cuda, "current_stream",
                              return_value=mock.Mock(cuda_stream=0)):
        out = fn(x, qt)
    return called, made, out


CALLS = [(t, m, n, k) for t in FORMATS for (m, n, k) in ((1, 1024, 4096), (8, 4096, 2048))]


@pytest.mark.parametrize("qtype,m,n,k", CALLS,
                         ids=[f"{t.name}-m{m}-n{n}" for t, m, n, k in CALLS])
def test_gemv_wrapper_makes_no_workspace(qtype, m, n, k):
    """The wrapper passes the 13 arguments of MATMUL_ARGS
    (the planes the format has, m, n, k, out_f32), makes its output and
    nothing else, and counts one launch."""
    qt = synth_quant(qtype, n, k, "cpu", torch.Generator().manual_seed(m))
    name = dm.MMA_GEMV[qtype]
    dm.reset_launches()
    called, made, out = _on_a_mocked_card(getattr(dm, name),
                                          torch.zeros((m, k), dtype=torch.bfloat16), qt)
    (entry, a), = called
    assert entry == name and len(a) == len(_build.MATMUL_ARGS) == 13
    assert a[8:12] == (m, n, k, 0)
    assert [p != 0 for p in a[1:7]] == [getattr(qt, nm) is not None for nm in dm.PLANES]
    assert made == [] and out.shape == (m, n) and out.dtype == torch.bfloat16
    assert dm.launches[name] == 1
    assert dm.gemv_plan(m, n, k, qtype).workspace_bytes == 0


PROBE_VARIANTS = [(src, v) for src in GEMV_SOURCES
                  for v in ("warps8", "warps2", "few4", "via-l1", "warps8-via-l1",
                            "no-alloc", "blocks3", "stages2", "stages4")
                  if v in __import__("omni_tpu_torch.gemv_plan_probe",
                                     fromlist=["SOURCES"]).SOURCES[src][1]]


@pytest.mark.parametrize("source,variant", PROBE_VARIANTS,
                         ids=[f"{s}-{v}" for s, v in PROBE_VARIANTS])
def test_probe_variants_change_only_their_setting(source, variant):
    """gemv_plan_probe's copies of each source: each of a variant's edits
    (kManyWarps, kFewWarps, the weight load through L1 or past it, the
    blocks an SM, kernel C's steps in flight) matches once and is made, and
    undoing them gives the source back: nothing else changes."""
    from omni_tpu_torch import gemv_plan_probe

    src = (_build.CSRC / source).read_text()
    got = gemv_plan_probe.variant_source(source, variant)
    assert got != src
    for old, new in gemv_plan_probe.edits(source, variant):
        assert got.count(new) == 1 and old != new
        got = got.replace(new, old)
    assert got == src
    many = 8 if "warps8" in variant else 2 if "warps2" in variant else 4
    got = gemv_plan_probe.variant_source(source, variant)
    assert f"constexpr int kManyWarps = {many};" in got
    if "kFewWarps" in src:
        assert f"constexpr int kFewWarps = {4 if variant == 'few4' else 2};" in got


WARPS = [(src, n, k, want) for src in ("q6k_gemv.cu", "lowbit_gemv.cu") for n, k, want in (
    (1024, 4096, 8), (4096, 12288, 8), (6144, 4096, 4), (12288, 4096, 2),
    (24576, 4096, 4), (151748, 4096, 4))] + [
    (src, 12288, 4096, 4) for src in ("q4k_gemv.cu", "codebook_gemv.cu")]


@pytest.mark.parametrize("source,n,k,want", WARPS,
                         ids=[f"{s}-n{n}-k{k}" for s, n, k, _ in WARPS])
def test_gemv_block_warps_at_qwen3_shapes(source, n, k, want):
    """The warps a block runs (the probe's copy of each source's
    block_warps, on the source's own constants): 8 below two waves of row
    tiles; for kernels C and H 2 where every tile is on the card at once at
    2 warps a block but not at 4 (Qwen3-8B's gate, 768 tiles), else 4;
    kernels A and E keep 4 there."""
    from omni_tpu_torch import gemv_plan_probe

    warps = gemv_plan_probe.warp_constants((_build.CSRC / source).read_text())
    step = gemv_plan_probe.STEP.get(source, 256)
    assert gemv_plan_probe.block_warps(n, k, warps, step) == want
