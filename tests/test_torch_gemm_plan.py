"""The split plan of the prefill GEMMs (kernels B and D, csrc/qmma.cuh):
`gemm_splits` at every Qwen3-8B prefill shape, the workspace the wrappers
ask for, and the split count they pass to the C entry points, on a mocked
card (no CUDA here). This file imports no JAX."""

from types import SimpleNamespace
from unittest import mock

import pytest
import torch

from omni_tpu_torch.core.dtypes import GGMLType
from omni_tpu_torch.kernels import _build
from omni_tpu_torch.kernels import dequant_matmul as dm
from omni_tpu_torch.testing_synth import synth_quant

# Qwen3-8B's prefill weight shapes, N x K
SHAPES = {"wk": (1024, 4096), "wq": (4096, 4096), "wqkv": (6144, 4096),
          "gate": (12288, 4096), "gateup": (24576, 4096), "down": (4096, 12288),
          "head": (151748, 4096)}
MS = (9, 64, 65, 256, 512)
# a halves-packed, a Q6_K and an int8-plane format
FORMATS = (GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0)
PLAN = [(nm, m, t) for nm in SHAPES for m in MS for t in FORMATS]


def _busiest(m, n, k, splits):
    """Steps (plus one per unit for its epilogue) that the busiest of the
    132 SMs walks, with `splits` ranges of K steps."""
    units = -(-n // 64) * -(-m // 64) * splits
    steps = -(-k // 256)
    return -(-units // 132) * (-(-steps // splits) + 1)


@pytest.mark.parametrize("shape,m,qtype", PLAN,
                         ids=[f"{nm}-m{m}-{t.name}" for nm, m, t in PLAN])
def test_gemm_splits_fill_the_card(shape, m, qtype):
    """A power of two within the step count; at least 2 steps per split;
    no other such count lets the busiest SM finish sooner, and no smaller
    one as soon; 1 at the head, and more than 1 where a 64-row ubatch
    leaves the tiles fewer than the SMs."""
    n, k = SHAPES[shape]
    steps = -(-k // 256)
    splits = dm.gemm_splits(m, n, k, qtype)
    assert splits >= 1 and splits & (splits - 1) == 0 and splits <= steps
    assert splits == 1 or steps // splits >= 2
    allowed = [1] + [2 ** i for i in range(1, 8) if steps // 2 ** i >= 2]
    best = min(_busiest(m, n, k, c) for c in allowed)
    assert _busiest(m, n, k, splits) == best
    assert all(_busiest(m, n, k, c) > best for c in allowed if c < splits)
    if shape == "head":
        assert splits == 1
    if m <= 64 and dm.gemm_units(m, n) < 132:
        assert splits >= 2


@pytest.mark.parametrize("m,n,k,qtype,want", [
    (64, 1024, 4096, GGMLType.Q4_K, 8),     # 16 tiles, 16 steps: 128 units of 2
    (64, 4096, 4096, GGMLType.Q4_K, 2),     # 64 tiles: 128 units of 8 steps
    (64, 6144, 4096, GGMLType.Q6_K, 4),     # 96 tiles: 384 units, 3 per SM, of 4
    (64, 12288, 4096, GGMLType.Q8_0, 2),    # 192 tiles: 384 units of 8
    (64, 24576, 4096, GGMLType.Q4_K, 1),    # 384 tiles
    (64, 4096, 12288, GGMLType.Q6_K, 2),    # 48 steps: 128 units of 24
    (256, 4096, 4096, GGMLType.Q4_K, 1),    # 256 tiles
    (256, 1024, 4096, GGMLType.Q4_K, 2),    # 64 tiles
    (9, 4096, 1248, GGMLType.Q8_0, 2),      # a ragged fifth step: 2 and 3 steps
    (9, 4096, 1280, GGMLType.Q4_K, 2),
    (64, 4096, 256, GGMLType.Q8_0, 1),      # one step
    (64, 4096, 96, GGMLType.Q8_0, 1),       # one ragged step
    (64, 151748, 4096, GGMLType.Q6_K, 1),   # the head: 2372 tiles
])
def test_gemm_splits_examples(m, n, k, qtype, want):
    assert dm.gemm_splits(m, n, k, qtype) == want


def test_gemm_splits_refuses_a_k_of_partial_blocks():
    with pytest.raises(ValueError, match="granule"):
        dm.gemm_splits(64, 4096, 1248, GGMLType.Q4_K)


@pytest.mark.parametrize("m,n,k,splits,side,want", [
    (64, 4096, 4096, 1, False, 0),
    (64, 4096, 4096, 1, True, 4 * 64 * 128),
    (64, 4096, 4096, 8, False, 4 * 8 * 64 * 4096),
    (64, 4096, 4096, 8, True, 4 * (64 * 128 + 8 * 64 * 4096)),
    (9, 1000, 1280, 2, True, 4 * (9 * 40 + 2 * 9 * 1000)),
])
def test_gemm_workspace_bytes(m, n, k, splits, side, want):
    assert dm.gemm_workspace_bytes(m, n, k, splits, side) == want


def _on_a_mocked_card(fn, x, qt):
    """fn(x, qt) with the wrappers taking the card's path and a stand-in
    library that records each entry point's arguments and launches
    nothing; returns ([(entry, args)], the f32 workspaces made)."""
    called, made = [], []

    def entry(name):
        return lambda *a: called.append((name, a)) or 0

    lib = {name: entry(name) for entries in _build.SOURCES.values() for name in entries}
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        if kw.get("dtype") == torch.float32 and t.dim() == 1:
            made.append(t)
        return t

    with mock.patch.object(dm, "_on_cuda", return_value=True), \
            mock.patch.object(_build, "load", return_value=lib), \
            mock.patch.object(dm.torch, "empty", side_effect=empty), \
            mock.patch.object(torch.cuda, "current_stream",
                              return_value=SimpleNamespace(cuda_stream=0)):
        fn(x, qt)
    return called, made


# (wrapper, format, side term): B with and without a side term, D on a
# halves, a Q6_K and a ragged int8-plane weight
GEMMS = [("q4k_gemm", GGMLType.Q4_K, 2048, True), ("q4_0_gemm", GGMLType.Q4_0, 2048, False),
         ("q5_1_gemm", GGMLType.Q5_1, 2048, True), ("qgemm", GGMLType.Q4_K, 2048, False),
         ("qgemm", GGMLType.Q6_K, 2048, False), ("qgemm", GGMLType.Q8_0, 1248, False)]


@pytest.mark.parametrize("wrapper,qtype,k,side", GEMMS,
                         ids=[f"{w}-{t.name}" for w, t, _, _ in GEMMS])
@pytest.mark.parametrize("m", [16, 200])
def test_gemm_wrapper_passes_the_split_plan(wrapper, qtype, k, side, m):
    """Kernels B and D get gemm_splits' count and a workspace of
    gemm_workspace_bytes, made for this call (null where it is 0), in the
    15 arguments of GEMM_ARGS; the launch counts once."""
    n = 64
    qt = synth_quant(qtype, n, k, "cpu", torch.Generator().manual_seed(m))
    x = torch.zeros((m, k), dtype=torch.bfloat16)
    dm.reset_launches()
    called, made = _on_a_mocked_card(getattr(dm, wrapper), x, qt)
    (entry, a), = called
    assert len(a) == len(_build.GEMM_ARGS) == 15
    splits = dm.gemm_splits(m, n, k, qtype)
    assert splits > 1  # one 64-row tile of N: K is split
    assert a[9:14] == (m, n, k, splits, 0)
    nbytes = dm.gemm_workspace_bytes(m, n, k, splits, side)
    assert [t.numel() * 4 for t in made] == [nbytes]
    assert a[8] == made[0].data_ptr() != 0
    assert dm.launches[wrapper] == 1


@pytest.mark.parametrize("wrapper,qtype", [("q4k_gemm", GGMLType.Q4_K),
                                           ("qgemm", GGMLType.Q8_0)])
def test_gemm_wrapper_takes_the_count_from_gemm_splits(wrapper, qtype):
    """A count forced through gemm_splits reaches the C entry as it is, with
    the workspace for it; one split and no side term needs none (null)."""
    qt = synth_quant(qtype, 64, 2048, "cpu", torch.Generator().manual_seed(0))
    x = torch.zeros((16, 2048), dtype=torch.bfloat16)
    for forced in (1, 4, 8):
        with mock.patch.object(dm, "gemm_splits", return_value=forced) as plan:
            (entry, a), = _on_a_mocked_card(getattr(dm, wrapper), x, qt)[0]
        plan.assert_called_once_with(16, 64, 2048, qtype)
        assert a[12] == forced
        side = wrapper == "q4k_gemm"
        assert (a[8] == 0) == (dm.gemm_workspace_bytes(16, 64, 2048, forced, side) == 0)


def test_gemv_keeps_its_13_arguments():
    """The decode kernels take no split count and no workspace."""
    qt = synth_quant(GGMLType.Q4_K, 64, 2048, "cpu", torch.Generator().manual_seed(1))
    (entry, a), = _on_a_mocked_card(dm.q4k_gemv, torch.zeros((1, 2048), dtype=torch.bfloat16),
                                    qt)[0]
    assert entry == "q4k_gemv" and len(a) == len(_build.MATMUL_ARGS) == 13
    assert a[8:12] == (1, 64, 2048, 0)
