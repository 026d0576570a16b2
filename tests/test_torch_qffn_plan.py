"""Kernel I's plan (`fused_ffn.qffn_plan`, csrc/qffn.cu): the regime at the
M = 8/9 boundary, the split counts of its two prefill passes (the mainloop
of csrc/qmma.cuh, `dequant_matmul.gemm_splits`), the workspace it asks for,
and the split counts the wrapper passes to the C entry points on a mocked
card (no CUDA here). This file imports no JAX."""

from types import SimpleNamespace
from unittest import mock

import pytest
import torch

from omni_tpu_torch.core.dtypes import GGMLType
from omni_tpu_torch.kernels import _build
from omni_tpu_torch.kernels import dequant_matmul as dm
from omni_tpu_torch.kernels import fused_ffn as ff
from omni_tpu_torch.testing_synth import synth_quant

Q4_K, Q6_K, Q8_0 = GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0
# Qwen3-8B's FFN: K (d_model) 4096, F 12288, N 4096
K8B, F8B = 4096, 12288
PAIRS = [(Q4_K, Q4_K), (Q4_K, Q6_K), (Q8_0, Q8_0), (GGMLType.Q4_0, GGMLType.Q4_1),
         (GGMLType.Q2_K, GGMLType.Q3_K), (GGMLType.IQ4_XS, GGMLType.MXFP4)]
pair_id = lambda p: f"{p[0].name}-{p[1].name}"  # noqa: E731


@pytest.mark.parametrize("pair", PAIRS, ids=pair_id)
@pytest.mark.parametrize("m", [1, 2, 7, 8])
def test_decode_rows_take_the_register_path(m, pair):
    """M <= GP_MAX_M: the register-dequant passes, no mainloop splits, and
    a workspace of h alone (bf16 [M, F]): no f32 partials."""
    plan = ff.qffn_plan(m, K8B, K8B, F8B, *pair)
    assert m <= dm.GP_MAX_M == 8
    assert plan == ff.QffnPlan("gemv", 1, 1, 2 * m * F8B)


@pytest.mark.parametrize("pair", PAIRS, ids=pair_id)
@pytest.mark.parametrize("m", [9, 37, 64, 65, 512])
def test_prefill_rows_take_the_mainloop(m, pair):
    """M > 8: the mainloop, the gate/up pass over the fused [2F, K] weight
    and the down pass over h [M, F], each split as `gemm_splits` says; the
    workspace holds h, then g|u in f32, then the larger pass's partials,
    each part 16-byte aligned."""
    t_gu, t_dn = pair
    plan = ff.qffn_plan(m, K8B, K8B, F8B, t_gu, t_dn)
    s_gu = dm.gemm_splits(m, 2 * F8B, K8B, t_gu)
    s_dn = dm.gemm_splits(m, K8B, F8B, t_dn)
    assert plan.regime == "gemm" and (plan.splits_gu, plan.splits_dn) == (s_gu, s_dn)
    parts = [s * m * n * 4 if s > 1 else 0 for s, n in ((s_gu, 2 * F8B), (s_dn, K8B))]
    h, gu = 2 * m * F8B, 4 * m * 2 * F8B
    assert plan.workspace_bytes == h + gu + max(parts)
    assert h % 16 == 0 and (h + gu) % 16 == 0


@pytest.mark.parametrize("m,pair,want", [
    (64, (Q4_K, Q4_K), (1, 2)),    # gate/up 384 tiles; down 64 tiles of 48 steps
    (64, (Q4_K, Q6_K), (1, 2)),
    (64, (Q8_0, Q8_0), (1, 2)),
    (9, (Q4_K, Q4_K), (1, 2)),     # one M tile: as at 64
    (256, (Q4_K, Q4_K), (1, 1)),   # 256 down tiles: the card is full
])
def test_prefill_splits_at_qwen3_8b(m, pair, want):
    """The split counts at Qwen3-8B's FFN shape: the fused gate/up weight
    has tiles enough for every SM; the down weight's 64 tiles do not at
    one M tile, so its 48 K steps are split in two."""
    plan = ff.qffn_plan(m, K8B, K8B, F8B, *pair)
    assert (plan.splits_gu, plan.splits_dn) == want


@pytest.mark.parametrize("m", [1, 8, 9, 64])
def test_ragged_int8_plane_f(m):
    """F = 800 (Q8_0/Q8_0, whole 32-blocks, no whole 256-step): both
    regimes plan it; the down pass's K steps are ragged (four, the last of
    32 elements), and its split count is `gemm_splits`' at that K."""
    plan = ff.qffn_plan(m, 1056, 1056, 800, Q8_0, Q8_0)
    if m <= 8:
        assert plan == ff.QffnPlan("gemv", 1, 1, 2 * m * 800)
    else:
        assert plan.splits_dn == dm.gemm_splits(m, 1056, 800, Q8_0)
        assert plan.splits_gu == dm.gemm_splits(m, 1600, 1056, Q8_0)
        assert plan.workspace_bytes >= 2 * m * 800 + 4 * m * 1600


@pytest.mark.parametrize("m", [1, 64])
def test_plan_refuses_an_f_of_partial_blocks(m):
    """F must hold whole blocks of both formats, K whole blocks of the
    gate/up format, in both regimes."""
    with pytest.raises(ValueError, match="granule 256"):
        ff.qffn_plan(m, 1056, 1056, 800, Q8_0, Q4_K)
    with pytest.raises(ValueError, match="granule 256"):
        ff.qffn_plan(m, 1056, 1056, 768, Q4_K, Q8_0)
    with pytest.raises(ValueError, match="granule 32"):
        ff.qffn_plan(m, 1024, 1024, 784, Q8_0, Q8_0)


@pytest.mark.parametrize("splits", [1, 4])
def test_forced_splits_reach_the_entry_points(splits):
    """With `gemm_splits` forced (as chip_smoke.py forces it), a prefill
    call passes the forced count to both passes and sizes the workspace
    for it; a decode call passes 1."""
    gen = torch.Generator().manual_seed(0)
    gu = synth_quant(Q4_K, 2 * 768, 1024, "cpu", gen)
    dn = synth_quant(Q6_K, 1024, 768, "cpu", gen)
    calls = []

    def entry(name):
        def fn(*a):
            calls.append((name, a))
            return 0
        return fn

    with mock.patch.object(ff, "_on_cuda", return_value=True), \
            mock.patch.object(_build, "load", return_value={
                nm: entry(nm) for nm in ("qffn_gated", "qffn_down")}), \
            mock.patch.object(torch.cuda, "current_stream",
                              return_value=SimpleNamespace(cuda_stream=0)), \
            mock.patch.object(dm, "gemm_splits", return_value=splits):
        for m in (1, 64):
            ff.qffn(torch.zeros((m, 1024)), gu, dn)
    got = {(nm, a[8]): a[13] for nm, a in calls}
    assert got == {("qffn_gated", 1): 1, ("qffn_down", 1): 1,
                   ("qffn_gated", 64): splits, ("qffn_down", 64): splits}
    part = max(splits * 64 * 1536, splits * 64 * 1024) * 4 if splits > 1 else 0
    nbytes = 2 * 64 * 768 + 4 * 64 * 1536 + part
    assert ff._workspace[("cpu", nbytes)].numel() == nbytes
