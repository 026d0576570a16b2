"""The port's flash-decode attention (kernels/flash_attention.py) against
omni_tpu's Pallas `flash_decode` / `_flash_decode4` in interpret mode, as
omni_tpu's own tests run them on the CPU; the wrapper's routing, argument
checks and launch arguments on a mocked card; and chip_smoke.py's f64
attention law against the kernel's law."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import FLASH_FLOOR, FLASH_RTOL, flash_law_f64
from jax._src import compilation_cache
from omni_tpu.kernels.flash_attention import flash_decode as jax_flash_decode
from omni_tpu.runtime import kv_cache as jkv
from omni_tpu_torch.kernels import flash_attention as fa
from omni_tpu_torch.runtime import KVCache


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


def _inputs(bits, t, g, s, seed, hkv=2, d=128):
    """numpy-seeded q [T, Hkv*G, D], K/V rows quantized by omni_tpu's codecs
    (or bf16), and a mask: random (70 % visible), a masked tail of S/8
    cells and, for T > 1, one row masked everywhere. Returns the JAX
    arguments and the same as torch tensors."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((t, hkv * g, d)).astype(np.float32)
    kf, vf = (rng.standard_normal((hkv, s, d)).astype(np.float32) for _ in range(2))
    mask = rng.random((t, s)) < 0.7
    mask[:, -s // 8:] = False
    if t > 1:
        mask[t // 2] = False
    if bits == 16:
        k, v, ks, vs = jnp.asarray(kf, jnp.bfloat16), jnp.asarray(vf, jnp.bfloat16), None, None
    else:
        qr = jkv._quant_rows if bits == 8 else jkv._quant_rows4
        (ks, k), (vs, v) = qr(jnp.asarray(kf)), qr(jnp.asarray(vf))
    jargs = (jnp.asarray(q), k, v, jnp.asarray(mask), ks, vs)

    def tt(a):
        if a is None:
            return None
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(a.copy())

    return jargs, tuple(tt(a) for a in jargs)


def _within_limit(got, want, targs):
    """chip_smoke.py's kernel-vs-plain limit: FLASH_RTOL x Σ p|v| from the
    f64 law, plus FLASH_FLOOR of its largest value."""
    _, exact_abs = flash_law_f64(*targs, with_abs=True)
    limit = FLASH_RTOL * exact_abs + FLASH_FLOOR * exact_abs.max()
    return ((got.double() - want.double()).abs() <= limit).all()


CASES = [(bits, t, g, s) for bits in (16, 8, 4) for t in (1, 3, 8)
         for g in (1, 4) for s in (256, 1024, 1000)]


@pytest.mark.parametrize("bits,t,g,s", CASES,
                         ids=[f"{b}bit-t{t}-g{g}-s{s}" for b, t, g, s in CASES])
def test_plain_matches_pallas_interpret(bits, t, g, s):
    """flash_decode_plain against omni_tpu's flash_decode(interpret=True)
    for bf16, int8 and packed int4 cells (S = 1000 tiles by 8 cells): both
    run one law over the same 512-cell tiles, so they differ only where an
    f32 sum in another order flips a bf16 rounding of p·vs; held to
    chip_smoke.py's kernel-vs-plain limit. Masked-everywhere rows are
    finite."""
    jargs, targs = _inputs(bits, t, g, s, seed=bits * 1000 + t * 100 + g * 10 + s)
    q, k, v, mask, ks, vs = jargs
    want = torch.from_numpy(np.asarray(
        jax_flash_decode(q, k, v, mask, k_scale=ks, v_scale=vs, interpret=True)))
    got = fa.flash_decode_plain(*targs)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    assert _within_limit(got, want, targs)


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_head_dim_64_matches_pallas_interpret(bits):
    jargs, targs = _inputs(bits, 2, 4, 512, seed=7, d=64)
    q, k, v, mask, ks, vs = jargs
    want = torch.from_numpy(np.asarray(
        jax_flash_decode(q, k, v, mask, k_scale=ks, v_scale=vs, interpret=True)))
    assert _within_limit(fa.flash_decode_plain(*targs), want, targs)


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_fully_masked_rows_are_the_mean_of_v(bits):
    """A row masked everywhere sees every score at the finite -1e30: p = 1
    on every cell, so it comes out as the mean of (dequantized) V, as in
    omni_tpu's test_flash_fully_masked_rows_are_finite."""
    _, (q, k, v, mask, ks, vs) = _inputs(bits, 2, 4, 1000, seed=3)
    mask = torch.zeros_like(mask)
    got = fa.flash_decode_plain(q, k, v, mask, ks, vs)
    vd = fa.cells_f32(v, fa.cell_bits(k, ks))
    if ks is not None:
        vd = vd * vs[..., None]
    want = vd.mean(1)  # [Hkv, D]
    for h in range(2):
        torch.testing.assert_close(got[:, 4 * h:4 * h + 4],
                                   want[h].expand(2, 4, -1), rtol=1e-2, atol=1e-3)


def test_f64_law_is_the_kernel_law():
    """chip_smoke.py's flash_law_f64 against the plain law and omni_tpu's
    Pallas kernel on a small case: both within the kernel-vs-plain limit of
    it (the law in f64 differs only by the bf16 rounding of p·vs)."""
    for bits in (16, 8, 4):
        jargs, targs = _inputs(bits, 3, 4, 512, seed=11)
        exact = flash_law_f64(*targs, with_abs=True)[0]
        q, k, v, mask, ks, vs = jargs
        pallas = torch.from_numpy(np.asarray(
            jax_flash_decode(q, k, v, mask, k_scale=ks, v_scale=vs, interpret=True)))
        assert _within_limit(fa.flash_decode_plain(*targs), exact, targs)
        assert _within_limit(pallas, exact, targs)
        assert flash_law_f64(*targs).dtype == torch.float32


def test_tile_rule_is_the_pallas_one():
    assert [fa.tile_cells(s) for s in (1, 256, 512, 1000, 1024, 2048, 96)] == \
        [1, 256, 512, 8, 512, 512, 96]


@pytest.mark.parametrize("rows,s", [(4, 1), (4, 512), (4, 1000), (4, 32768),
                                    (32, 2048), (256, 2048), (2048, 2048),
                                    (12, 77), (8, 4096), (9, 4096), (8, 300),
                                    (9, 300), (1, 65536), (65535 * 64, 64)])
def test_split_plan_covers_every_cell(rows, s):
    """The plan's regime switches between 8 and 9 rows per head; every cell
    falls in exactly one split of whole tiles; the grid fits CUDA's limits;
    the workspace and counters are what the kernel writes; a block's shared
    memory fits the H100; the splits fill the card where the cells allow."""
    hkv = 8
    plan = fa.split_plan(rows, hkv, s)
    regime, per, n = plan
    assert regime == ("decode" if rows <= 8 else "prefill")
    assert per % fa.TILE == 0 and per >= fa.TILE
    assert per * (n - 1) < s <= per * n and n <= fa.MAX_SPLITS
    blocks = plan.row_blocks(rows)
    assert blocks == (1 if rows <= 8 else -(-rows // 64))
    assert max(n, blocks, hkv) <= 65535
    # partials: acc [Hkv, n, rows, D], then m and l [Hkv, n, rows]; at
    # decode one counter per head (prefill merges in a second launch)
    for d in fa.HEAD_DIMS:
        assert plan.workspace_floats(rows, hkv, d) == (
            hkv * n * rows * (d + 2) if n > 1 else 0)
    assert plan.counters(rows, hkv) == (hkv if n > 1 and rows <= 8 else 0)
    want = min(fa.MAX_SPLITS, -(-fa.TARGET_BLOCKS // (hkv * blocks)))
    if s >= fa.TILE * want:
        assert hkv * blocks * n >= fa.TARGET_BLOCKS * 0.9
    else:  # too few cells: a tile per split
        assert per == fa.TILE


@pytest.mark.parametrize("bits", [16, 8, 4])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_shared_memory_fits_the_card(bits, d):
    """A block's shared memory (three ring slots, the widened tiles) stays
    within the H100's 227 KB, and the decode regime's merge buffers (m, l
    and acc [D] per warp and row; each row's split weights) fit inside it."""
    smem = fa.shared_bytes(bits, d)
    assert smem <= 232448  # what a block may use on the H100 (227 KB)
    assert fa.WARPS * fa.DECODE_ROWS * (d + 2) * 4 <= smem
    assert fa.DECODE_ROWS * (2 * fa.MAX_SPLITS + 1) * 4 <= smem
    assert smem == {(16, 128): 104448, (8, 128): 85504, (4, 128): 60928,
                    (16, 64): 55296, (8, 64): 44544, (4, 64): 32256}[(bits, d)]


def test_cpu_wrapper_is_the_plain_law_and_launches_nothing():
    _, targs = _inputs(8, 3, 4, 256, seed=1)
    fa.reset_launches()
    torch.testing.assert_close(fa.flash_decode(*targs), fa.flash_decode_plain(*targs),
                               rtol=0, atol=0)
    assert fa.launches == {"flash_decode": 0, "flash_decode4": 0}


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_cuda_wrapper_launches_or_raises(bits):
    """On the card path the wrapper goes to the kernel launcher: where the
    kernel cannot be built (no nvcc here) the call raises rather than
    running the plain version, and no launch is counted."""
    _, targs = _inputs(bits, 1, 4, 256, seed=2)
    fa.reset_launches()
    with mock.patch.object(fa, "_on_cuda", return_value=True), \
            mock.patch("omni_tpu_torch.kernels._build.load",
                       side_effect=RuntimeError("nvcc not found")), \
            mock.patch.object(fa, "flash_decode_plain") as plain:
        with pytest.raises(RuntimeError, match="nvcc"):
            fa.flash_decode(*targs)
    assert not plain.called
    assert fa.launches == {"flash_decode": 0, "flash_decode4": 0}


@pytest.mark.parametrize("kv,entry,count", [("bf16", "flash_decode_bf16", "flash_decode"),
                                            ("q8_0", "flash_decode_i8", "flash_decode"),
                                            ("q4_0", "flash_decode_i4", "flash_decode4")])
def test_launch_arguments_on_a_mocked_card(kv, entry, count):
    """The raw planes of a pool layer under a ragged limit go to the C entry
    point of their cell type as views (the pool's head stride, no copy),
    with the split plan, the default scale and a workspace sized for the
    splits; one launch is counted."""
    cache = KVCache.create(3, 4096, 8, 128, "cpu", dtype=kv)
    k, v, ks, vs = cache.layer_planes(1, limit=1000)
    q = torch.randn((1, 32, 128))
    mask = torch.ones((1, 1000), dtype=torch.bool)
    calls = []

    def fn(*args):
        calls.append(args)
        return 0

    fa.reset_launches()
    with mock.patch.object(fa, "_on_cuda", return_value=True), \
            mock.patch("omni_tpu_torch.kernels._build.load", return_value={entry: fn}), \
            mock.patch("torch.cuda.current_stream",
                       return_value=mock.Mock(cuda_stream=1234)):
        out = fa.flash_decode(q, k, v, mask, ks, vs)
    assert out.shape == (1, 32, 128) and out.dtype == torch.float32
    assert fa.launches == {"flash_decode": 0, "flash_decode4": 0, count: 1}
    (qp, kp, vp, mp, ksp, vsp, op, wsp, cntp, t, hkv, g, s, d, hstride, sstride,
     scale, regime, per, nsplit, stream) = calls[0]
    assert (kp, vp, mp, op) == (k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr())
    assert (t, hkv, g, s, d, stream) == (1, 8, 4, 1000, 128, 1234)
    plan = fa.split_plan(4, 8, 1000)
    assert hstride == 4096 * k.shape[-1] and (regime, per, nsplit) == (0, *plan[1:])
    assert plan.regime == "decode" and nsplit > 1
    assert cntp == fa._counters["cpu"].data_ptr()
    assert scale == pytest.approx(128 ** -0.5)
    if kv == "bf16":
        assert (ksp, vsp, sstride) == (0, 0, 0)
    else:
        assert (ksp, vsp, sstride) == (ks.data_ptr(), vs.data_ptr(), 4096)


@pytest.mark.parametrize("kv", ["bf16", "q8_0", "q4_0"])
def test_prefill_launch_arguments_on_a_mocked_card(kv):
    """A 64-token ubatch (256 rows per head) takes the prefill regime: the
    plan's splits and a workspace of the splits' partials go to the entry
    (whose second launch merges them: no counter is needed, the cached
    buffer goes along); a second call passes the same counters."""
    cache = KVCache.create(2, 2048, 8, 128, "cpu", dtype=kv)
    k, v, ks, vs = cache.layer_planes(0, limit=2048)
    q = torch.randn((64, 32, 128))
    mask = torch.ones((64, 2048), dtype=torch.bool)
    calls, sizes, ws_sizes = [], [], []
    entry = {"bf16": "flash_decode_bf16", "q8_0": "flash_decode_i8",
             "q4_0": "flash_decode_i4"}[kv]
    empty = torch.empty

    def fn(*args):
        calls.append(args)
        # the size of the workspace as the launch sees it (a later tensor
        # may take the address once the call has freed it)
        ws_sizes.append(dict(sizes)[args[7]])
        return 0

    def sized_empty(shape, *args, **kwargs):
        out = empty(shape, *args, **kwargs)
        sizes.append((out.data_ptr(), out.numel()))
        return out

    fa._counters.clear()
    with mock.patch.object(fa, "_on_cuda", return_value=True), \
            mock.patch("omni_tpu_torch.kernels._build.load", return_value={entry: fn}), \
            mock.patch.object(fa.torch, "empty", side_effect=sized_empty), \
            mock.patch("torch.cuda.current_stream",
                       return_value=mock.Mock(cuda_stream=7)):
        fa.flash_decode(q, k, v, mask, ks, vs)
        fa.flash_decode(q, k, v, mask, ks, vs)
    plan = fa.split_plan(256, 8, 2048)
    assert plan.regime == "prefill" and plan.nsplit > 1
    args = calls[0]
    assert args[17:20] == (1, plan.per_split, plan.nsplit)
    ws_floats = ws_sizes[0]
    assert ws_floats == plan.workspace_floats(256, 8, 128) == 8 * plan.nsplit * 256 * 130
    cnt = fa._counters["cpu"]
    assert args[8] == calls[1][8] == cnt.data_ptr()
    assert plan.counters(256, 8) == 0 and not cnt.any()


def _bad(case):
    q = torch.randn((2, 8, 128))
    k8 = torch.zeros((2, 64, 128), dtype=torch.int8)
    sc = torch.ones((2, 64))
    mask = torch.ones((2, 64), dtype=torch.bool)
    return {
        "cell_dtype": (q, k8.float(), k8.float(), mask, None, None),
        "int8_without_scales": (q, k8, k8, mask, None, None),
        "one_scale": (q, k8, k8, mask, sc, None),
        "head_dim_96": (torch.randn((2, 8, 96)), k8[..., :96], k8[..., :96], mask, sc, sc),
        "int4_width": (q, k8.to(torch.uint8), k8.to(torch.uint8), mask, sc, sc),
        "kv_shapes": (q, k8, k8[:, :32], mask, sc, sc),
        "groups": (torch.randn((2, 7, 128)), k8, k8, mask, sc, sc),
        "mask_dtype": (q, k8, k8, mask.to(torch.uint8), sc, sc),
        "mask_shape": (q, k8, k8, mask[:, :32], sc, sc),
        "scale_dtype": (q, k8, k8, mask, sc.double(), sc.double()),
        "cells_not_contiguous": (q, k8.transpose(1, 2).contiguous().transpose(1, 2),
                                 k8, mask, sc, sc),
        "mask_not_contiguous": (q, k8, k8, torch.ones((64, 2), dtype=torch.bool).T, sc, sc),
        "devices": (q, k8, k8, mask.to("meta"), sc, sc),
    }[case]


@pytest.mark.parametrize("case", ["cell_dtype", "int8_without_scales", "one_scale",
                                  "head_dim_96", "int4_width", "kv_shapes", "groups",
                                  "mask_dtype", "mask_shape", "scale_dtype",
                                  "cells_not_contiguous", "mask_not_contiguous",
                                  "devices"])
def test_wrapper_argument_checks(case):
    with pytest.raises(ValueError):
        fa.flash_decode(*_bad(case))
