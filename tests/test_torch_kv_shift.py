"""The port's KV position shifts (KVCache.seq_add / seq_div with K
re-rotation, seq_pos_min / seq_pos_max, Context.seq_add / seq_div) against
omni_tpu's on bf16, q8_0 and q4_0 pools.

Bit for bit: the planes, scales, positions and masks equal omni_tpu's
cache op by op, given the same f32 cos and sin. XLA's and torch's f32
sin/cos differ in the last bit on a few per cent of angles, so that test
feeds the port XLA's values (`rope.rope_trig` patched); with its own trig
the port is held to the rotation law in f64 instead, as chip_smoke.py
holds it on the card: at most one code step a value on a quantized pool,
2^-7 of the value on a bf16 one. Its own trig is within one ulp of the f64
cos and sin."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import rerotation_excess
from jax._src import compilation_cache
from omni_tpu.models import qwen3 as jq
from omni_tpu.runtime import Context as JaxContext
from omni_tpu.runtime import kv_cache as jkv
from omni_tpu_torch.kernels import rope
from omni_tpu_torch.kernels.rope import rope_freqs
from omni_tpu_torch.runtime import Context, KVCache

L, H, S, D = 2, 2, 48, 64
BASE = 1e6
JDT = {"bf16": jnp.bfloat16, "q8_0": jnp.int8, "q4_0": "q4_0"}
OPS = [("seq_add", 0, 10, -1, -7), ("seq_add", 0, 0, 20, 5),
       ("seq_add", 1, -1, -1, -100), ("seq_div", 0, 5, 40, 3),
       ("seq_add", 0, -1, -1, 1000)]


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


def _meta(seed):
    """Cell metadata: seq 0 on cells 0..29 (positions shuffled), seq 1 on
    30..39, cells 40..43 shared by both, the rest free."""
    rng = np.random.default_rng(seed)
    pos = np.full(S, -1, np.int32)
    mask = np.zeros(S, np.int64)
    pos[:30] = rng.permutation(30)
    mask[:30] = 1
    pos[30:40] = np.arange(10) + 60
    mask[30:40] = 2
    pos[40:44] = np.arange(4) + 30
    mask[40:44] = 3
    return pos, mask


def _pools(kv, seed=0):
    """The same pool in both packages: every cell written (K of RMS 2,
    bf16), then the metadata of `_meta`."""
    rng = np.random.default_rng(seed)
    jc = jkv.KVCache.create(L, S, H, D, dtype=JDT[kv], rope_base=BASE)
    tc = KVCache.create(L, S, H, D, "cpu", dtype=kv, rope_base=BASE)
    slots = np.arange(S, dtype=np.int32)
    for li in range(L):
        k = jnp.asarray(rng.standard_normal((S, H, D)) * 2.0, jnp.bfloat16)
        v = jnp.asarray(rng.standard_normal((S, H, D)), jnp.bfloat16)
        jc = jc.write(li, jnp.asarray(slots), k, v)
        tc.write(li, torch.from_numpy(slots).long(), _t(k), _t(v))
    pos, mask = _meta(seed)
    jc = dataclasses.replace(jc, pos=jnp.asarray(pos),
                             seq_mask=jnp.asarray(mask, jnp.uint32))
    tc.pos.copy_(torch.from_numpy(pos))
    tc.seq_mask.copy_(torch.from_numpy(mask))
    return jc, tc


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    """A tensor's exact contents as numpy (bf16 as its bit pattern)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _xla_trig(angles):
    a = jnp.asarray(angles.numpy())
    return (torch.from_numpy(np.array(jnp.cos(a))),
            torch.from_numpy(np.array(jnp.sin(a))))


def _apply(cache, op):
    name, *args = op
    return getattr(cache, name)(*args)


@pytest.mark.parametrize("kv", list(JDT))
def test_shift_is_bit_exact_given_the_same_trig(kv):
    jc, tc = _pools(kv)
    with mock.patch.object(rope, "rope_trig", _xla_trig), jax.disable_jit():
        for op in OPS:
            jc = _apply(jc, op)
            assert _apply(tc, op) is tc
            for nm in ("k", "v", "k_scale", "v_scale", "pos"):
                j = getattr(jc, nm)
                if j is None:
                    assert getattr(tc, nm) is None
                    continue
                np.testing.assert_array_equal(_bits(getattr(tc, nm)), _jbits(j),
                                              err_msg=f"{op} {nm}")
            np.testing.assert_array_equal(tc.seq_mask.numpy(),
                                          np.asarray(jc.seq_mask).astype(np.int64))
            for s in (0, 1, 2):
                assert int(tc.seq_pos_min(s)) == int(jc.seq_pos_min(s))
                assert int(tc.seq_pos_max(s)) == int(jc.seq_pos_max(s))


def _before_and_rot(tc: KVCache, op):
    """K of every layer as f64 [H, S, D] before `op`, dequantized as
    `read_layer` does, and each cell's delta under it (the pool's own
    `seq_add_delta` / `seq_div_delta`, which the op applies)."""
    name, *args = op
    before = [tc.read_layer(li)[0].double() for li in range(tc.k.shape[0])]
    return before, getattr(tc, name + "_delta")(*args)


@pytest.mark.parametrize("kv", list(JDT))
def test_own_trig_holds_the_f64_law(kv):
    """With the port's own cos/sin each shift stays within the f64 law of
    the cells it started from; the positions are omni_tpu's."""
    jc, tc = _pools(kv, seed=3)
    for op in OPS:
        before, rot = _before_and_rot(tc, op)
        with jax.disable_jit():
            jc = _apply(jc, op)
        _apply(tc, op)
        assert rerotation_excess(before, tc, range(L), rot, BASE) <= 1.0, op
        np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))


@pytest.mark.parametrize("kv", list(JDT))
def test_f64_law_sees_a_wrong_rotation_beside_empty_cells(kv):
    """`rerotation_excess` on a pool whose upper half is empty (zero K,
    zero scales: a real session's unused cells): the shift holds, and the
    same cells held to twice its angle fail; an empty cell's 0 / 0 must not
    hide them."""
    _, tc = _pools(kv, seed=5)
    tc.k[:, :, S // 2:] = 0
    if tc.quantized:
        tc.k_scale[:, :, S // 2:] = 0
    op = ("seq_add", 0, 10, -1, -7)
    before, rot = _before_and_rot(tc, op)
    _apply(tc, op)
    assert rerotation_excess(before, tc, range(L), rot, BASE) <= 1.0
    assert rerotation_excess(before, tc, range(L), 2 * rot, BASE) > 1.0


def test_f64_law_holds_the_reference_at_scale():
    """A Qwen3-8B layer's bf16 pool (2,048 cells, 8 heads of 128) shifted by
    -474, as the unit window shifts one: the JAX cache's own shift and the
    port's hold the law (whose f32-arithmetic term covers the values near a
    cancellation, where 2^-7 of the value alone reads ~150 on the JAX
    cache), and the same cells held to a delta one off fail it."""
    s_, h_, d_ = 2048, 8, 128
    rng = np.random.default_rng(7)
    k = jnp.asarray(rng.standard_normal((s_, h_, d_)) * 2.0, jnp.bfloat16)
    jc = jkv.KVCache.create(1, s_, h_, d_, dtype=jnp.bfloat16, rope_base=BASE)
    jc = jc.write(0, jnp.arange(s_, dtype=jnp.int32), k, k)
    jc = dataclasses.replace(jc, pos=jnp.arange(s_, dtype=jnp.int32),
                             seq_mask=jnp.ones(s_, jnp.uint32))
    tc = KVCache.create(1, s_, h_, d_, "cpu", dtype=torch.bfloat16, rope_base=BASE)
    tc.write(0, torch.arange(s_), _t(k), _t(k))
    tc.pos.copy_(torch.arange(s_, dtype=tc.pos.dtype))
    tc.seq_mask.fill_(1)
    op = ("seq_add", 0, 500, -1, -474)
    before, rot = _before_and_rot(tc, op)
    _apply(tc, op)
    assert rerotation_excess(before, tc, [0], rot, BASE) <= 1.0
    assert rerotation_excess(before, tc, [0], rot + (rot != 0).long(), BASE) > 1.0
    jc = _apply(jc, op)
    tc.k.copy_(_t(jc.k))
    assert rerotation_excess(before, tc, [0], rot, BASE) <= 1.0


def test_own_trig_is_within_one_ulp_of_f64():
    deltas = torch.arange(-4096, 4097, dtype=torch.float32)
    for d, base in ((128, 1e6), (64, 1e6), (128, 1e4)):
        ang = deltas[:, None] * rope_freqs(d, base)
        cos, sin = rope.rope_trig(ang)
        a64 = ang.double().numpy()
        for got, want in ((cos, np.cos(a64)), (sin, np.sin(a64))):
            err = np.abs(got.double().numpy() - want)
            assert (err <= np.spacing(np.abs(want).astype(np.float32))).all()


@pytest.mark.parametrize("kv", list(JDT))
def test_context_shifts_keep_the_host_shadows(kv):
    """Context.seq_add / seq_div move n_past as omni_tpu's Context does; a
    negative shift that frees cells re-syncs cells_used and kv_high."""
    cfg = jq.Qwen3Config(n_layers=L, d_model=128, n_heads=2, n_kv_heads=H,
                         head_dim=D, d_ff=256, n_vocab=64, rope_base=BASE)
    jctx = JaxContext(cfg, None, jq.forward, jq.embed, n_ctx=S, kv_dtype=JDT[kv])
    tctx = Context(cfg, None, None, None, n_ctx=S, device="cpu", kv_dtype=kv)
    jctx.cache, tctx.cache = _pools(kv)
    for ctx in (jctx, tctx):
        ctx.n_past = {0: 30, 1: 70}
        ctx.sync_cells_used()
    assert tctx.cache.rope_base == BASE
    for name, *args in OPS:
        getattr(jctx, name)(*args)
        getattr(tctx, name)(*args)
        assert tctx.n_past == jctx.n_past
        assert (tctx.cells_used, tctx.kv_high) == (jctx.cells_used, jctx.kv_high)
        np.testing.assert_array_equal(tctx.cache.pos.numpy(), np.asarray(jctx.cache.pos))
        # kv_high bounds the highest occupied cell
        occ = np.nonzero(tctx.cache.seq_mask.numpy())[0]
        assert not len(occ) or occ.max() < max(tctx.kv_high, tctx.cells_used)
    assert tctx.cells_used < 44  # the -100 shift freed seq 1's cells
