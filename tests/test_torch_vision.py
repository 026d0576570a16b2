"""The port's vision path (omni_tpu_torch.omni.image, models/siglip.py,
convert.vpm_from_jax_params, omni-cli's VPM encoder) against omni_tpu's on
the CPU: the resampler byte for byte against Pillow (which the JAX package
calls), the LLaVA-UHD slice plan, `preprocess_uhd` and `stack_frames`
byte for byte, the positions exact on non-square grids (a w/h swap of the
sincos table is invisible on a square slice), and the VPM's rows on the
JAX package's tiny VPM (`write_tiny_vpm`; with a pre-LN, and with the
historical ffn_up/ffn_down name swap) within ROWS_RTOL of max|row|."""

import argparse

import jax
import numpy as np
import pytest
import torch
from jax._src import compilation_cache

from omni_tpu.cli import omni_cli as jcli
from omni_tpu.core import GGUFReader as JaxReader
from omni_tpu.core.gguf import GGUFWriter as JaxWriter
from omni_tpu.models import siglip as jsig
from omni_tpu.omni import image as jimg
from omni_tpu.testing_gguf import write_tiny_model_dir, write_tiny_vpm
from omni_tpu_torch.cli import omni_cli as tcli
from omni_tpu_torch.convert import vpm_from_jax_params
from omni_tpu_torch.core.gguf import GGUFReader
from omni_tpu_torch.models import siglip as tsig
from omni_tpu_torch.omni import image as timg

# f32 on both sides, the sums in another order: measured 5e-7 of max|row|
ROWS_RTOL = 1e-5
MEAN, STD = [0.48, 0.46, 0.41], [0.27, 0.26, 0.28]


@pytest.fixture(scope="module", autouse=True)
def jax_setup():
    """No compile-cache entries from the JAX calls; one intra-op thread."""
    old = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)
    jax.config.update("jax_enable_compilation_cache", old)
    compilation_cache.reset_cache()


def _img(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("way", ["down", "up", "mixed"])
def test_resize_as_pillow(method, way):
    """Twelve seeded sizes a case, 5-300 px: Pillow's bytes exactly."""
    rng = np.random.default_rng(["down", "up", "mixed"].index(way) * 2
                                + (method == "bilinear"))
    for _ in range(12):
        h, w = (int(v) for v in rng.integers(5, 300, 2))
        if way == "down":
            oh, ow = (int(rng.integers(2, h + 1)), int(rng.integers(2, w + 1)))
        elif way == "up":
            oh, ow = (int(rng.integers(h, 2 * h + 2)), int(rng.integers(w, 2 * w + 2)))
        else:
            oh, ow = int(rng.integers(2, h + 1)), int(rng.integers(w, 2 * w + 2))
        src = _img(rng, h, w)
        got = timg.resize(src, ow, oh, method)
        want = jimg._resize(src, ow, oh, method)
        assert got.dtype == np.uint8 and got.shape == want.shape == (oh, ow, 3)
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} -> {oh}x{ow}")


@pytest.mark.parametrize("msn", [-1, 0, 2, 9])
def test_slice_instructions_as_jax(msn):
    for w in (14, 100, 300, 448, 449, 600, 1000, 1344, 2000, 3000):
        for h in (20, 224, 448, 500, 1008, 2500):
            got = timg.get_slice_instructions(w, h, max_slice_nums=msn)
            want = jimg.get_slice_instructions(w, h, max_slice_nums=msn)
            assert vars(got) == vars(want), (w, h)


@pytest.mark.parametrize("hw", [(200, 300), (1008, 1344), (900, 500)])
def test_preprocess_uhd_as_jax(hw):
    """Upscaled overview alone; 7 parts (the card's image); a tall grid."""
    src = _img(np.random.default_rng(hw[0]), *hw)
    got = timg.preprocess_uhd(src, MEAN, STD)
    want = jimg.preprocess_uhd(src, MEAN, STD)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    if hw == (1008, 1344):
        assert [p.shape for p in got] == [(392, 518, 3)] + [(476, 420, 3)] * 6


def test_stack_frames_as_jax():
    """An odd count (black pad) of mixed sizes (each resized bilinear to the
    first's), a pair, a single frame."""
    rng = np.random.default_rng(3)
    frames = [_img(rng, 60, 80), _img(rng, 45, 97), _img(rng, 60, 80),
              _img(rng, 120, 33), _img(rng, 61, 79)]
    for fs in (frames, frames[:2], frames[:1]):
        got, want = timg.stack_frames(fs), jimg.stack_frames(fs)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        timg.stack_frames([])


def test_load_image_as_jax(tmp_path):
    from PIL import Image

    path = str(tmp_path / "x.png")
    Image.fromarray(_img(np.random.default_rng(0), 9, 13)).save(path)
    np.testing.assert_array_equal(timg.load_image(path), jimg.load_image(path))


@pytest.mark.parametrize("hp,wp", [(3, 5), (37, 28), (26, 39), (1, 7)])
def test_positions_as_jax(hp, wp):
    np.testing.assert_array_equal(tsig.bucket_positions(hp, wp),
                                  jsig.bucket_positions(hp, wp))
    got = tsig.sincos_pos_embed_2d(64, wp, hp)
    np.testing.assert_array_equal(got, jsig.sincos_pos_embed_2d(64, wp, hp))
    # row i is patch (i // wp, i % wp): rows 0 and 1 share the patch row
    # (the second half) and differ in the column (the first)
    assert got.shape == (hp * wp, 64)
    np.testing.assert_array_equal(got[0, 32:], got[1, 32:])
    assert not np.array_equal(got[0, :32], got[1, :32])


def _variant_vpm(path, variant):
    """The tiny VPM, with a pre-LN added or every layer's ffn_up/ffn_down
    names swapped (the historical converter's files)."""
    write_tiny_vpm(path + ".base")
    r = JaxReader(path + ".base")
    w = JaxWriter(path)
    for k, v in r.kv.items():
        if not k.startswith("GGUF.") and not k.startswith("general.alignment"):
            w.add_kv(k, v)
    rng = np.random.default_rng(9)
    for name, ti in r.tensors.items():
        if variant == "swapped" and ".ffn_" in name:
            name = name.replace("ffn_up", "ffn_tmp").replace(
                "ffn_down", "ffn_up").replace("ffn_tmp", "ffn_down")
        w.add_tensor(name, np.array(ti.data, np.float32).reshape(ti.shape))
    if variant == "pre_ln":
        d = r.kv["clip.vision.embedding_length"]
        w.add_tensor("v.pre_ln.weight", (1 + 0.3 * rng.standard_normal(d)).astype(np.float32))
        w.add_tensor("v.pre_ln.bias", (0.2 * rng.standard_normal(d)).astype(np.float32))
    w.write()
    return path


@pytest.fixture(scope="module")
def vpms(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_vision")
    out = {}
    for variant in ("plain", "pre_ln", "swapped"):
        path = str(base / f"{variant}.gguf")
        if variant == "plain":
            write_tiny_vpm(path)
        else:
            _variant_vpm(path, variant)
        jr, tr = JaxReader(path), GGUFReader(path)
        out[variant] = (jsig.SigLipConfig.from_gguf(jr.kv), jsig.load_params(jr),
                        tsig.SigLipConfig.from_gguf(tr.kv),
                        tsig.load_params(tr, device="cpu"))
    return out


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=ROWS_RTOL * np.abs(want).max())


@pytest.mark.parametrize("variant", ["plain", "pre_ln", "swapped"])
def test_encode_image_as_jax(vpms, variant):
    """One non-square slice (3 x 5 patches): [n_queries, d_out] rows."""
    jcfg, jp, tcfg, tp = vpms[variant]
    assert dataclasses_equal(tcfg, jcfg)
    assert (tp["pre_ln_w"] is not None) == (variant == "pre_ln")
    if variant == "swapped":  # the loader put them back by shape
        assert tp["layers"][0]["w_up"].shape == (tcfg.d_ff, tcfg.d_model)
    px = np.random.default_rng(1).standard_normal((42, 70, 3)).astype(np.float32)
    got = tsig.encode_image_np(tp, tcfg, px).numpy()
    want = jsig.encode_image_np(jp, jcfg, px)
    assert got.shape == want.shape == (tcfg.n_queries, tcfg.d_out)
    _close(got, want)


def dataclasses_equal(a, b):
    return all(getattr(a, f) == getattr(b, f) for f in a.__dataclass_fields__)


def test_vpm_params_from_jax(vpms):
    """omni_tpu's params carried across equal the port's loader's, bit for
    bit, the patch weight viewed as the product's."""
    _, jp, _, tp = vpms["pre_ln"]
    cp = vpm_from_jax_params(jax.tree_util.tree_map(np.asarray, jp), "cpu")

    def flat(p, pre=""):
        if isinstance(p, dict):
            return {k2: v2 for k, v in p.items() for k2, v2 in flat(v, f"{pre}{k}.").items()}
        if isinstance(p, list):
            return {k2: v2 for i, v in enumerate(p)
                    for k2, v2 in flat(v, f"{pre}{i}.").items()}
        return {pre: p}

    a, b = flat(cp), flat(tp)
    assert a.keys() == b.keys()
    for k in a:
        if a[k] is None:
            assert b[k] is None, k
        else:
            assert a[k].shape == b[k].shape and torch.equal(a[k], b[k]), k
    assert cp["patch_w"].shape == (32, 3 * 14 * 14)


def test_cli_vision_encoder_as_jax(tmp_path):
    """omni-cli's --omni encoders on one sliced 600 x 400 image (an
    overview of 39 x 26 patches, two slices of 28 x 37): the same parts."""
    llm = write_tiny_model_dir(tmp_path / "model")
    args = argparse.Namespace(ctx_size=256, temp=0.0, no_audio=True, no_tts=True,
                              omni=True, duplex=False, max_slice_nums=9)
    jpipe = jcli.build_pipeline(jcli.resolve_model_paths(llm), args)
    tpipe = tcli.build_pipeline(tcli.resolve_model_paths(llm), args, device="cpu")
    try:
        img = _img(np.random.default_rng(4), 400, 600)
        want = jpipe.vision_encoder(img)
        got = tpipe.vision_encoder(img)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _close(g.numpy(), np.asarray(w))
        # the override: no slices
        assert len(tpipe.vision_encoder(img, max_slice_nums=0)) == 1
        assert tpipe.cfg.media_type == 2
    finally:
        jpipe.shutdown()
        tpipe.shutdown()


def test_vision_limits_readings_on_the_cpu(tmp_path):
    """`vision_limits.readings`, the gaps behind chip_smoke.py's VPM check,
    on `testing_synth.write_vpm_gguf` at a small width: both sides on the
    CPU agree exactly, the two position faults move the rows (TF32 does
    not exist on the CPU)."""
    from omni_tpu_torch import vision_limits
    from omni_tpu_torch.testing_synth import write_vpm_gguf

    path = str(tmp_path / "vpm.gguf")
    write_vpm_gguf(path, torch.Generator().manual_seed(0), n_layers=2, d_model=64,
                   n_heads=4, d_ff=128, d_out=128, n_queries=8)
    r = vision_limits.readings(path, 0, torch.device("cpu"))
    assert r["sound"] == r["tf32"] == 0.0
    assert r["sincos_transposed"] > 1e-3 and r["buckets_one_row_off"] > 1e-3
