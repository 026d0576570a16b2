"""The port's GGUF path (omni_tpu_torch) against the JAX package: the
reader and writer in both directions, the load policy, `Qwen3Config.from_gguf`
and `qwen3.load_params` on a tiny Q4_K_M file, the Q4_K_M type map, the
port's own Q4_K_M writer, and a greedy turn served from that file.
Everything here runs on the CPU."""

import numpy as np
import pytest
import torch

import jax
from jax._src import compilation_cache
from omni_tpu.cli import quantize as jax_quantize
from omni_tpu.core import GGMLType, quants
from omni_tpu.core.dtypes import type_traits
from omni_tpu.core.gguf import GGUFReader as JaxReader
from omni_tpu.core.gguf import GGUFWriter as JaxWriter
from omni_tpu.kernels.qformats import load_quantized as jax_load_quantized
from omni_tpu.models import qwen3 as jq
from omni_tpu.omni.pipeline import OmniPipeline as JaxPipeline
from omni_tpu.omni.pipeline import SessionConfig as JaxSessionConfig
from omni_tpu.runtime import Context as JaxContext
from omni_tpu.runtime import SamplerParams as JaxSamplerParams
from omni_tpu.testing import write_tiny_qwen3
from omni_tpu_torch import testing_synth
from omni_tpu_torch.convert import from_jax_params
from omni_tpu_torch.core.gguf import GGUFReader, GGUFWriter
from omni_tpu_torch.kernels.qformats import QTensor, load_quantized
from omni_tpu_torch.models import qwen3 as tq
from omni_tpu_torch.omni.pipeline import OmniPipeline, SessionConfig
from omni_tpu_torch.runtime import Context, SamplerParams
from test_torch_model import WordTokenizer, _serve


@pytest.fixture(scope="module", autouse=True)
def no_compile_cache():
    """Keep the JAX reference calls from writing compile-cache entries into
    omni_tpu/_warmcache/. JAX decides once per process whether the cache is
    in use, so that decision is reset on the way in and out."""
    old = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", old)
    compilation_cache.reset_cache()


# ------------------------------------------------------------ the container

def _content():
    """KV of every kind the Qwen3 files use, and tensors of four types."""
    rng = np.random.default_rng(0)
    kv = {"general.architecture": "qwen3", "qwen3.block_count": 36,
          "qwen3.rope.freq_base": 1000000.0, "general.flag": True,
          "general.neg": -5, "general.big": 2**40,
          "tokenizer.ggml.tokens": ["<a>", "bé", "<|im_end|>"],
          "tokenizer.ggml.token_type": [1, 3, 3],
          "tokenizer.ggml.scores": [0.5, -1.0, 2.0]}
    w = rng.standard_normal((8, 512), dtype=np.float32)
    tensors = {
        "norm.weight": (rng.standard_normal(100, dtype=np.float32), None, None),
        "half.weight": (rng.standard_normal((3, 40)).astype(np.float16), None, None),
        "q4.weight": (quants.quantize(w, GGMLType.Q4_K), GGMLType.Q4_K, (8, 512)),
        "q6.weight": (quants.quantize(w, GGMLType.Q6_K), GGMLType.Q6_K, (8, 512)),
    }
    return kv, tensors


def _write(writer_cls, path):
    kv, tensors = _content()
    w = writer_cls(path)
    for k, v in kv.items():
        w.add_kv(k, v)
    for name, (data, t, shape) in tensors.items():
        w.add_tensor(name, data, t, logical_shape=shape)
    w.write()


def _assert_reads_back(reader):
    kv, tensors = _content()
    assert set(reader.kv) == set(kv)
    for k, v in kv.items():
        got = reader.kv[k]
        if isinstance(v, list):
            got = [x.item() if isinstance(x, np.generic) else x for x in got]
            assert got == pytest.approx(v) if isinstance(v[0], float) else got == v
        else:
            assert got == v, k
    assert list(reader.tensors) == list(tensors)
    for name, (data, t, shape) in tensors.items():
        ti = reader.tensors[name]
        assert ti.shape == (shape or data.shape)
        assert ti.ggml_type == (t if t is not None else
                                {np.float32: GGMLType.F32,
                                 np.float16: GGMLType.F16}[data.dtype.type])
        np.testing.assert_array_equal(ti.data, data)


def test_port_reader_reads_the_jax_writer(tmp_path):
    _write(JaxWriter, tmp_path / "jax.gguf")
    _assert_reads_back(GGUFReader(tmp_path / "jax.gguf"))


def test_jax_reader_reads_the_port_writer(tmp_path):
    _write(GGUFWriter, tmp_path / "port.gguf")
    _assert_reads_back(JaxReader(tmp_path / "port.gguf"))


def test_both_writers_write_the_same_bytes(tmp_path):
    _write(JaxWriter, tmp_path / "jax.gguf")
    _write(GGUFWriter, tmp_path / "port.gguf")
    assert (tmp_path / "jax.gguf").read_bytes() == (tmp_path / "port.gguf").read_bytes()


def test_port_writer_streams_lazy_tensors(tmp_path):
    """A tensor given as a function is made only when it is written, once,
    in file order; a blob of the wrong size is refused."""
    made = []

    def lazy(i):
        def make():
            made.append(i)
            return np.full(4, i, np.float32)
        return make

    w = GGUFWriter(tmp_path / "lazy.gguf")
    for i in range(3):
        w.add_tensor(f"t{i}", lazy(i), GGMLType.F32, (4,))
    assert made == []
    w.write()
    assert made == [0, 1, 2]
    r = GGUFReader(tmp_path / "lazy.gguf")
    np.testing.assert_array_equal(r.tensors["t2"].data, np.full(4, 2, np.float32))
    w = GGUFWriter(tmp_path / "bad.gguf")
    w.add_tensor("t", lambda: np.zeros(3, np.float32), GGMLType.F32, (4,))
    with pytest.raises(ValueError, match="needs 16"):
        w.write()


# ---------------------------------------------------------------- load policy

@pytest.mark.parametrize("qtype,shape,keep", [
    (GGMLType.F32, (64,), True), (GGMLType.F16, (4, 64), True),
    (GGMLType.BF16, (4, 64), True), (GGMLType.Q4_K, (4, 512), False),
    (GGMLType.Q6_K, (4, 512), False), (GGMLType.Q4_K, (512,), True),
    (GGMLType.Q8_0, (4, 96), False), (GGMLType.Q8_0, (96,), True)],
    ids=["f32-1d", "f16-2d", "bf16-2d", "q4k-dense", "q6k-dense", "q4k-1d",
         "q8_0-dense", "q8_0-1d"])
def test_load_quantized_widens_like_jax(qtype, shape, keep):
    """Plain types widen (1-D to f32, 2-D to bf16), and a quantized tensor
    that is not kept quantized dequantises, to the JAX package's values
    bit for bit."""
    x = np.random.default_rng(1).standard_normal(shape, dtype=np.float32)
    blocks = quants.quantize(x, qtype)
    want = np.asarray(jax_load_quantized(blocks, qtype, shape, keep)
                      .astype(np.float32))
    got = load_quantized(blocks, qtype, shape, keep, "cpu")
    assert got.dtype == (torch.float32 if len(shape) == 1 else torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("qtype", [GGMLType.TQ1_0, GGMLType.IQ2_XXS, GGMLType.TQ2_0],
                         ids=lambda t: t.name)
def test_load_quantized_refuses_unported_formats(qtype):
    """The JAX package widens TQ1_0, TQ2_0 and IQ2_XXS to bf16 at load; the
    port has no dequantiser for them yet, so it raises, naming the format,
    rather than widening them quietly."""
    if qtype == GGMLType.IQ2_XXS:  # omni_tpu has no IQ2_XXS encoder
        blocks = np.zeros((2, type_traits(qtype).type_size), np.uint8)
    else:
        blocks = quants.quantize(np.zeros((2, 256), np.float32), qtype)
    with pytest.raises(NotImplementedError, match=qtype.name):
        load_quantized(blocks, qtype, (2, 256), device="cpu")


# ------------------------------------------------------- the Q4_K_M file

@pytest.fixture(scope="module")
def q4km(tmp_path_factory):
    """The tiny Qwen3 of the JAX package's tools, quantized Q4_K_M by
    `omni-quantize`: layers 2-3 get Q6_K attn_v and ffn_down, the head is
    Q6_K, every other weight Q4_K."""
    d = tmp_path_factory.mktemp("q4km")
    src, dst = d / "f32.gguf", d / "q4km.gguf"
    write_tiny_qwen3(src, qtype=GGMLType.F32, n_layers=4, d_model=256,
                     n_heads=2, n_kv_heads=1, head_dim=128, d_ff=512,
                     n_vocab=512, tied_head=False)
    jax_quantize.quantize_file(str(src), str(dst), "Q4_K_M")
    return dst


def _assert_same_params(jparams, tparams):
    """The port's dict equals the JAX tree (converted) leaf for leaf, for
    every key the port has; the JAX keys the port lacks are all None."""
    def same(a, b, where):
        if isinstance(b, QTensor):
            assert isinstance(a, QTensor) and a.ggml_type == b.ggml_type, where
            assert a.shape == b.shape and set(a.planes()) == set(b.planes()), where
            for nm, p in b.planes().items():
                assert torch.equal(getattr(a, nm), p), (where, nm)
        elif b is None:
            assert a is None, where
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), (where, a.dtype, b.dtype)

    conv = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    for key in ("token_embd", "output_norm", "output"):
        same(conv[key], tparams[key], key)
    assert {k for k, v in conv.items() if v is not None} <= set(tparams)
    for i, (jl, tl) in enumerate(zip(conv["layers"], tparams["layers"], strict=True)):
        for key, v in tl.items():
            same(jl[key], v, (i, key))
        assert {k for k, v in jl.items() if v is not None} <= set(tl), i


def test_from_gguf_matches_jax(q4km):
    jcfg = jq.Qwen3Config.from_gguf(JaxReader(q4km).kv)
    tcfg = tq.Qwen3Config.from_gguf(GGUFReader(q4km).kv)
    for f in tq.Qwen3Config.__dataclass_fields__:
        assert getattr(tcfg, f) == getattr(jcfg, f), f


def test_load_params_matches_jax(q4km):
    """Planes, embedding and norms equal the JAX package's, and the file's
    mix of formats is the Q4_K_M one."""
    tparams = tq.load_params(GGUFReader(q4km), device="cpu")
    _assert_same_params(jq.load_params(JaxReader(q4km)), tparams)
    q6 = {(i, k) for i, lp in enumerate(tparams["layers"])
          for k, w in lp.items()
          if isinstance(w, QTensor) and w.ggml_type == GGMLType.Q6_K}
    assert q6 == {(2, "wv"), (2, "w_down"), (3, "wv"), (3, "w_down")}
    assert tparams["output"].ggml_type == GGMLType.Q6_K
    assert tparams["token_embd"].dtype == torch.bfloat16


def test_fuse_refuses_a_mixed_layer_like_jax(q4km):
    """fuse=True would concatenate Q4_K wq with Q6_K wv: both packages
    refuse (the JAX package by assertion)."""
    with pytest.raises(AssertionError):
        jq.load_params(JaxReader(q4km), fuse=True)
    with pytest.raises(ValueError, match="mixed formats"):
        tq.load_params(GGUFReader(q4km), fuse=True, device="cpu")


@pytest.mark.parametrize("key,value", [
    ("general.architecture", "llama"), ("qwen3.expert_count", 8),
    ("qwen3.attention.kv_lora_rank", 512),
    ("qwen3.attention.sliding_window", 4096),
    ("qwen3.attention.max_alibi_bias", 8.0),
    ("qwen3.final_logit_softcapping", 30.0),
    ("qwen3.rope.scaling.type", "yarn")])
def test_from_gguf_refuses_what_the_dense_branch_does_not_run(q4km, key, value):
    kv = dict(GGUFReader(q4km).kv, **{key: value})
    with pytest.raises(NotImplementedError, match=str(value) if key ==
                       "general.architecture" else key):
        tq.Qwen3Config.from_gguf(kv)


def test_load_params_refuses_tensors_it_would_not_read(q4km, tmp_path):
    r = GGUFReader(q4km)
    w = GGUFWriter(tmp_path / "bias.gguf")
    for k, v in r.kv.items():
        w.add_kv(k, v)
    for name, ti in r.tensors.items():
        w.add_tensor(name, np.asarray(ti.data), ti.ggml_type, ti.shape)
    w.add_tensor("blk.0.attn_q.bias", np.zeros(256, np.float32))
    w.write()
    with pytest.raises(NotImplementedError, match="attn_q.bias"):
        tq.load_params(GGUFReader(tmp_path / "bias.gguf"), device="cpu")


# ---------------------------------------------------- the Q4_K_M type map

@pytest.mark.parametrize("n_layers", [4, 8, 9, 28, 36])
def test_type_map_matches_jax(n_layers):
    names = ["token_embd.weight", "output.weight"] + [
        f"blk.{i}.{t}.weight" for i in range(n_layers)
        for t in ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate",
                  "ffn_up", "ffn_down")]
    for name in names:
        assert testing_synth.pick_type(name, "Q4_K_M", GGMLType.Q4_K, n_layers) \
            == jax_quantize.pick_type(name, "Q4_K_M", GGMLType.Q4_K, n_layers), name
    if n_layers == 36:
        types = [testing_synth.pick_type(n, "Q4_K_M", GGMLType.Q4_K, 36)
                 for n in names[1:]]
        assert types.count(GGMLType.Q6_K) == 37
        assert types.count(GGMLType.Q4_K) == 216


def test_write_qwen3_gguf_loads_the_same_in_both_packages(tmp_path):
    """The port's random Q4_K_M writer: JAX's reader and load_params read
    the same parameters as the port's, the types follow the recipe, and
    the weights stay in the ranges that keep 36 layers tame."""
    cfg = tq.Qwen3Config(n_layers=8, d_model=256, n_heads=2, n_kv_heads=1,
                         head_dim=128, d_ff=512, n_vocab=300)
    path = tmp_path / "synth.gguf"
    types = testing_synth.write_qwen3_gguf(path, cfg, "Q4_K_M",
                                           torch.Generator().manual_seed(0))
    assert sum(t == GGMLType.Q6_K for t in types.values()) == 9
    tparams = tq.load_params(GGUFReader(path), device="cpu")
    _assert_same_params(jq.load_params(JaxReader(path)), tparams)
    assert tq.Qwen3Config.from_gguf(GGUFReader(path).kv).n_layers == 8
    from omni_tpu_torch.kernels.qformats import dequant

    lp = tparams["layers"][0]  # layer 0 of 8: Q6_K wv and w_down
    q4, q6 = dequant(lp["w_gate"]), dequant(lp["w_down"])
    assert 20 <= int(lp["w_gate"].sc.min()) and int(lp["w_gate"].sc.max()) < 64
    assert 20 <= int(lp["w_down"].sc.min()) and int(lp["w_down"].sc.max()) < 64
    # Q6_K values span their full signed range, as a real file's do: the
    # RMS of the Q4_K weights, none of their common part
    assert int(lp["w_down"].q.min()) == -32 and int(lp["w_down"].q.max()) == 31
    rms4, rms6 = q4.pow(2).mean().sqrt(), q6.pow(2).mean().sqrt()
    assert 0.015 < rms4 < 0.03 and 0.015 < rms6 < 0.03
    assert 0.01 < q4.mean() < 0.025 and abs(q6.mean()) < 0.002


def test_synth_q6k_spans_every_value():
    """The Q6_K weights the kernel checks use take all 64 values."""
    qt = testing_synth.synth_q6k(64, 512, "cpu", torch.Generator().manual_seed(0))
    assert int(qt.q.min()) == -32 and int(qt.q.max()) == 31
    assert 20 <= int(qt.sc.min()) and int(qt.sc.max()) < 64


def test_greedy_turn_from_the_q4km_file_token_identical(q4km):
    """A 16-token greedy turn served from the Q4_K_M file, loaded by each
    package's own reader and loader, emits the same tokens in both."""
    jr = JaxReader(q4km)
    jctx = JaxContext(jq.Qwen3Config.from_gguf(jr.kv), jq.load_params(jr),
                      jq.forward, jq.embed, n_ctx=512,
                      sampler=JaxSamplerParams(greedy=True))
    jpipe = JaxPipeline(llm=jctx, tokenizer=WordTokenizer(),
                        config=JaxSessionConfig(duplex=False, use_tts=False,
                                                max_preserved_context=512))
    try:
        want = _serve(jpipe, 1)
    finally:
        jpipe.shutdown()
    tr = GGUFReader(q4km)
    tctx = Context(tq.Qwen3Config.from_gguf(tr.kv),
                   tq.load_params(tr, device="cpu"), tq.forward, tq.embed,
                   n_ctx=512, sampler=SamplerParams(greedy=True), device="cpu")
    tpipe = OmniPipeline(tctx, WordTokenizer(),
                         SessionConfig(max_preserved_context=512))
    got = _serve(tpipe, 1)
    assert sum(len(e["content"].split()) for e in got) >= 10
    assert got == want
    assert tctx.n_past == jctx.n_past
