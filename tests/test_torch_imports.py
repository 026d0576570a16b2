"""The port's isolation from JAX, its kernel build, and chip_smoke.py's
refusal to run off the card. The machine with the card has no JAX, so
nothing under omni_tpu_torch/ nor chip_smoke.py may import `jax` or any of
`omni_tpu` (whose package __init__ runs JAX set-up)."""

import ast
import ctypes
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    p for p in (ROOT / "omni_tpu_torch").rglob("*.py")
    if "build" not in p.relative_to(ROOT / "omni_tpu_torch").parts) + [
    ROOT / "chip_smoke.py"]


def _run(code, cwd=ROOT, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT), **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_with_jax_and_omni_tpu_blocked():
    code = """
import sys
for name in ("jax", "jaxlib", "omni_tpu", "regex", "PIL"):
    sys.modules[name] = None  # any import of them raises ImportError
import importlib, pkgutil
import omni_tpu_torch
names = [m.name for m in pkgutil.walk_packages(omni_tpu_torch.__path__,
                                               "omni_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "omni_tpu_torch.kernels.fused_ffn" in names  # kernel I's wrapper
for name in ("omni_tpu_torch.tokenizer", "omni_tpu_torch.tokenizer.bpe",
             "omni_tpu_torch.tokenizer.unicode_ln",
             "omni_tpu_torch.chat", "omni_tpu_torch.runtime.sampler",
             "omni_tpu_torch.omni.pipeline", "omni_tpu_torch.omni.audio",
             "omni_tpu_torch.models.whisper", "omni_tpu_torch.models.tts",
             "omni_tpu_torch.models.token2wav",
             "omni_tpu_torch.models.token2wav.conformer",
             "omni_tpu_torch.models.token2wav.dit",
             "omni_tpu_torch.models.token2wav.hifigan",
             "omni_tpu_torch.models.token2wav.prompt_cache",
             "omni_tpu_torch.cli.omni_cli", "omni_tpu_torch.spoken_limits",
             "omni_tpu_torch.omni.image", "omni_tpu_torch.models.siglip",
             "omni_tpu_torch.vision_limits", "omni_tpu_torch.cli.args",
             "omni_tpu_torch.grammar", "omni_tpu_torch.grammar.gbnf",
             "omni_tpu_torch.grammar.json_schema", "omni_tpu_torch.chat_parser",
             "omni_tpu_torch.runtime.slots", "omni_tpu_torch.server",
             "omni_tpu_torch.server.main"):
    assert name in names, name
# the spoken round's pieces work without them: a mel, a TTS draw, a code
# window's conformer chunk at a tiny width
import numpy as np
import torch
from omni_tpu_torch.omni.audio import log_mel_spectrogram
from omni_tpu_torch.models import tts
from omni_tpu_torch.models.token2wav import conformer
assert log_mel_spectrogram(np.zeros(1600, np.float32),
                           np.ones((4, 201), np.float32)).shape == (10, 4)
assert 0 <= int(tts.sample_audio_token(torch.randn(64), torch.full((16,), -1),
                                       generator=torch.Generator())) < 64
ccfg = conformer.ConformerConfig(d_model=8, n_heads=2, d_ff=16, n_blocks=1,
                                 n_up_blocks=1, max_tokens=32)
layer = {k: torch.zeros(s) for k, s in (
    ("norm_ff_w", 8), ("norm_ff_b", 8), ("norm_mha_w", 8), ("norm_mha_b", 8),
    ("q_w", (8, 8)), ("q_b", 8), ("k_w", (8, 8)), ("k_b", 8), ("v_w", (8, 8)),
    ("v_b", 8), ("o_w", (8, 8)), ("o_b", 8), ("pos_w", (8, 8)),
    ("pos_bias_u", (2, 4)), ("pos_bias_v", (2, 4)), ("ff1_w", (16, 8)),
    ("ff1_b", 16), ("ff2_w", (8, 16)), ("ff2_b", 8))}
cp = {k: torch.zeros(s) for k, s in (
    ("embed_w", (8, 8)), ("embed_b", 8), ("embed_ln_w", 8), ("embed_ln_b", 8),
    ("prelook1_w", (8, 8, 4)), ("prelook1_b", 8), ("prelook2_w", (8, 8, 3)),
    ("prelook2_b", 8), ("up_conv_w", (8, 8, 5)), ("up_conv_b", 8),
    ("up_embed_w", (8, 8)), ("up_embed_b", 8), ("up_embed_ln_w", 8),
    ("up_embed_ln_b", 8), ("after_norm_w", 8), ("after_norm_b", 8))}
cp["encoders"], cp["up_encoders"] = [layer], [layer]
out, _ = conformer.encode_chunk(cp, ccfg, torch.zeros(28, 8),
                                conformer.ConformerState.create(ccfg, "cpu"))
assert out.shape == (50, 8)
# the tokenizer, the sampler chain and the round window work without them
from omni_tpu_torch.tokenizer import build_tokenizer
from omni_tpu_torch.testing_synth import qwen2_vocab_kv
from omni_tpu_torch.chat import apply_chat_template
from omni_tpu_torch.runtime.sampler import SamplerParams, sample
from omni_tpu_torch.omni.pipeline import RoundBoundary, SessionConfig
import torch
tok = build_tokenizer(qwen2_vocab_kv(1024, 300))
text = apply_chat_template("chatml", [{"role": "user", "content": "Hi 'S 一二"}])
assert tok.decode(tok.encode(text)) == text
assert 0 <= int(sample(torch.randn(64), SamplerParams(mirostat=0),
                       generator=torch.Generator().manual_seed(0))) < 64
assert SessionConfig().fused_decode and RoundBoundary(0, 1).end_pos == 1
# the vision path without Pillow: slicing, the VPM's positions; decoding a
# file names what it needs
from omni_tpu_torch.omni.image import load_image, preprocess_uhd
from omni_tpu_torch.models import siglip
from omni_tpu_torch.omni.pipeline import UnitEntry
parts = preprocess_uhd(np.zeros((500, 700, 3), np.uint8), [0.5] * 3, [0.5] * 3)
assert len(parts) > 1 and parts[0].dtype == np.float32
assert siglip.sincos_pos_embed_2d(16, 3, 2).shape == (6, 16)
assert not UnitEntry(0).closed
try:
    load_image("x.jpg")
    raise AssertionError("load_image decoded without Pillow")
except ImportError as e:
    assert "Pillow" in str(e)
# the server's pieces work without them, and without jinja2: a grammar
# walk, a family renderer, a tool-call parse, the server's state
sys.modules["jinja2"] = None
from omni_tpu_torch.grammar import VocabTrie, json_schema_to_gbnf, parse_gbnf
from omni_tpu_torch.chat import apply_chat_template as family
from omni_tpu_torch.chat_parser import parse_response
from omni_tpu_torch.server.main import ServerState
g = parse_gbnf(json_schema_to_gbnf({"type": "boolean"}))
allowed = set(g.allowed_tokens(VocabTrie([(0, "t"), (1, "x"), (2, "fal")])))
assert {0, 2} <= allowed and 1 not in allowed
assert family("llama3", [{"role": "user", "content": "hi"}]).endswith(
    "<|start_header_id|>assistant<|end_header_id|>\\n\\n")
assert parse_response('<tool_call>{"name": "f", "arguments": {}}</tool_call>',
                      "hermes")["tool_calls"][0]["function"]["name"] == "f"
import chip_smoke
assert not any(k == "jax" or k.startswith(("jax.", "omni_tpu."))
               for k, v in sys.modules.items() if v is not None)
print(len(names))
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 16


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_cpp_extension_imports(path):
    """No import of jax/omni_tpu at any level, and no
    torch.utils.cpp_extension (the kernels build with nvcc + ctypes)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "omni_tpu", "regex"), (path, mod)
            assert not mod.startswith("torch.utils.cpp_extension"), (path, mod)
    assert "cpp_extension" not in path.read_text()


def test_chip_smoke_fails_without_cuda():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo it
    fails (even where a card is present) and prints no result."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    code = """
import runpy, sys, torch
torch.cuda.is_available = lambda: True  # as on the machine with the card
sys.argv = ["chip_smoke.py"]
runpy.run_path("chip_smoke.py", run_name="__main__")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "omni_tpu_torch" in r.stderr
    assert '"ok"' not in r.stdout


def test_kernel_build_runs_nvcc_per_source_in_parallel(tmp_path):
    """One nvcc per source, all started before any is waited on, for sm_90a,
    into a directory keyed by the sources' hash; loaded with ctypes with
    void* pointers and stream."""
    from omni_tpu_torch.kernels import _build

    started, waited = [], []

    class FakeProc:
        def __init__(self, cmd, **kw):
            started.append(cmd)
            self.out = Path(cmd[cmd.index("-o") + 1])
            self.returncode = 0

        def communicate(self):
            waited.append(len(started))
            self.out.write_bytes(b"")
            return b"", b""

    class FakeLib:
        def __init__(self, path):
            self.path = path
            for entry in _build.SOURCES[Path(path).stem + ".cu"]:
                setattr(self, entry, mock.Mock())

    _build.load.cache_clear()
    try:
        with mock.patch.object(_build, "BUILD", tmp_path), \
                mock.patch.object(_build, "nvcc", return_value="nvcc"), \
                mock.patch.object(_build.subprocess, "Popen", FakeProc), \
                mock.patch.object(_build.ctypes, "CDLL", FakeLib):
            fns = _build.load()
            want_dir = _build.build_dir()
    finally:
        _build.load.cache_clear()
    assert len(started) == len(_build.SOURCES) == 9
    assert waited[0] == len(started)  # all started before the first wait
    for cmd in started:
        assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    out_dirs = {Path(c[c.index("-o") + 1]).parent for c in started}
    assert out_dirs == {want_dir} and want_dir.parent == tmp_path
    assert sorted(fns) == ["flash_decode_bf16", "flash_decode_i4", "flash_decode_i8",
                           "iq4_nl_gemv", "iq4_xs_gemv", "mxfp4_gemv",
                           "q2k_gemv", "q3k_gemv",
                           "q4_0_gemm", "q4_0_gemv", "q4_1_gemm", "q4_1_gemv",
                           "q4k_gemm", "q4k_gemv", "q5_0_gemm", "q5_0_gemv",
                           "q5_1_gemm", "q5_1_gemv", "q5k_gemm", "q5k_gemv",
                           "q6k_gemv", "q8_0_gemv", "qffn_down", "qffn_gated",
                           "qgemm_iq4_nl", "qgemm_iq4_xs", "qgemm_mxfp4", "qgemm_q2k",
                           "qgemm_q3k", "qgemm_q4_0", "qgemm_q4_1", "qgemm_q4k",
                           "qgemm_q5_0", "qgemm_q5_1", "qgemm_q5k", "qgemm_q6k",
                           "qgemm_q8_0"]
    for name, fn in fns.items():
        assert fn.argtypes[:7] == [ctypes.c_void_p] * 7
        if name.startswith("flash"):  # 9 pointers, int64 strides, f32 scale
            assert fn.argtypes == _build.FLASH_ARGS and len(fn.argtypes) == 21
            assert fn.argtypes[14:17] == [ctypes.c_longlong] * 2 + [ctypes.c_float]
        elif name.startswith("qffn"):  # input, six planes, out or workspace, 6 ints
            assert fn.argtypes == _build.QFFN_ARGS and len(fn.argtypes) == 15
            assert fn.argtypes[7:14] == [ctypes.c_void_p] + [ctypes.c_int] * 6
        elif name.endswith("_gemm") or name.startswith("qgemm"):
            # kernels B and D: x, six planes, out, workspace, m, n, k,
            # splits, out_f32
            assert fn.argtypes == _build.GEMM_ARGS and len(fn.argtypes) == 15
            assert fn.argtypes[7:14] == [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
        else:  # x, six planes (q, sc, mn, d, dm, qh), out, m, n, k, out_f32
            assert fn.argtypes == _build.MATMUL_ARGS and len(fn.argtypes) == 13
            assert fn.argtypes[7:12] == [ctypes.c_void_p] + [ctypes.c_int] * 4
        assert fn.argtypes[-1] == ctypes.c_void_p and fn.restype == ctypes.c_int
    assert sorted(p.name for p in want_dir.iterdir()) == [
        "codebook_gemv.so", "flash_decode.so", "lowbit_gemv.so", "q4k_gemm.so",
        "q4k_gemv.so", "q6k_gemv.so", "q8_0_gemv.so", "qffn.so", "qgemm.so"]


def test_build_dir_hashes_the_shared_headers(tmp_path):
    """A change to a header the sources include (csrc/*.cuh) moves the build
    directory, so no library built from the old header is reused."""
    import shutil

    from omni_tpu_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers
    with mock.patch.object(_build, "CSRC", csrc):
        before = _build.build_dir()
        headers[0].write_text(headers[0].read_text() + "\n// changed\n")
        assert _build.build_dir() != before
