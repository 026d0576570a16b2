"""Synthetic full-size Qwen3 weights (counterpart of
omni_tpu/testing_synth.py), made ON THE DEVICE from a `torch.Generator`, so
no multi-GB host-to-device copy happens. Three forms:

- `synth_qwen3_params`: an all-Q4_K parameter dict in the port's planes.
  The value ranges are the JAX package's: nibbles 0..255 per byte,
  sc 20..63, mn 0..39, d and dm uniform in [1e-5, 1.1e-4), a bf16 embedding
  uniform in [-0.02, 0.02). It streams 4.49 GB per decode token, less than
  a real Q4_K_M checkpoint (5.27 GB: its Q6_K tensors are larger).
- `write_qwen3_gguf`: a GGUF file whose tensors take the types of a
  quantization recipe (Q4_K_M, Q5_K_M, Q8_0, Q4_0, Q5_0, IQ4_NL, IQ4_XS,
  MXFP4, Q2_K or Q3_K: llama.cpp's rules, the port's copy of
  `omni_tpu/cli/quantize.py`,
  and for Q4_0 and Q5_0 optionally llama.cpp's importance-matrix layout),
  with random block
  bytes: Q4_K in the ranges above; Q5_K the same, its high bits random
  bytes too (values 0..31); Q6_K with its 6-bit values over their full signed range
  (q - 32 in -32..31, as a real file's are), scales 20..63 and d uniform
  in [5e-6, 5.5e-5), so that its weights have about the Q4_K weights' RMS
  (0.027 against 0.025); Q8_0 with its int8 values over -127..127 (the
  range llama.cpp's quantizer writes) and d uniform in [2e-4, 4.5e-4), RMS
  0.025; Q4_0 and Q5_0 (recipes of the same names) with every nibble and
  high bit random and d uniform in [3.5e-3, 7.5e-3) and [1.75e-3, 3.75e-3),
  RMS 0.026 (signed weights, (q - 8)·d and (q - 16)·d); Q4_1 and Q5_1 (the
  importance-matrix layout's ffn_down) with the same d, an added min m
  uniform in [-0.08, 0.01) (one in nine positive; weights of mean ~0.006,
  RMS ~0.04), and d = 0 in about one block in 64, so that a kernel's
  dl = 0 residual path runs; IQ4_NL, IQ4_XS and MXFP4 (the codebook
  recipes) with every nibble random, so every codebook index appears:
  IQ4_NL's d uniform in [2.5e-4, 5e-4) (RMS 0.026), IQ4_XS's 6-bit group
  scales random, so ls − 32 spans −32..31, under a d uniform in
  [1.5e-5, 2.5e-5) (RMS 0.025), MXFP4's e8m0 exponents 119..121 (d 2^-9 to
  2^-7, mid-range of the byte; RMS 0.030); Q2_K and Q3_K (recipes of the
  same names: every layer weight and the embedding in the format, the head
  Q6_K, the JAX quantizer's rule for its uniform recipes) with every bit
  of the block random but d and dmin, which are drawn as Q4_K's are,
  uniform in [1e-5, 1.1e-4): Q2_K's 4-bit scales and mins over 0..15 and
  its values over 0..3 (weights of mean 2.3e-4, RMS 9.6e-4), Q3_K's hmask
  bits, 2-bit quarters and 12 bytes of packed 6-bit scales random, so its
  scales span −32..31 and its values −4..3 (mean ~0, RMS 2.9e-3). Those
  ranges were fixed before any check ran and not tuned since; they make
  the low-bit weights 9-26x smaller than the Q4_K ones, which the
  per-head q/k norms and the RMS norms absorb. The Q4_K weights in these
  ranges have a common part (mean 0.017, 91 % positive), and so do the
  Q2_K ones (their mins); the Q6_K, Q8_0, Q4_0, Q5_0 and Q3_K weights have
  none (mean ~0), so a Q6_K or Q8_0 output head gives logits of max ~10
  where the all-Q4_K model's reach ~110.
- `synth_qwen3_dense_params`: the dense parameter dict of an F16 checkpoint
  as the port loads one (every weight bf16, drawn in F16 first), normal
  weights of RMS 0.025, unfused.
- `qwen2_vocab_kv`: the tokenizer.ggml.* keys of a Qwen2-style byte-level
  BPE vocabulary at any width, made with no download: the 256 byte symbols,
  the merges a deterministic BPE pass learns from the repository's
  SURVEY.md (split as qwen2 splits), filler tokens up to the width, and at
  the end, as Qwen2 places them, the ChatML and MiniCPM-o specials the omni
  pipeline names (`SPECIALS`), control tokens; <|im_end|> and
  <|endoftext|> end a generation. `write_qwen3_gguf(..., vocab=True)`
  writes it into the file.

Dense decode speed does not depend on the values."""

from __future__ import annotations

import collections
import functools
import os
from pathlib import Path

import numpy as np
import torch

from .core.dtypes import GGMLType, type_traits
from .core.gguf import GGUFWriter
from .kernels.qformats import LEGACY, QTensor, repack
from .models.qwen3 import Qwen3Config, fuse_layer
from .tokenizer.bpe import bytes_to_unicode, split_qwen2
from .tokenizer.vocab import TYPE_CONTROL, TYPE_NORMAL

QWEN3_8B = Qwen3Config(
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12288, n_vocab=151748, rope_base=1000000.0, rms_eps=1e-6,
)


def synth_q4k(n: int, k: int, device, generator: torch.Generator) -> QTensor:
    """Random Q4_K QTensor [n, k] in the port's N-major layout."""
    def ints(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, dtype=dtype, device=device,
                             generator=generator)

    def unif(shape):
        return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
            1e-5, 1.1e-4, generator=generator)

    return QTensor(GGMLType.Q4_K, (n, k),
                   q=ints(0, 256, (n, k // 2), torch.uint8),
                   sc=ints(20, 64, (n, k // 32), torch.int8),
                   mn=ints(0, 40, (n, k // 32), torch.int8),
                   d=unif((n, k // 256)), dm=unif((n, k // 256)))


def _unif_f16_bytes(nb: int, lo: float, hi: float, device,
                    generator: torch.Generator) -> torch.Tensor:
    """nb f16 values uniform in [lo, hi) as little-endian bytes [nb, 2]."""
    v = torch.empty((nb, 1), dtype=torch.float32, device=device).uniform_(
        lo, hi, generator=generator)
    return v.to(torch.float16).view(torch.uint8)


def _ints(lo: int, hi: int, shape, device, generator) -> torch.Tensor:
    return torch.randint(lo, hi, shape, dtype=torch.uint8, device=device,
                         generator=generator)


def _kquant_head(nb: int, device, generator: torch.Generator) -> torch.Tensor:
    """The first 16 bytes of nb random Q4_K or Q5_K blocks: d and dmin
    uniform in [1e-5, 1.1e-4) as f16, then the 6-bit scales 20..63 and mins
    0..39 packed as ggml packs them (get_scale_min_k4's inverse)."""
    sc = _ints(20, 64, (nb, 8), device, generator)
    mn = _ints(0, 40, (nb, 8), device, generator)
    a = sc[:, :4] | ((sc[:, 4:] >> 4) << 6)
    bb = mn[:, :4] | ((mn[:, 4:] >> 4) << 6)
    c = (sc[:, 4:] & 0x0F) | ((mn[:, 4:] & 0x0F) << 4)
    return torch.cat([_unif_f16_bytes(nb, 1e-5, 1.1e-4, device, generator),
                      _unif_f16_bytes(nb, 1e-5, 1.1e-4, device, generator),
                      a, bb, c], dim=1)


def q4k_blocks(nb: int, device, generator: torch.Generator) -> torch.Tensor:
    """nb random Q4_K blocks [nb, 144]: d, dmin, the packed scales and
    mins, nibbles."""
    head = _kquant_head(nb, device, generator)
    return torch.cat([head, _ints(0, 256, (nb, 128), device, generator)], dim=1)


def q5k_blocks(nb: int, device, generator: torch.Generator) -> torch.Tensor:
    """nb random Q5_K blocks [nb, 176]: Q4_K's head, then 32 bytes of high
    bits and 128 of nibbles, all random (values 0..31, every high bit a coin
    flip: a kernel that drops or misplaces them is off by 16·dl)."""
    head = _kquant_head(nb, device, generator)
    return torch.cat([head, _ints(0, 256, (nb, 160), device, generator)], dim=1)


def q6k_blocks(nb: int, device, generator: torch.Generator) -> torch.Tensor:
    """nb random Q6_K blocks [nb, 210]: low nibbles, high bits (values
    q - 32 over -32..31), int8 scales 20..63, d in [5e-6, 5.5e-5)."""
    return torch.cat([_ints(0, 256, (nb, 192), device, generator),
                      _ints(20, 64, (nb, 16), device, generator),
                      _unif_f16_bytes(nb, 5e-6, 5.5e-5, device, generator)],
                     dim=1)


def q8_0_blocks(nb: int, device, generator: torch.Generator) -> torch.Tensor:
    """nb random Q8_0 blocks [nb, 34]: d in [2e-4, 4.5e-4) as f16 bytes,
    then 32 int8 values over -127..127."""
    q = torch.randint(-127, 128, (nb, 32), dtype=torch.int8, device=device,
                      generator=generator)
    return torch.cat([_unif_f16_bytes(nb, 2e-4, 4.5e-4, device, generator),
                      q.view(torch.uint8)], dim=1)


def legacy_blocks(t: GGMLType, nb: int, device,
                  generator: torch.Generator) -> torch.Tensor:
    """nb random blocks [nb, type_size] of legacy format `t`: d (then
    Q4_1/Q5_1's m) as f16, Q5_0/Q5_1's 4 bytes of high bits, 16 bytes of
    nibbles, every bit random. d is uniform in [3.5e-3, 7.5e-3) for Q4_0
    and Q4_1, [1.75e-3, 3.75e-3) for Q5_0 and Q5_1 (weights of RMS ~0.026
    either way); m uniform in [-0.08, 0.01), and where a block's draw falls
    below 1/64 its d is 0, keeping its m (w = m on all 32 elements: the
    residual path of kernel B's centered law)."""
    five = t in (GGMLType.Q5_0, GGMLType.Q5_1)
    lo, hi = (1.75e-3, 3.75e-3) if five else (3.5e-3, 7.5e-3)
    d = _unif_f16_bytes(nb, lo, hi, device, generator)
    fields = [d]
    if t in (GGMLType.Q4_1, GGMLType.Q5_1):
        zero = torch.rand((nb, 1), device=device, generator=generator) < 1 / 64
        fields = [d.masked_fill(zero, 0),
                  _unif_f16_bytes(nb, -0.08, 0.01, device, generator)]
    fields.append(_ints(0, 256, (nb, 20 if five else 16), device, generator))
    return torch.cat(fields, dim=1)


def iq4_nl_blocks(nb: int, device, generator: torch.Generator) -> torch.Tensor:
    """nb random IQ4_NL blocks [nb, 18]: d uniform in [2.5e-4, 5e-4) as f16
    (the codebook's RMS is 67.4: weights of RMS 0.026), then 16 bytes of
    random codebook indices."""
    return torch.cat([_unif_f16_bytes(nb, 2.5e-4, 5e-4, device, generator),
                      _ints(0, 256, (nb, 16), device, generator)], dim=1)


def iq4_xs_blocks(nb: int, device, generator: torch.Generator) -> torch.Tensor:
    """nb random IQ4_XS superblocks [nb, 136]: d uniform in [1.5e-5,
    2.5e-5) as f16, then scales_h, scales_l and the codebook indices, all
    random bytes: the 6-bit scales ls − 32 cover −32..31 (RMS 18.5; weights
    of RMS 0.025)."""
    return torch.cat([_unif_f16_bytes(nb, 1.5e-5, 2.5e-5, device, generator),
                      _ints(0, 256, (nb, 134), device, generator)], dim=1)


def mxfp4_blocks(nb: int, device, generator: torch.Generator) -> torch.Tensor:
    """nb random MXFP4 blocks [nb, 17]: the e8m0 exponent 119..121 (d =
    2^(e − 128), 2^-9..2^-7; the pre-doubled e2m1 codebook's RMS is 5.85:
    weights of RMS 0.030), then 16 bytes of random indices."""
    return torch.cat([_ints(119, 122, (nb, 1), device, generator),
                      _ints(0, 256, (nb, 16), device, generator)], dim=1)


def q2k_blocks(nb: int, device, generator: torch.Generator) -> torch.Tensor:
    """nb random Q2_K superblocks [nb, 84]: 16 scale bytes (a 4-bit scale
    and a 4-bit min each) and 64 bytes of 2-bit values, all random, then d
    and dmin uniform in [1e-5, 1.1e-4) as f16 (`q4k_blocks`'s draws)."""
    return torch.cat([_ints(0, 256, (nb, 80), device, generator),
                      _unif_f16_bytes(nb, 1e-5, 1.1e-4, device, generator),
                      _unif_f16_bytes(nb, 1e-5, 1.1e-4, device, generator)], dim=1)


def q3k_blocks(nb: int, device, generator: torch.Generator) -> torch.Tensor:
    """nb random Q3_K superblocks [nb, 110]: hmask (32 bytes), the 2-bit
    values (64) and the packed 6-bit scales (12), all random (scales
    −32..31, values −4..3, every high bit a coin flip: a kernel that reads
    hmask's sense backwards is off by 4·dl), then d uniform in [1e-5,
    1.1e-4) as f16 (`q4k_blocks`'s draw)."""
    return torch.cat([_ints(0, 256, (nb, 108), device, generator),
                      _unif_f16_bytes(nb, 1e-5, 1.1e-4, device, generator)], dim=1)


# format -> its random block maker, (nb, device, generator) -> uint8
# [nb, type_size]
BLOCKS = {GGMLType.Q4_K: q4k_blocks, GGMLType.Q5_K: q5k_blocks,
          GGMLType.Q6_K: q6k_blocks, GGMLType.Q8_0: q8_0_blocks,
          **{t: functools.partial(legacy_blocks, t) for t in LEGACY},
          GGMLType.IQ4_NL: iq4_nl_blocks, GGMLType.IQ4_XS: iq4_xs_blocks,
          GGMLType.MXFP4: mxfp4_blocks, GGMLType.Q2_K: q2k_blocks,
          GGMLType.Q3_K: q3k_blocks}


def synth_quant(t: GGMLType, n: int, k: int, device,
                generator: torch.Generator) -> QTensor:
    """Random QTensor [n, k] of format `t` in the port's layout (random
    blocks from `BLOCKS`, repacked where they were made)."""
    nb = n * k // type_traits(t).block_size
    return repack(BLOCKS[t](nb, device, generator), t, (n, k))


def synth_q8_0(n: int, k: int, device, generator: torch.Generator) -> QTensor:
    """Random Q8_0 QTensor [n, k] (`synth_quant`)."""
    return synth_quant(GGMLType.Q8_0, n, k, device, generator)


def synth_q5k(n: int, k: int, device, generator: torch.Generator) -> QTensor:
    """Random Q5_K QTensor [n, k] (`synth_quant`)."""
    return synth_quant(GGMLType.Q5_K, n, k, device, generator)


def synth_q6k(n: int, k: int, device, generator: torch.Generator) -> QTensor:
    """Random Q6_K QTensor [n, k] (`synth_quant`)."""
    return synth_quant(GGMLType.Q6_K, n, k, device, generator)


# ---- quantization recipes: the port's copy of omni_tpu/cli/quantize.py ----

def use_more_bits(i_layer: int, n_layers: int) -> bool:
    """llama-quant.cpp:185: the layers whose attn_v and ffn_down Q4_K_M and
    Q5_K_M promote to Q6_K."""
    return (i_layer < n_layers // 8 or i_layer >= 7 * n_layers // 8
            or (i_layer - n_layers // 8) % 3 == 2)


# recipe -> its default type
RECIPES = {"Q4_K_M": GGMLType.Q4_K, "Q5_K_M": GGMLType.Q5_K,
           "Q8_0": GGMLType.Q8_0, "Q4_0": GGMLType.Q4_0, "Q5_0": GGMLType.Q5_0,
           "IQ4_NL": GGMLType.IQ4_NL, "IQ4_XS": GGMLType.IQ4_XS,
           "MXFP4": GGMLType.MXFP4, "Q2_K": GGMLType.Q2_K, "Q3_K": GGMLType.Q3_K}
# the importance-matrix layout's type for the first ffn_down layers
_IMATRIX_DOWN = {GGMLType.Q4_0: GGMLType.Q4_1, GGMLType.Q5_0: GGMLType.Q5_1}


def pick_type(name: str, ftype: str, default: GGMLType, n_layers: int,
              imatrix: bool = False) -> GGMLType:
    """Per-tensor type rules (the Q4_K_M and Q5_K_M schedules): the output
    head is Q6_K unless the recipe's type is Q8_0 (llama-quant.cpp keeps a
    Q8_0 head; the JAX package's quantizer makes it Q6_K under every
    recipe), the token embedding keeps the default, and Q4_K_M and Q5_K_M
    promote attn_v and ffn_down on the use_more_bits layers to Q6_K.

    imatrix=True is the layout llama.cpp writes when the file is quantized
    with an importance matrix (`llama-quant.cpp`, llama_tensor_get_type: for
    LLAMA_FTYPE_MOSTLY_Q4_0 / _Q5_0 with `qs.has_imatrix`, the ffn_down of
    layers i < n_layers / 8 becomes Q4_1 / Q5_1, a guard against those
    first layers going wrong); the JAX package's quantizer has no such rule
    (an importance matrix there weights the rounding only).

    The codebook recipes (IQ4_NL, IQ4_XS, MXFP4) and the uniform low-bit
    ones (Q2_K, Q3_K) follow the JAX quantizer: every 2-D weight in the
    recipe's type, the token embedding too, the head Q6_K (`quantize.py:
    46-60`; Qwen3's weights all have K % 256 == 0). llama.cpp's own Q2_K
    and Q3_K_M mixes promote some tensors to Q3_K, Q4_K or Q5_K; such a
    file is not in this repository, and this copy does not write one.
    llama.cpp's own IQ4_NL and IQ4_XS recipes promote some tensors (the
    head, attn_v, ffn_down on some layers), and its MXFP4 recipe,
    MXFP4_MOE, targets the expert tensors of a mixture-of-experts model;
    this repo's reference models neither, so neither does this copy."""
    i_layer = int(name.split(".")[1]) if name.startswith("blk.") else -1
    if name == "output.weight":
        return default if default == GGMLType.Q8_0 else GGMLType.Q6_K
    if name == "token_embd.weight":
        return default
    if ftype in ("Q4_K_M", "Q5_K_M") and i_layer >= 0:
        if ((".attn_v.weight" in name or ".ffn_down.weight" in name)
                and use_more_bits(i_layer, n_layers)):
            return GGMLType.Q6_K
    if (imatrix and ftype in ("Q4_0", "Q5_0") and ".ffn_down.weight" in name
            and 0 <= i_layer < n_layers // 8):
        return _IMATRIX_DOWN[default]
    return default


# the corpus of the synthesised vocabulary's merges: a file of the
# repository that no change rewrites
VOCAB_CORPUS = Path(__file__).resolve().parent.parent / "SURVEY.md"
# the specials of a Qwen2 vocabulary and of MiniCPM-o (the omni pipeline's
# SPECIALS), in the order they take after the regular tokens
VOCAB_SPECIALS = (
    "<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|speak|>", "<|listen|>",
    "<|chunk_eos|>", "<|chunk_tts_eos|>", "<|turn_eos|>", "<|tts_eos|>", "</s>",
    "<|tts_bos|>", "</unit>", "<unit>", "<|tts_pad|>", "<|audio_start|>",
    "<|audio_end|>", "<think>", "</think>", "<image>", "</image>", "<slice>",
    "</slice>")


def learn_merges(text: str, n_merges: int) -> list[tuple[str, str]]:
    """A deterministic byte-level BPE pass over `text`: words as qwen2
    splits them, in GPT-2's byte alphabet; each step merges the most
    frequent adjacent pair (ties: the smallest pair), until `n_merges` or
    no pair occurs twice."""
    b2u = bytes_to_unicode()
    freq = collections.Counter(split_qwen2(text))
    words = [[b2u[b] for b in w.encode("utf-8")] for w in freq]
    counts = list(freq.values())
    pairs: collections.Counter = collections.Counter()
    where: dict[tuple[str, str], set[int]] = collections.defaultdict(set)
    for wi, w in enumerate(words):
        for a, b in zip(w, w[1:]):
            pairs[a, b] += counts[wi]
            where[a, b].add(wi)
    merges = []
    while len(merges) < n_merges and pairs:
        best = min(pairs, key=lambda p: (-pairs[p], p))
        if pairs[best] < 2:
            break
        merges.append(best)
        a, b = best
        for wi in sorted(where.pop(best, ())):
            w, c = words[wi], counts[wi]
            for x, y in zip(w, w[1:]):  # the word's pairs leave...
                pairs[x, y] -= c
                if pairs[x, y] <= 0:
                    del pairs[x, y]
            i, out = 0, []
            while i < len(w):
                if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            words[wi] = out
            for x, y in zip(out, out[1:]):  # ...and come back merged
                pairs[x, y] += c
                where[x, y].add(wi)
    return merges


@functools.lru_cache(maxsize=4)
def qwen2_vocab_kv(n_vocab: int, n_merges: int = 4096) -> dict:
    """The tokenizer.ggml.* keys of a Qwen2-style vocabulary of `n_vocab`
    tokens: byte symbols, the merged tokens of `learn_merges` over
    VOCAB_CORPUS, fillers ("<filler i>": a space is no byte symbol, so no
    merge makes one), then VOCAB_SPECIALS as control tokens. eos is
    <|im_end|>, padding <|endoftext|>, no bos. Cached per process: copy
    the dict before changing it."""
    b2u = bytes_to_unicode()
    merges = learn_merges(VOCAB_CORPUS.read_text(encoding="utf-8"), n_merges)
    tokens = [b2u[b] for b in range(256)]
    seen = set(tokens)
    for a, b in merges:
        if a + b not in seen:
            seen.add(a + b)
            tokens.append(a + b)
    n_regular = n_vocab - len(VOCAB_SPECIALS)
    if len(tokens) > n_regular:
        raise ValueError(f"{n_vocab} tokens cannot hold {len(tokens)} byte "
                         f"and merged tokens and {len(VOCAB_SPECIALS)} specials")
    tokens += [f"<filler {i}>" for i in range(n_regular - len(tokens))]
    tokens += VOCAB_SPECIALS
    return {
        "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.pre": "qwen2",
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.token_type": ([TYPE_NORMAL] * n_regular
                                      + [TYPE_CONTROL] * len(VOCAB_SPECIALS)),
        "tokenizer.ggml.merges": [f"{a} {b}" for a, b in merges],
        "tokenizer.ggml.eos_token_id": tokens.index("<|im_end|>"),
        "tokenizer.ggml.padding_token_id": tokens.index("<|endoftext|>"),
        "tokenizer.ggml.add_bos_token": False,
    }


def write_qwen3_gguf(path, cfg: Qwen3Config, recipe: str,
                     generator: torch.Generator,
                     imatrix: bool = False,
                     vocab: bool = False) -> dict[str, GGMLType]:
    """Write a random `qwen3` GGUF of `cfg` (separate output head) whose
    2-D tensors take the types of `recipe` (`pick_type`; imatrix=True: the
    importance-matrix layout of a Q4_0 or Q5_0 file); norms are F32 ones.
    The block bytes are made on `generator`'s device, one tensor at a time,
    and streamed to the file. vocab=True writes `qwen2_vocab_kv`'s
    tokenizer at the model's width (else placeholder tokens). Returns
    {tensor name: type}."""
    default = RECIPES[recipe]
    device = generator.device
    arch = "qwen3"
    w = GGUFWriter(path)
    for key, v in (("block_count", cfg.n_layers),
                   ("context_length", 40960),
                   ("embedding_length", cfg.d_model),
                   ("feed_forward_length", cfg.d_ff),
                   ("attention.head_count", cfg.n_heads),
                   ("attention.head_count_kv", cfg.n_kv_heads),
                   ("attention.key_length", cfg.head_dim),
                   ("attention.value_length", cfg.head_dim),
                   ("attention.layer_norm_rms_epsilon", float(cfg.rms_eps)),
                   ("rope.freq_base", float(cfg.rope_base))):
        w.add_kv(f"{arch}.{key}", v)
    w.add_kv("general.architecture", arch)
    if vocab:
        for key, v in qwen2_vocab_kv(cfg.n_vocab).items():
            w.add_kv(key, v)
    else:
        w.add_kv("tokenizer.ggml.model", "gpt2")
        w.add_kv("tokenizer.ggml.tokens",
                 [f"<t{i}>" for i in range(cfg.n_vocab)])
    types = {}

    def quant(name: str, n: int, k: int) -> None:
        t = types[name] = pick_type(name, recipe, default, cfg.n_layers, imatrix)
        nb = n * k // type_traits(t).block_size
        w.add_tensor(name, lambda: BLOCKS[t](nb, device, generator).cpu().numpy(),
                     t, (n, k))

    def norm(name: str, n: int) -> None:
        types[name] = GGMLType.F32
        w.add_tensor(name, np.ones(n, np.float32))

    d, ff = cfg.d_model, cfg.d_ff
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    quant("token_embd.weight", cfg.n_vocab, d)
    norm("output_norm.weight", d)
    quant("output.weight", cfg.n_vocab, d)
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        norm(p + "attn_norm.weight", d)
        quant(p + "attn_q.weight", qd, d)
        quant(p + "attn_k.weight", kvd, d)
        quant(p + "attn_v.weight", kvd, d)
        quant(p + "attn_output.weight", d, qd)
        norm(p + "attn_q_norm.weight", cfg.head_dim)
        norm(p + "attn_k_norm.weight", cfg.head_dim)
        norm(p + "ffn_norm.weight", d)
        quant(p + "ffn_gate.weight", ff, d)
        quant(p + "ffn_up.weight", ff, d)
        quant(p + "ffn_down.weight", d, ff)
    w.write()
    return types


def synth_qwen3_params(cfg: Qwen3Config = QWEN3_8B, device=None,
                       generator: torch.Generator | None = None,
                       fuse: bool = True) -> dict:
    """Parameter dict of a random Q4_K Qwen3 (separate output head) on
    `device`. `generator` must live on that device; default: seed 0."""
    from . import resolve_device

    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d, ff = cfg.d_model, cfg.d_ff
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim

    def q4k(n, k):
        return synth_q4k(n, k, device, generator)

    def norm(n):
        return torch.ones((n,), dtype=torch.float32, device=device)

    params = {
        "token_embd": torch.empty((cfg.n_vocab, d), dtype=torch.bfloat16,
                                  device=device).uniform_(
            -0.02, 0.02, generator=generator),
        "output_norm": norm(d),
        "output": q4k(cfg.n_vocab, d),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": norm(d),
            "wq": q4k(qd, d), "wk": q4k(kvd, d), "wv": q4k(kvd, d),
            "wo": q4k(d, qd),
            "q_norm": norm(cfg.head_dim), "k_norm": norm(cfg.head_dim),
            "ffn_norm": norm(d),
            "w_gate": q4k(ff, d), "w_up": q4k(ff, d), "w_down": q4k(d, ff),
        }
        params["layers"].append(fuse_layer(layer) if fuse else layer)
    return params


def synth_qwen3_dense_params(cfg: Qwen3Config = QWEN3_8B, device=None,
                             generator: torch.Generator | None = None) -> dict:
    """Parameter dict of a random dense Qwen3 (separate output head,
    unfused) on `device`, as `load_params` makes it from an F16 GGUF: each
    2-D weight drawn normal with RMS 0.025, rounded to f16 as the file
    stores it, then to bf16 as `load_quantized` loads an F16 tensor; norms
    f32 ones. `generator` must live on that device; default: seed 0."""
    from . import resolve_device

    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    d, ff = cfg.d_model, cfg.d_ff
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim

    def dense(n, k):
        w = torch.empty((n, k), dtype=torch.bfloat16, device=device)
        for r in range(0, n, 16384):  # f32 draws in slices of <= 256 MB
            rows = min(16384, n - r)
            v = torch.randn((rows, k), device=device, generator=generator)
            w[r:r + rows] = (v * 0.025).to(torch.float16).to(torch.float32)
        return w

    def norm(n):
        return torch.ones((n,), dtype=torch.float32, device=device)

    params = {"token_embd": dense(cfg.n_vocab, d), "output_norm": norm(d),
              "output": dense(cfg.n_vocab, d), "layers": []}
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "attn_norm": norm(d),
            "wq": dense(qd, d), "wk": dense(kvd, d), "wv": dense(kvd, d),
            "wo": dense(d, qd),
            "q_norm": norm(cfg.head_dim), "k_norm": norm(cfg.head_dim),
            "ffn_norm": norm(d),
            "w_gate": dense(ff, d), "w_up": dense(ff, d),
            "w_down": dense(d, ff)})
    return params


# ---------------------------------------------------------------------------
# the spoken round's modules at MiniCPM-o 4.5's widths: the APM, the TTS and
# Token2Wav's four files and prompt cache, F16 weights (the reference's
# "Full omni (NVIDIA) Q4_K_M" set keeps these modules F16), random from a
# torch.Generator, under the names the loaders read
# ---------------------------------------------------------------------------

class _F16Writer:
    """GGUFWriter helpers: random F16 tensors made on the generator's
    device when written, F32 ones and zeros."""

    def __init__(self, path, generator: torch.Generator):
        self.w = GGUFWriter(path)
        self.gen = generator

    def rand(self, name: str, *shape: int, s: float = 0.02) -> None:
        gen = self.gen

        def make():
            x = torch.randn(shape, generator=gen, device=gen.device) * s
            return x.to(torch.float16).cpu().numpy()

        self.w.add_tensor(name, make, GGMLType.F16, shape)

    def const(self, name: str, n: int, value: float) -> None:
        self.w.add_tensor(name, np.full(n, value, np.float32))

    def ln(self, prefix: str, n: int) -> None:
        self.const(prefix + ".weight", n, 1.0)
        self.const(prefix + ".bias", n, 0.0)


def write_apm_gguf(path, generator: torch.Generator, n_layers: int = 24,
                   d_model: int = 1024, n_heads: int = 16, d_ff: int = 4096,
                   n_mels: int = 80, n_audio_ctx: int = 1500,
                   d_out: int = 4096) -> None:
    """The Whisper-style APM (convert_apm.py's names): two convs, the
    1,500-row positional table, 24 pre-LN layers, the final LN and the
    1024 -> 4096 -> 4096 projector; a positive random mel filterbank."""
    f = _F16Writer(path, generator)
    w = f.w
    w.add_kv("general.architecture", "whisper")
    for key, v in (("encoder_layers", n_layers), ("d_model", d_model),
                   ("encoder_attention_heads", n_heads), ("n_mel", n_mels),
                   ("n_audio_ctx", n_audio_ctx), ("audio_projection_dim", d_out)):
        w.add_kv(key, v)
    filt = torch.rand((n_mels, 201), generator=torch.Generator().manual_seed(0)) * 0.02
    w.add_kv("filters", filt.reshape(-1).numpy().astype(np.float32))
    f.rand("encoder.conv1.weight", d_model, n_mels, 3, s=0.1)
    f.rand("encoder.conv1.bias", d_model)
    f.rand("encoder.conv2.weight", d_model, d_model, 3)
    f.rand("encoder.conv2.bias", d_model)
    f.rand("encoder.positional_embedding", n_audio_ctx, d_model, s=0.1)
    f.ln("encoder.ln_post", d_model)
    f.rand("audio_projector.linear1.weight", d_out, d_model)
    f.rand("audio_projector.linear1.bias", d_out)
    f.rand("audio_projector.linear2.weight", d_out, d_out)
    f.rand("audio_projector.linear2.bias", d_out)
    for i in range(n_layers):
        b = f"encoder.blocks.{i}."
        f.ln(b + "attn_ln", d_model)
        for nm in ("query", "key", "value", "out"):
            f.rand(b + f"attn.{nm}.weight", d_model, d_model)
            if nm != "key":  # Whisper's k has no bias
                f.rand(b + f"attn.{nm}.bias", d_model)
        f.ln(b + "mlp_ln", d_model)
        f.rand(b + "mlp.0.weight", d_ff, d_model)
        f.rand(b + "mlp.0.bias", d_ff)
        f.rand(b + "mlp.2.weight", d_model, d_ff)
        f.rand(b + "mlp.2.bias", d_model)
    w.write()


def write_vpm_gguf(path, generator: torch.Generator, n_layers: int = 26,
                   d_model: int = 1152, n_heads: int = 16, d_ff: int = 4304,
                   patch_size: int = 14, pos_buckets: int = 70,
                   d_out: int = 4096, n_queries: int = 64) -> None:
    """The VPM (convert_vpm.py's names, the clip.vision.* keys of
    omni_tpu/testing_gguf.py's `write_tiny_vpm`): the patch embedding, the
    70 x 70 = 4,900-row positional table, 26 pre-LN SigLip layers, the
    post-LN and the resampler (64 queries x 4096, kv_proj, q/k/v/out, three
    LNs, proj); image mean and std 0.5. At full width ~491 M parameters."""
    f = _F16Writer(path, generator)
    w = f.w
    w.add_kv("general.architecture", "clip")
    for key, v in (("block_count", n_layers), ("embedding_length", d_model),
                   ("attention.head_count", n_heads), ("feed_forward_length", d_ff),
                   ("patch_size", patch_size), ("image_size", 448),
                   ("projection_dim", d_out)):
        w.add_kv(f"clip.vision.{key}", v)
    w.add_kv("clip.minicpmv_query_num", n_queries)
    w.add_kv("clip.vision.image_mean", [0.5, 0.5, 0.5])
    w.add_kv("clip.vision.image_std", [0.5, 0.5, 0.5])
    f.rand("v.patch_embd.weight", d_model, 3, patch_size, patch_size)
    f.rand("v.patch_embd.bias", d_model)
    f.rand("v.position_embd.weight", pos_buckets * pos_buckets, d_model, s=0.1)
    f.ln("v.post_ln", d_model)
    f.rand("resampler.query", n_queries, d_out, s=0.1)
    f.rand("resampler.kv.weight", d_out, d_model)
    for nm in ("q", "k", "v", "out"):
        f.rand(f"resampler.attn.{nm}.weight", d_out, d_out)
        f.rand(f"resampler.attn.{nm}.bias", d_out)
    for nm in ("ln_q", "ln_kv", "ln_post"):
        f.ln(f"resampler.{nm}", d_out)
    f.rand("resampler.proj.weight", d_out, d_out)
    for i in range(n_layers):
        b = f"v.blk.{i}."
        f.ln(b + "ln1", d_model)
        for nm in ("q", "k", "v", "out"):
            f.rand(b + f"attn_{nm}.weight", d_model, d_model)
            f.rand(b + f"attn_{nm}.bias", d_model)
        f.ln(b + "ln2", d_model)
        f.rand(b + "ffn_up.weight", d_ff, d_model)
        f.rand(b + "ffn_up.bias", d_ff)
        f.rand(b + "ffn_down.weight", d_model, d_ff)
        f.rand(b + "ffn_down.bias", d_model)
    w.write()


def write_tts_gguf(path, generator: torch.Generator, n_layers: int = 20,
                   d_model: int = 768, n_heads: int = 12, d_ff: int = 3072,
                   d_llm: int = 4096, n_text: int = 152064,
                   n_codes: int = 6562) -> None:
    """The TTS: a `minicpmtts` LLaMA decoder under llama.cpp's blk.N names
    (its token_embd the 6,562 codes, the tied head) and the side weights
    emb_text, emb_code, head_code, projector_semantic and projector_spk."""
    f = _F16Writer(path, generator)
    w = f.w
    arch = "minicpmtts"
    w.add_kv("general.architecture", arch)
    for key, v in (("block_count", n_layers), ("embedding_length", d_model),
                   ("feed_forward_length", d_ff), ("attention.head_count", n_heads),
                   ("attention.head_count_kv", n_heads),
                   ("attention.layer_norm_rms_epsilon", 1e-6),
                   ("rope.freq_base", 10000.0)):
        w.add_kv(f"{arch}.{key}", v)
    f.rand("token_embd.weight", n_codes, d_model)
    f.const("output_norm.weight", d_model, 1.0)
    for i in range(n_layers):
        p = f"blk.{i}."
        f.const(p + "attn_norm.weight", d_model, 1.0)
        for nm in ("attn_q", "attn_k", "attn_v", "attn_output"):
            f.rand(p + nm + ".weight", d_model, d_model)
        f.const(p + "ffn_norm.weight", d_model, 1.0)
        f.rand(p + "ffn_gate.weight", d_ff, d_model)
        f.rand(p + "ffn_up.weight", d_ff, d_model)
        f.rand(p + "ffn_down.weight", d_model, d_ff)
    f.rand("emb_text.weight", n_text, d_model, s=0.1)
    f.rand("emb_code.0.weight", n_codes, d_model, s=0.1)
    f.rand("head_code.0.weight", n_codes, d_model, s=0.1)
    for proj in ("projector_semantic", "projector_spk"):
        f.rand(f"{proj}.linear1.weight", d_model, d_llm)
        f.rand(f"{proj}.linear1.bias", d_model)
        f.rand(f"{proj}.linear2.weight", d_model, d_model)
        f.rand(f"{proj}.linear2.bias", d_model)
    w.write()


def write_token2wav_ggufs(dir_path, generator: torch.Generator,
                          n_prompt_tokens: int = 50) -> dict:
    """Token2Wav's encoder (conformer d 512, 8 heads, ffn 2048, 6 + 4
    blocks), flow_matching (DiT depth 16, hidden 512, 8 x 64 heads, 320 ->
    80 channels, conv k3), flow_extra (input embedding of the 6,561 speech
    tokens, speaker affine 192 -> 80, encoder_proj 512 -> 80), hifigan2
    (HiFT at 24 kHz: conv_pre 80 -> 512, upsampling 8, 5, 3 to 256, 128,
    64 channels with kernels 16, 11, 7, resblocks of kernels 3, 7, 11 with
    dilations 1, 3, 5, source resblocks of kernels 7, 7, 11, source downs
    of kernels 29, 5, 1, an F0 predictor of five 512-wide convs) and a
    prompt cache with a speaker x-vector and prompt tokens (primed by
    replay). Returns the path dict, keyed as `resolve_model_paths`."""
    os.makedirs(dir_path, exist_ok=True)
    paths = {k: os.path.join(dir_path, f"minicpmo-{n}.gguf") for k, n in (
        ("t2w_encoder", "encoder"), ("t2w_flow", "flow_matching"),
        ("t2w_extra", "flow_extra"), ("t2w_vocoder", "hifigan2"),
        ("t2w_prompt", "prompt_cache"))}
    d, heads, ff = 512, 8, 2048
    f = _F16Writer(paths["t2w_encoder"], generator)
    for pre in ("embed", "up_embed"):
        f.rand(f"{pre}.out.0.weight", d, d)
        f.rand(f"{pre}.out.0.bias", d)
        f.ln(f"{pre}.out.1", d)
    for nm, k in (("pre_lookahead_layer.conv1", 4), ("pre_lookahead_layer.conv2", 3),
                  ("up_layer.conv", 5)):
        f.rand(nm + ".weight", d, d, k)
        f.rand(nm + ".bias", d)
    f.ln("after_norm", d)
    for prefix, n in (("encoders", 6), ("up_encoders", 4)):
        for i in range(n):
            b = f"{prefix}.{i}."
            f.ln(b + "norm_ff", d)
            f.ln(b + "norm_mha", d)
            for nm in ("q", "k", "v", "out"):
                f.rand(b + f"self_attn.linear_{nm}.weight", d, d)
                f.rand(b + f"self_attn.linear_{nm}.bias", d)
            f.rand(b + "self_attn.linear_pos.weight", d, d)
            f.rand(b + "self_attn.pos_bias_u", heads, d // heads)
            f.rand(b + "self_attn.pos_bias_v", heads, d // heads)
            f.rand(b + "feed_forward.w_1.weight", ff, d)
            f.rand(b + "feed_forward.w_1.bias", ff)
            f.rand(b + "feed_forward.w_2.weight", d, ff)
            f.rand(b + "feed_forward.w_2.bias", d)
    f.w.write()

    hidden, mel, hd = 512, 80, 64
    f = _F16Writer(paths["t2w_flow"], generator)
    e = "estimator."
    for nm, n, k in (("in_proj", hidden, mel * 4), ("t_embedder.mlp.0", hidden, 256),
                     ("t_embedder.mlp.2", hidden, hidden),
                     ("final_layer.adaLN_modulation.1", 2 * hidden, hidden),
                     ("final_layer.linear", mel, hidden)):
        f.rand(e + nm + ".weight", n, k)
        f.rand(e + nm + ".bias", n)
    for i in range(16):
        b = f"{e}blocks.{i}."
        f.rand(b + "adaLN_modulation.1.weight", 9 * hidden, hidden)
        f.rand(b + "adaLN_modulation.1.bias", 9 * hidden)
        for nm in ("to_q", "to_k", "to_v", "proj"):
            f.rand(b + f"attn.{nm}.weight", hidden, hidden)
            f.rand(b + f"attn.{nm}.bias", hidden)
        f.ln(b + "attn.q_norm", hd)
        f.ln(b + "attn.k_norm", hd)
        for j in (1, 6):
            f.rand(b + f"conv.block.{j}.weight", hidden, hidden, 3)
            f.rand(b + f"conv.block.{j}.bias", hidden)
        f.ln(b + "conv.block.3", hidden)
        f.rand(b + "mlp.fc1.weight", 4 * hidden, hidden)
        f.rand(b + "mlp.fc1.bias", 4 * hidden)
        f.rand(b + "mlp.fc2.weight", hidden, 4 * hidden)
        f.rand(b + "mlp.fc2.bias", hidden)
    f.w.write()

    f = _F16Writer(paths["t2w_extra"], generator)
    f.rand("input_embedding.weight", 6561, d, s=0.5)
    f.rand("spk_embed_affine_layer.weight", mel, 192, s=0.1)
    f.rand("spk_embed_affine_layer.bias", mel)
    f.rand("encoder_proj.weight", mel, d)
    f.rand("encoder_proj.bias", mel)
    f.w.write()

    f = _F16Writer(paths["t2w_vocoder"], generator)
    ch = [512, 256, 128, 64]
    f.rand("conv_pre.weight", ch[0], mel, 7)
    f.rand("conv_pre.bias", ch[0])
    f.rand("conv_post.weight", 18, ch[3], 7)
    f.rand("conv_post.bias", 18)
    c = mel
    for i in range(5):
        f.rand(f"f0_predictor.condnet.{2 * i}.weight", 512, c, 3)
        f.rand(f"f0_predictor.condnet.{2 * i}.bias", 512)
        c = 512
    f.rand("f0_predictor.proj.weight", 1, 512, s=0.1)
    f.rand("f0_predictor.proj.bias", 1)
    f.rand("m_source.l_linear.weight", 1, 9, s=0.3)
    f.rand("m_source.l_linear.bias", 1)

    def resblock(prefix, c, k):
        for i in range(3):
            for conv in ("convs1", "convs2"):
                f.rand(f"{prefix}.{conv}.{i}.weight", c, c, k)
                f.rand(f"{prefix}.{conv}.{i}.bias", c)
            f.const(f"{prefix}.activations1.{i}.alpha", c, 1.0)
            f.const(f"{prefix}.activations2.{i}.alpha", c, 1.0)

    for s, (up_k, sd_k, src_k) in enumerate(((16, 29, 7), (11, 5, 7), (7, 1, 11))):
        f.rand(f"ups.{s}.weight", ch[s], ch[s + 1], up_k)
        f.rand(f"ups.{s}.bias", ch[s + 1])
        f.rand(f"source_downs.{s}.weight", ch[s + 1], 18, sd_k)
        f.rand(f"source_downs.{s}.bias", ch[s + 1])
        resblock(f"source_resblocks.{s}", ch[s + 1], src_k)
    for r in range(9):
        resblock(f"resblocks.{r}", ch[r // 3 + 1], (3, 7, 11)[r % 3])
    f.w.write()

    w = GGUFWriter(paths["t2w_prompt"])
    dev = generator.device
    w.add_tensor("prompt_cache.spk_cb", torch.randn(
        (1, 192), generator=generator, device=dev).cpu().numpy())
    w.add_tensor("prompt_cache.prompt_tokens", torch.randint(
        0, 6561, (n_prompt_tokens,), generator=generator, device=dev)
        .cpu().numpy().astype(np.int32))
    w.write()
    return paths
