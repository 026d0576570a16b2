#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port `omni_tpu_torch` on one NVIDIA GPU.

    python3 chip_smoke.py [--prompts N] [--near-tie-prompts P] [--seed S]

Builds the port's CUDA kernels from `omni_tpu_torch/csrc/` and holds each
against its plain PyTorch version at every Qwen3-8B shape of the served
paths, and reads both against the kernel's law evaluated in f64: a kernel
fails where it disagrees with its plain version, or where it rounds
clearly more bf16 outputs otherwise than the f64 law than its plain
version does (`flip_limit`). Kernels B and D (one mainloop,
`csrc/qmma.cuh`) are held so at their own split plan and, every entry of
both, with the split count forced to 1 and 4 at wk and down, where a
repeat launch must give the same bits; their timing lines print each
call's split count and work units. The mma.sync GEMVs, kernel A's six
entries (`q4k_gemv.cu`), kernel E's three codebook entries
(`codebook_gemv.cu`), kernel C (`q6k_gemv.cu`) and kernel H's two
(`lowbit_gemv.cu`), are held at every decode M (1..8) on each weight, a
repeat launch and a CUDA-graph replay bit-identical; they are timed at
M = 1 and 8, their timing lines print the plan (`gemv_plan`: one block
per 16-row tile, K not split), and their `kernels` entries carry the M = 8
sums (`m8`). It holds the dense dot of a bf16 weight
(cuBLAS, K split into chunks) against the widened-f32 product the same
way, and the flash-decode kernels (bf16, int8 and int4 KV cells) against
their plain versions and the attention law in f64, in both of kernel F's
regimes (T = 1 and 2 decode, 3, 8 and 64 prefill at G = 4), a repeat
launch bit-identical. Then it drives these
paths at full width and depth (all 36 layers, random weights made on the
card from seed S, 0 by default; cut, earlier slices' paths, so that the
run stays inside its time limit: the Q5_K_M, Q4_0, Q5_0, Q8_0, codebook,
Q2_K and Q3_K models of paths 3 to 7 at 18 layers, CUT_LAYERS), one
model resident at a
time, each through
`OmniPipeline.stream_prefill` / `stream_decode`:
1. an all-Q4_K Qwen3-8B synthesised in the port's planes, fused QKV and
   gate+up (kernels A and B);
2. a Q4_K_M Qwen3-8B GGUF written to a temporary directory (about 5 GB,
   deleted before the next path; with the synthesised 151,748-token Qwen2
   vocabulary, `testing_synth.qwen2_vocab_kv`) and loaded back through the
   port's GGUF reader and `qwen3.load_params`, unfused: Q4_K through
   kernels A and B, Q6_K through kernels C and D; the same model serves
   twice more with a quantized KV cache, q8_0 (kernel F, `flash_decode`)
   and q4_0 (kernel F's int4 branch, `flash_decode4`), every layer's
   attention in the kernel; then a session (`session_phase`) with the
   file's own tokenizer (`build_tokenizer(reader.kv)`): ChatML turns on a
   q8_0 pool under the server's default `SamplerParams()` past a 512-token
   round window, one turn with penalties and DRY, one mirostat-2 turn on
   the host loop; after each slide the positions must be contiguous and
   the re-rotated K within one code step of the rotation law in f64; a
   fresh context from the same seed must repeat the first turn, a turn
   after a session load the turn before it, and 20,000 draws of `sample()`
   must follow softmax of the filtered row (chi-square p > 1e-4); then the
   server (`server_phase`): the port's OpenAI-style server on a q8_0 pool
   with 8 slots, driven over HTTP from several threads: 2, 4 and 8
   step-path requests at once (continuous batching: each step's A/C or
   B/D launches checked, each stream equal to its run alone or parting at
   a teacher-forced near tie), kernel F held at 2, 4 and 8 rows of
   different sequences, two fused-path chats at once, SSE, a JSON schema,
   a forced tool call, embeddings, /metrics, a slot saved, erased and
   restored, a text-only /v1/stream turn and a request past its slot's
   budget; then a
   spoken round (`spoken_phase`): the full-width APM, TTS and Token2Wav
   (F16 files written beside it) loaded by omni-cli's `build_pipeline`
   around the loaded Q4_K_M LLM, one `run_test_cases` round of 2 s of
   audio in, 10 text tokens, the TTS to audio_eos or its 500-code cap and
   every Token2Wav window, its waves, sync-free TTS scan, card-vs-CPU
   TTS and Token2Wav, and A-D launches checked, and four short rounds
   that time the first wave with and without the first-window hold; then
   vision and duplex (`vision_duplex_phase`): the full-width VPM written
   beside the spoken modules, omni-cli's `build_pipeline` with --omni
   --duplex taking them over, a duplex session of a 1344 x 1008 image (7
   parts), five 640 x 480 frames under high_refresh and audio chunks, a
   60-token turn with the TTS past the 26-token cap twice, the unit window
   dropping the oldest unit, the session saved and loaded and one more
   unit; the cap, the window's cells and K against the f64 law, the TTS
   chunks, the waves, a VPM part against the CPU and A-D launches checked;
3. a Q5_K_M Qwen3-8B GGUF at 18 layers (CUT_LAYERS; about 2.9 GB,
   deleted before the next path),
   loaded the same way, on the bf16 pool: Q5_K through kernel G
   (`q5k_gemv`) and kernel B's Q5_K branch (`q5k_gemm`), Q6_K through
   kernels C and D;
4. a Q4_0 and a Q5_0 Qwen3-8B GGUF in llama.cpp's importance-matrix
   layout at 18 layers (CUT_LAYERS; about 2.4 and 2.9 GB, each deleted
   before the next path; the ffn_down of layers 0-1 Q4_1 / Q5_1, the
   head Q6_K), loaded the same way,
   on the bf16 pool: decode through kernel A's Q4_0/Q4_1 (Q5_0/Q5_1)
   branches, prefill through kernel B's, the head through C and D; the
   Q4_0 model serves once more with the dispatcher's gp and sh routes
   switched off (`dequant_matmul.GP_DECODE`, `SH_PREFILL`: the JAX
   package's OMNI_GP_DECODE=0, OMNI_SH_PREFILL=0), every matmul through
   kernel D's Q4_0, Q4_1 and Q6_K branches;
5. a Q8_0 Qwen3-8B GGUF at 18 layers (CUT_LAYERS; about
   4.4 GB in $TMPDIR, every weight Q8_0), loaded the same way: decode
   through kernel E, prefill through D;
6. an IQ4_NL, an IQ4_XS and an MXFP4 Qwen3-8B GGUF at 18 layers (CUT_LAYERS; each
   deleted before the next path; every weight in the
   recipe's type, the embedding too, the head Q6_K, as the JAX quantizer
   writes them), loaded the same way (q planes of nibble indexes, the
   file's bytes; their plane bytes printed): decode through kernel E's
   codebook entries `iq4_nl_gemv`, `iq4_xs_gemv` and `mxfp4_gemv`, prefill
   through kernel D's IQ4_NL, IQ4_XS and MXFP4 branches, the head through
   C and D;
7. a Q2_K and a Q3_K Qwen3-8B GGUF at 18 layers (CUT_LAYERS; each
   deleted before the next path; every layer weight and the
   embedding in the format, the head Q6_K), loaded the same way: decode
   through kernel H
   (`q2k_gemv`, `q3k_gemv`), prefill through kernel D's Q2_K and Q3_K
   branches, the head through C and D;
8. an F16 Qwen3-8B as `load_params` loads one (dense bf16 weights made on
   the card): every matmul a dense dot, no hand-written kernel; its decode
   step must allocate less than 100 MB above its starting allocation.
Three models serve once more with the fused FFN switched on
(`qwen3.FUSED_FFN`: the JAX package's OMNI_FUSED_FFN=1), every layer's
gated FFN one launch of kernel I (`qffn`, `csrc/qffn.cu`): the all-Q4_K
model of path 1 (Q4_K/Q4_K), and the Q4_0 (Q4_0/Q4_0, and Q4_0/Q4_1 on
layers 0-1) and Q8_0 (Q8_0/Q8_0) models, fused in place (`fuse_layer`)
after their unfused turns. Kernel I is held against its plain version and
its law in f64 at the Qwen3-8B FFN shape for every same-format pair of the
thirteen formats and the mixed pairs Q4_K/Q6_K, Q5_K/Q6_K, Q4_0/Q4_1 and
Q5_0/Q5_1 (its h, for each gate/up format, through an identity down
weight), at M = 1 and 8 (its register path) and 9 and 64 (the mainloop), a
repeat launch bit-identical; its two passes are timed apart.
For each path it checks the launches of every kernel per decode step and
per 64-token ubatch, and that its logits agree with the plain path: within
1e-3 of max|logit| on the all-Q4_K model; on the others, whose
logits sit at the bf16 noise floor, within twice the plain path's own
distance from the same forward with every matmul's law in f64 (over N
prompts, 3 by default; on the quantized-KV turns the plain path's
attention is the flash kernel's plain version and the f64 path's is the
attention law in f64). Every argmax must agree with the plain path's,
except on the models whose logits lie at that floor itself (LOWBIT_AGAINST,
CODEBOOK_AGAINST: Q8_0, IQ4_XS, MXFP4, F16 and Q3_K): there a row may pick
another token only where both the plain path and the f64 path have it in a
near tie (F64_FACTOR), over P prompts (N_PROMPTS_NEAR_TIE by default), and
at least MIN_HELD_ROWS rows must lie past that band and agree. Last it
times each kernel, the dense dot and the flash kernels beside their
bounds. One flushed line per phase, each with its seconds and the running
total, and a line with the script's total seconds. The second-to-last
lines are the card as nvidia-smi reports it and a JSON
`{"kernels": [...]}` line; the last line is {"ok": true, "device": {...}}.
Without a CUDA device, or outside a checkout of the repository, it fails
before printing any result.

Imports nothing of JAX or of the JAX package `omni_tpu`.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from unittest import mock

T_START = time.perf_counter()

# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_OPS_PER_S = 989e12

# Qwen3-8B weight shapes, N x K: the Q4_K ones of the fused all-Q4_K path
# (fused wqkv and gate+up), and the Q6_K ones of a Q4_K_M checkpoint
SHAPES = {"wqkv": (6144, 4096), "wo": (4096, 4096), "gateup": (24576, 4096),
          "down": (4096, 12288), "output": (151748, 4096)}
Q6_SHAPES = {"wv": (1024, 4096), "down": (4096, 12288), "output": (151748, 4096)}
# the Q4_K shapes of the unfused Q4_K_M path that the fused ones leave out
# (wq is wo's shape, w_up gate's); checked against the plain versions only
Q4_UNFUSED_SHAPES = {"wk": (1024, 4096), "gate": (12288, 4096)}
# a Q4_K or Q5_K weight whose K is no multiple of 2048 (kernel D's Q4_K and
# Q5_K branches; the shape of tests/test_qkernels.py::
# test_qmatmul_gp_odd_k_divisor)
ODD_K_SHAPE = (4096, 1280)
# the unfused weight shapes of a Qwen3-8B, each format's path: wq and wo,
# wk and wv, gate and up share a shape
UNFUSED_SHAPES = {"wq": (4096, 4096), "wk": (1024, 4096), "gate": (12288, 4096),
                  "down": (4096, 12288), "output": (151748, 4096)}
# calls per decode token (M = 1) or per 64-token ubatch of each shape there
UNFUSED_CALLS = {"wq": 72, "wk": 72, "gate": 72, "down": 36, "output": 1}
# the Q5_K weights of a Q5_K_M Qwen3-8B, per shape: wq and wo of 36 layers,
# wk of 36 and wv of the 18 layers whose wv stays Q5_K, gate and up, and
# down on those 18 layers (216 calls); the other 37 are Q6_K (Q6_SHAPES)
Q5_SHAPES = {nm: UNFUSED_SHAPES[nm] for nm in ("wq", "wk", "gate", "down")}
Q5_CALLS = {"wq": 72, "wk": 54, "gate": 72, "down": 18}
# the Q4_0 and Q5_0 files in the importance-matrix layout: the ffn_down of
# layers i < 36 // 8 in Q4_1 / Q5_1 (4 calls), every other layer weight in
# the recipe's type (248 calls), the head Q6_K; per shape, as UNFUSED_CALLS
LEGACY_RECIPES = {"Q4_0": "Q4_1", "Q5_0": "Q5_1"}
# the legacy model also served with the gp and sh routes switched off
SWITCHED_RECIPE = "Q4_0"
LEGACY_CALLS = {"wq": 72, "wk": 72, "gate": 72, "down": 32}
LEGACY_MIN_CALLS = {"down": 4}
# a Q8_0 weight whose K is no multiple of 256 (kernel D's ragged K step;
# Q8_0's K granule is 32)
ODD_K_Q8_SHAPE = (4096, 1248)
# the codebook recipes' files (the JAX quantizer's rule): every layer weight
# in the recipe's type (252 calls per token), the embedding too, the head
# Q6_K; per shape, as UNFUSED_CALLS
CODEBOOK_RECIPES = ("IQ4_NL", "IQ4_XS", "MXFP4")
CODEBOOK_SHAPES = {nm: UNFUSED_SHAPES[nm] for nm in ("wq", "wk", "gate", "down")}
CODEBOOK_CALLS = {"wq": 72, "wk": 72, "gate": 72, "down": 36}
# an IQ4_NL or MXFP4 weight whose K is no multiple of 256 (their K granule
# is 32): kernel D at every M, M = 1 included
ODD_K_CODEBOOK_SHAPE = (4096, 1056)
# the uniform Q2_K and Q3_K files: every layer weight in the format (252
# calls per token: kernel H, per ubatch: kernel D), the embedding too, the
# head Q6_K; per shape, as UNFUSED_CALLS
LOWBIT_RECIPES = ("Q2_K", "Q3_K")
LOWBIT_SHAPES = CODEBOOK_SHAPES
LOWBIT_CALLS = CODEBOOK_CALLS
# Qwen3-8B's fused gate/up (wqkv) shape on the Q8_0 and Q4_0 files served
# fused: kernels E, A's and B's Q4_0 branches and D's Q8_0 branch
WQKV_SHAPE = SHAPES["wqkv"]
# kernel I's (gate/up, down) format pairs: every same-format pair and the
# mixed pairs of the Q4_K_M, Q5_K_M and importance-matrix Q4_0 / Q5_0
# recipes; at Qwen3-8B's FFN shape (K 4096, F 12288, N 4096)
QFFN_PAIRS = ([(t, t) for t in ("Q4_K", "Q5_K", "Q6_K", "Q8_0", "Q4_0", "Q4_1",
                                "Q5_0", "Q5_1", "IQ4_NL", "IQ4_XS", "MXFP4",
                                "Q2_K", "Q3_K")]
              + [("Q4_K", "Q6_K"), ("Q5_K", "Q6_K"), ("Q4_0", "Q4_1"), ("Q5_0", "Q5_1")])
# kernel I's M: its register path at 1 and 8, the mainloop from 9 (the
# first prefill M) and at a 64-token ubatch
QFFN_MS = (1, 8, 9, 64)
# rows over which kernel I's flip share is read (M = 1, 8, 9 and 64 in 512,
# 64, 56 and 8 launches: see check_qffn). Read over 64 rows, Q5_K/Q5_K at M = 8
# gave 4.2x its plain version's share in a first full call (NVIDIA H100
# 80GB HBM3, 700.00 W): a few large h decide the share of a row. The h
# themselves are held too, through an identity down weight (out = h).
QFFN_ROWS = 512
GEMV_MS = (1, 2, 3, 8)
# the mma.sync GEMVs (dequant_matmul.MMA_GEMV: kernel A's six entries,
# q4k_gemv.cu; E's three codebook entries, codebook_gemv.cu; kernel C,
# q6k_gemv.cu; kernel H's two entries, lowbit_gemv.cu), at every decode M,
# held against their plain versions on one x of 8 rows (check_gemv_rows);
# timed at the ends of that range
MMA_GEMV_MS, MMA_GEMV_TIMES = tuple(range(1, 9)), (1, 8)
GEMM_MS = (64, 256)
QGEMM_MS = (1, 64, 256)
# kernel D's legacy branches: decode rows (GP_DECODE off) and a prefill
# ubatch (SH_PREFILL off)
LEGACY_QGEMM_MS = (1, 8, 64)
L2_FLUSH_BYTES = 100 * 2**20
# kernels B and D at forced split counts (dequant_matmul.gemm_splits is
# patched): one split stores straight from the registers, more go through
# the f32 partials and the ordered reduction; at Qwen3-8B's wk and down
GEMM_FORCED_SPLITS = (1, 4)
GEMM_SPLIT_SHAPES = ("wk", "down")
# kernel vs plain: both run the same law with f32 sums in another order,
# so a bf16 output may round one way or the other: 2 bf16 ulps of |want|
# (2 x 2**-7 relative at worst), plus a floor of 1e-3 x max|want| for the
# f32 order differences near zero. Measured: 1 ulp at most.
KERNEL_RTOL, KERNEL_FLOOR = 2**-6, 1e-3
# bf16 outputs rounded otherwise than the law in f64: a kernel fails where
# its share exceeds flip_limit(its plain version's share at the same shape
# and inputs). Every kernel and plain version of the Q4_K_M paths read 0 to
# 6.5e-4 (2 of 3072 outputs at M = 3, N = 1024); the unsplit tensor-core
# accumulation of an earlier kernel B read 7.11e-3 against its plain
# version's 2.94e-4 at down (K = 12288) and 2.22e-3 against 1.91e-4 at
# wqkv. So: 4x the plain share (the fault read 11-24x), a floor of 1e-3 for
# shapes where the plain share is ~0 (1.5x the worst correct reading, below
# the fault's 2.2e-3), and FLIP_CHANCE outputs, as at M = 1, N = 1024 one
# flip is already 1e-3.
FLIP_FACTOR, FLIP_FLOOR, FLIP_CHANCE = 4.0, 1e-3, 4
# served logits vs the plain path, relative to max|logit|: the two differ
# by those flips, carried through 36 layers (measured 7.6e-5); the argmax
# of every row must agree too
LOGITS_REL_TOL = 1e-3
# The Q4_K_M model's signed Q6_K head gives logits with no common part (max
# ~11), where bf16 rounding alone moves the plain path as far from its law
# in f64 as 1.3e-3 of max|logit|. There the kernel path's RMS distance from
# the f64 path (every matmul's law in f64: law_f64), over the rows of
# N_PROMPTS_Q4KM prompts, must stay within F64_FACTOR of the plain path's
# own, and the argmax of every row must agree with the plain path's. One
# prompt is too few: its distance turns on a handful of bf16 flips, and
# the ratio per prompt read 1.1-3.4.
F64_FACTOR = 2.0
N_PROMPTS_Q4KM = 3
# The Q8_0 and F16 models (signed weights in every layer, no common part)
# sit at the bf16 noise floor itself: a one-ulp flip in one matmul output
# spreads through the per-head q/k norms and the softmax, and after a few
# layers every activation of two paths of the same law differs by about an
# ulp. Their logits then lie ~4 % of max|logit| apart (kernel vs plain,
# and either vs the f64 path alike), so a row's argmax may go to a near
# tie. There ("f64_near_tie") a row's argmax may differ from the plain
# path's only where the row is a near tie: the plain path puts the kernel
# path's token within the band (F64_FACTOR x the plain path's largest
# distance from the f64 path at that row) of its best, and the f64 path's
# own top two lie within the band too. Every other row must agree; the RMS
# ratio is held as on the Q4_K_M model.
# The Q4_0 and Q5_0 models have signed weights in every layer too (no
# common part, RMS 0.026), yet their logits do not sit at that floor: the
# kernel and plain paths lie 3.4e-4-1.2e-3 of max|logit| apart, and every
# argmax agreed with the plain path's (27 of 27 rows each; RMS ratio 1.12
# and 1.10; NVIDIA H100 80GB HBM3, 700.00 W). So they are held as the
# Q4_K_M model is ("f64": argmax on every row).
# Of the codebook models, the IQ4_XS and MXFP4 ones sit at that floor (kernel
# vs plain 3.2-5.5 % of max|logit|, as Q8_0's 3.7-4.7 % in the same call;
# one MXFP4 row of 27 picked another token on a near tie: the plain path's
# gap 0.043, the f64 path's margin 0.015, the band 0.59), the IQ4_NL one
# does not (0.10-0.12 %, every argmax agreed; RMS ratio 1.14; NVIDIA H100
# 80GB HBM3, 700.00 W). The models at the floor are those whose weights
# have no common part (mean / RMS ~0: Q8_0, F16, MXFP4's symmetric codebook,
# IQ4_XS's sub-scales of both signs); IQ4_NL's codebook (mean −5.9, RMS
# 67.4: −0.088), like Q4_0's and Q5_0's offsets (−0.11, −0.054) and Q4_K's
# mins, gives them one. So:
CODEBOOK_AGAINST = {"IQ4_NL": "f64", "IQ4_XS": "f64_near_tie",
                    "MXFP4": "f64_near_tie"}
# A model held "f64_near_tie" must still hold MIN_HELD_ROWS rows to exact
# argmax agreement: rows whose f64 top-2 margin lies past the band. Three
# prompts held 5-8 of their 27 rows on the Q8_0, F16, IQ4_XS and MXFP4
# models (NVIDIA H100 80GB HBM3, 700.00 W), so they take N_PROMPTS_NEAR_TIE
# prompts (~18+ held rows each at the rarest rate seen, 5 in 27; 12 prompts
# then held 20-67 on the same card).
MIN_HELD_ROWS, N_PROMPTS_NEAR_TIE = 12, 12
# the uniform low-bit files: the rule each is held to, from the common-part
# guess (PERF.md §7): Q2_K's mins give its weights a common part and its
# logits sit off the noise floor (kernel vs plain 0.06-0.07 % of
# max|logit|, every row held); Q3_K's signed sub-scales give none and its
# logits sit near the floor (1.0-1.4 %; 4 of 108 rows near ties; NVIDIA
# H100 80GB HBM3, 700.00 W)
LOWBIT_AGAINST = {"Q2_K": "f64", "Q3_K": "f64_near_tie"}

N_CTX, N_PREFILL, N_DECODE, N_TEACHER = 2048, 64, 128, 8
# the flash kernels at Qwen3-8B's attention shapes (32 query heads over 8 KV
# heads of 128): T query tokens over S cells. S = 1000 is no multiple of 512
# (the Pallas tile halves to 8 cells; the kernel's last split is ragged).
# T = 1 and 2 (4 and 8 rows per KV head) take kernel F's decode regime, T =
# 3, 8 and 64 (12, 32, 256 rows) its prefill regime.
FLASH_HEADS = (32, 8, 128)
FLASH_TS, FLASH_SS = (1, 2, 3, 8, 64), (512, 1000, 2048, 8192)
# the kv-read bucket the served turns decode over (Context.kv_buckets)
KV_BUCKET = 512
# times: decode (T = 1) from that bucket up to a 32,768-cell pool, and a
# 64-token ubatch, which reads the whole N_CTX pool
FLASH_TIMES = ((1, KV_BUCKET), (1, 2048), (1, 8192), (1, 32768),
               (N_PREFILL, KV_BUCKET), (N_PREFILL, N_CTX))
N_LAYERS = 36  # full depth, on every path but those cut to CUT_LAYERS
# the depth of earlier slices' paths, cut so that the whole run stays well
# inside its time limit, their kernels still held and timed at the full
# model's shapes: the IQ4_NL, IQ4_XS and MXFP4 files (kernel E's codebook
# entries, D's codebook branches; 38-103 s each of a 997-s run at 36
# layers), since the spoken round the Q8_0, Q2_K and Q3_K files
# (kernels E, H, D's branches; the run read 1,041.8 s with them at 18
# layers, and their phases took 109 s more at 36 in the slice before:
# ~1,150 s), and since the vision-duplex phase the Q5_K_M, Q4_0 and Q5_0
# files (a run read 1,191.6 s with them and F16 at 36 layers, those
# phases 281.1 s of it; NVIDIA H100 80GB HBM3, 700.00 W). The F16 model,
# whose latency the reference quotes, serves at 36 layers
CUT_LAYERS = 18
# Q4_K_M Qwen3-8B (llama.cpp's rules): the output head and attn_v, ffn_down
# of 18 of the 36 layers are Q6_K, the other weights Q4_K
N_Q6K, N_Q4K = 37, 216
# Q5_K_M at CUT_LAYERS (the same rules): attn_v and ffn_down of the 9
# use_more_bits layers of 18, and the head, Q6_K; the other 108 weights Q5_K
N_Q6K_CUT, N_Q5K_CUT = 19, 108
# Q4_0 / Q5_0 in the importance-matrix layout: 248 weights of the recipe's
# type, 4 of Q4_1 / Q5_1 (the ffn_down of layers i < n_layers / 8), 1 Q6_K
# head; at CUT_LAYERS 124 and 2
N_LEGACY, N_LEGACY_MIN = 248, 4
N_LEGACY_CUT, N_LEGACY_MIN_CUT = 7 * CUT_LAYERS - CUT_LAYERS // 8, CUT_LAYERS // 8
# unfused Qwen3-8B at CUT_LAYERS: 18 x (wq, wk, wv, wo, gate, up, down) + output
N_UNFUSED = 7 * CUT_LAYERS + 1
# the codebook and low-bit files: the layer weights in the recipe's type
# (252 at 36 layers; 126 at CUT_LAYERS), 1 Q6_K head
N_CUT = 7 * CUT_LAYERS
# the Q8_0 file: every weight Q8_0, the head too
N_Q8_0 = 7 * CUT_LAYERS + 1
# the F16 path's decode step may allocate this much above its start: the
# step's activations, logits, attention scores and the split dots' f32
# partials (16 x 151748 x 4 B = 9.7 MB at the head) are ~12 MB; a widened
# copy of the 151748 x 4096 head alone would be 2.49 GB
DECODE_STEP_ALLOC_LIMIT = 100e6
# the Q8_0 GGUF at CUT_LAYERS (about 4.4 GB; 8.70 at 36 layers) and room
# for its metadata
Q8_0_FILE_BYTES = 4.6e9
# a served turn may drop this share of its sampled tokens from its text:
# random weights sample ids >= 150000 (1748 of the 151748, 1.15 %), which
# the pipeline's text filter drops; a sampler emitting special ids fails
MAX_FILTERED_SHARE = 0.05

# kernel vs plain: both round each p·vs to bf16 (relative error <= 2**-8),
# but against other running maxima (a warp's 64-cell tiles, or its 16 cells
# of each, in the kernel, the Pallas 512-cell tiles in the plain version; the
# bound holds for any tiling), so one term may differ by 2 x 2**-8
# of p|v|: per output, 2**-7 x Σ p|v| / l (from the f64 law), plus a floor
# of 1e-6 of its largest value for the f32 sums taken in another order.
# Measured: 0.15 of the limit at most.
FLASH_RTOL, FLASH_FLOOR = 2**-7, 1e-6
# the quantized KV caches the Q4_K_M model serves with: Context kv_dtype ->
# the flash kernel every layer's attention launches
KV_TURNS = {"q8_0": "flash_decode", "q4_0": "flash_decode4"}

# the session phase: ChatML turns of the Q4_K_M model on a q8_0 pool under
# the server's default sampler, past a 512-token round window
SESSION_WINDOW = 512  # SessionConfig.max_preserved_context
SESSION_TURN = 160  # tokens a default turn (four; the slide fires at 3 and 4)
SESSION_DRY = 64  # tokens of the turn with penalties and DRY
SESSION_MIROSTAT = 48  # tokens of the mirostat-2 turn (the host loop)
SESSION_SHORT = 24  # tokens of the repeat-from-seed and save/load turns
SESSION_SYSTEM = "You are a helpful assistant. Answer in a few sentences."
SESSION_USER = (
    "What does a GGUF file hold, and how is it read?",
    "Explain byte-level BPE tokenization in plain words, please.",
    "Why would a server evict whole rounds of a conversation?",
    "How does rotary position embedding let cached keys be shifted?",
    "Summarise our talk so far; don't repeat yourself, OK?",
    "One more thing: what is mirostat sampling?",
    "Say hello again.")
SESSION_CHECK_LAYERS = (0, 35)  # K layers held to the f64 rotation law
CHI2_DRAWS, CHI2_MIN_P = 20000, 1e-4
SAMPLE_TIMES = 200  # sample() calls timed with CUDA events

KERNELS = {
    "q4k_gemv": {"route": "cuda", "source": "omni_tpu_torch/csrc/q4k_gemv.cu",
                 "replaces": "omni_tpu/kernels/dequant_matmul.py:333"},
    "q4k_gemm": {"route": "cuda", "source": "omni_tpu_torch/csrc/q4k_gemm.cu",
                 "replaces": "omni_tpu/kernels/dequant_matmul.py:565"},
    "q5k_gemv": {"route": "cuda", "source": "omni_tpu_torch/csrc/q4k_gemv.cu",
                 "replaces": "omni_tpu/kernels/dequant_matmul.py:333"},
    "q5k_gemm": {"route": "cuda", "source": "omni_tpu_torch/csrc/q4k_gemm.cu",
                 "replaces": "omni_tpu/kernels/dequant_matmul.py:565"},
    **{f"{f}_gemv": {"route": "cuda", "source": "omni_tpu_torch/csrc/q4k_gemv.cu",
                     "replaces": "omni_tpu/kernels/dequant_matmul.py:333"}
       for f in ("q4_0", "q4_1", "q5_0", "q5_1")},
    **{f"{f}_gemm": {"route": "cuda", "source": "omni_tpu_torch/csrc/q4k_gemm.cu",
                     "replaces": "omni_tpu/kernels/dequant_matmul.py:565"}
       for f in ("q4_0", "q4_1", "q5_0", "q5_1")},
    "q6k_gemv": {"route": "cuda", "source": "omni_tpu_torch/csrc/q6k_gemv.cu",
                 "replaces": "omni_tpu/kernels/dequant_matmul.py:333"},
    "qgemm": {"route": "cuda", "source": "omni_tpu_torch/csrc/qgemm.cu",
              "replaces": "omni_tpu/kernels/dequant_matmul.py:103"},
    "q8_0_gemv": {"route": "cuda", "source": "omni_tpu_torch/csrc/q8_0_gemv.cu",
                  "replaces": "omni_tpu/kernels/dequant_matmul.py:333"},
    **{f"{f}_gemv": {"route": "cuda", "source": "omni_tpu_torch/csrc/codebook_gemv.cu",
                     "replaces": "omni_tpu/kernels/dequant_matmul.py:333"}
       for f in ("iq4_nl", "iq4_xs", "mxfp4")},
    **{f"{f}_gemv": {"route": "cuda", "source": "omni_tpu_torch/csrc/lowbit_gemv.cu",
                     "replaces": "omni_tpu/kernels/dequant_matmul.py:333"}
       for f in ("q2k", "q3k")},
    "flash_decode": {"route": "cuda", "source": "omni_tpu_torch/csrc/flash_decode.cu",
                     "replaces": "omni_tpu/kernels/flash_attention.py:141"},
    "flash_decode4": {"route": "cuda", "source": "omni_tpu_torch/csrc/flash_decode.cu",
                      "replaces": "omni_tpu/kernels/flash_attention.py:217"},
    "qffn": {"route": "cuda", "source": "omni_tpu_torch/csrc/qffn.cu",
             "replaces": "omni_tpu/kernels/fused_ffn.py:80"},
}


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, kernel D's per format (as
    "qgemm Q5_K" and so on) and kernel I's per format pair met so far (as
    "qffn Q4_0/Q4_1")."""
    from omni_tpu_torch.kernels import dequant_matmul as dm
    from omni_tpu_torch.kernels import flash_attention as fa
    from omni_tpu_torch.kernels import fused_ffn as ff

    return {**dm.launches, **{f"qgemm {f}": n for f, n in dm.qgemm_launches.items()},
            **fa.launches, **ff.launches,
            **{f"qffn {p}": n for p, n in ff.qffn_launches.items()}}


def nonzero(counts: dict) -> dict:
    """The launch counts that are not 0 (kernel I's pairs appear as met)."""
    return {k: v for k, v in counts.items() if v}


def reset_launches() -> None:
    from omni_tpu_torch.kernels import dequant_matmul as dm
    from omni_tpu_torch.kernels import flash_attention as fa
    from omni_tpu_torch.kernels import fused_ffn as ff

    dm.reset_launches()
    fa.reset_launches()
    ff.reset_launches()


def phase(name: str, t0: float, msg: str = "") -> None:
    now = time.perf_counter()
    print(f"[phase {name}] {now - t0:.2f} s (total {now - T_START:.1f} s)"
          + (f" {msg}" if msg else ""), flush=True)


class BenchTokenizer:
    """bench.py's tokenizer: byte ids, no special or end tokens, so every
    turn runs to its token budget."""

    class _V:
        token_to_id: dict = {}
        eos_id = None

        @staticmethod
        def is_eog(tid):
            return False

    vocab = _V()

    def encode(self, text, add_special=False, parse_special=True):
        return [b % 1000 for b in text.encode()]

    def decode(self, ids):
        return "".join(chr(97 + int(i) % 26) for i in ids)


def limit_ratio(got, want) -> float:
    """Largest |got - want| over its limit (KERNEL_RTOL |want| +
    KERNEL_FLOOR max|want|); the kernel agrees where it is <= 1."""
    want_abs = want.abs()
    limit = KERNEL_RTOL * want_abs + KERNEL_FLOOR * want_abs.max()
    return ((got - want).abs() / limit).max().item()


def flip_limit(plain_share: float, n_outputs: int) -> float:
    """The largest share of bf16 outputs a kernel may round otherwise than
    the f64 law, where its plain version rounds `plain_share` of the same
    `n_outputs` otherwise."""
    return max(FLIP_FACTOR * plain_share, FLIP_FLOOR, FLIP_CHANCE / n_outputs)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` runs, after one warm-up, by
    CUDA events around the launches (host enqueue time included)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of fn(i), i = 0..iters-1, captured in one CUDA graph
    and replayed, so the host's enqueue time between launches drops out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(m: int, n: int, k: int, weight_bytes: int,
             out_dtype) -> tuple[float, str]:
    """Least time for one call: bytes (the weight's `weight_bytes`, and x
    and out, each once) over HBM bandwidth vs operations over the bf16
    tensor-core peak (the operands are bf16 x and weights the tensor cores
    take as bf16). The weight bytes are those of the GGUF blocks (Q4_K
    0.5625 B per element, Q6_K 0.8203 B, Q8_0 1.0625 B: what the function
    needs) for the bound, those of the port's planes (0.594, 1.078 and
    1.125 B) for the planes' bound."""
    out_b = 4 if str(out_dtype).endswith("float32") else 2
    nbytes = weight_bytes + m * k * 2 + m * n * out_b
    ops = 2.0 * m * n * k
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_TENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def law_f64(name: str, x, qt, out_dtype):
    """Kernel `name`'s law evaluated in f64 ("dense_matmul": the dense dot's,
    x in the weight's dtype): the same bf16 x and the same weights (rounded to
    bf16 where the law rounds them), sums without rounding, one rounding to
    out_dtype at the end."""
    import torch

    from omni_tpu_torch.kernels import dequant_matmul as dm
    from omni_tpu_torch.kernels.qformats import (dequant, int8_group_scales,
                                                 int8_values, kquant_values,
                                                 lowbit_group_scales, lowbit_values,
                                                 q4k_group_scales, q6k_group_scales)

    f64 = torch.float64
    if name == "dense_matmul":
        return (x.to(qt.dtype).to(f64) @ qt.to(f64).T).to(out_dtype)
    if name == "qffn":  # qt = (gate/up, down, act): bf16 x, weights and h kept
        gu, down, act = qt
        f = down.shape[1]
        xd = x.to(torch.bfloat16).to(f64)
        w = dequant(gu, torch.bfloat16).to(f64)
        g, u = xd @ w[:f].T, xd @ w[f:].T
        del w
        if act == "silu":
            a = g * torch.sigmoid(g)
        else:
            a = g * (0.5 * (1.0 + torch.tanh((2 / torch.pi) ** 0.5
                                             * (g + 0.044715 * g * g * g))))
        h = (a * u).to(torch.bfloat16).to(f64)
        return (h @ dequant(down, torch.bfloat16).to(f64).T).to(out_dtype)
    xd = x.to(torch.bfloat16).to(f64)
    if name in dm.HALVES_GEMV.values():  # the group law; q·dl − ml is exact in f64
        dl, ml = (a.to(f64).repeat_interleave(32, 1) for a in q4k_group_scales(qt))
        out = xd @ (kquant_values(qt).to(f64) * dl - ml).T
    elif name in dm.HALVES_GEMM.values():
        w, ml_res = dm.q4k_centered(qt)
        xs = xd.reshape(x.shape[0], -1, 32).sum(-1)
        out = xd @ w.to(f64).T - xs @ ml_res.to(f64).T
    elif name == "q6k_gemv":
        dl = q6k_group_scales(qt).to(f64).repeat_interleave(16, 1)
        out = xd @ (qt.q.to(f64) * dl).T
    elif name in dm.LOWBIT_GEMV.values():  # q·dl − ml is exact in f64
        dl, ml = lowbit_group_scales(qt)
        w = lowbit_values(qt).to(f64) * dl.to(f64).repeat_interleave(16, 1)
        if ml is not None:
            w = w - ml.to(f64).repeat_interleave(16, 1)
        out = xd @ w.T
    elif name == "q8_0_gemv" or name in dm.CODEBOOK_GEMV.values():
        # q·dl is exact in f64 (dl in f32; q the codebook value)
        dl = int8_group_scales(qt).to(f64).repeat_interleave(32, 1)
        out = xd @ (int8_values(qt).to(f64) * dl).T
    elif name == "qgemm":
        out = xd @ dequant(qt, torch.bfloat16).to(f64).T
    else:
        raise ValueError(f"no law for kernel {name!r}")
    return out.to(out_dtype)


def plain_law(name: str, x, w, out_dtype):
    """Kernel `name`'s plain PyTorch version (`dense_matmul`'s too; for
    "qffn", w is (gate/up, down, act))."""
    from omni_tpu_torch.kernels import dequant_matmul as dm
    from omni_tpu_torch.kernels import fused_ffn as ff

    if name == "qffn":
        return ff.qffn_plain(x, *w, out_dtype)
    return getattr(dm, name + "_plain")(x, w, out_dtype)


@contextmanager
def matmuls_by(qwen3_mod, dm, law, attn=None):
    """Run the forward with each kernel, and the dense dot, replaced by
    law(kernel name or "dense_matmul", x, w, out_dtype) under the same dispatch
    (plain_law or law_f64; the fused FFN, kernel I, by law("qffn", x,
    (gate/up, down, act), out_dtype)), and a quantized pool's attention by
    attn(q, k, v, mask, k_scale, v_scale, scale) on the layer's raw planes
    (`flash_decode_plain` or `flash_law_f64`), for the logits references."""
    from omni_tpu_torch.kernels.qformats import QTensor

    def mm(x, w, out_dtype=None):
        import torch

        out_dtype = out_dtype or torch.bfloat16
        if not isinstance(w, QTensor):
            return law("dense_matmul", x, w, out_dtype)
        return law(dm.kernel_for(x.shape[0], w).__name__,
                   x.to(torch.bfloat16), w, out_dtype)

    def ffn(x, gu, down, act="silu", out_dtype=None):
        import torch

        return law("qffn", x.to(torch.bfloat16), (gu, down, act),
                   out_dtype or torch.bfloat16)

    def pool_attn(q, cache, layer, mask, scale=None, kv_limit=None):
        k, v, ks, vs = cache.layer_planes(layer, limit=kv_limit)
        return attn(q, k, v, mask, ks, vs, scale)

    with mock.patch.object(qwen3_mod, "matmul", mm), \
            mock.patch.object(qwen3_mod, "qffn", ffn), \
            mock.patch.object(qwen3_mod, "pool_attention", pool_attn):
        yield


def flash_law_f64(q, k, v, mask, k_scale=None, v_scale=None, scale=None,
                  with_abs=False):
    """The flash law in f64: bf16 q, the cells dequantized in f64 (exact),
    an exact softmax of the scores with -1e30 where masked, f32 [T, Hq, D]
    out; with_abs also returns Σ p|v| per output in f64, the scale of the
    kernel-vs-plain limit."""
    import torch

    from omni_tpu_torch.kernels import flash_attention as fa

    t, hq, d = q.shape
    hkv = k.shape[0]
    bits = fa.cell_bits(k, k_scale)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    kd, vd = (fa.cells_f32(x, bits).double() for x in (k, v))
    if bits < 16:
        kd = kd * k_scale.double()[..., None]
        vd = vd * v_scale.double()[..., None]
    sc = fa.heads_major(q.to(torch.bfloat16).double(), hkv) @ kd.transpose(1, 2) * scale
    sc = torch.where(mask.repeat_interleave(hq // hkv, dim=0)[None], sc, fa.NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = fa.tokens_major(p @ vd, t)
    if with_abs:
        return out, fa.tokens_major(p @ vd.abs(), t)
    return out.float()


def flash_inputs(bits: int, t: int, s: int, dev, gen, heads=FLASH_HEADS,
                 mixed: bool = False):
    """Attention inputs over S cells, Qwen3-8B's `heads` (Hq, Hkv, D) by
    default: q [T, 32, 128], K/V [8, S, 128] drawn N(0, 1) and stored as the pool stores them (bf16, or
    quantized by the port's q8_0 / q4_0 codec), a causal mask from real
    positions (cell c holds position c; the T queries sit just before a
    masked tail of 16 cells) and, for T > 1, a first row masked everywhere.
    mixed: each row a sequence of its own, as a server step's decode rows
    (cell c belongs to sequence c mod T; row i sees its sequence's cells
    before the tail). Returns (q, k, v, mask, k_scale, v_scale)."""
    import torch

    from omni_tpu_torch.runtime.kv_cache import quant_rows, quant_rows4

    hq, hkv, d = heads
    q = torch.randn((t, hq, d), device=dev, generator=gen)
    kf, vf = (torch.randn((hkv, s, d), device=dev, generator=gen) for _ in range(2))
    tail = min(16, s // 4)
    cell = torch.arange(s, device=dev)
    qpos = torch.arange(t, device=dev) + max(s - tail - t, 0)
    mask = (cell[None] <= qpos[:, None]) & (cell[None] < s - tail)
    if mixed:
        mask = (cell[None] % t == torch.arange(t, device=dev)[:, None]) & (
            cell[None] < s - tail)
    elif t > 1:
        mask[0] = False
    if bits == 16:
        return q, kf.to(torch.bfloat16), vf.to(torch.bfloat16), mask, None, None
    qr = quant_rows if bits == 8 else quant_rows4
    (ks, k), (vs, v) = qr(kf), qr(vf)
    return q, k, v, mask, ks, vs


def check_flash(bits: int, t: int, s: int, dev, gen, max_err,
                mixed: bool = False) -> None:
    """Kernel F (`flash_decode`, or `flash_decode4` for int4 cells) against
    its plain version within FLASH_RTOL x Σ p|v| (+ FLASH_FLOOR), finite,
    its RMS distance from the f64 law within F64_FACTOR of the plain
    version's, and a repeat launch bit-identical (the splits are merged in
    split order whichever arrives last)."""
    import torch

    from omni_tpu_torch.kernels import flash_attention as fa

    args = flash_inputs(bits, t, s, dev, gen, mixed=mixed)
    name = "flash_decode4" if bits == 4 else "flash_decode"
    got = fa.flash_decode(*args)
    again = fa.flash_decode(*args)
    want = fa.flash_decode_plain(*args)
    exact, exact_abs = flash_law_f64(*args, with_abs=True)
    torch.cuda.synchronize()
    same = torch.equal(got, again)
    err = (got - want).abs().max().item()
    limit = FLASH_RTOL * exact_abs + FLASH_FLOOR * exact_abs.max()
    worst = ((got - want).abs() / limit).max().item()
    rms = [(a.double() - exact).pow(2).mean().sqrt().item() for a in (got, want)]
    ratio = rms[0] / max(rms[1], 1e-30)
    max_err[name] = max(max_err.get(name, 0.0), err)
    ok = bool(torch.isfinite(got).all()) and worst <= 1.0 and ratio <= F64_FACTOR and same
    plan = fa.split_plan(t * FLASH_HEADS[0] // FLASH_HEADS[1], FLASH_HEADS[1], s)
    print(f"  {name} {({16: 'bf16', 8: 'int8', 4: 'int4'})[bits]} T={t} S={s} "
          + ("(a sequence a row) " if mixed else "") +
          f"{plan.regime}, {plan.nsplit} splits of {plan.per_split}: "
          f"max|d|={err:.3g}, worst |d|/limit {worst:.3g} (limit {FLASH_RTOL:g} "
          f"sum p|v| + {FLASH_FLOOR:g} max); rms vs the f64 law kernel {rms[0]:.3g}, "
          f"plain {rms[1]:.3g}, ratio {ratio:.3g} (limit {F64_FACTOR}), repeat "
          f"{'bit-identical' if same else 'DIFFERS'} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"{name} at T={t} S={s} ({bits}-bit cells) disagrees with "
                         f"its plain version or the f64 law, or a repeat launch "
                         f"gave other bits")


def check_kernel(name, kern, plain, w, shape_name, m, out_dtype, gen, max_err):
    """Kernel `name` against its plain version on a random [m, K] x, for a
    QTensor or a dense weight `w`; both are also read against the law in
    f64 (bf16 outputs: the share rounded otherwise, held to flip_limit;
    f32 outputs: max|d| over max|law|)."""
    import torch

    n, k = w.shape
    x = torch.randn((m, k), device=(w.q if hasattr(w, "q") else w).device,
                    generator=gen).to(torch.bfloat16)
    got = kern(x, w, out_dtype).float()
    want = plain(x, w, out_dtype).float()
    exact = law_f64(name, x, w, out_dtype).float()
    if x.is_cuda:
        torch.cuda.synchronize()
    hold(name, w, shape_name, m, out_dtype, got, want, exact, max_err)


def hold(name, w, shape_name, m, out_dtype, got, want, exact, max_err, note="") -> None:
    """check_kernel's verdict on kernel `name`'s outputs `got` against its
    plain version's `want` and the f64 law's `exact` (f32 tensors of the
    same shape): the agreement limit, and for bf16 outputs the share
    rounded otherwise than the law under flip_limit; prints one line."""
    import torch

    n, k = w.shape
    err = (got - want).abs().max().item()
    worst = limit_ratio(got, want)
    fmt = getattr(w, "ggml_type", None)
    for key in [name] if fmt is None else [name, f"{name} {fmt.name}"]:
        max_err[key] = max(max_err.get(key, 0.0), err)
    ok = bool(torch.isfinite(got).all()) and worst <= 1.0
    flips_ok, held = True, ""
    if out_dtype == torch.bfloat16:
        vs = [(a != exact).float().mean().item() for a in (got, want)]
        vs_what = "bf16 outputs rounded otherwise than the f64 law"
        lim = flip_limit(vs[1], got.numel())
        flips_ok = vs[0] <= lim
        held = f" (limit {lim:.3g}) {'ok' if flips_ok else 'FAIL'}"
    else:
        vs = [((a - exact).abs().max() / exact.abs().max()).item()
              for a in (got, want)]
        vs_what = "max|d| / max|f64 law|"
    print(f"  {name} {fmt.name if fmt is not None else str(w.dtype)[6:]} "
          f"{shape_name} {n}x{k} M={m}{note}: max|d|={err:.3g} "
          f"max|want|={want.abs().max().item():.3g},"
          f" worst |d|/limit {worst:.3g} (limit {KERNEL_RTOL:g}|want| + "
          f"{KERNEL_FLOOR:g} max|want|) {'ok' if ok else 'FAIL'}; {vs_what}: "
          f"kernel {vs[0]:.3g}, plain {vs[1]:.3g}{held}", flush=True)
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version")
    if not flips_ok:
        raise SystemExit(
            f"{name} at {shape_name} M={m} rounds {vs[0]:.3g} of its bf16 "
            f"outputs otherwise than the f64 law, its plain version {vs[1]:.3g}: "
            f"above flip_limit {lim:.3g}")


def check_gemv_rows(name, w, shape_name, out_dtype, gen, max_err) -> None:
    """The mma.sync GEMV entry `name` against its plain version at
    every M in MMA_GEMV_MS: the first m rows of one random x [8, K], whose plain and
    f64-law outputs are computed once (an output row depends on its x row
    alone), held as check_kernel holds them. At M = 8 a repeat launch and a
    CUDA-graph replay must give the eager launch's bits."""
    import torch

    from omni_tpu_torch.kernels import dequant_matmul as dm

    kern = getattr(dm, name)
    n, k = w.shape
    x = torch.randn((max(MMA_GEMV_MS), k), device=w.q.device,
                    generator=gen).to(torch.bfloat16)
    want = getattr(dm, name + "_plain")(x, w, out_dtype).float()
    exact = law_f64(name, x, w, out_dtype).float()
    note = f" ({dm.gemv_plan(x.shape[0], n, k, w.ggml_type).blocks(n)} blocks)"
    for m in MMA_GEMV_MS:
        got = kern(x[:m], w, out_dtype).float()
        torch.cuda.synchronize()
        hold(name, w, shape_name, m, out_dtype, got, want[:m], exact[:m], max_err, note)
    first, again = kern(x, w, out_dtype), kern(x, w, out_dtype)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        kern(x, w, out_dtype)
    torch.cuda.current_stream().wait_stream(side)
    graph, out = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        out.append(kern(x, w, out_dtype))
    graph.replay()
    torch.cuda.synchronize()
    as_int = torch.int16 if out_dtype == torch.bfloat16 else torch.int32
    for what, other in (("a repeat launch", again), ("a CUDA-graph replay", out[0])):
        if not torch.equal(first.view(as_int), other.view(as_int)):
            raise SystemExit(f"{name} {w.ggml_type.name} at {shape_name}: {what} gave "
                             "other bits than the eager launch")


def check_cases(name, qt, shape_name, ms, out_dtype, gen, max_err) -> None:
    """check_kernel at each M of `ms`; the mma.sync GEMVs (kernel A's and
    E's codebook entries, kernels C and H) through check_gemv_rows at
    MMA_GEMV_MS instead."""
    from omni_tpu_torch.kernels import dequant_matmul as dm

    if name in dm.MMA_GEMV.values():
        check_gemv_rows(name, qt, shape_name, out_dtype, gen, max_err)
        return
    for m in ms:
        check_kernel(name, getattr(dm, name), getattr(dm, name + "_plain"), qt,
                     shape_name, m, out_dtype, gen, max_err)


def check_qffn(gu, down, m, act, gen, max_err, rows=QFFN_ROWS) -> None:
    """Kernel I against its plain version on random [m, K] x (bf16
    outputs), both read against its law in f64 (the share of bf16 outputs
    rounded otherwise, held to flip_limit); a second launch on the same
    inputs must give the same bits (every sum is taken in a fixed order). The shares are read over `rows` rows, in launches of m rows: an
    h = bf16(act(g)·u) that rounds otherwise moves every output of its row,
    by as much as that h is large, so a row's share turns on its largest h
    that sit near a rounding boundary, for the plain version as for the
    kernel. With `down` an identity (`identity_q8_0`) the outputs are h
    itself."""
    import torch

    from omni_tpu_torch.kernels import fused_ffn as ff

    pair = ff.pair_name(gu, down)
    reps = max(1, rows // m)
    xs = torch.randn((reps * m, gu.shape[1]), device=gu.q.device,
                     generator=gen).to(torch.bfloat16)
    got = torch.cat([ff.qffn(xs[i * m:(i + 1) * m], gu, down, act) for i in range(reps)])
    again = ff.qffn(xs[:m], gu, down, act)
    want = ff.qffn_plain(xs, gu, down, act)
    exact = law_f64("qffn", xs, (gu, down, act), torch.bfloat16)
    torch.cuda.synchronize()
    same = torch.equal(got[:m], again)
    got, want, exact = got.float(), want.float(), exact.float()
    err = (got - want).abs().max().item()
    worst = limit_ratio(got, want)
    for key in ("qffn", f"qffn {pair}"):
        max_err[key] = max(max_err.get(key, 0.0), err)
    vs = [(a != exact).float().mean().item() for a in (got, want)]
    lim = flip_limit(vs[1], got.numel())
    ok = bool(torch.isfinite(got).all()) and worst <= 1.0 and vs[0] <= lim and same
    print(f"  qffn {pair} {act} K={gu.shape[1]} F={down.shape[1]} N={down.shape[0]} "
          f"M={m} x {reps}: max|d|={err:.3g} max|want|={want.abs().max().item():.3g}, "
          f"worst |d|/limit {worst:.3g}; bf16 outputs rounded otherwise than the f64 "
          f"law: kernel {vs[0]:.3g}, plain {vs[1]:.3g} (limit {lim:.3g}); repeat "
          f"launch {'bit-identical' if same else 'DIFFERS'} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit(f"qffn {pair} at M={m} disagrees with its plain version, rounds "
                         f"{vs[0]:.3g} of its bf16 outputs otherwise than the f64 law "
                         f"(limit {lim:.3g}) or differs between launches")


def identity_q8_0(n: int, device):
    """An [n, n] Q8_0 identity (q = 1 on the diagonal, d = 1): kernel I
    through it gives h itself, exactly (each output sums one term)."""
    import torch

    from omni_tpu_torch.core.dtypes import GGMLType
    from omni_tpu_torch.kernels.qformats import QTensor

    return QTensor(GGMLType.Q8_0, (n, n), q=torch.eye(n, dtype=torch.int8, device=device),
                   sc=None, mn=None, d=torch.ones((n, n // 32), device=device), dm=None,
                   qh=None)


def time_qffn(weights, ms, gen, rows) -> None:
    """Time kernel I per (gate/up, down) pair of `weights` at each M beside
    its plain version, the library yardstick (torch.matmul on the weights
    pre-dequantised to bf16, SiLU and the product between; the port never
    calls it), the port's own unfused composition (`matmul` over the fused
    gate/up weight, its bf16 SiLU product, `matmul` over down: A/B, E/D and
    so on) and the bound of the format's bytes (and of the planes'); and
    each of its two passes alone (`fused_ffn.passes`: the gated pass, then
    the down pass on the h it left), with its share of the call."""
    import torch
    import torch.nn.functional as F

    from omni_tpu_torch.core.dtypes import row_nbytes
    from omni_tpu_torch.kernels import dequant_matmul as dm
    from omni_tpu_torch.kernels import fused_ffn as ff
    from omni_tpu_torch.kernels.qformats import dequant
    from omni_tpu_torch.testing_synth import synth_quant

    for pair, (gu, dn) in weights.items():
        (two_f, k), (n, f) = gu.shape, dn.shape
        dev = gu.q.device
        fmt_bytes = two_f * row_nbytes(gu.ggml_type, k) + n * row_nbytes(dn.ggml_type, f)
        planes = gu.nbytes + dn.nbytes
        ws = [(gu, dn)] + [(synth_quant(gu.ggml_type, two_f, k, dev, gen),
                            synth_quant(dn.ggml_type, n, f, dev, gen))
                           for _ in range(min(7, L2_FLUSH_BYTES // planes))]
        lib_w = (dequant(gu, torch.bfloat16), dequant(dn, torch.bfloat16))

        def library(x):
            g_u = torch.matmul(x, lib_w[0].T)
            return torch.matmul(F.silu(g_u[:, :f]) * g_u[:, f:], lib_w[1].T)

        def composition(x, w):
            g_u = dm.matmul(x, w[0])
            h = F.silu(g_u[:, :f].to(torch.float32)).to(torch.bfloat16) * g_u[:, f:]
            return dm.matmul(h, w[1])

        for m in ms:
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            t_k = graph_ms(lambda i: ff.qffn(x, *ws[i % len(ws)]), 24)
            runs = [ff.passes(x, *w) for w in ws]
            plan = runs[0][0]
            t_gated = graph_ms(lambda i: runs[i % len(runs)][1](), 24)
            t_down = graph_ms(lambda i: runs[i % len(runs)][2](), 24)
            del runs
            t_p = cuda_ms(lambda: ff.qffn_plain(x, gu, dn), 3)
            t_l = graph_ms(lambda i: library(x), 24)
            t_c = graph_ms(lambda i: composition(x, ws[i % len(ws)]), 24)
            ops = 2.0 * m * (two_f * k + f * n)
            io = m * k * 2 + m * n * 2
            t_bytes = (fmt_bytes + io) / HBM_BYTES_PER_S * 1e3
            t_ops = ops / BF16_TENSOR_OPS_PER_S * 1e3
            b, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            pb = max((planes + io) / HBM_BYTES_PER_S * 1e3, t_ops)
            rows.append({"kernel": "qffn", "pair": pair, "m": m, "k": k, "f": f, "n": n,
                         "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                         "composition_ms": t_c, "bound_ms": b, "bound_by": by,
                         "planes_bound_ms": pb, "regime": plan.regime,
                         "splits": [plan.splits_gu, plan.splits_dn],
                         "gated_ms": t_gated, "down_ms": t_down})
            print(f"  qffn {pair} K={k} F={f} N={n} M={m}: {t_k:.4f} ms, plain "
                  f"{t_p:.4f}, torch.matmul(bf16) composition {t_l:.4f}, the port's "
                  f"unfused composition {t_c:.4f}, bound {b:.4f} ({by}), {b / t_k:.1%} "
                  f"of bound; the planes' bound {pb:.4f}, {pb / t_k:.1%}; x "
                  f"{N_LAYERS} layers {t_k * N_LAYERS:.3f} ms; {plan.regime} passes: gated "
                  f"{t_gated:.4f} ms ({t_gated / t_k:.1%}), down {t_down:.4f} ms "
                  f"({t_down / t_k:.1%}), splits {plan.splits_gu}/{plan.splits_dn}",
                  flush=True)
        del ws, lib_w


def serve_turn(label, cfg, params, dev, qwen3, want_step, want_ubatch, rng,
               kv_dtype="bf16"):
    """The main path: one served turn (session-init prefill of a 64-char
    prompt, a 32-token warm turn, a warm 64-token prefill ubatch, a timed
    N_DECODE-token turn) with every launch count set to 0 just before it
    and read just after. Checks the launches of each kernel in every
    single-token decode step (want_step) and in the 64-token ubatch
    (want_ubatch). The prompt and the ubatch's tokens are drawn from host
    generator `rng`; the KV cells are `kv_dtype`. Returns (the path's
    launches, its numbers)."""
    import torch

    from omni_tpu_torch.omni.pipeline import OmniPipeline, SessionConfig
    from omni_tpu_torch.runtime import Batch, Context, SamplerParams

    calls = []  # (rows, launches of that forward call), in order

    def counted_forward(params, cfg, x, *a, **kw):
        before = launch_counts()
        out = qwen3.forward(params, cfg, x, *a, **kw)
        calls.append((x.shape[0], {k: v - before.get(k, 0)
                                   for k, v in launch_counts().items()}))
        return out

    llm = Context(cfg, params, counted_forward, qwen3.embed, n_ctx=N_CTX,
                  sampler=SamplerParams(greedy=True), device=dev, kv_dtype=kv_dtype)
    cache = llm.cache
    kv_bytes_per_cell = sum(x.nbytes for x in (cache.k, cache.v, cache.k_scale,
                                                cache.v_scale) if x is not None) / cache.size
    pipe = OmniPipeline(llm, BenchTokenizer(),
                        SessionConfig(max_preserved_context=N_CTX))
    prompt = "".join(chr(65 + int(c)) for c in torch.randint(0, 26, (N_PREFILL,),
                                                             generator=rng))
    texts = []
    # every sampled token passes the pipeline's text filter (no special ids,
    # none >= 150000: random weights sample those ~1 % of the time), and
    # each that passes is one character of BenchTokenizer's text
    passed = []
    valid = pipe.is_valid_tts_token

    def counted_valid(tid):
        passed.append(valid(tid))
        return passed[-1]

    pipe.is_valid_tts_token = counted_valid

    def drain():
        while True:
            try:
                ev = pipe.text_out.get_nowait()
            except queue.Empty:
                return
            texts.append(ev.get("content", ""))

    reset_launches()  # the main path starts here
    t1 = time.perf_counter()
    pipe.stream_prefill(index=0, system_prompt=prompt)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t1) * 1e3
    t1 = time.perf_counter()
    pipe.stream_decode(round_idx=0, max_new_tokens=32)
    drain()
    warm_turn_s = time.perf_counter() - t1
    pipe.warm_decode()
    cont = torch.randint(0, 1000, (N_PREFILL,), generator=rng).numpy()
    llm.decode(Batch(tokens=cont))
    t1 = time.perf_counter()
    logits, hidden = llm.decode(Batch(tokens=cont), return_hidden=True)
    warm_prefill_ms = (time.perf_counter() - t1) * 1e3
    ubatch = calls[-1][1]
    if not (torch.isfinite(logits).all() and torch.isfinite(hidden).all()
            and tuple(logits.shape) == (N_PREFILL, cfg.n_vocab)
            and tuple(hidden.shape) == (N_PREFILL, cfg.d_model)):
        raise SystemExit("prefill logits/hidden are not finite or misshapen")
    n_before = len(calls)
    texts.clear()
    passed.clear()
    t1 = time.perf_counter()
    pipe.stream_decode(round_idx=1, max_new_tokens=N_DECODE)
    torch.cuda.synchronize()
    turn_s = time.perf_counter() - t1
    drain()
    launches = launch_counts()  # the main path ends here
    steps = [c for t, c in calls[n_before:] if t == 1]
    decode_ms_per_token = turn_s * 1e3 / N_DECODE
    text = "".join(texts)
    n_filtered = len(passed) - sum(passed)
    print(f"  {label}: prefill (session init, incl. first use) {prefill_ms:.1f} "
          f"ms; warm turn {warm_turn_s:.2f} s; warm {N_PREFILL}-token prefill "
          f"{warm_prefill_ms:.2f} ms, launches {ubatch}; timed turn {N_DECODE} "
          f"tokens {turn_s:.3f} s = {decode_ms_per_token:.3f} ms/token; "
          f"{len(steps)} single-token steps, launches per step "
          f"{steps[0] if steps else None}; {len(passed)} tokens, "
          f"{n_filtered} filtered, text {len(text)} chars", flush=True)
    bad = [c for c in steps if nonzero(c) != nonzero(want_step)]
    if bad or len(steps) < N_DECODE - 1:
        raise SystemExit(f"decode steps: want {want_step} launches in each of "
                         f">= {N_DECODE - 1} steps, got {len(steps)} steps, "
                         f"{len(bad)} differing, e.g. {bad[:1]}")
    if nonzero(ubatch) != nonzero(want_ubatch):
        raise SystemExit(f"64-token ubatch launches {nonzero(ubatch)} != "
                         f"{nonzero(want_ubatch)}")
    if (len(passed) < N_DECODE - 1 or len(text) != sum(passed)
            or n_filtered > MAX_FILTERED_SHARE * len(passed)):
        raise SystemExit(f"the turn emitted {len(text)} chars for {len(passed)} "
                         f"sampled tokens ({n_filtered} dropped by the text "
                         f"filter), want >= {N_DECODE - 1} tokens, a char for "
                         f"each kept one and at most {MAX_FILTERED_SHARE:.0%} "
                         f"dropped")
    return launches, {"launches_per_decode_step": steps[0],
                      "launches_per_64_token_ubatch": ubatch,
                      "decode_ms_per_token": decode_ms_per_token,
                      "warm_prefill_ms": warm_prefill_ms,
                      "tokens_filtered": n_filtered,
                      "session_init_prefill_ms": prefill_ms,
                      "layers": cfg.n_layers, "kv_dtype": str(kv_dtype),
                      "kv_bytes_per_cell": kv_bytes_per_cell}


def rerotation_excess(before, after, layers, rot, base: float) -> float:
    """Largest error of `after`'s K (a KVCache) on `layers` against the f64
    rotation of the K `before` (f64 [H, S, D] per layer, dequantized as the
    pool does) by each cell's delta `rot` ([S]), over its limit: one code
    step (the code times the row's f32 scale, in f64) on a quantized pool;
    on a bf16 one 2^-7 of the value plus the rotation's f32 arithmetic,
    (2^-20 |angle| + 2^-22) of its pair's norm (the rotation, as the JAX
    cache's, takes its angle and cos/sin in f32: an angle error of about
    2^-21 of the angle, a trig error of an f32 ulp; near a cancellation, a
    value small against its pair, this outweighs 2^-7 of the value: the JAX
    cache's own shift of a 2,048-cell pool by -474 reads 150 times 2^-7
    alone). An empty cell (zero limit) holds while it stays zero. <= 1
    holds. Runs on the tensors' device (the card here, the CPU in
    tests/test_torch_kv_shift.py)."""
    import torch

    from omni_tpu_torch.runtime.kv_cache import unpack4

    d = before[0].shape[-1]
    dev = before[0].device
    freqs = 1.0 / base ** (torch.arange(0, d, 2, dtype=torch.float64, device=dev) / d)
    ang = rot.to(torch.float64)[:, None] * freqs  # [S, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    worst = 0.0
    for li, kf in zip(layers, before):
        x1, x2 = kf[..., :d // 2], kf[..., d // 2:]
        want = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
        if after.quantized:
            codes = unpack4(after.k[li]) if after.bits == 4 else after.k[li]
            limit = after.k_scale[li].double()[..., None]
            got = codes.double() * limit
        else:
            got = after.k[li].double()
            norm = torch.sqrt(x1 * x1 + x2 * x2).repeat(1, 1, 2)
            f32 = (2.0 ** -20 * ang.abs() + 2.0 ** -22).repeat(1, 2)  # [S, D]
            limit = 2.0 ** -7 * want.abs() + f32 * norm
        # an empty cell (zeros, a zero scale) has a zero limit: it holds
        # when it is still zero, and fails otherwise (0 / 0 would be NaN,
        # which max() passes over)
        err = (got - want).abs()
        worst = max(worst, float(torch.where(err == 0, 0.0, err / limit).max()))
    return worst


@contextmanager
def no_host_sync():
    """Raise on any host sync with the card (an `.item()`, a copy from or
    to pageable host memory, a stream wait) inside the block."""
    import torch

    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def check_sync_guard(dev) -> None:
    """Fail unless `no_host_sync` raises on a host read: a 0-d index
    tensor, which ATen reads with `.item()`."""
    import torch

    try:
        with no_host_sync():
            torch.zeros(4, device=dev)[torch.zeros((), dtype=torch.int64, device=dev)]
    except RuntimeError:
        return
    raise SystemExit("the sync guard let a 0-d index read pass")


def filters_on_the_card(row, sp):
    """sp's top-k, top-p and min-p on the card's `row`, each held against
    the same filter on the CPU copy of its input: the -inf masks must be
    equal but at a token whose deciding quantity (its cumulative
    probability before it, for top-p; its probability, for min-p, against
    max * min_p), computed on the CPU in f32, lies within 4 ulp of the
    threshold, the rule of tests/test_torch_sampler.py; top-k's mask must
    be equal. Returns (the filtered row on the card, the tokens so
    admitted)."""
    import numpy as np
    import torch

    from omni_tpu_torch.runtime import sampler as smp

    def top_p_q(x):
        srt = torch.sort(x, descending=True, stable=True)
        cum = torch.cumsum(torch.softmax(srt.values, -1), 0)
        q = torch.empty_like(x)
        q[srt.indices] = torch.cat([torch.zeros(1), cum[:-1]])
        return q, sp.top_p

    def min_p_q(x):
        probs = torch.softmax(x, -1)
        return probs, float(probs.max() * np.float32(sp.min_p))

    admitted = 0
    for name, f, quantity in (
            ("top_k", lambda x: smp.apply_top_k(x, sp.top_k), None),
            ("top_p", lambda x: smp.apply_top_p(x, sp.top_p), top_p_q),
            ("min_p", lambda x: smp.apply_min_p(x, sp.min_p), min_p_q)):
        host = row.cpu()
        got, row = f(host).isneginf(), f(row)
        diff = torch.nonzero(row.cpu().isneginf() != got)[:, 0]
        if len(diff):
            ok = quantity is not None
            if ok:
                q, thresh = quantity(host)
                ulp = float(np.spacing(np.float32(abs(thresh))))
                ok = bool(((q[diff].double() - thresh).abs() <= 4 * ulp).all())
            if not ok:
                raise SystemExit(f"session: {name}'s mask on the card differs from "
                                 f"the CPU's at tokens {diff[:8].tolist()}")
            admitted += len(diff)
    return row, admitted


def session_phase(cfg, params, tok, dev, qwen3, smi: str):
    """The session a real file needs, on the Q4_K_M model loaded with its
    own tokenizer (`tok`, `build_tokenizer(reader.kv)`): ChatML turns
    through OmniPipeline on a q8_0 pool (kernel F) under the server's
    default SamplerParams(), past a SESSION_WINDOW-token round window (the
    slide evicts whole rounds and re-rotates the later K cells), one turn
    with the penalties and DRY, one mirostat-2 turn on the host loop. Every
    launch count is set to 0 just before the turns and read just after;
    A, B, C, D and F must have launched. Checks: after each slide the
    positions are contiguous from 0 (so from n_keep), kv_high bounds the
    occupied cells, and K on SESSION_CHECK_LAYERS is within the f64
    rotation law of the cells before it; a fresh context from the same
    seed repeats the first turn's tokens; a turn run after a session save
    and again after its load (the generator reseeded) gives the same
    tokens; CHI2_DRAWS draws from one logits row follow softmax of its
    filtered row (chi-square p > CHI2_MIN_P), the card's filter masks equal
    the CPU's (`filters_on_the_card`); every fused chunk of the turns and
    the timed sample() calls run under `no_host_sync`. Prints the rounds dropped,
    n_past after each slide, host ms to encode and decode the session's
    ChatML text, device ms a call of `sample` alone and ms a slide, each
    with the card. Returns (launches, stats)."""
    import numpy as np
    import torch
    from scipy import stats as sps

    from omni_tpu_torch.chat import apply_chat_template
    from omni_tpu_torch.omni import pipeline as pipeline_mod
    from omni_tpu_torch.omni.pipeline import OmniPipeline, SessionConfig
    from omni_tpu_torch.runtime import Batch, Context, SamplerParams
    from omni_tpu_torch.runtime import sampler as smp

    t_phase = time.perf_counter()
    default = SamplerParams()
    slides, checks = [], []

    def make():
        llm = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=N_CTX,
                      sampler=default, device=dev, kv_dtype="q8_0")
        pipe = OmniPipeline(llm, tok, SessionConfig(
            max_preserved_context=SESSION_WINDOW))
        fed = []  # every fed token passes the text filter once, in order
        valid = pipe.is_valid_tts_token

        def recording(tid):
            fed.append(int(tid))
            return valid(tid)

        pipe.is_valid_tts_token = recording
        return llm, pipe, fed

    llm, pipe, fed = make()
    cache = llm.cache

    # every slide: its time, the rounds it dropped, n_past after, and the
    # re-rotated K against the f64 law (the check's time left out)
    seq_add, slide = llm.seq_add, pipe._slide_window_if_needed

    def checked_seq_add(seq_id, p0, p1, delta):
        t = time.perf_counter()
        before = [cache.read_layer(li)[0].double() for li in SESSION_CHECK_LAYERS]
        rot = cache.seq_add_delta(seq_id, p0, p1, delta)
        checks.append(time.perf_counter() - t)
        seq_add(seq_id, p0, p1, delta)
        t = time.perf_counter()
        slides[-1]["law"] = max(slides[-1].get("law", 0.0), rerotation_excess(
            before, cache, SESSION_CHECK_LAYERS, rot, cfg.rope_base))
        checks[-1] += time.perf_counter() - t

    def timed_slide():
        if llm.n_past.get(0, 0) <= SESSION_WINDOW:
            return slide()
        rounds = [(r.start_pos, r.end_pos) for r in pipe.rounds]
        slides.append({})
        checks.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        slide()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t - sum(checks)) * 1e3
        if "law" not in slides[-1]:  # no whole round could go
            slides.pop()
            return
        occupied = torch.nonzero(cache.seq_mask != 0)[:, 0]
        pos = torch.sort(cache.pos[occupied]).values.cpu().numpy()
        n_past = llm.n_past[0]
        slides[-1].update(
            ms=ms, n_past=n_past, dropped=rounds[:len(rounds) - len(pipe.rounds)],
            contiguous=bool(np.array_equal(pos, np.arange(n_past))),
            bounded=int(occupied.max()) < max(llm.kv_high, llm.cells_used))

    llm.seq_add = checked_seq_add
    pipe._slide_window_if_needed = timed_slide

    # every chunk the fused loop enqueues must make no host sync: each one
    # runs with CUDA's sync debug mode set to raise
    real_scan, synced = pipeline_mod.omni_decode_scan, [0]

    def sync_free_scan(*a, **kw):
        with no_host_sync():
            out = real_scan(*a, **kw)
        synced[0] += 1
        return out

    pipeline_mod.omni_decode_scan = sync_free_scan
    check_sync_guard(dev)

    messages = [{"role": "system", "content": SESSION_SYSTEM}]
    turns = []

    def turn(r, text, budget):
        fed.clear()
        pipe.prefill_text(text)
        t = time.perf_counter()
        pipe.stream_decode(round_idx=r, max_new_tokens=budget)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        reply = ""
        while True:
            try:
                reply += pipe.text_out.get_nowait().get("content", "")
            except queue.Empty:
                break
        messages.extend([{"role": "user", "content": text},
                         {"role": "assistant", "content": reply}])
        turns.append({"tokens": len(fed), "s": secs, "n_past": llm.n_past[0]})
        return list(fed)

    reset_launches()  # the session's main path starts here
    pipe.stream_prefill(index=0, system_prompt=SESSION_SYSTEM)
    first = None
    for r in range(4):
        toks = turn(r, SESSION_USER[r], SESSION_TURN)
        first = toks if first is None else first
    llm.sampler = SamplerParams(penalty_repeat=1.1, penalty_freq=0.05,
                                penalty_present=0.05, dry_multiplier=0.8,
                                dry_breakers=tuple(tok.encode("\n", add_special=False)))
    turn(4, SESSION_USER[4], SESSION_DRY)
    llm.sampler = SamplerParams(mirostat=2)
    llm.mu = smp.mirostat_init(llm.sampler, dev)
    turn(5, SESSION_USER[5], SESSION_MIROSTAT)
    torch.cuda.synchronize()
    launches = launch_counts()  # the session's main path ends here
    pipeline_mod.omni_decode_scan = real_scan
    llm.sampler, llm.mu = default, None
    session_s = time.perf_counter() - t_phase
    missing = [k for k in ("q4k_gemv", "q4k_gemm", "q6k_gemv", "qgemm", "flash_decode")
               if not launches.get(k)]
    if missing or len(slides) < 2 or not synced[0]:
        raise SystemExit(f"session: kernels not launched {missing}; {len(slides)} "
                         f"slides (want >= 2); {synced[0]} chunks checked for "
                         "host syncs")

    # the same seed, a fresh context: the first turn's tokens again
    llm2, pipe2, fed2 = make()
    pipe2.stream_prefill(index=0, system_prompt=SESSION_SYSTEM)
    pipe2.prefill_text(SESSION_USER[0])
    pipe2.stream_decode(round_idx=0, max_new_tokens=SESSION_SHORT)
    repeat = list(fed2)
    del llm2, pipe2
    if not repeat or repeat != first[:len(repeat)]:
        raise SystemExit(f"session: a fresh context from seed {default.seed} gave "
                         f"{repeat[:8]}..., the first turn {first[:8]}...")

    # save, run a turn, load, run it again from the same generator seed
    llm.sync_cells_used()
    t = time.perf_counter()
    state = pipe.session_state_bytes()
    save_s = time.perf_counter() - t
    prev = llm.prev_tokens.clone()
    again = []
    for i in range(2):
        llm.generator.manual_seed(1234)
        llm.prev_tokens = prev.clone()
        again.append(turn(6, SESSION_USER[6], SESSION_SHORT))
        if i == 0:
            t = time.perf_counter()
            pipe.load_session_state_bytes(state)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t
    if not again[0] or again[0] != again[1]:
        raise SystemExit(f"session: the turn after a load gave {again[1][:8]}..., "
                         f"before it {again[0][:8]}...")
    bad = [d for d in slides if not (d["contiguous"] and d["bounded"] and d["law"] <= 1.0)]
    if bad:
        raise SystemExit(f"session: slides with cells out of place or K off its "
                         f"f64 law: {bad}")

    # host: the session's ChatML text through the file's tokenizer
    text = apply_chat_template("chatml", messages, add_assistant=False)
    t = time.perf_counter()
    ids = tok.encode(text)
    encode_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    back = tok.decode(ids)
    decode_ms = (time.perf_counter() - t) * 1e3
    if back != text:
        raise SystemExit("session: the ChatML text does not decode to itself")

    # sample() alone on one real logits row: its time, and its law
    row = llm.decode(Batch(tokens=tok.encode("Once upon a time", add_special=False)))[0][-1]
    gen = torch.Generator(device=dev).manual_seed(7)
    smp.sample(row, default, generator=gen)  # first use
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with no_host_sync():  # the timed calls are enqueued without a wait
        start.record()
        for _ in range(SAMPLE_TIMES):
            smp.sample(row, default, generator=gen)
        end.record()
    torch.cuda.synchronize()
    sample_ms = start.elapsed_time(end) / SAMPLE_TIMES
    draws = torch.stack([smp.sample(row, default, generator=gen)
                         for _ in range(CHI2_DRAWS)]).cpu().numpy()
    filt, at_threshold = filters_on_the_card(row.float(), default)
    filt = smp.apply_temp(filt, default)
    p = torch.softmax(filt.double(), -1).cpu().numpy()
    seen = np.bincount(draws, minlength=len(p))
    if seen[p == 0].sum():
        raise SystemExit(f"session: {seen[p == 0].sum()} draws of filtered tokens")
    exp = p * CHI2_DRAWS
    big = exp >= 5
    obs_b = np.append(seen[big], seen[~big & (p > 0)].sum())
    exp_b = np.append(exp[big], exp[~big & (p > 0)].sum())
    if exp_b[-1] == 0:
        obs_b, exp_b = obs_b[:-1], exp_b[:-1]
    chi = sps.chisquare(obs_b, exp_b * obs_b.sum() / exp_b.sum())
    if not chi.pvalue > CHI2_MIN_P:
        raise SystemExit(f"session: {CHI2_DRAWS} draws against softmax of the "
                         f"filtered row: chi-square p = {chi.pvalue}")

    print(f"  session ({smi}): n_keep {pipe.n_keep}; turns "
          f"{[(d['tokens'], round(d['s'], 3), d['n_past']) for d in turns]} "
          f"(tokens, s, n_past); {len(slides)} slides", flush=True)
    for i, d in enumerate(slides):
        print(f"  session slide {i} ({smi}): dropped rounds {d['dropped']}, n_past "
              f"after {d['n_past']}, {d['ms']:.3f} ms, K vs f64 law "
              f"{d['law']:.3f} of one code step", flush=True)
    print(f"  session text ({smi}): {len(text)} chars, {len(ids)} tokens, host "
          f"encode {encode_ms:.3f} ms, decode {decode_ms:.3f} ms", flush=True)
    print(f"  session sample ({smi}): {sample_ms:.4f} ms a call of sample() "
          f"(CUDA events over {SAMPLE_TIMES} calls, vocab {row.shape[0]}); "
          f"{CHI2_DRAWS} draws over {len(exp_b)} bins, chi-square p "
          f"{chi.pvalue:.4g}; the card's filter masks equal the CPU's but "
          f"{at_threshold} token(s) within 4 ulp of a threshold; {synced[0]} "
          f"fused chunks and the timed sample() calls made no host sync; state save {save_s:.3f} s ({len(state) / 1e6:.1f} MB), "
          f"load {load_s:.3f} s; repeat from seed {len(repeat)} tokens, after load "
          f"{len(again[1])} tokens equal; phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, {
        "session_s": session_s, "phase_s": time.perf_counter() - t_phase,
        "n_keep": pipe.n_keep, "turns": turns,
        "slides": [{k: v for k, v in d.items()} for d in slides],
        "slide_ms": [d["ms"] for d in slides],
        "chatml_chars": len(text), "chatml_tokens": len(ids),
        "encode_ms": encode_ms, "decode_ms": decode_ms, "sample_ms": sample_ms,
        "chi2_p": chi.pvalue, "state_mb": len(state) / 1e6,
        "filter_tokens_at_threshold": at_threshold, "sync_free_chunks": synced[0],
        "save_s": save_s, "load_s": load_s}


SPOKEN_AUDIO_S = 2  # seconds of 16 kHz audio in the spoken round
SPOKEN_TOKENS = 10  # text tokens out: one TTS chunk
SPOKEN_TF_STEPS = 25  # TTS steps teacher-forced on the card and the CPU
# the two card-vs-CPU limits, between the sound port's largest gap and the
# smallest gap of a fault planted on the card, over seeds 0-4
# (`python -m omni_tpu_torch.spoken_limits`, NVIDIA H100 80GB HBM3, 700.00 W):
# the TTS teacher-forced, of max|logit| a step (bf16 activations, cuBLAS vs
# CPU sums): sound 0.0203-0.0224, the rotary pairs flipped 0.220-0.245 (a
# head in f32 reads as sound, 0.0199-0.0223: this check cannot see it)
SPOKEN_TF_RTOL = 6e-2
# one Token2Wav window (the wave's RMS 0.0082-0.0112, none of it clamped):
# sound 7.0e-8-8.2e-8, TF32 dots 2.0e-4-2.8e-4, the noise table drawn on
# the card or one frame off 0.0145-0.0166
SPOKEN_WAVE_ATOL = 1e-5
SPOKEN_APM_ITERS = 5
# short rounds (two 25-code TTS scans) that time the end of prefill to the
# first wave with the pipeline's first-window hold (True) and without it
SPOKEN_HOLD_ROUNDS = (False, True, True, False)


def spoken_phase(cfg, params, qts, tok, dev, qwen3, smi: str, seed: int, tmp: str):
    """A spoken round on the Q4_K_M model (MiniCPM-o 4.5's "Full omni"
    layout: the LLM Q4_K_M, the rest F16): the APM (24 x 1024), the TTS (20
    x 768), Token2Wav (conformer 6 + 4, DiT 16 x 512, HiFiGAN2) written at
    full width to the model directory `tmp` (`testing_synth`), loaded by
    omni-cli's `build_pipeline` beside the loaded LLM, then one
    `run_test_cases` round: SPOKEN_AUDIO_S s of 16 kHz audio in,
    SPOKEN_TOKENS text tokens out (one TTS chunk), the TTS to audio_eos or
    its cap, every Token2Wav window. Fails unless every wave is finite,
    within +-0.99 and 24,000 samples a 25 codes (960 a code of the window
    but its 3 look-ahead codes, which only the final window renders, after
    the 3,840-sample cached head from the second window on); a 25-code TTS scan runs
    with no host sync (`no_host_sync`); SPOKEN_TF_STEPS TTS steps
    teacher-forced on the card agree with the port on the CPU within
    SPOKEN_TF_RTOL of max|logit| a step, and one Token2Wav window within
    SPOKEN_WAVE_ATOL (`spoken_limits` reads both gaps over seeds and
    planted faults); and the launches of kernels A-D equal those of the
    LLM's own forward calls (`kernel_for` at each call's rows over the
    file's weights): the APM, the TTS and Token2Wav launch none. Then
    short rounds of two TTS scans time the end of prefill to the first
    wave with and without the pipeline's first-window hold
    (SPOKEN_HOLD_ROUNDS). Prints ms a 1 s APM chunk, ms an audio code, ms
    a Token2Wav window and its RTF, the time from the end of prefill to
    the first wave and the peak memory, each with the card. Returns
    (launches, stats, the pipeline, whose modules the vision-duplex phase
    takes over)."""
    import argparse

    import numpy as np
    import torch

    from omni_tpu_torch.cli import omni_cli
    from omni_tpu_torch.core.gguf import GGUFReader
    from omni_tpu_torch.models import tts as tts_mod
    from omni_tpu_torch.models import whisper
    from omni_tpu_torch.models.token2wav import Token2Wav
    from omni_tpu_torch.omni import audio as audio_mod
    from omni_tpu_torch.omni import pipeline as pipeline_mod
    from omni_tpu_torch.runtime import Batch, Context, SamplerParams
    from omni_tpu_torch.runtime.loop import _scalar
    from omni_tpu_torch.spoken_limits import forced_gap, forced_logits, wave_stats
    from omni_tpu_torch.testing_synth import (write_apm_gguf, write_token2wav_ggufs,
                                              write_tts_gguf)

    t_phase = time.perf_counter()
    check_sync_guard(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident_gib = torch.cuda.memory_allocated() / 2**30
    llm_gib = (sum(w.nbytes for w in qts) + params["token_embd"].nbytes) / 2**30
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    for sub in ("audio", "tts"):
        os.makedirs(os.path.join(tmp, sub))
    write_apm_gguf(os.path.join(tmp, "audio", "minicpmo-audio-apm-f16.gguf"), gen)
    write_tts_gguf(os.path.join(tmp, "tts", "minicpmo-tts-f16.gguf"), gen)
    write_token2wav_ggufs(os.path.join(tmp, "token2wav"), gen)
    paths = omni_cli.resolve_model_paths(os.path.join(tmp, "llm.gguf"))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    llm = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=N_CTX,
                  device=dev, sampler=SamplerParams(temp=0.7))
    args = argparse.Namespace(ctx_size=N_CTX, temp=0.7, no_audio=False,
                              no_tts=False, omni=False, duplex=False)
    pipe = omni_cli.build_pipeline(paths, args, dev, llm=llm, tokenizer=tok)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    x = np.arange(16000 * SPOKEN_AUDIO_S) / 16000
    noise = np.random.default_rng(seed).standard_normal(len(x))
    audio_mod.write_wav(os.path.join(tmp, "case_1.wav"),
                        0.3 * np.sin(2 * np.pi * 220 * x) + 0.02 * noise, rate=16000)

    # the round, instrumented: the LLM's forward calls by rows, the
    # Token2Wav windows and their times, the end of prefill, the first wave
    rows, windows, marks, tts_runs = [], [], {}, []
    forward = llm._forward

    def counted(p, c, xx, *a, **kw):
        rows.append(int(xx.shape[0]))
        return forward(p, c, xx, *a, **kw)

    llm._forward = counted
    feed = pipe.t2w.feed_window

    def timed_window(tokens, is_final=False):
        t = time.perf_counter()
        wave = feed(tokens, is_final=is_final)
        windows.append((np.asarray(tokens), is_final, wave,
                        time.perf_counter() - t))
        return wave

    pipe.t2w.feed_window = timed_window
    wait_prefill, put = pipe._wait_prefill, pipe.wav_out.put

    def marked_wait():
        wait_prefill()
        torch.cuda.synchronize()
        marks["prefilled"] = time.perf_counter()

    def marked_put(item):
        marks.setdefault("first_wave", time.perf_counter())
        put(item)

    pipe._wait_prefill, pipe.wav_out.put = marked_wait, marked_put
    generate = pipe._tts_generate

    def timed_generate(out, first_chunk, emit=None):
        t = time.perf_counter()
        codes = generate(out, first_chunk, emit=emit)
        tts_runs.append((len(out.token_ids), len(codes), time.perf_counter() - t))
        return codes

    pipe._tts_generate = timed_generate
    reset_launches()
    t0 = time.perf_counter()
    try:
        res = omni_cli.run_test_cases(pipe, os.path.join(tmp, "case_"), 1,
                                      os.path.join(tmp, "out"), SPOKEN_TOKENS)
        round_s = time.perf_counter() - t0
        launches = launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        first_wave_ms = 1e3 * (marks["first_wave"] - marks["prefilled"])
        n_main = len(rows), len(windows), len(tts_runs)
        # the first wave with and without the hold, in rounds of two scans
        held_ms, cap = {True: [], False: []}, pipeline_mod.SIMPLEX_AUDIO_CAP
        pipeline_mod.SIMPLEX_AUDIO_CAP = 2 * pipeline_mod.T2W_MAIN
        try:
            for k, held in enumerate(SPOKEN_HOLD_ROUNDS):
                if not held:
                    pipe._hold_for_token2wav = lambda: True
                marks.clear()
                omni_cli.run_test_cases(pipe, os.path.join(tmp, "case_"), 1,
                                        os.path.join(tmp, f"hold_{k}"), SPOKEN_TOKENS)
                held_ms[held].append(1e3 * (marks["first_wave"] - marks["prefilled"]))
                pipe.__dict__.pop("_hold_for_token2wav", None)
        finally:
            pipeline_mod.SIMPLEX_AUDIO_CAP = cap
        for lst, n in zip((rows, windows, tts_runs), n_main):
            del lst[n:]  # the short rounds' records
    finally:
        pipe.shutdown()
    llm._forward = forward
    files = sorted(os.listdir(os.path.join(tmp, "out", "round_000", "tts_wav")))
    # the copies the checks compare with: the TTS on the CPU, Token2Wav
    # fresh on the card and on the CPU
    t0 = time.perf_counter()
    tcfg = pipe.tts_ctx.cfg
    tts_cpu = tts_mod.load_params(GGUFReader(paths["tts"]), device="cpu")
    t2w_files = [paths[k] for k in ("t2w_encoder", "t2w_flow", "t2w_extra",
                                     "t2w_vocoder", "t2w_prompt")]
    t2w_cpu = Token2Wav.from_gguf(*t2w_files, device="cpu")
    t2w_card = Token2Wav.from_gguf(*t2w_files, device=dev)
    cpu_s = time.perf_counter() - t0

    # ---- the waves and the launches ----------------------------------------
    waves = res["waves"]
    if not waves or len(waves) != len(windows) or len(files) != len(waves):
        raise SystemExit(f"spoken: {len(waves)} waves, {len(windows)} windows, "
                         f"{len(files)} files")
    for i, (toks, fin, wave, _) in enumerate(windows):
        # 2 mel frames a code, less the 3 look-ahead codes of a window that
        # is not final, after the 8 cached frames: 24,000 samples a 25 codes
        want = 480 * ((8 if i else 0) + 2 * (len(toks) - (0 if fin else 3)))
        if (len(wave) != want or not np.isfinite(wave).all()
                or np.abs(wave).max() > 0.99):
            raise SystemExit(f"spoken: window {i} has {len(wave)} samples (want "
                             f"{want}), max |x| {np.abs(wave).max()}")
    want_l = kernel_launches(rows, qts)
    if nonzero(launches) != want_l:
        raise SystemExit(f"spoken: launches {nonzero(launches)}, the LLM's "
                         f"{len(rows)} forward calls make {want_l}")

    # ---- a TTS scan with no host sync; ms an audio code --------------------
    ex, tctx = pipe.tts_extras, pipe.tts_ctx
    tctx.clear_kv()
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, 150000, (SPOKEN_TOKENS,), generator=g, device=dev)
    hid = torch.randn((SPOKEN_TOKENS, cfg.d_model), generator=g, device=dev)
    cond = tts_mod.build_condition(ex, ids, hid, True, pipe.spk_embed)
    _, h0 = tctx.decode(Batch(embeds=cond), return_hidden=True)
    start = tctx.n_past[0]

    def scan(n=SPOKEN_TF_STEPS):
        return tts_mod.tts_decode_scan(tctx.params, tcfg, ex, tctx.cache, h0[-1],
                                       _scalar(start, dev), n, first_chunk=True,
                                       generator=g)

    torch.cuda.synchronize()
    with no_host_sync():
        codes = scan()[0]
    tts_ms = cuda_ms(scan, 2) / SPOKEN_TF_STEPS
    codes = codes.cpu().numpy()
    codes = codes[codes >= 0]

    # ---- 25 TTS steps teacher-forced: the card against the CPU ---------------
    got = forced_logits(tcfg, tctx.params, ex, cond, codes, dev)
    want = forced_logits(tcfg, *tts_cpu, cond, codes, "cpu")
    tf_rel = forced_gap(got, want)
    tf_argmax = float((got.argmax(1) == want.argmax(1)).float().mean())
    if not tf_rel <= SPOKEN_TF_RTOL:
        raise SystemExit(f"spoken: teacher-forced TTS logits {tf_rel:.3g} of "
                         f"max|logit| from the CPU's (limit {SPOKEN_TF_RTOL})")

    # ---- one Token2Wav window: the card against the CPU ----------------------
    w_toks = windows[0][0]
    w_card = t2w_card.feed_window(w_toks)
    w_cpu = t2w_cpu.feed_window(w_toks)
    t2w_err = float(np.abs(w_card - w_cpu).max())
    w_stats = wave_stats(w_cpu)
    if not t2w_err <= SPOKEN_WAVE_ATOL:
        raise SystemExit(f"spoken: a Token2Wav window differs from the CPU's by "
                         f"{t2w_err:.3g} (limit {SPOKEN_WAVE_ATOL}; the wave's RMS "
                         f"{w_stats['rms']:.3g}, {w_stats['clamped']:.3g} clamped)")

    # ---- ms a 1 s APM chunk --------------------------------------------------
    enc = pipe.audio_encoder
    mel = audio_mod.log_mel_spectrogram(
        np.sin(2 * np.pi * 220 * x[:16000]).astype(np.float32), enc.filters)
    mel_d = torch.from_numpy(mel).to(dev)
    state = whisper.WhisperState.create(enc.cfg, device=dev)
    params_apm = enc.params
    apm_ms = cuda_ms(lambda: whisper.encode_chunk(params_apm, enc.cfg, mel_d, state),
                     SPOKEN_APM_ITERS)

    full = [wt for toks, fin, _, wt in windows if len(toks) == 28 and not fin]
    win_ms = 1e3 * float(np.median(full)) if full else float("nan")
    n_codes = sum(c for _, c, _ in tts_runs)
    stats = {
        "write_s": write_s, "load_s": load_s, "cpu_copies_s": cpu_s, "round_s": round_s,
        "text": res["text"], "text_chars": len(res["text"]), "tts_chunks": tts_runs,
        "audio_codes": n_codes, "windows": len(windows),
        "window_codes": [len(t) for t, _, _, _ in windows],
        "window_ms": [1e3 * wt for _, _, _, wt in windows],
        "apm_ms_per_1s_chunk": apm_ms, "tts_ms_per_code": tts_ms,
        "tts_round_ms_per_code": 1e3 * sum(t for _, _, t in tts_runs) / max(n_codes, 1),
        "t2w_ms_per_window": win_ms, "t2w_rtf": win_ms / 1e3,
        "prefill_end_to_first_wave_ms": first_wave_ms, "peak_gib": peak_gib,
        "resident_gib": resident_gib, "llm_gib": llm_gib,
        "tts_teacher_forced_rel": tf_rel, "tts_teacher_forced_argmax": tf_argmax,
        "t2w_window_max_abs_err": t2w_err, "t2w_window_rms": w_stats["rms"],
        "t2w_window_clamped": w_stats["clamped"],
        "first_wave_held_ms": held_ms[True], "first_wave_not_held_ms": held_ms[False],
        "llm_forward_calls": len(rows),
        "phase_s": time.perf_counter() - t_phase}
    print(f"  spoken APM ({smi}): {apm_ms:.3f} ms a 1 s chunk (24 x 1024, 50 conv "
          f"frames -> 10 rows; CUDA events over {SPOKEN_APM_ITERS})", flush=True)
    print(f"  spoken TTS ({smi}): {tts_ms:.3f} ms an audio code (a "
          f"{SPOKEN_TF_STEPS}-code scan, CUDA events; no host sync inside); the "
          f"round's {n_codes} codes at {stats['tts_round_ms_per_code']:.3f} ms a code "
          f"(host clock, reads included); teacher-forced vs CPU {tf_rel:.3g} of "
          f"max|logit|, argmax agreement {tf_argmax:.3f}", flush=True)
    print(f"  spoken Token2Wav ({smi}): {win_ms:.3f} ms a full window (median of "
          f"{len(full)}), RTF {win_ms / 1e3:.4f}; {len(windows)} windows; one window "
          f"vs CPU max |diff| {t2w_err:.3g} (the wave's RMS {w_stats['rms']:.4g}, "
          f"{w_stats['clamped']:.4g} of its samples at the clamp)", flush=True)
    print(f"  spoken first wave ({smi}): end of prefill to first wave in rounds of "
          f"two TTS scans, the second held for the first window "
          f"{[round(t, 1) for t in held_ms[True]]} ms, not held "
          f"{[round(t, 1) for t in held_ms[False]]} ms", flush=True)
    print(f"  spoken round ({smi}): end of prefill to first wave {first_wave_ms:.1f} ms; "
          f"peak memory {peak_gib:.3f} GiB, {resident_gib:.3f} GiB resident at the "
          f"phase's start (the LLM {llm_gib:.3f} GiB; the rest earlier phases' "
          f"weights), so the round's modules and state {peak_gib - resident_gib:.3f} "
          f"GiB (the reference's ~9 GB is its RTX 4090 figure); "
          f"{len(res['text'])} chars of text; round {round_s:.2f} s; "
          f"write {write_s:.1f} s, load {load_s:.1f} s, CPU copies {cpu_s:.1f} s; "
          f"LLM launches {nonzero(launches)} = its {len(rows)} forward calls'",
          flush=True)
    return launches, stats, pipe


# the vision-duplex phase: a 1344 x 1008 image (an overview of 518 x 392
# and 3 x 2 slices of 420 x 476: 7 parts, 448 LLM rows), then five 640 x
# 480 frames under high_refresh (the main frame, 3 parts, and a 2 x 2 stack
# of 1280 x 960, 7 parts), a duplex turn of VISION_TURN tokens (the 26-token
# cap twice) with the TTS on
VISION_IMAGE_HW = (1008, 1344)
VISION_FRAME_HW = (480, 640)
VISION_FRAMES = 5
VISION_TURN = 60
# tokens of the turn after the session's save and load, the TTS off: the
# cap once, every fused chunk under `no_host_sync` (the sync debug mode is
# global, so it would catch the TTS worker's own copies in a spoken turn)
VISION_SHORT = 30
VISION_PART_ITERS = 5
# the VPM's card-vs-CPU limit on one 224 x 224 part, of max|row|, between
# the sound port's largest gap and the smallest gap of a fault planted on
# the card, over seeds 0-4 (`python -m omni_tpu_torch.vision_limits`,
# NVIDIA H100 80GB HBM3, 700.00 W): sound 1.12e-6-1.30e-6, TF32 products
# 3.64e-4-4.29e-4, the sincos grid transposed 0.0655-0.0819, the bucket
# ids a row off 0.115-0.166
VISION_RTOL = 2e-5


def vision_duplex_phase(cfg, params, qts, tok, dev, qwen3, smi: str, seed: int,
                        tmp: str, spoken):
    """Vision and duplex on the Q4_K_M model beside the spoken phase's
    modules (`spoken`: its pipeline, whose APM, TTS and Token2Wav are taken
    over): the full-width VPM (26 x 1152 SigLip2, the 64 x 4096 resampler)
    written to the model directory `tmp` and loaded by omni-cli's
    `build_pipeline` with --omni --duplex. The session: the duplex system
    prompt with 1 s of reference voice; chunk 1, 1 s of audio and a
    1344 x 1008 image from the seed (7 parts, 448 image rows, prefilled
    through kernels B and D); chunk 2, five 640 x 480 frames under
    high_refresh (the main frame and a 2 x 2 stack of 1280 x 960, 10
    parts); chunk 3, audio alone; a duplex turn of VISION_TURN tokens with
    the TTS on, past the 26-token cap twice, whose end drops the oldest
    unit (the water marks set for it); the session saved, loaded into a
    fresh pipeline, one more unit and a VISION_SHORT-token turn. Fails unless one
    224 x 224 VPM part on the card agrees with the port on the CPU within
    VISION_RTOL of max|row| (`vision_limits` reads the gap over seeds and
    planted faults); no speak segment feeds more than 25 sampled tokens
    before <|chunk_eos|></unit>; after the unit window the KV positions are
    0..n_past-1, the n_keep cells hold the same bits, and the re-rotated K
    is within the f64 law (`rerotation_excess`); every duplex TTS chunk
    has at most 26 codes; every wave is finite and within +-0.99; the
    loaded session's books equal the saved ones, and its turn (the TTS
    off) runs every fused chunk under `no_host_sync` and feeds 25 tokens
    before its forced chunk end; and the launches of kernels A-D equal those of
    the LLM's forward calls (`kernel_launches`): the VPM, the APM, the TTS
    and Token2Wav launch none. Prints ms a VPM part and a sliced image, the
    LLM's image-prefill ms, ms from the end of a chunk to the first text
    and the first wave, and the peak memory, each with the card. Returns
    (launches, stats)."""
    import argparse

    import numpy as np
    import torch

    from omni_tpu_torch.cli import omni_cli
    from omni_tpu_torch.core.gguf import GGUFReader
    from omni_tpu_torch.models import siglip
    from omni_tpu_torch.omni import image as image_mod
    from omni_tpu_torch.omni import pipeline as pipeline_mod
    from omni_tpu_torch.runtime import Context, SamplerParams
    from omni_tpu_torch.testing_synth import write_vpm_gguf
    from omni_tpu_torch.vision_limits import check_inputs, encode, gap

    t_phase = time.perf_counter()
    check_sync_guard(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident_gib = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    os.makedirs(os.path.join(tmp, "vision"), exist_ok=True)
    write_vpm_gguf(os.path.join(tmp, "vision", "minicpmo-vision-vpm-f16.gguf"),
                   torch.Generator(device=dev).manual_seed(seed))
    paths = omni_cli.resolve_model_paths(os.path.join(tmp, "llm.gguf"))
    write_s = time.perf_counter() - t0
    spoken.audio_encoder.state.n_cached = 0  # a fresh audio stream
    args = argparse.Namespace(ctx_size=N_CTX, temp=0.7, no_audio=False, no_tts=False,
                              omni=True, duplex=True, max_slice_nums=9)
    rows = []

    def build():
        llm = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=N_CTX,
                      device=dev, sampler=SamplerParams(temp=0.7, seed=seed))
        forward = llm._forward

        def counted(p, c, xx, *a, **kw):
            rows.append(int(xx.shape[0]))
            return forward(p, c, xx, *a, **kw)

        llm._forward = counted
        return omni_cli.build_pipeline(paths, args, dev, llm=llm, tokenizer=tok,
                                       modules=spoken)

    t0 = time.perf_counter()
    pipe = build()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    enc = pipe.vision_encoder
    if not (pipe.cfg.duplex and enc is not None and pipe.speaking):
        raise SystemExit("vision-duplex: build_pipeline made no duplex pipeline "
                         "with the VPM and the TTS")
    llm, cache = pipe.llm, pipe.llm.cache
    vcfg = enc.cfg

    # the inputs, from the seed
    rng = np.random.default_rng(seed)
    x = np.arange(16000) / 16000
    voices = [(0.3 * np.sin(2 * np.pi * f * x) + 0.02 * rng.standard_normal(16000))
              .astype(np.float32) for f in (150, 220, 330, 260)]
    image = rng.integers(0, 256, VISION_IMAGE_HW + (3,), dtype=np.uint8)
    frames = [rng.integers(0, 256, VISION_FRAME_HW + (3,), dtype=np.uint8)
              for _ in range(VISION_FRAMES)]

    # instruments: prefill items, forced chunk ends, the fused loop's span,
    # TTS chunks, the first text and wave, the window's seq_add
    marks, items, forces, spans, tts_chunks, slides = {}, [], [], [], [], []

    def instrument(p):
        prefill_item = p._prefill_item

        def timed_item(item):
            torch.cuda.synchronize()
            t = time.perf_counter()
            prefill_item(item)
            torch.cuda.synchronize()
            parts = [q for im in item.get("image_parts") or [] for q in im]
            items.append((len(parts), sum(int(q.shape[0]) for q in parts),
                          time.perf_counter() - t))

        p._prefill_item = timed_item
        force, loop, generate = p._force_chunk_end, p._decode_loop_fused, p._tts_generate
        wait_prefill, text_put, wav_put = p._wait_prefill, p.text_out.put, p.wav_out.put

        def counted_force(lg):
            forces.append(p.llm.n_past[0])
            return force(lg)

        def spanned_loop(*a, **kw):
            start = p.llm.n_past[0]
            out = loop(*a, **kw)
            spans.append((start, p.llm.n_past[0], list(forces)))
            forces.clear()
            return out

        def counted_generate(out, first_chunk, emit=None):
            codes = generate(out, first_chunk, emit=emit)
            tts_chunks.append((len(out.token_ids), out.is_final, len(codes)))
            return codes

        def marked_wait():
            wait_prefill()
            torch.cuda.synchronize()
            marks["prefilled"] = time.perf_counter()

        def marked_text(ev):
            if ev.get("content"):
                marks.setdefault("first_text", time.perf_counter())
            text_put(ev)

        def marked_wave(w):
            marks.setdefault("first_wave", time.perf_counter())
            wav_put(w)

        p._force_chunk_end, p._decode_loop_fused = counted_force, spanned_loop
        p._tts_generate, p._wait_prefill = counted_generate, marked_wait
        p.text_out.put, p.wav_out.put = marked_text, marked_wave

    instrument(pipe)
    real_scan, synced = pipeline_mod.omni_decode_scan, [0]

    def sync_free_scan(*a, **kw):
        with no_host_sync():
            out = real_scan(*a, **kw)
        synced[0] += 1
        return out

    seq_add = llm.seq_add

    def checked_seq_add(seq_id, p0, p1, delta):
        before = [cache.read_layer(li)[0].double() for li in SESSION_CHECK_LAYERS]
        rot = cache.seq_add_delta(seq_id, p0, p1, delta)
        seq_add(seq_id, p0, p1, delta)
        slides.append(rerotation_excess(before, cache, SESSION_CHECK_LAYERS, rot,
                                        cfg.rope_base))

    llm.seq_add = checked_seq_add

    def turn(p, budget):
        p.stream_decode(round_idx=0, max_new_tokens=budget)
        text = ""
        while True:
            ev = p.text_out.get(timeout=600)
            text += ev.get("content", "")
            if ev.get("stop"):
                break
        p.wait_idle()
        waves = []
        while True:
            try:
                waves.append(p.wav_out.get_nowait())
            except queue.Empty:
                return text, waves

    reset_launches()  # the phase's main path starts here
    try:
        pipe.stream_prefill(index=0, system_prompt="You are a helpful assistant.",
                            ref_audio=voices[0])
        n_keep = pipe.n_keep
        pipe.stream_prefill(audio=voices[1], image=image, index=1)
        pipe.cfg.high_refresh = True
        pipe.stream_prefill(frames=frames, index=2)
        pipe.stream_prefill(audio=voices[2], index=3)
        pipe._wait_prefill()
        # the marks: the turn's end (at most VISION_TURN + 5 cells on) must
        # drop the oldest unit, and only it
        n_pre = llm.n_past[0]
        first = pipe.units[0]
        pipe.cfg.high_water = n_pre
        pipe.cfg.low_water = n_pre + VISION_TURN + 8 - (first.end_pos - first.start_pos)
        units_before = [(u.start_pos, u.end_pos) for u in pipe.units]
        keep_cells = torch.nonzero((cache.seq_mask != 0) & (cache.pos < n_keep))[:, 0]
        keep = [(cache.k[li][:, keep_cells].clone(), cache.v[li][:, keep_cells].clone())
                for li in SESSION_CHECK_LAYERS]
        keep_pos = cache.pos[keep_cells].clone()
        t0 = time.perf_counter()
        text, waves = turn(pipe, VISION_TURN)
        turn_s = time.perf_counter() - t0
        first_text_ms = 1e3 * (marks["first_text"] - marks["prefilled"])
        first_wave_ms = 1e3 * (marks["first_wave"] - marks["prefilled"])
        main_chunks = list(tts_chunks)
        turn_span = spans[-1]
        units_after = [(u.start_pos, u.end_pos) for u in pipe.units]
        occupied = torch.nonzero(cache.seq_mask != 0)[:, 0]
        pos = torch.sort(cache.pos[occupied]).values.cpu().numpy()
        contiguous = bool(np.array_equal(pos, np.arange(llm.n_past[0])))
        kept = torch.equal(cache.pos[keep_cells], keep_pos) and all(
            torch.equal(cache.k[li][:, keep_cells], k)
            and torch.equal(cache.v[li][:, keep_cells], v)
            for li, (k, v) in zip(SESSION_CHECK_LAYERS, keep))
        n_past_after = llm.n_past[0]
        # the session saved, loaded into a fresh pipeline; one more unit
        pipe.shutdown()
        llm.sync_cells_used()
        t0 = time.perf_counter()
        state = pipe.session_state_bytes()
        save_s = time.perf_counter() - t0
        pipe2 = build()
        instrument(pipe2)
        t0 = time.perf_counter()
        pipe2.load_session_state_bytes(state)
        torch.cuda.synchronize()
        load_state_s = time.perf_counter() - t0
        books = [(p.n_keep, dict(p.llm.n_past), [(u.start_pos, u.end_pos) for u in p.units],
                  [(r.start_pos, r.end_pos) for r in p.rounds], p.cfg.duplex)
                 for p in (pipe, pipe2)]
        pipe2.stream_prefill(audio=voices[3], index=4)
        pipe2._wait_prefill()
        units_loaded = [(u.start_pos, u.end_pos) for u in pipe2.units]
        pipe2.cfg.use_tts = False
        pipeline_mod.omni_decode_scan = sync_free_scan
        text2, _ = turn(pipe2, VISION_SHORT)
        short_span = spans[-1]
        torch.cuda.synchronize()
        launches = launch_counts()  # the phase's main path ends here
    finally:
        pipeline_mod.omni_decode_scan = real_scan
        pipe.shutdown()
        if "pipe2" in locals():
            pipe2.shutdown()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # ---- the checks ---------------------------------------------------------
    start, end, at = turn_span
    fed = [f - s for f, s in zip(at, [start] + [f + 2 for f in at[:-1]])]
    fed.append(end - (at[-1] + 2 if at else start))
    if len(at) < 2 or max(fed) > 25 or len(short_span[2]) != 1 or \
            short_span[2][0] - short_span[0] != 25:
        raise SystemExit(f"vision-duplex: the turn's speak segments fed {fed} sampled "
                         f"tokens ({len(at)} forced chunk ends; want >= 2, each "
                         f"after at most 25); the short turn's span {short_span}")
    if not (len(units_after) < len(units_before) and contiguous and kept
            and slides and max(slides) <= 1.0):
        raise SystemExit(f"vision-duplex: the unit window left units {units_after} "
                         f"of {units_before}; positions contiguous {contiguous}; "
                         f"n_keep cells intact {kept}; K vs the f64 law {slides}")
    if books[0] != books[1] or len(units_loaded) != len(books[1][2]) + 1:
        raise SystemExit(f"vision-duplex: the loaded session {books[1]}, saved "
                         f"{books[0]}; units after one more chunk {units_loaded}")
    if not main_chunks or any(c > pipeline_mod.DUPLEX_CHUNK_CAP for _, _, c in tts_chunks):
        raise SystemExit(f"vision-duplex: TTS chunks (tokens, final, codes) {tts_chunks}")
    for w in waves:
        if not np.isfinite(w).all() or np.abs(w).max() > 0.99:
            raise SystemExit(f"vision-duplex: a wave of {len(w)} samples, max |x| "
                             f"{np.abs(w).max()}")
    if not waves or not synced[0]:
        raise SystemExit(f"vision-duplex: {len(waves)} waves; {synced[0]} fused chunks "
                         "checked for host syncs")
    want_l = kernel_launches(rows, qts)
    if nonzero(launches) != want_l or not all(launches.get(k) for k in (
            "q4k_gemv", "q4k_gemm", "q6k_gemv", "qgemm")):
        raise SystemExit(f"vision-duplex: launches {nonzero(launches)}, the LLM's "
                         f"{len(rows)} forward calls make {want_l}")

    # ---- one 224 x 224 VPM part: the card against the CPU --------------------
    t0 = time.perf_counter()
    reader = GGUFReader(paths["vision"])
    cpu_params = siglip.load_params(reader, device="cpu")
    reader.close()
    inputs = check_inputs(vcfg, seed)
    vpm_gap = gap(encode(enc.params, vcfg, *inputs, dev), encode(cpu_params, vcfg,
                                                                 *inputs, "cpu"))
    cpu_s = time.perf_counter() - t0
    del cpu_params
    if not vpm_gap <= VISION_RTOL:
        raise SystemExit(f"vision-duplex: a VPM part on the card differs from the "
                         f"CPU's by {vpm_gap:.3g} of max|row| (limit {VISION_RTOL})")

    # ---- times: a VPM part, a sliced image -----------------------------------
    parts = image_mod.preprocess_uhd(image, enc.mean, enc.std)
    px = torch.from_numpy(parts[0]).to(dev)
    hp, wp = px.shape[0] // vcfg.patch_size, px.shape[1] // vcfg.patch_size
    ids = torch.from_numpy(siglip.bucket_positions(hp, wp).astype(np.int64)).to(dev)
    pe = torch.from_numpy(siglip.sincos_pos_embed_2d(vcfg.d_out, wp, hp)).to(dev)
    part_ms = cuda_ms(lambda: siglip.encode_image(enc.params, vcfg, px, ids, pe),
                      VISION_PART_ITERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc(image)
    torch.cuda.synchronize()
    image_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    image_mod.preprocess_uhd(image, enc.mean, enc.std)
    slicing_ms = 1e3 * (time.perf_counter() - t0)

    image_items = [(n, r, 1e3 * s) for n, r, s in items if n]
    stats = {
        "write_s": write_s, "load_s": load_s, "cpu_check_s": cpu_s, "turn_s": turn_s,
        "vpm_ms_per_part": part_ms, "vpm_part_patches": hp * wp,
        "vpm_ms_per_sliced_image": image_ms, "host_slicing_ms": slicing_ms,
        "image_prefill_ms": image_items, "n_keep": n_keep,
        "chunk_end_to_first_text_ms": first_text_ms,
        "chunk_end_to_first_wave_ms": first_wave_ms,
        "segments_fed": fed, "tts_chunks": tts_chunks, "waves": len(waves),
        "units_before": units_before, "units_after": units_after,
        "n_past_before_turn": n_pre, "n_past_after_window": n_past_after,
        "rerotation_excess": slides, "sync_free_chunks": synced[0],
        "state_mb": len(state) / 1e6, "save_s": save_s, "load_state_s": load_state_s,
        "vpm_card_vs_cpu": vpm_gap, "peak_gib": peak_gib, "resident_gib": resident_gib,
        "llm_forward_calls": len(rows), "text_chars": len(text) + len(text2),
        "phase_s": time.perf_counter() - t_phase}
    print(f"  vision VPM ({smi}): {part_ms:.3f} ms a part of {hp * wp} patches "
          f"({wp * vcfg.patch_size} x {hp * vcfg.patch_size}; CUDA events over "
          f"{VISION_PART_ITERS}); {image_ms:.1f} ms a sliced "
          f"{VISION_IMAGE_HW[1]} x {VISION_IMAGE_HW[0]} image of {len(parts)} parts "
          f"(wall, its host slicing {slicing_ms:.1f} ms included); card vs CPU "
          f"{vpm_gap:.3g} of max|row| on 224 x 224 (limit {VISION_RTOL})", flush=True)
    print(f"  vision prefill ({smi}): chunks with images (parts, rows, ms) "
          f"{[(n, r, round(ms, 1)) for n, r, ms in image_items]}, each with its "
          f"markers and audio rows; n_keep {n_keep}, n_past {n_pre} before the turn",
          flush=True)
    print(f"  duplex turn ({smi}): end of the chunks to the first text "
          f"{first_text_ms:.1f} ms, to the first wave {first_wave_ms:.1f} ms; speak "
          f"segments fed {fed} sampled tokens; TTS chunks (tokens, final, codes) "
          f"{tts_chunks}; {len(waves)} waves; after the load a {VISION_SHORT}-token turn "
          f"with the TTS off, {synced[0]} fused chunks with no host sync, the cap "
          f"after {short_span[2][0] - short_span[0]}; turn {turn_s:.2f} s; peak "
          f"memory {peak_gib:.3f} GiB "
          f"({resident_gib:.3f} resident at the phase's start)", flush=True)
    print(f"  duplex window ({smi}): units {units_before} -> {units_after}, n_past "
          f"{n_past_after} after; K vs f64 law {[round(v, 3) for v in slides]} of its "
          f"limit; the {len(keep_cells)} n_keep cells intact; state "
          f"{len(state) / 1e6:.1f} MB saved in {save_s:.3f} s, loaded in "
          f"{load_state_s:.3f} s, units then {units_loaded}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, stats


SERVER_CTX, SERVER_SLOTS = 2048, 8  # n_ctx and -np of the server phase
SERVER_TOKENS = 32  # tokens of each step-path request (n_probs 2, greedy)
SERVER_CONCURRENCY = (2, 4, 8)  # step-path requests sent at once
SERVER_WAVE_STEPS = 6  # the 8-request round's second wave, steps after the first
SERVER_CHAT_TOKENS = 24  # tokens of each fused-path chat
# prompt and new tokens of the request past its budget: 244 + 16 > 256, so
# the fused path shifts before its first chunk
SERVER_SHIFT = (244, 16)
SERVER_FLASH_TS = (2, 4, 8)  # kernel F at a server step's decode rows
SERVER_PROMPTS = tuple(f"Request {i}: " + s for i, s in enumerate(
    (SESSION_SYSTEM,) + SESSION_USER))[:max(SERVER_CONCURRENCY)]
SERVER_SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                                   "c": {"enum": ["a", "b"]}},
                 "required": ["ok", "c"], "additionalProperties": False}
SERVER_TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "Get the weather",
    "parameters": {"type": "object",
                   "properties": {"city": {"type": "string", "maxLength": 4}},
                   "required": ["city"], "additionalProperties": False}}}]
# A stream that parts from the same request served alone is a rounding flip
# where the teacher-forced logits at the first parting (the prompt and the
# common tokens fed through Context.decode) hold both tokens within
# SERVER_TIE_REL of max|logit| of the row's best. A mixed step sends a decode
# row through kernels B/D (or kernel F's prefill regime) where alone it went
# through A/C: two routes of one law, each within ~1.3e-3 of max|logit| of
# the f64 law on this model (F64_FACTOR's note), so up to ~2.6e-3 apart;
# with F64_FACTOR's margin, 5e-3.
SERVER_TIE_REL = 5e-3


def flip_proof(state, prompt_ids, a_toks, b_toks, what: str) -> dict:
    """The first parting of two token streams of one prompt on the server
    `state`, teacher-forced: the prompt and the common tokens through
    `Context.decode` on the scratch sequence (under the server's lock);
    both tokens must lie within SERVER_TIE_REL of max|logit| of the row's
    best, else the run fails. Returns the reading."""
    import numpy as np

    from omni_tpu_torch.runtime import Batch
    from omni_tpu_torch.server.main import SCRATCH_SEQ

    ctx = state.ctx
    i = next(j for j, (x, y) in enumerate(zip(a_toks, b_toks)) if x != y)
    ids = list(prompt_ids) + list(a_toks[:i])
    with state.sched_lock:
        lg, _ = ctx.decode(Batch(tokens=np.asarray(ids, np.int32),
                                 pos=np.arange(len(ids), dtype=np.int32),
                                 seq_id=np.full(len(ids), SCRATCH_SEQ, np.int32)))
        ctx.seq_rm(SCRATCH_SEQ, -1, -1)
        ctx.n_past.pop(SCRATCH_SEQ, None)
        row = lg[-1].float()
        best, scale = row.max().item(), row.abs().max().item()
        gaps = [best - row[x].item() for x in (a_toks[i], b_toks[i])]
    ok = max(gaps) <= SERVER_TIE_REL * scale
    print(f"  server {what}: parts from its run alone at token {i} "
          f"({a_toks[i]} vs {b_toks[i]}); teacher-forced gaps to the best "
          f"{gaps[0]:.4g}, {gaps[1]:.4g} of max|logit| {scale:.4g} (band "
          f"{SERVER_TIE_REL * scale:.4g}) {'a rounding flip' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit(f"server {what}: parts from its run alone at token "
                         f"{i}, no near tie")
    return {"at": i, "gaps": gaps, "max_logit": scale}


def server_phase(cfg, params, qts, tok, dev, qwen3, smi: str, gen, max_err):
    """The port's OpenAI-style server (`omni_tpu_torch.server.main`) on the
    Q4_K_M model: `serve(ServerState(...))` on 127.0.0.1:0 in a thread,
    n_ctx SERVER_CTX on a q8_0 pool, SERVER_SLOTS slots, driven over HTTP
    from several threads. Kernel F is first held at SERVER_FLASH_TS rows of
    different sequences (`check_flash(mixed=True)`, with its device kernels
    a call). Every launch count is set to 0 just before the requests and
    read just after. Checks:
    - batching: SERVER_PROMPTS served alone, then 2, 4 and 8 of them at
      once on the step path (n_probs 2, greedy, SERVER_TOKENS tokens): each
      stream equals its run alone, or parts at a rounding flip
      (SERVER_TIE_REL, teacher-forced); every step launches A and C (M <= 8
      rows) or B and D (more) as `kernel_for` says, and kernel F once a
      layer; ms a step and tokens/s summed over the slots by live slots;
    - the fused path: two greedy chats at once, each equal to its run alone
      (or a proven flip), interleaved by chunk;
    - an SSE chat ending with [DONE], a json_schema chat whose content
      parses against its schema, a forced tool call that returns
      tool_calls, /v1/embeddings of norm 1 +- 1e-3, /metrics, the
      vocabulary trie's build time and the host ms a constrained token;
    - /slots/0 save, erase, restore: a continuation of slot 0's sequence
      after the round trip equals the one before it;
    - /v1/stream/omni_init (text only), a prefill and a decode SSE ending
      with stop;
    - one request past its slot's budget (n_ctx / slots), which shifts the
      context.
    The server is shut down at the end with no thread of it left. Returns
    (launches, stats)."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from omni_tpu_torch.grammar import gbnf
    from omni_tpu_torch.kernels import flash_attention as fa
    from omni_tpu_torch.runtime import Batch, Context
    from omni_tpu_torch.server import main as srv

    t_phase = time.perf_counter()
    flash_calls = {}
    for t in SERVER_FLASH_TS:
        check_flash(8, t, SERVER_CTX, dev, gen, max_err, mixed=True)
        args = flash_inputs(8, t, SERVER_CTX, dev, gen, mixed=True)
        flash_calls[t] = kernels_per_call(lambda: fa.flash_decode(*args),
                                          ("flash_kernel", "merge_kernel"))
        print(f"  flash_decode T={t} (a sequence a row): "
              f"{flash_calls[t] if flash_calls[t] is not None else 'not measured'} "
              "device kernels a call", flush=True)

    flash_s = time.perf_counter() - t_phase
    threads_before = set(threading.enumerate())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slots_")
    ctx = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=SERVER_CTX,
                  device=dev, kv_dtype="q8_0")
    state = srv.ServerState(ctx, tok, n_slots=SERVER_SLOTS, slot_save_path=tmp)
    t = time.perf_counter()
    state._trie()
    trie_s = time.perf_counter() - t

    # every step: its rows, live decode rows, ms and launches; every served
    # completion: its prompt and tokens (for the teacher-forced proof)
    steps, served, rows, book = [], [], [], threading.Lock()
    orig_step, orig_decode, orig_complete = (state.sched.step, ctx.decode,
                                             state.complete)

    def decode(batch, **kw):
        rows.append(len(batch))
        return orig_decode(batch, **kw)

    def step():  # runs under sched_lock
        rows.clear()
        live = sum(s.state.name == "GENERATING" and bool(s.out_tokens)
                   for s in state.sched.slots)
        before = launch_counts()
        t = time.perf_counter()
        orig_step()
        ms = (time.perf_counter() - t) * 1e3
        after = launch_counts()
        steps.append({"rows": rows[0] if rows else 0, "live": live, "ms": ms,
                      "launches": {k: after[k] - before.get(k, 0) for k in after
                                   if after[k] != before.get(k, 0)}})

    def complete(prompt_tokens, *a, **kw):
        r = orig_complete(prompt_tokens, *a, **kw)
        with book:
            served.append((list(map(int, prompt_tokens)), list(r[0])))
        return r

    allowed_s = [0.0, 0]
    orig_allowed = gbnf.Grammar.allowed_tokens

    def allowed(self, trie):
        t = time.perf_counter()
        out = orig_allowed(self, trie)
        allowed_s[0] += time.perf_counter() - t
        allowed_s[1] += 1
        return out

    state.sched.step, ctx.decode, state.complete = step, decode, complete
    gbnf.Grammar.allowed_tokens = allowed
    httpd = srv.serve(state, "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(route, body, raw=False):
        req = urllib.request.Request(url + route, json.dumps(body).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            data = r.read()
        return data if raw else json.loads(data)

    def at_once(route, bodies, delays=None):
        """The requests from one thread each, released together (request i
        after delays[i] s)."""
        out = [None] * len(bodies)
        go = threading.Barrier(len(bodies))

        def hit(i):
            go.wait()
            time.sleep(delays[i] if delays else 0.0)
            out[i] = post(route, bodies[i])

        ts = [threading.Thread(target=hit, args=(i,)) for i in range(len(bodies))]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=600)
        if any(o is None for o in out):
            raise SystemExit("server: a concurrent request got no answer")
        return out

    stats = {"trie_s": trie_s, "flash_check_s": flash_s,
             "flash_kernels_per_call": flash_calls}
    stage_s, t_stage = {}, [time.perf_counter()]

    def stage(name):
        now = time.perf_counter()
        stage_s[name] = now - t_stage[0]
        t_stage[0] = now

    reset_launches()
    try:
        # ---- batching on the step path -----------------------------------
        body = {"n_predict": SERVER_TOKENS, "n_probs": 2, "temperature": 0.0}
        prompts = [list(map(int, tok.encode(p))) for p in SERVER_PROMPTS]
        alone = [post("/completion", {**body, "prompt": p}) for p in SERVER_PROMPTS]
        alone_ids = [[c["id"] for c in r["completion_probabilities"]] for r in alone]
        n_alone_steps = len(steps)
        flips = []
        step_ms = float(np.median([s["ms"] for s in steps if s["rows"] == 1]))
        for n in SERVER_CONCURRENCY:
            # the last round in two waves: the second half's prompts join a
            # step of the first half's decode rows (a mixed ubatch)
            delays = ([0.0] * (n // 2) + [SERVER_WAVE_STEPS * step_ms / 1e3] * (n - n // 2)
                      if n == max(SERVER_CONCURRENCY) else None)
            outs = at_once("/completion", [{**body, "prompt": p}
                                           for p in SERVER_PROMPTS[:n]], delays)
            for i, r in enumerate(outs):
                got = [c["id"] for c in r["completion_probabilities"]]
                if len(got) != SERVER_TOKENS or not all(
                        len(c["top_logprobs"]) == 2 for c in r["completion_probabilities"]):
                    raise SystemExit(f"server: request {i} of {n} gave {len(got)} "
                                     "tokens or a wrong n_probs row")
                if got != alone_ids[i]:
                    flips.append({"n": n, "request": i, **flip_proof(
                        state, prompts[i], alone_ids[i], got, f"request {i} of {n}")})
        bad = []
        for s in steps:
            want = {**{k: v for k, v in kernel_launches([s["rows"]], qts).items() if v},
                    "flash_decode": cfg.n_layers}
            if s["launches"] != want:
                bad.append((s["rows"], s["launches"], want))
        if bad:
            raise SystemExit(f"server: {len(bad)} steps launched other kernels "
                             f"than kernel_for says, e.g. {bad[0]}")
        small = [s for s in steps if s["rows"] <= 8]
        big = [s for s in steps if s["rows"] > 8]
        if not small or not big or any(
                (s["launches"].get("q4k_gemv"), s["launches"].get("q6k_gemv"))
                != (N_Q4K, N_Q6K) for s in small) or any(
                (s["launches"].get("q4k_gemm"), s["launches"].get("qgemm Q6_K"))
                != (N_Q4K, N_Q6K) for s in big):
            raise SystemExit("server: a step of <= 8 rows must launch A and C "
                             f"({N_Q4K}, {N_Q6K}), a larger one B and D")
        by_live = {}
        for s in steps:
            if s["rows"] == s["live"] and s["live"]:  # decode rows only
                by_live.setdefault(s["live"], []).append(s["ms"])
        timing = {n: {"steps": len(v), "ms_per_step": float(np.median(v)),
                      "tokens_per_s": n / (float(np.median(v)) / 1e3)}
                  for n, v in sorted(by_live.items())}
        for n in (1, 2, 4, 8):
            if n not in timing:
                raise SystemExit(f"server: no decode-only step at {n} live slots")
        prompt_steps = [s for s in steps if s["rows"] > s["live"]]
        mixed = [s for s in prompt_steps if s["live"]]
        if not mixed:
            raise SystemExit("server: no step mixed prompt rows with decode rows")
        print(f"  server batching ({smi}): {len(steps)} steps ({n_alone_steps} "
              f"alone), {len(small)} of <= 8 rows (A, C), {len(big)} of more (B, "
              f"D), {len(prompt_steps)} with prompt rows (median "
              f"{np.median([s['ms'] for s in prompt_steps]):.2f} ms, rows "
              f"{sorted({s['rows'] for s in prompt_steps})}; {len(mixed)} mixed "
              f"with decode rows: {[(s['rows'], s['live']) for s in mixed]}); "
              "decode-only steps "
              + ", ".join(f"{n} live: {v['ms_per_step']:.2f} ms a step, "
                          f"{v['tokens_per_s']:.1f} tokens/s ({v['steps']} steps)"
                          for n, v in timing.items())
              + f"; {len(flips)} streams parted at a flip", flush=True)
        stats.update(steps_by_live=timing, n_steps=len(steps),
                     mixed_steps=[(s["rows"], s["live"], s["ms"]) for s in mixed],
                     steps_small=len(small), steps_big=len(big), flips=flips)

        stage("batching")

        # ---- the fused path: two chats at once ----------------------------
        chats = [{"messages": [{"role": "user", "content": SESSION_USER[i]}],
                  "max_tokens": SERVER_CHAT_TOKENS, "temperature": 0.0}
                 for i in range(2)]
        n_steps = len(steps)
        t = time.perf_counter()
        solo = [post("/v1/chat/completions", c) for c in chats]
        solo_s = time.perf_counter() - t
        with book:
            solo_ids = [o for _, o in served[-2:]]
            solo_prompts = [p for p, _ in served[-2:]]
        t = time.perf_counter()
        both = at_once("/v1/chat/completions", chats)
        both_s = time.perf_counter() - t
        with book:
            both_ids = {tuple(p): o for p, o in served[-2:]}
        if len(steps) != n_steps:
            raise SystemExit("server: a plain chat took the step path")
        for i in range(2):
            got = both_ids[tuple(solo_prompts[i])]
            if got != solo_ids[i]:
                flips.append({"chat": i, **flip_proof(state, solo_prompts[i],
                                                       solo_ids[i], got, f"chat {i}")})
            elif both[i]["choices"][0]["message"] != solo[i]["choices"][0]["message"]:
                raise SystemExit(f"server: chat {i}'s message differs with equal tokens")
        print(f"  server fused path ({smi}): two {SERVER_CHAT_TOKENS}-token chats "
              f"alone {solo_s:.2f} s, at once {both_s:.2f} s", flush=True)
        stats.update(chats_alone_s=solo_s, chats_at_once_s=both_s)

        stage("fused")

        # ---- other routes --------------------------------------------------
        raw = post("/v1/chat/completions", {**chats[0], "max_tokens": 8,
                                            "stream": True}, raw=True)
        events = [json.loads(x[6:]) for x in raw.decode().splitlines()
                  if x.startswith("data: ") and x != "data: [DONE]"]
        if not raw.rstrip().endswith(b"data: [DONE]") or \
                events[-1]["choices"][0]["finish_reason"] != "stop":
            raise SystemExit("server: the SSE chat did not end with stop and [DONE]")
        allowed_s[:] = [0.0, 0]
        t = time.perf_counter()
        js = post("/v1/chat/completions", {
            "messages": [{"role": "user", "content": "Answer in JSON."}],
            "max_tokens": 48, "temperature": 0.0,
            "response_format": {"type": "json_schema",
                                "json_schema": {"schema": SERVER_SCHEMA}}})
        json_s = time.perf_counter() - t
        doc = json.loads(js["choices"][0]["message"]["content"])
        if set(doc) != {"ok", "c"} or not isinstance(doc["ok"], bool) or \
                doc["c"] not in ("a", "b"):
            raise SystemExit(f"server: json_schema content {doc!r} breaks its schema")
        grammar_ms = allowed_s[0] / max(allowed_s[1], 1) * 1e3
        tc = post("/v1/chat/completions", {
            "messages": [{"role": "user", "content": "What is the weather in Paris?"}],
            "tools": SERVER_TOOLS, "tool_choice": "required", "max_tokens": 64,
            "temperature": 0.0})
        choice = tc["choices"][0]
        if choice["finish_reason"] != "tool_calls" or \
                choice["message"]["tool_calls"][0]["function"]["name"] != "get_weather":
            raise SystemExit(f"server: the forced tool call gave {choice}")
        json.loads(choice["message"]["tool_calls"][0]["function"]["arguments"])
        emb = post("/v1/embeddings", {"input": ["hello world", SESSION_USER[0]]})
        norms = [float(np.linalg.norm(e["embedding"])) for e in emb["data"]]
        if any(abs(v - 1.0) > 1e-3 for v in norms) or \
                len(emb["data"][0]["embedding"]) != cfg.d_model:
            raise SystemExit(f"server: embedding norms {norms}")
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        if f"omni_tpu_kv_cells_total {SERVER_CTX}" not in metrics or \
                "omni_tpu_tokens_generated_total" not in metrics:
            raise SystemExit("server: /metrics lacks its counters")
        print(f"  server routes ({smi}): SSE chat {len(events)} events then "
              f"[DONE]; json_schema {doc} in {json_s:.2f} s, host "
              f"{grammar_ms:.3f} ms a constrained token ({allowed_s[1]} tokens), "
              f"vocabulary trie built in {trie_s:.2f} s over "
              f"{tok.vocab.n_tokens} tokens; tool call "
              f"{choice['message']['tool_calls'][0]['function']}; embedding norms "
              f"{[round(v, 6) for v in norms]}", flush=True)
        stats.update(grammar_host_ms_per_token=grammar_ms, json_schema_s=json_s,
                     embedding_norms=norms)

        stage("routes")

        # ---- slot 0 saved, erased, restored --------------------------------
        post("/completion", {"prompt": SESSION_USER[1], "n_predict": 16,
                             "temperature": 0.0})

        def continuation():
            """Four greedy tokens on slot 0's sequence after its cells,
            undone after."""
            out = []
            with state.sched_lock:
                p0 = ctx.n_past[0]
                tok_id = int(tok.encode("\n")[0])
                for j in range(4):
                    lg, _ = ctx.decode(Batch(tokens=np.asarray([tok_id], np.int32),
                                             pos=np.asarray([p0 + j], np.int32),
                                             seq_id=np.zeros(1, np.int32)))
                    tok_id = int(torch.argmax(lg[-1]))
                    out.append(tok_id)
                ctx.seq_rm(0, p0, -1)
                ctx.n_past[0] = p0
            return out

        if state.sched.slots[0].n_past == 0:
            raise SystemExit("server: slot 0 served nothing")
        with state.sched_lock:
            blob = ctx.seq_state_bytes(0)
        save = post("/slots/0?action=save", {"filename": "slot0.bin"})
        first = continuation()
        post("/slots/0?action=erase", {})
        if ctx.n_past.get(0):
            raise SystemExit("server: erase left slot 0's cells")
        restore = post("/slots/0?action=restore", {"filename": "slot0.bin"})
        again = continuation()
        with state.sched_lock:
            same_cells = ctx.seq_state_bytes(0) == blob
        if again != first or not same_cells:
            raise SystemExit(f"server: after the slot round trip {again} != {first}")
        print(f"  server slot round trip: saved {save['n_saved']} bytes, restored "
              f"{restore['n_restored']} cells; the continuation after it equals "
              f"the one before ({len(first)} tokens)", flush=True)

        stage("slot_round_trip")

        # ---- the text-only /v1/stream session ------------------------------
        post("/v1/stream/omni_init", {"media_type": 1})
        post("/v1/stream/update_session_config", {"max_new_tokens": 16})
        post("/v1/stream/prefill", {"cnt": 0, "system_prompt": SESSION_SYSTEM})
        raw = post("/v1/stream/decode", {"round_idx": 0}, raw=True)
        sse = [json.loads(x[6:]) for x in raw.decode().splitlines()
               if x.startswith("data: ") and x != "data: [DONE]"]
        if not sse or not sse[-1]["stop"] or b"data: [DONE]" not in raw:
            raise SystemExit("server: the /v1/stream decode did not end with stop")
        text = "".join(e["content"] for e in sse)
        post("/v1/stream/reset", {})
        print(f"  server /v1/stream session: {len(sse)} events, {text!r}, ended "
              "with stop", flush=True)

        stage("stream_session")

        # ---- one request past its slot's budget ----------------------------
        shifted = [s.n_shifted for s in state.sched.slots]
        words = (SESSION_SYSTEM + " ") * 40
        ids = tok.encode(words)[:SERVER_SHIFT[0]]
        long_prompt = tok.decode(ids)
        r = post("/completion", {"prompt": long_prompt, "n_predict": SERVER_SHIFT[1],
                                 "temperature": 0.0})
        moved = [s.n_shifted - b for s, b in zip(state.sched.slots, shifted)]
        if not any(moved):
            raise SystemExit(f"server: the request past its budget gave "
                             f"{r['tokens_predicted']} tokens, shifted {moved}")
        print(f"  server past the budget ({state.sched.n_ctx_slot} a slot): "
              f"{len(tok.encode(long_prompt))}-token prompt + {r['tokens_predicted']} "
              f"tokens, {sum(moved)} positions shifted out", flush=True)
        stats["shifted"] = sum(moved)
        stage("past_budget")
        stats["stage_s"] = stage_s
    finally:
        launches = launch_counts()
        gbnf.Grammar.allowed_tokens = orig_allowed
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
        if state.omni is not None:
            state.omni.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    deadline = time.perf_counter() + 30
    while set(threading.enumerate()) - threads_before and time.perf_counter() < deadline:
        time.sleep(0.05)
    left = set(threading.enumerate()) - threads_before
    if left:
        raise SystemExit(f"server: threads left after shutdown: {left}")
    stats["phase_s"] = time.perf_counter() - t_phase
    print(f"  server phase ({smi}): {stats['phase_s']:.1f} s (flash checks "
          f"{flash_s:.1f} s, trie {trie_s:.1f} s; stages "
          + ", ".join(f"{k} {v:.1f} s" for k, v in stats.get("stage_s", {}).items())
          + "), no thread left", flush=True)
    return launches, stats


def kernel_launches(rows, qts) -> dict:
    """The launches the LLM's forward calls of `rows` rows each make over
    its quantized weights `qts`, by `kernel_for` (kernel D also per
    format, as "qgemm Q6_K")."""
    from omni_tpu_torch.kernels import dequant_matmul as dm

    want = {}
    for m in rows:
        for w in qts:
            name = dm.kernel_for(m, w).__name__
            want[name] = want.get(name, 0) + 1
            if name == "qgemm":
                key = f"qgemm {w.ggml_type.name}"
                want[key] = want.get(key, 0) + 1
    return want


def teacher_forced(cfg, params, dev, dm, qwen3, prompts, against: str,
                   kv_dtype="bf16") -> dict:
    """Logits of the kernel path, the plain path and the f64 path (every
    matmul's law in f64) over each prompt of `prompts` (token arrays): a
    prefill and N_TEACHER decode steps fed the kernel path's own greedy
    tokens. Fails past the limit `against` names: "plain", every argmax
    equal to the plain path's and kernel vs plain within LOGITS_REL_TOL of
    max|logit| on every prompt; "f64", every argmax equal to the plain
    path's and the kernel path's RMS distance from the f64 path over the
    rows of all prompts within F64_FACTOR of the plain path's;
    "f64_near_tie", the same RMS ratio, an argmax that differs from the
    plain path's only on a near tie of both the plain and the f64 path (see
    F64_FACTOR), and at least MIN_HELD_ROWS rows over all prompts whose f64
    top-2 margin lies past the band, each of them held to exact agreement
    (fewer fails the check). The KV cells are `kv_dtype`; a quantized pool's attention
    is the flash kernel's plain version on the plain path and the law in f64
    on the f64 path. Returns the readings, with the rows admitted as near
    ties."""
    import torch

    from omni_tpu_torch.kernels.flash_attention import flash_decode_plain
    from omni_tpu_torch.runtime import Batch, Context, SamplerParams

    def run(tokens, forced=None):
        ctx = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=N_CTX,
                      sampler=SamplerParams(greedy=True), device=dev,
                      kv_dtype=kv_dtype)
        lg, _ = ctx.decode(Batch(tokens=tokens))
        rows, fed = [lg[-1].float()], []
        for i in range(N_TEACHER):
            tok = int(torch.argmax(rows[-1])) if forced is None else forced[i]
            fed.append(tok)
            lg, _ = ctx.decode(Batch(tokens=[tok]))
            rows.append(lg[-1].float())
        return torch.stack(rows), fed

    per, diffs, bad = [], {"kernel": [], "plain": []}, []
    for i, tokens in enumerate(prompts):
        got, fed = run(tokens)
        with matmuls_by(qwen3, dm, plain_law, flash_decode_plain):
            want, _ = run(tokens, fed)
        with matmuls_by(qwen3, dm, law_f64, flash_law_f64):
            exact, _ = run(tokens, fed)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        scale_f64 = exact.abs().max().item()
        gap = want.max(-1).values - want.gather(-1, got.argmax(-1, keepdim=True))[:, 0]
        band = F64_FACTOR * (want - exact).abs().max(-1).values
        top2 = exact.topk(2, -1).values
        margin = top2[:, 0] - top2[:, 1]
        same = got.argmax(-1) == want.argmax(-1)
        tie = (gap <= band) & (margin <= band)
        r = {"rel": err / scale,
             "argmax_agree": int(same.sum()),
             "argmax_near_tie": int((same | tie).sum()),
             "rows_past_the_band": int((margin > band).sum()),
             "near_tie_rows": [{"row": i, "plain_gap": gap[i].item(),
                                "f64_margin": margin[i].item(), "band": band[i].item()}
                               for i in torch.nonzero(~same & tie)[:, 0].tolist()],
             "argmax_agree_f64": int((got.argmax(-1) == exact.argmax(-1)).sum()),
             "max_logit": scale_f64}
        for side, a in (("kernel", got), ("plain", want)):
            d = (a - exact) / scale_f64
            diffs[side].append(d)
            r[f"{side}_vs_f64_rel"] = d.abs().max().item()
            r[f"{side}_vs_f64_rms"] = d.pow(2).mean().sqrt().item()
        per.append(r)
        print(f"  teacher-forced logits, prompt {i}, prefill + {N_TEACHER} decode "
              f"steps: kernel vs plain max|d|={err:.4g}, max|ref|={scale:.4g}, "
              f"rel {r['rel']:.3g}; argmax agrees {r['argmax_agree']}/"
              f"{N_TEACHER + 1} (with the f64 path {r['argmax_agree_f64']}; "
              f"with near ties {r['argmax_near_tie']}, admitted "
              f"{json.dumps(r['near_tie_rows'])}; f64 top-2 margin past the "
              f"band on {r['rows_past_the_band']} rows); vs "
              f"the f64 path, max|d| / max|logit| kernel "
              f"{r['kernel_vs_f64_rel']:.3g}, plain {r['plain_vs_f64_rel']:.3g}, "
              f"rms(d) / max|logit| kernel {r['kernel_vs_f64_rms']:.3g}, plain "
              f"{r['plain_vs_f64_rms']:.3g}", flush=True)
        if not torch.isfinite(got).all():
            bad.append(f"prompt {i}: logits not finite")
        agree = r["argmax_near_tie" if against == "f64_near_tie" else "argmax_agree"]
        if agree != N_TEACHER + 1:
            bad.append(f"prompt {i}: argmax agrees {agree}/{N_TEACHER + 1}"
                       + (" with near ties"
                          if against == "f64_near_tie" else ""))
        if against == "plain" and r["rel"] > LOGITS_REL_TOL:
            bad.append(f"prompt {i}: rel {r['rel']:.3g} > {LOGITS_REL_TOL}")
    rms = {side: torch.cat(d).pow(2).mean().sqrt().item() for side, d in diffs.items()}
    ratio = rms["kernel"] / max(rms["plain"], 1e-30)
    held = sum(r["rows_past_the_band"] for r in per)
    print(f"  teacher-forced logits over {len(prompts)} prompt(s): rms(d) / "
          f"max|logit| vs the f64 path, kernel {rms['kernel']:.3g}, plain "
          f"{rms['plain']:.3g}, ratio {ratio:.3g}; rows held past the band "
          f"{held} of {len(per) * (N_TEACHER + 1)}; limit: "
          + (f"rel <= {LOGITS_REL_TOL} per prompt" if against == "plain"
             else f"ratio <= {F64_FACTOR}")
          + (f", held rows >= {MIN_HELD_ROWS}" if against == "f64_near_tie" else ""),
          flush=True)
    if against != "plain" and ratio > F64_FACTOR:
        bad.append(f"rms ratio {ratio:.3g} > {F64_FACTOR}")
    if against == "f64_near_tie" and held < MIN_HELD_ROWS:
        bad.append(f"{held} rows held past the band < {MIN_HELD_ROWS}")
    if bad:
        raise SystemExit("served logits disagree with the plain path: " + "; ".join(bad))
    return {"prompts": per, "kernel_vs_f64_rms": rms["kernel"],
            "plain_vs_f64_rms": rms["plain"], "rms_ratio": ratio,
            "rows_held": held, "against": against}


def decode_step_alloc(cfg, params, dev, qwen3, rng) -> tuple[int, int]:
    """(bytes allocated at the peak of one single-token decode step above
    the allocation before it, that allocation), after a 64-token prefill
    and one warm step."""
    import torch

    from omni_tpu_torch.runtime import Batch, Context, SamplerParams

    ctx = Context(cfg, params, qwen3.forward, qwen3.embed, n_ctx=N_CTX,
                  sampler=SamplerParams(greedy=True), device=dev)
    logits, _ = ctx.decode(Batch(tokens=torch.randint(0, 1000, (N_PREFILL,),
                                                      generator=rng).numpy()))
    tok = int(torch.argmax(logits[-1]))
    logits, _ = ctx.decode(Batch(tokens=[tok]))
    tok = int(torch.argmax(logits[-1]))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logits, _ = ctx.decode(Batch(tokens=[tok]))
    torch.cuda.synchronize()
    if not torch.isfinite(logits).all():
        raise SystemExit("the measured decode step's logits are not finite")
    return torch.cuda.max_memory_allocated() - base, base


def write_and_load(cfg, recipe, dev, qwen3, tmp, seed, imatrix=False, vocab=False):
    """Write a random `recipe` Qwen3 GGUF of `cfg` (weights from `seed`;
    imatrix: llama.cpp's importance-matrix layout; vocab: the synthesised
    Qwen2 vocabulary, `testing_synth.qwen2_vocab_kv`) into directory `tmp`,
    load it back through the port's reader and `qwen3.load_params`, check
    its metadata and that the loaded planes of three tensors equal a host
    repack of their blocks. Returns (params, types, {gguf_gb, write_s,
    load_s, planes_gb}, the file's tokenizer by `build_tokenizer(reader.kv)`
    where vocab, else None)."""
    import numpy as np
    import torch

    from omni_tpu_torch.core.gguf import GGUFReader
    from omni_tpu_torch.kernels.qformats import QTensor, repack, upload
    from omni_tpu_torch.testing_synth import write_qwen3_gguf
    from omni_tpu_torch.tokenizer import build_tokenizer

    path = os.path.join(tmp, f"qwen3-8b-{recipe.lower()}.gguf")
    t0 = time.perf_counter()
    types = write_qwen3_gguf(path, cfg, recipe,
                             torch.Generator(device=dev).manual_seed(seed), imatrix,
                             vocab=vocab)
    write_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    reader = GGUFReader(path)
    cfg_file = qwen3.Qwen3Config.from_gguf(reader.kv)
    # the file holds the float fields as f32
    if cfg_file != dataclasses.replace(
            cfg, rope_base=float(np.float32(cfg.rope_base)),
            rms_eps=float(np.float32(cfg.rms_eps))):
        raise SystemExit(f"from_gguf read {cfg_file}, wrote {cfg}")
    params = qwen3.load_params(reader, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    for name, w in (("blk.0.attn_q.weight", params["layers"][0]["wq"]),
                    ("blk.0.attn_v.weight", params["layers"][0]["wv"]),
                    ("blk.0.ffn_down.weight", params["layers"][0]["w_down"])):
        ti = reader.tensors[name]
        ref = repack(upload(ti.data, "cpu"), ti.ggml_type, ti.shape)
        if w.ggml_type != ti.ggml_type or any(
                not torch.equal(p.cpu(), getattr(ref, nm))
                for nm, p in w.planes().items()):
            raise SystemExit(f"{name}: loaded planes differ from its blocks")
    tok = build_tokenizer(reader.kv) if vocab else None
    reader.close()
    qts = [w for lp in params["layers"] for w in lp.values()
           if isinstance(w, QTensor)] + [params["output"]]
    return params, qts, {"gguf_gb": size / 1e9, "write_s": write_s,
                         "load_s": load_s,
                         "planes_gb": sum(w.nbytes for w in qts) / 1e9}, tok


def synth_dense(n: int, k: int, device, gen):
    """A dense bf16 [n, k] weight of RMS 0.025 (the F16 model's scale)."""
    import torch

    return torch.randn((n, k), device=device, generator=gen).mul_(0.025).to(torch.bfloat16)


def time_kernels(name, kern, plain, weights, ms, gen, synth, rows) -> None:
    """Time kernel `name` (or `dense_matmul`), its plain version and one
    library call, torch.matmul on the weight in bf16 (pre-dequantised for a
    QTensor), at each shape and M, beside the bound of the format's bytes
    (the GGUF blocks; a dense weight's own) and of the port's planes."""
    import torch

    from omni_tpu_torch.core.dtypes import row_nbytes
    from omni_tpu_torch.kernels import dequant_matmul as dm
    from omni_tpu_torch.kernels.qformats import QTensor, dequant

    for nm, w in weights.items():
        out_dtype = torch.float32 if nm == "output" else torch.bfloat16
        n, k = w.shape
        quant = isinstance(w, QTensor)
        dev = w.q.device if quant else w.device
        fmt_bytes = n * row_nbytes(w.ggml_type, k) if quant else w.nbytes
        # enough weight copies to stream > 2x the 50 MB L2 per round, as the
        # decode path streams every layer's weights from HBM
        ws = [w] + [synth(n, k, dev, gen)
                    for _ in range(min(7, L2_FLUSH_BYTES // w.nbytes))]
        w_bf16 = [dequant(v, torch.bfloat16) for v in ws] if quant else ws
        fmt = w.ggml_type.name if quant else "dense"
        for m in ms:
            x = torch.randn((m, k), device=dev, generator=gen).to(torch.bfloat16)
            t_k = graph_ms(lambda i: kern(x, ws[i % len(ws)], out_dtype), 24)
            t_p = cuda_ms(lambda: plain(x, w, out_dtype), 3)
            t_l = graph_ms(lambda i: torch.matmul(x, w_bf16[i % len(ws)].T), 24)
            b, by = bound_ms(m, n, k, fmt_bytes, out_dtype)
            pb, _ = bound_ms(m, n, k, w.nbytes, out_dtype)
            row = {"kernel": name, "fmt": fmt, "shape": nm,
                   "n": n, "k": k, "m": m,
                   "ms": t_k, "plain_ms": t_p, "library_ms": t_l,
                   "bound_ms": b, "bound_by": by, "planes_bound_ms": pb}
            plan = ""
            if name == "qgemm" or name in dm.HALVES_GEMM.values():
                row.update(gemm_plan(m, n, k, w.ggml_type))
                plan = (f"; {row['splits']} splits, {row['units']} work units on "
                        f"{row['blocks']} blocks")
            elif name in dm.MMA_GEMV.values():
                p = dm.gemv_plan(m, n, k, w.ggml_type)
                row.update(splits=p.splits, blocks=p.blocks(n))
                plan = f"; {p.splits} split, {p.blocks(n)} blocks"
            rows.append(row)
            print(f"  {name} {fmt} {nm} {n}x{k} M={m}: {t_k:.4f} ms, plain "
                  f"{t_p:.4f}, torch.matmul(bf16) {t_l:.4f}, bound {b:.4f} "
                  f"({by}), {b / t_k:.1%} of bound; the planes' bound "
                  f"{pb:.4f}, {pb / t_k:.1%}{plan}", flush=True)
        del ws, w_bf16


def gemm_plan(m: int, n: int, k: int, qtype) -> dict:
    """Kernel B's or D's split plan for an [m, k] x [n, k] call: the split
    count (dequant_matmul.gemm_splits), the work units (64 x 64 tiles x
    splits) and the blocks of its persistent grid (one per SM at most)."""
    import torch

    from omni_tpu_torch.kernels import dequant_matmul as dm

    splits = dm.gemm_splits(m, n, k, qtype)
    units = dm.gemm_units(m, n) * splits
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"splits": splits, "units": units, "blocks": min(units, sms)}


def check_gemm_splits(dev, gen, max_err) -> None:
    """Kernel B's six entries and kernel D's thirteen against their plain
    versions (check_kernel: the agreement limit and the flip share under
    flip_limit) at GEMM_SPLIT_SHAPES, M = 64, with the split count forced
    to each of GEMM_FORCED_SPLITS; at each, a repeat launch on the same
    inputs must give the same bits (the partials are summed in a fixed
    order, with no atomics)."""
    import torch

    from omni_tpu_torch.core.dtypes import GGMLType
    from omni_tpu_torch.kernels import dequant_matmul as dm
    from omni_tpu_torch.testing_synth import synth_quant

    cases = ([(dm.HALVES_GEMM[t], t) for t in dm.HALVES_GEMM]
             + [("qgemm", t) for t in dm._QGEMM_ENTRY])
    for name, fmt in cases:
        kern, plain = getattr(dm, name), getattr(dm, name + "_plain")
        for nm in GEMM_SPLIT_SHAPES:
            n, k = UNFUSED_SHAPES[nm]
            qt = synth_quant(GGMLType(fmt), n, k, dev, gen)
            x = torch.randn((N_PREFILL, k), device=dev, generator=gen).to(torch.bfloat16)
            for forced in GEMM_FORCED_SPLITS:
                with mock.patch.object(dm, "gemm_splits", return_value=forced):
                    print(f"  forced to {forced} splits:", end="", flush=True)
                    check_kernel(name, kern, plain, qt, nm, N_PREFILL, torch.bfloat16,
                                 gen, max_err)
                    first, again = kern(x, qt), kern(x, qt)
                torch.cuda.synchronize()
                if not torch.equal(first.view(torch.int16), again.view(torch.int16)):
                    raise SystemExit(f"{name} {fmt.name} at {nm} with {forced} splits: a "
                                     "repeat launch gave other bits")
            del qt


def kernels_per_call(fn, names: tuple[str, ...]):
    """How many kernels whose name holds one of `names` the card ran for one
    call of fn(), from torch.profiler's CUDA activity; None where the
    profiler saw no device activity at all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen = [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as exc:  # the profiler is a reading aid, not a check
        print(f"  kernels_per_call: profiler failed ({exc})", flush=True)
        return None
    return sum(any(k in n for k in names) for n in seen) if seen else None


def time_flash(rows, dev, gen) -> None:
    """Time kernel F for each cell type at each FLASH_TIMES shape, in a CUDA
    graph over copies of the planes that stream more than twice the L2 per
    round (as a decode step streams every layer's cells from HBM), beside
    its plain version, the library yardstick (SDPA on K/V pre-dequantised to
    bf16 with the same boolean mask; the port never calls it) and its bound:
    the bytes of cells, scales, q (bf16), out (f32) and mask, each once,
    over HBM bandwidth vs 4·T·Hq·S·D operations over the bf16 tensor-core
    peak. Each row also carries the regime and split of the call and the
    kernel F launches the card ran for one call (torch.profiler)."""
    import torch
    import torch.nn.functional as F

    from omni_tpu_torch.kernels import flash_attention as fa
    from omni_tpu_torch.runtime.kv_cache import dequant4

    hq, hkv, d = FLASH_HEADS
    for bits, cells in ((16, "bf16"), (8, "int8"), (4, "int4")):
        name = "flash_decode4" if bits == 4 else "flash_decode"
        for t, s in FLASH_TIMES:
            q, k, v, mask, ks, vs = flash_inputs(bits, t, s, dev, gen)
            planes = [x for x in (k, v, ks, vs) if x is not None]
            nbytes = sum(x.nbytes for x in planes)
            pool = [(k, v, ks, vs)] + [
                tuple(None if x is None else x.clone() for x in (k, v, ks, vs))
                for _ in range(min(127, L2_FLUSH_BYTES // nbytes))]

            def bf16_cells(x, sc):
                if bits == 16:
                    return x
                if bits == 4:
                    return dequant4(x, sc)
                return x.to(torch.bfloat16) * sc[..., None].to(torch.bfloat16)

            lib = [(bf16_cells(a, c)[None], bf16_cells(b, e)[None]) for a, b, c, e in pool]
            q4 = q.to(torch.bfloat16).transpose(0, 1)[None]
            m4 = mask[None, None]
            iters = max(24, len(pool))
            t_k = graph_ms(lambda i: fa.flash_decode(q, *pool[i % len(pool)][:2], mask,
                                                     *pool[i % len(pool)][2:]), iters)
            t_p = cuda_ms(lambda: fa.flash_decode_plain(q, k, v, mask, ks, vs), 3)
            t_l = graph_ms(lambda i: F.scaled_dot_product_attention(
                q4, *lib[i % len(lib)], attn_mask=m4, enable_gqa=True), iters)
            # kernel F's own launches (csrc/flash_decode.cu: flash_kernel,
            # and merge_kernel at prefill with splits)
            per_call = kernels_per_call(lambda: fa.flash_decode(q, k, v, mask, ks, vs),
                                        ("flash_kernel", "merge_kernel"))
            io = nbytes + t * hq * d * (2 + 4) + t * s
            t_bytes = io / HBM_BYTES_PER_S * 1e3
            t_ops = 4.0 * t * hq * s * d / BF16_TENSOR_OPS_PER_S * 1e3
            b, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            plan = fa.split_plan(t * hq // hkv, hkv, s)
            rows.append({"kernel": name, "cells": cells, "t": t, "s": s, "ms": t_k,
                         "plain_ms": t_p, "library_ms": t_l, "bound_ms": b,
                         "bound_by": by, "regime": plan.regime,
                         "split": [plan.per_split, plan.nsplit],
                         "launches_per_call": per_call})
            print(f"  {name} {cells} T={t} S={s} ({plan.regime}, {plan.nsplit} splits, "
                  f"{'not measured' if per_call is None else per_call} launches a call): "
                  f"{t_k:.4f} ms, plain {t_p:.4f}, "
                  f"SDPA(bf16) {t_l:.4f}, bound {b:.4f} ({by}), {b / t_k:.1%} of "
                  f"bound; x {N_LAYERS} layers {t_k * N_LAYERS:.3f} ms", flush=True)
            del pool, lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prompts", type=int, default=N_PROMPTS_Q4KM,
                    help="prompts of each f64-law teacher-forced check (each "
                         "64 random tokens; the first ones are the default run's)")
    ap.add_argument("--near-tie-prompts", type=int, default=N_PROMPTS_NEAR_TIE,
                    help="prompts of each f64_near_tie teacher-forced check")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the models' random weights")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from omni_tpu_torch.core.dtypes import GGMLType
    from omni_tpu_torch.kernels import _build
    from omni_tpu_torch.kernels import dequant_matmul as dm
    from omni_tpu_torch.models import qwen3
    from omni_tpu_torch.testing_synth import (QWEN3_8B, synth_q4k, synth_q5k,
                                              synth_q6k, synth_q8_0, synth_quant,
                                              synth_qwen3_dense_params,
                                              synth_qwen3_params)

    torch.backends.cuda.matmul.allow_tf32 = False  # plain f32 dots stay f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = QWEN3_8B
    if cfg.n_layers != N_LAYERS:
        raise SystemExit(f"expected {N_LAYERS} layers, got {cfg.n_layers}")

    # ---- environment -------------------------------------------------------
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    try:  # the dense dot's f32-output overload (aten::bmm.dtype, CUDA only)
        probe = torch.ones((1, 2, 8), dtype=torch.bfloat16, device=dev)
        if torch.bmm(probe, probe.mT, out_dtype=torch.float32).dtype != torch.float32:
            raise RuntimeError("wrong output dtype")
    except (TypeError, RuntimeError) as e:
        raise SystemExit(f"torch {torch.__version__} lacks torch.bmm(..., "
                         f"out_dtype=torch.float32) on the card: {e}")
    phase("environment", t0, f"torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {kind!r} count "
          f"{torch.cuda.device_count()} nvidia-smi {smi!r}")

    # ---- build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    phase("build", t0, f"nvcc {', '.join(_build.SOURCES)} -> {_build.build_dir()}")

    # ---- kernels vs their plain versions at the paths' shapes --------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(1)
    weights = {nm: synth_q4k(n, k, dev, gen) for nm, (n, k) in SHAPES.items()}
    q6_weights = {nm: synth_q6k(n, k, dev, gen) for nm, (n, k) in Q6_SHAPES.items()}
    q8_weights = {nm: synth_q8_0(n, k, dev, gen) for nm, (n, k) in UNFUSED_SHAPES.items()}
    q5_weights = {nm: synth_q5k(n, k, dev, gen) for nm, (n, k) in Q5_SHAPES.items()}
    max_err = {name: 0.0 for name in KERNELS}
    q4_unfused = {nm: synth_q4k(n, k, dev, gen)
                  for nm, (n, k) in Q4_UNFUSED_SHAPES.items()}
    for group, cases in (
            ({**weights, **q4_unfused},
             (("q4k_gemv", GEMV_MS), ("q4k_gemm", GEMM_MS))),
            (q6_weights, (("q6k_gemv", GEMV_MS), ("qgemm", QGEMM_MS))),
            ({"odd_k": synth_q4k(*ODD_K_SHAPE, dev, gen)}, (("qgemm", (1, 64)),)),
            (q5_weights, (("q5k_gemv", GEMV_MS), ("q5k_gemm", GEMM_MS))),
            ({"odd_k": synth_q5k(*ODD_K_SHAPE, dev, gen)}, (("qgemm", (1, 64)),)),
            (q8_weights, (("q8_0_gemv", GEMV_MS), ("qgemm", QGEMM_MS))),
            ({"odd_k": synth_q8_0(*ODD_K_Q8_SHAPE, dev, gen)}, (("qgemm", (1, 64)),))):
        for nm, qt in group.items():
            out_dtype = torch.float32 if nm == "output" else torch.bfloat16
            for name, ms in cases:
                check_cases(name, qt, nm, ms, out_dtype, gen, max_err)
    gemv_weights = {**weights, "wk": q4_unfused["wk"]}  # kernel A's times at N = 1024 too
    del q4_unfused
    # kernel A's and B's legacy branches at every unfused shape (the head's
    # too, though these files' head is Q6_K); the layer shapes are kept
    # for the times
    legacy_weights = {}
    for fmt in (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1):
        for nm, (n, k) in UNFUSED_SHAPES.items():
            qt = synth_quant(fmt, n, k, dev, gen)
            out_dtype = torch.float32 if nm == "output" else torch.bfloat16
            cases = [(dm.HALVES_GEMV[fmt], GEMV_MS), (dm.HALVES_GEMM[fmt], GEMM_MS)]
            if nm != "output":  # D's legacy branch (the switched routes)
                cases.append(("qgemm", LEGACY_QGEMM_MS))
            for name, ms in cases:
                check_cases(name, qt, nm, ms, out_dtype, gen, max_err)
            if nm != "output":
                legacy_weights.setdefault(fmt, {})[nm] = qt
            del qt
    # kernel E's codebook entries (at M = 1..8, repeat launch and graph
    # replay) and kernel D's codebook branches at every layer shape of the
    # codebook files (kept for the times), and D at a K of whole 32-blocks
    # but no whole 256 (IQ4_NL and MXFP4)
    codebook_weights = {}
    for recipe in CODEBOOK_RECIPES:
        fmt = GGMLType[recipe]
        codebook_weights[fmt] = {nm: synth_quant(fmt, n, k, dev, gen)
                                 for nm, (n, k) in CODEBOOK_SHAPES.items()}
        cases = ((dm.CODEBOOK_GEMV[fmt], GEMV_MS), ("qgemm", GEMM_MS))
        if fmt != GGMLType.IQ4_XS:
            codebook_weights[fmt]["odd_k"] = synth_quant(fmt, *ODD_K_CODEBOOK_SHAPE,
                                                         dev, gen)
        for nm, qt in codebook_weights[fmt].items():
            for name, ms in (cases if nm != "odd_k" else (("qgemm", (1, N_PREFILL)),)):
                check_cases(name, qt, nm, ms, torch.bfloat16, gen, max_err)
        codebook_weights[fmt].pop("odd_k", None)
    # kernel H (at M = 1..8, repeat launch and graph replay) and kernel D's
    # Q2_K and Q3_K branches at every layer shape of the low-bit files (kept
    # for the times), D also at M = 256 for down and at a K of whole
    # superblocks but no multiple of 2048 (gp refuses it)
    lowbit_weights = {}
    for recipe in LOWBIT_RECIPES:
        fmt = GGMLType[recipe]
        lowbit_weights[fmt] = {nm: synth_quant(fmt, n, k, dev, gen)
                               for nm, (n, k) in LOWBIT_SHAPES.items()}
        lowbit_weights[fmt]["odd_k"] = synth_quant(fmt, *ODD_K_SHAPE, dev, gen)
        for nm, qt in lowbit_weights[fmt].items():
            cases = ((dm.LOWBIT_GEMV[fmt], GEMV_MS),
                     ("qgemm", (N_PREFILL, 256) if nm == "down" else (N_PREFILL,)))
            for name, ms in (cases if nm != "odd_k" else (("qgemm", (1, N_PREFILL)),)):
                check_cases(name, qt, nm, ms, torch.bfloat16, gen, max_err)
        lowbit_weights[fmt].pop("odd_k")
    # the dense dot (cuBLAS, K split) at the F16 path's shapes, against the
    # widened-f32 product
    dense_weights = {nm: synth_dense(n, k, dev, gen)
                     for nm, (n, k) in UNFUSED_SHAPES.items()}
    for nm, w in dense_weights.items():
        for m in (1, N_PREFILL):
            check_kernel("dense_matmul", dm.dense_matmul, dm.dense_matmul_plain, w,
                         nm, m, torch.float32 if nm == "output" else torch.bfloat16,
                         gen, max_err)
    # the fused wqkv (N = 6144) of the Q8_0 and Q4_0 files served fused:
    # kernel E and D's Q8_0 branch, kernel A's and B's Q4_0 branches
    for fmt, cases in ((GGMLType.Q8_0, (("q8_0_gemv", GEMV_MS), ("qgemm", QGEMM_MS))),
                       (GGMLType.Q4_0, (("q4_0_gemv", GEMV_MS), ("q4_0_gemm", GEMM_MS)))):
        qt = synth_quant(fmt, *WQKV_SHAPE, dev, gen)
        for name, ms in cases:
            check_cases(name, qt, "wqkv", ms, torch.bfloat16, gen, max_err)
        del qt
    phase("kernels-vs-plain", t0, json.dumps(max_err))

    # ---- kernels B and D at forced split counts, repeat launches ----------
    t0 = time.perf_counter()
    check_gemm_splits(dev, gen, max_err)
    torch.cuda.empty_cache()
    phase("gemm-splits", t0, f"{len(dm.HALVES_GEMM) + len(dm.qgemm_launches)} entries x "
          f"{GEMM_SPLIT_SHAPES} x splits {GEMM_FORCED_SPLITS}: each against its plain "
          "version, a repeat launch bit-identical")

    # ---- kernel I (the fused FFN) at Qwen3-8B's FFN shape, every pair -------
    t0 = time.perf_counter()
    d_ff, d_model = SHAPES["down"][1], SHAPES["down"][0]
    qffn_rows = []
    eye = identity_q8_0(d_ff, dev)  # h itself, for every gate/up format
    for t_gu, t_dn in QFFN_PAIRS:
        gu = synth_quant(GGMLType[t_gu], 2 * d_ff, d_model, dev, gen)
        dn = synth_quant(GGMLType[t_dn], d_model, d_ff, dev, gen)
        if t_gu == t_dn:
            check_qffn(gu, eye, N_PREFILL, "silu", gen, max_err, rows=N_PREFILL)
        for m in QFFN_MS:
            check_qffn(gu, dn, m, "silu", gen, max_err)
        if (t_gu, t_dn) in (("Q4_K", "Q6_K"), ("Q8_0", "Q8_0")):
            check_qffn(gu, dn, 8, "gelu_tanh", gen, max_err)
        # per decode token (M = 1) and per 64-token ubatch
        time_qffn({f"{t_gu}/{t_dn}": (gu, dn)}, (1, N_PREFILL), gen, qffn_rows)
        del gu, dn
    del eye
    torch.cuda.empty_cache()
    phase("qffn-vs-plain", t0, json.dumps({k: v for k, v in max_err.items()
                                          if k.startswith("qffn")}))
    t0 = time.perf_counter()
    for bits in (16, 8, 4):
        for t in FLASH_TS:
            for s in FLASH_SS:
                check_flash(bits, t, s, dev, gen, max_err)
    phase("flash-vs-plain", t0, json.dumps({k: max_err[k] for k in KV_TURNS.values()}))

    paths, launches_by_path = {}, {}
    zero = dict.fromkeys(launch_counts(), 0)

    def tf_prompts(rng, against):
        """The teacher-forced prompts of a model held to `against`: 64
        random tokens each, N_PROMPTS_NEAR_TIE of them under "f64_near_tie"
        (the first ones those of the default f64 run)."""
        n = args.near_tie_prompts if against == "f64_near_tie" else args.prompts
        return [torch.randint(0, 1000, (N_PREFILL,), generator=rng).numpy()
                for _ in range(n)]

    def finish(path, label, launches, stats, tf, t_start):
        launches_by_path[path] = launches
        paths[path] = {**stats, "teacher_forced": tf}
        torch.cuda.empty_cache()
        phase(label, t_start, json.dumps({"launches": nonzero(launches), **stats,
                                          "teacher_forced": tf}))

    def fused_ffn_turn(path, label, params, want_step, want_ubatch, against, n_prompts,
                       model_cfg=None):
        """The model (of `model_cfg`, Qwen3-8B by default) served once more
        with the fused FFN switched on (qwen3.FUSED_FFN, the JAX package's
        OMNI_FUSED_FFN=1): every layer's gated FFN one launch of kernel I."""
        mcfg = model_cfg or cfg
        t0 = time.perf_counter()
        saved = qwen3.FUSED_FFN
        qwen3.FUSED_FFN = True
        try:
            rng = torch.Generator().manual_seed(0)
            launches, stats = serve_turn(f"{label}, fused FFN", mcfg, params, dev, qwen3,
                                         want_step, want_ubatch, rng)
            prompts = [torch.randint(0, 1000, (N_PREFILL,), generator=rng).numpy()
                       for _ in range(n_prompts)]
            tf = teacher_forced(mcfg, params, dev, dm, qwen3, prompts, against)
        finally:
            qwen3.FUSED_FFN = saved
        finish(path, f"served-turn-{path.replace('_', '-')}", launches, stats, tf, t0)

    def fuse_in_place(params):
        """`fuse_layer` on each layer of loaded (unfused) params in turn, so
        that each layer's unfused weights are freed as it is fused."""
        t0 = time.perf_counter()
        layers = params["layers"]
        for i in range(len(layers)):
            layers[i] = qwen3.fuse_layer(layers[i])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        phase("fuse", t0, f"{len(layers)} layers, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")

    def ffn_launches(pairs: dict) -> dict:
        """Kernel I's launches of one step or ubatch: `pairs` per pair."""
        return {"qffn": sum(pairs.values()), **{f"qffn {p}": n for p, n in pairs.items()}}

    # ---- path 1: all-Q4_K Qwen3-8B, fused (kernels A and B) ----------------
    t0 = time.perf_counter()
    params = synth_qwen3_params(cfg, dev,
                                torch.Generator(device=dev).manual_seed(args.seed),
                                fuse=True)
    torch.cuda.synchronize()
    phase("synthesise", t0, f"Qwen3-8B Q4_K {cfg.n_layers} layers d_model "
          f"{cfg.d_model} d_ff {cfg.d_ff} vocab {cfg.n_vocab}, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    t0 = time.perf_counter()
    per_step = 4 * cfg.n_layers + 1
    rng = torch.Generator().manual_seed(0)
    launches, stats = serve_turn(
        "all-Q4_K fused", cfg, params, dev, qwen3,
        {**zero, "q4k_gemv": per_step}, {**zero, "q4k_gemm": per_step}, rng)
    tf = teacher_forced(cfg, params, dev, dm, qwen3,
                        [torch.randint(0, 1000, (N_PREFILL,), generator=rng).numpy()],
                        "plain")
    finish("all_q4k_fused", "served-turn", launches, stats, tf, t0)
    # the same model with the fused FFN: A and B take wqkv, wo and the head
    per_step = 2 * cfg.n_layers + 1
    ffn = ffn_launches({"Q4_K/Q4_K": cfg.n_layers})
    fused_ffn_turn("all_q4k_fused_ffn", "all-Q4_K fused", params,
                   {**zero, "q4k_gemv": per_step, **ffn},
                   {**zero, "q4k_gemm": per_step, **ffn}, "plain", 1)
    del params

    # ---- path 2: Q4_K_M Qwen3-8B from a GGUF file (kernels A, B, C, D) -----
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        params, qts, io, tok = write_and_load(cfg, "Q4_K_M", dev, qwen3, tmp,
                                             args.seed, vocab=True)
    n_q6 = sum(w.ggml_type == GGMLType.Q6_K for w in qts)
    n_q4 = sum(w.ggml_type == GGMLType.Q4_K for w in qts)
    if (n_q6, n_q4) != (N_Q6K, N_Q4K):
        raise SystemExit(f"{n_q6} Q6_K and {n_q4} Q4_K weights, want "
                         f"{N_Q6K} and {N_Q4K}")
    phase("gguf-q4km", t0, f"{json.dumps(io)}; {n_q4} Q4_K + {n_q6} Q6_K "
          f"weights, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    t0 = time.perf_counter()
    want_step = {**zero, "q4k_gemv": N_Q4K, "q6k_gemv": N_Q6K}
    want_ubatch = {**zero, "q4k_gemm": N_Q4K, "qgemm": N_Q6K, "qgemm Q6_K": N_Q6K}
    rng = torch.Generator().manual_seed(0)
    launches, stats = serve_turn("Q4_K_M from GGUF", cfg, params, dev,
                                 qwen3, want_step, want_ubatch, rng)
    prompts = [torch.randint(0, 1000, (N_PREFILL,), generator=rng).numpy()
               for _ in range(args.prompts)]
    tf = teacher_forced(cfg, params, dev, dm, qwen3, prompts, "f64")
    finish("q4_k_m_gguf", "served-turn-q4km", launches, {**stats, **io}, tf, t0)

    # ---- the same model, quantized KV cache (kernel F) ---------------------
    for kv, flash in KV_TURNS.items():
        t0 = time.perf_counter()
        rng = torch.Generator().manual_seed(0)
        launches, stats = serve_turn(
            f"Q4_K_M from GGUF, {kv} KV", cfg, params, dev, qwen3,
            {**want_step, flash: cfg.n_layers}, {**want_ubatch, flash: cfg.n_layers},
            rng, kv_dtype=kv)
        prompts = [torch.randint(0, 1000, (N_PREFILL,), generator=rng).numpy()
                   for _ in range(args.prompts)]
        tf = teacher_forced(cfg, params, dev, dm, qwen3, prompts, "f64", kv_dtype=kv)
        finish(f"q4_k_m_gguf_kv_{kv}", f"served-turn-q4km-kv-{kv}", launches,
               stats, tf, t0)

    # ---- the same model: a ChatML session past its round window ------------
    t0 = time.perf_counter()
    launches, stats = session_phase(cfg, params, tok, dev, qwen3, smi)
    finish("q4_k_m_session", "session", launches, stats, None, t0)

    # ---- the same model: the server and its slots --------------------------
    t0 = time.perf_counter()
    launches, stats = server_phase(cfg, params, qts, tok, dev, qwen3, smi, gen, max_err)
    finish("q4_k_m_server", "server", launches, stats, None, t0)

    # ---- the same model: a spoken round (APM, TTS, Token2Wav) --------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_omni_") as omni_dir:
        launches, stats, spoken = spoken_phase(cfg, params, qts, tok, dev, qwen3, smi,
                                               args.seed, omni_dir)
        finish("q4_k_m_spoken", "spoken-round", launches, stats, None, t0)

        # ---- the same model and modules: vision and duplex (the VPM) -------
        t0 = time.perf_counter()
        launches, stats = vision_duplex_phase(cfg, params, qts, tok, dev, qwen3, smi,
                                              args.seed, omni_dir, spoken)
        finish("q4_k_m_vision_duplex", "vision-duplex", launches, stats, None, t0)
        del spoken
    del params, qts, tok

    # ---- path 3: Q5_K_M Qwen3-8B from a GGUF file (G, B's Q5_K branch, C,
    # D), at CUT_LAYERS
    cut_cfg = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        params, qts, io, _ = write_and_load(cut_cfg, "Q5_K_M", dev, qwen3, tmp,
                                            args.seed)
    n_q6 = sum(w.ggml_type == GGMLType.Q6_K for w in qts)
    n_q5 = sum(w.ggml_type == GGMLType.Q5_K for w in qts)
    if (n_q6, n_q5) != (N_Q6K_CUT, N_Q5K_CUT):
        raise SystemExit(f"{n_q6} Q6_K and {n_q5} Q5_K weights, want "
                         f"{N_Q6K_CUT} and {N_Q5K_CUT}")
    phase("gguf-q5km", t0, f"{json.dumps(io)}; {n_q5} Q5_K + {n_q6} Q6_K "
          f"weights, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    t0 = time.perf_counter()
    rng = torch.Generator().manual_seed(0)
    launches, stats = serve_turn("Q5_K_M from GGUF", cut_cfg, params, dev, qwen3,
                                 {**zero, "q5k_gemv": N_Q5K_CUT, "q6k_gemv": N_Q6K_CUT},
                                 {**zero, "q5k_gemm": N_Q5K_CUT, "qgemm": N_Q6K_CUT,
                                  "qgemm Q6_K": N_Q6K_CUT}, rng)
    prompts = [torch.randint(0, 1000, (N_PREFILL,), generator=rng).numpy()
               for _ in range(args.prompts)]
    tf = teacher_forced(cut_cfg, params, dev, dm, qwen3, prompts, "f64")
    del params, qts
    finish("q5_k_m_gguf", "served-turn-q5km", launches, {**stats, **io}, tf, t0)

    # ---- path 4: Q4_0 and Q5_0 Qwen3-8B from GGUF files, importance-matrix
    # layout (kernel A's and B's legacy branches, C, D), at CUT_LAYERS -------
    for recipe, with_min in LEGACY_RECIPES.items():
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            params, qts, io, _ = write_and_load(cut_cfg, recipe, dev, qwen3, tmp,
                                                args.seed, imatrix=True)
        fmt, fmt_min = GGMLType[recipe], GGMLType[with_min]
        counts = [sum(w.ggml_type == t for w in qts)
                  for t in (fmt, fmt_min, GGMLType.Q6_K)]
        if counts != [N_LEGACY_CUT, N_LEGACY_MIN_CUT, 1]:
            raise SystemExit(f"{counts} {recipe}, {with_min} and Q6_K weights, want "
                             f"{[N_LEGACY_CUT, N_LEGACY_MIN_CUT, 1]}")
        phase(f"gguf-{recipe.lower()}", t0,
              f"{json.dumps(io)}; {N_LEGACY_CUT} {recipe} + {N_LEGACY_MIN_CUT} {with_min} "
              f"+ 1 Q6_K weights, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
              "on the card")
        t0 = time.perf_counter()
        rng = torch.Generator().manual_seed(0)
        launches, stats = serve_turn(
            f"{recipe} (importance-matrix layout) from GGUF", cut_cfg, params, dev,
            qwen3,
            {**zero, dm.HALVES_GEMV[fmt]: N_LEGACY_CUT,
             dm.HALVES_GEMV[fmt_min]: N_LEGACY_MIN_CUT, "q6k_gemv": 1},
            {**zero, dm.HALVES_GEMM[fmt]: N_LEGACY_CUT,
             dm.HALVES_GEMM[fmt_min]: N_LEGACY_MIN_CUT, "qgemm": 1, "qgemm Q6_K": 1},
            rng)
        tf = teacher_forced(cut_cfg, params, dev, dm, qwen3, tf_prompts(rng, "f64"),
                            "f64")
        finish(f"{recipe.lower()}_imatrix_gguf", f"served-turn-{recipe.lower()}",
               launches, {**stats, **io}, tf, t0)
        if recipe == SWITCHED_RECIPE:
            # the same model with the dispatcher's gp and sh routes off
            # (OMNI_GP_DECODE=0, OMNI_SH_PREFILL=0): every matmul, decode
            # and prefill, through kernel D's legacy and Q6_K branches
            t0 = time.perf_counter()
            saved = dm.GP_DECODE, dm.SH_PREFILL
            dm.GP_DECODE = dm.SH_PREFILL = False
            try:
                want = {**zero, "qgemm": N_UNFUSED, f"qgemm {recipe}": N_LEGACY_CUT,
                        f"qgemm {with_min}": N_LEGACY_MIN_CUT, "qgemm Q6_K": 1}
                rng = torch.Generator().manual_seed(0)
                launches, stats = serve_turn(
                    f"{recipe} (importance-matrix layout), gp and sh routes off",
                    cut_cfg, params, dev, qwen3, want, want, rng)
                tf = teacher_forced(cut_cfg, params, dev, dm, qwen3,
                                    tf_prompts(rng, "f64"), "f64")
            finally:
                dm.GP_DECODE, dm.SH_PREFILL = saved
            finish(f"{recipe.lower()}_imatrix_gguf_switched",
                   f"served-turn-{recipe.lower()}-switched", launches, stats, tf, t0)
            # the same model fused (wqkv, gate+up) with the fused FFN: A's
            # and B's Q4_0 branches take wqkv and wo, C and D the head,
            # kernel I every FFN (Q4_0/Q4_1 where ffn_down is Q4_1)
            del qts
            fuse_in_place(params)
            ffn = ffn_launches({f"{recipe}/{recipe}": CUT_LAYERS - N_LEGACY_MIN_CUT,
                                f"{recipe}/{with_min}": N_LEGACY_MIN_CUT})
            fused_ffn_turn(f"{recipe.lower()}_imatrix_gguf_fused_ffn",
                           f"{recipe} (importance-matrix layout)", params,
                           {**zero, dm.HALVES_GEMV[fmt]: 2 * CUT_LAYERS,
                            "q6k_gemv": 1, **ffn},
                           {**zero, dm.HALVES_GEMM[fmt]: 2 * CUT_LAYERS, "qgemm": 1,
                            "qgemm Q6_K": 1, **ffn}, "f64", args.prompts, cut_cfg)
            del params
            continue
        del params, qts

    # ---- path 5: Q8_0 Qwen3-8B from a GGUF file (kernels E and D), at
    # CUT_LAYERS ---------------------------------------------------------------
    q8_cfg = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        free = shutil.disk_usage(tmp).free
        if free < Q8_0_FILE_BYTES:
            raise SystemExit(f"the Q8_0 Qwen3-8B GGUF needs {Q8_0_FILE_BYTES / 1e9:.1f} "
                             f"GB free in {tempfile.gettempdir()} ($TMPDIR); it has "
                             f"{free / 1e9:.2f} GB")
        params, qts, io, _ = write_and_load(q8_cfg, "Q8_0", dev, qwen3, tmp, args.seed)
    if len(qts) != N_Q8_0 or any(w.ggml_type != GGMLType.Q8_0 for w in qts):
        raise SystemExit(f"want {N_Q8_0} Q8_0 weights, got "
                         f"{sorted(str(w.ggml_type.name) for w in qts)[:4]}...")
    phase("gguf-q8_0", t0, f"{json.dumps(io)}; {len(qts)} Q8_0 weights, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    t0 = time.perf_counter()
    rng = torch.Generator().manual_seed(0)
    launches, stats = serve_turn("Q8_0 from GGUF", q8_cfg, params, dev, qwen3,
                                 {**zero, "q8_0_gemv": N_Q8_0},
                                 {**zero, "qgemm": N_Q8_0, "qgemm Q8_0": N_Q8_0}, rng)
    tf = teacher_forced(q8_cfg, params, dev, dm, qwen3, tf_prompts(rng, "f64_near_tie"),
                        "f64_near_tie")
    del qts
    finish("q8_0_gguf", "served-turn-q8_0", launches, {**stats, **io}, tf, t0)
    # the same model fused with the fused FFN: E and D take wqkv, wo and the
    # Q8_0 head, kernel I every FFN
    fuse_in_place(params)
    per_step = 2 * q8_cfg.n_layers + 1
    ffn = ffn_launches({"Q8_0/Q8_0": q8_cfg.n_layers})
    fused_ffn_turn("q8_0_gguf_fused_ffn", "Q8_0", params,
                   {**zero, "q8_0_gemv": per_step, **ffn},
                   {**zero, "qgemm": per_step, "qgemm Q8_0": per_step, **ffn},
                   "f64_near_tie", args.near_tie_prompts, q8_cfg)
    del params

    # ---- path 6: IQ4_NL, IQ4_XS and MXFP4 Qwen3-8B from GGUF files (kernel
    # E's codebook entries, D's codebook branches, C, D) ---------------------
    cb_cfg = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    for recipe in CODEBOOK_RECIPES:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            params, qts, io, _ = write_and_load(cb_cfg, recipe, dev, qwen3, tmp, args.seed)
        fmt = GGMLType[recipe]
        counts = [sum(w.ggml_type == t for w in qts) for t in (fmt, GGMLType.Q6_K)]
        if counts != [N_CUT, 1] or len(qts) != N_CUT + 1:
            raise SystemExit(f"{counts} {recipe} and Q6_K weights of {len(qts)}, "
                             f"want {[N_CUT, 1]} of {N_CUT + 1}")
        phase(f"gguf-{recipe.lower()}", t0,
              f"{json.dumps(io)}; {N_CUT} {recipe} + 1 Q6_K weights, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
        layer_qts = [w for w in qts if w.ggml_type == fmt]
        io["layer_planes_gb"] = sum(w.nbytes for w in layer_qts) / 1e9
        # the same weights as int8 value planes (the JAX package's layout)
        io["int8_value_planes_gb"] = sum(
            w.q.numel() * 2 + sum(p.nbytes for nm, p in w.planes().items() if nm != "q")
            for w in layer_qts) / 1e9
        print(f"  {recipe} planes: the {len(layer_qts)} layer weights "
              f"{io['layer_planes_gb']:.3f} GB of nibble-index planes and scales "
              f"(as int8 value planes {io['int8_value_planes_gb']:.3f} GB); all "
              f"{len(qts)} quantized weights {io['planes_gb']:.3f} GB", flush=True)
        del layer_qts
        t0 = time.perf_counter()
        rng = torch.Generator().manual_seed(0)
        launches, stats = serve_turn(
            f"{recipe} from GGUF", cb_cfg, params, dev, qwen3,
            {**zero, dm.CODEBOOK_GEMV[fmt]: N_CUT, "q6k_gemv": 1},
            {**zero, "qgemm": N_CUT + 1, f"qgemm {recipe}": N_CUT,
             "qgemm Q6_K": 1}, rng)
        tf = teacher_forced(cb_cfg, params, dev, dm, qwen3,
                            tf_prompts(rng, CODEBOOK_AGAINST[recipe]),
                            CODEBOOK_AGAINST[recipe])
        del params, qts
        finish(f"{recipe.lower()}_gguf", f"served-turn-{recipe.lower()}", launches,
               {**stats, **io}, tf, t0)

    # ---- path 7: Q2_K and Q3_K Qwen3-8B from GGUF files at CUT_LAYERS
    # (kernel H, D's low-bit branches, C, D) ----------------------------------
    lb_cfg = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    for recipe in LOWBIT_RECIPES:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            params, qts, io, _ = write_and_load(lb_cfg, recipe, dev, qwen3, tmp, args.seed)
        fmt = GGMLType[recipe]
        counts = [sum(w.ggml_type == t for w in qts) for t in (fmt, GGMLType.Q6_K)]
        if counts != [N_CUT, 1] or len(qts) != N_CUT + 1:
            raise SystemExit(f"{counts} {recipe} and Q6_K weights of {len(qts)}, "
                             f"want {[N_CUT, 1]} of {N_CUT + 1}")
        phase(f"gguf-{recipe.lower()}", t0,
              f"{json.dumps(io)}; {N_CUT} {recipe} + 1 Q6_K weights, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
        t0 = time.perf_counter()
        rng = torch.Generator().manual_seed(0)
        launches, stats = serve_turn(
            f"{recipe} from GGUF", lb_cfg, params, dev, qwen3,
            {**zero, dm.LOWBIT_GEMV[fmt]: N_CUT, "q6k_gemv": 1},
            {**zero, "qgemm": N_CUT + 1, f"qgemm {recipe}": N_CUT,
             "qgemm Q6_K": 1}, rng)
        tf = teacher_forced(lb_cfg, params, dev, dm, qwen3,
                            tf_prompts(rng, LOWBIT_AGAINST[recipe]),
                            LOWBIT_AGAINST[recipe])
        del params, qts
        finish(f"{recipe.lower()}_gguf", f"served-turn-{recipe.lower()}", launches,
               {**stats, **io}, tf, t0)

    # ---- path 8: F16 Qwen3-8B, dense bf16 weights (no hand kernel) -------
    f16_cfg = cfg
    t0 = time.perf_counter()
    params = synth_qwen3_dense_params(
        f16_cfg, dev, torch.Generator(device=dev).manual_seed(args.seed))
    torch.cuda.synchronize()
    dense_gb = sum(w.numel() * w.element_size() for lp in params["layers"]
                   for w in lp.values() if w.dim() == 2) / 1e9 + \
        params["output"].numel() * 2 / 1e9
    phase("synthesise-f16", t0, f"dense bf16 weights {dense_gb:.3f} GB per token, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    t0 = time.perf_counter()
    rng = torch.Generator().manual_seed(0)
    launches, stats = serve_turn("F16 dense", f16_cfg, params, dev, qwen3,
                                 zero, zero, rng)
    step_alloc, step_base = decode_step_alloc(f16_cfg, params, dev, qwen3, rng)
    print(f"  F16 decode step: peak allocation {step_alloc / 1e6:.3f} MB above "
          f"the {step_base / 2**30:.2f} GiB before it (limit "
          f"{DECODE_STEP_ALLOC_LIMIT / 1e6:.0f} MB)", flush=True)
    if step_alloc >= DECODE_STEP_ALLOC_LIMIT:
        raise SystemExit(f"an F16 decode step allocates {step_alloc / 1e6:.1f} MB "
                         f"above its start, limit {DECODE_STEP_ALLOC_LIMIT / 1e6:.0f}")
    tf = teacher_forced(f16_cfg, params, dev, dm, qwen3,
                        tf_prompts(rng, "f64_near_tie"), "f64_near_tie")
    del params
    finish("f16_dense", "served-turn-f16", launches,
           {**stats, "decode_step_alloc_mb": step_alloc / 1e6,
            "dense_weight_gb": dense_gb}, tf, t0)
    launches = {k: sum(lp.get(k, 0) for lp in launches_by_path.values())
                for k in set(zero).union(*launches_by_path.values())}
    if min(launches[k] for k in KERNELS) <= 0:
        raise SystemExit(f"a kernel was never launched on the main paths: {launches}")

    # ---- times at the paths' shapes ----------------------------------------
    t0 = time.perf_counter()
    rows = []
    time_kernels("q4k_gemv", dm.q4k_gemv, dm.q4k_gemv_plain, gemv_weights,
                 MMA_GEMV_TIMES, gen, synth_q4k, rows)
    del gemv_weights
    time_kernels("q4k_gemm", dm.q4k_gemm, dm.q4k_gemm_plain, weights, GEMM_MS,
                 gen, synth_q4k, rows)
    time_kernels("q6k_gemv", dm.q6k_gemv, dm.q6k_gemv_plain, q6_weights,
                 MMA_GEMV_TIMES, gen, synth_q6k, rows)
    time_kernels("qgemm", dm.qgemm, dm.qgemm_plain, q6_weights, QGEMM_MS,
                 gen, synth_q6k, rows)
    time_kernels("q5k_gemv", dm.q5k_gemv, dm.q5k_gemv_plain, q5_weights,
                 MMA_GEMV_TIMES, gen, synth_q5k, rows)
    time_kernels("q5k_gemm", dm.q5k_gemm, dm.q5k_gemm_plain, q5_weights, GEMM_MS,
                 gen, synth_q5k, rows)
    time_kernels("qgemm", dm.qgemm, dm.qgemm_plain, q5_weights, (N_PREFILL,),
                 gen, synth_q5k, rows)
    time_kernels("q8_0_gemv", dm.q8_0_gemv, dm.q8_0_gemv_plain, q8_weights, GEMV_MS,
                 gen, synth_q8_0, rows)
    time_kernels("qgemm", dm.qgemm, dm.qgemm_plain, q8_weights, QGEMM_MS,
                 gen, synth_q8_0, rows)
    for fmt, ws in legacy_weights.items():
        synth = functools.partial(synth_quant, fmt)
        for table, ms in ((dm.HALVES_GEMV, MMA_GEMV_TIMES), (dm.HALVES_GEMM, GEMM_MS)):
            name = table[fmt]
            time_kernels(name, getattr(dm, name), getattr(dm, name + "_plain"), ws,
                         ms, gen, synth, rows)
        time_kernels("qgemm", dm.qgemm, dm.qgemm_plain, ws, (N_PREFILL,), gen,
                     synth, rows)
    for fmt, ws in lowbit_weights.items():
        synth = functools.partial(synth_quant, fmt)
        name = dm.LOWBIT_GEMV[fmt]
        time_kernels(name, getattr(dm, name), getattr(dm, name + "_plain"), ws,
                     MMA_GEMV_TIMES, gen, synth, rows)
        time_kernels("qgemm", dm.qgemm, dm.qgemm_plain, ws, (N_PREFILL,), gen,
                     synth, rows)
    for fmt, ws in codebook_weights.items():
        synth = functools.partial(synth_quant, fmt)
        name = dm.CODEBOOK_GEMV[fmt]
        time_kernels(name, getattr(dm, name), getattr(dm, name + "_plain"), ws,
                     MMA_GEMV_TIMES, gen, synth, rows)
        time_kernels("qgemm", dm.qgemm, dm.qgemm_plain, ws, (N_PREFILL,), gen,
                     synth, rows)
    del (weights, q6_weights, q8_weights, q5_weights, legacy_weights, codebook_weights,
         lowbit_weights)
    torch.cuda.empty_cache()
    time_kernels("dense_matmul", dm.dense_matmul, dm.dense_matmul_plain,
                 dense_weights, (1, N_PREFILL), gen, synth_dense, rows)
    del dense_weights
    torch.cuda.empty_cache()
    time_flash(rows, dev, gen)
    phase("times", t0)

    # per kernel, the sum over the calls of one served token (M=1) or one
    # 64-token prefill ubatch (M=64): A and B over the all-Q4_K path's
    # fused calls, C and D over the Q6_K calls of the Q4_K_M path, G, B's
    # and D's Q5_K branches over the Q5_K_M path's 216 Q5_K calls, E and
    # D's Q8_0 branch over the Q8_0 path's 253 calls
    q4k_calls = {"wqkv": cfg.n_layers, "wo": cfg.n_layers,
                 "gateup": cfg.n_layers, "down": cfg.n_layers, "output": 1}
    q6k_calls = {"wv": N_Q6K // 2, "down": N_Q6K // 2, "output": 1}
    q4k_work = "36 layers x (wqkv, wo, gateup, down) + output"
    q6k_work = ("M={m} (C) or M=64 (D): 18 x (wv, down) + output of Q4_K_M "
                "Qwen3-8B")
    q8_work = ("M=1 (E) or M=64 (D): 36 x (wq, wk, wv, wo, gate, up, down) + "
               "output of Q8_0 Qwen3-8B")
    q5_work = ("the 216 Q5_K weights of Q5_K_M Qwen3-8B: 36 x (wq, wk, wo, gate, "
               "up) + 18 x (wv, down)")
    legacy_work = {
        f: (f"the {N_LEGACY} {f} weights of {f} Qwen3-8B (importance-matrix "
            "layout): 36 x (wq, wk, wv, wo, gate, up) + 32 x down")
        for f in LEGACY_RECIPES}
    legacy_work.update({
        f: (f"the {N_LEGACY_MIN} {f} weights of {r} Qwen3-8B (importance-matrix "
            "layout): the down of layers 0-3") for r, f in LEGACY_RECIPES.items()})
    codebook_work = {
        f: (f"M={{m}}, the {7 * N_LAYERS} {f} weights of {f} Qwen3-8B: 36 x (wq, wk, "
            "wv, wo, gate, up, down)") for f in CODEBOOK_RECIPES}
    codebook_rows = [(dm.CODEBOOK_GEMV[GGMLType[f]], f, 1, CODEBOOK_CALLS,
                      codebook_work[f].format(m=1)) for f in CODEBOOK_RECIPES]
    lowbit_work = {
        f: (f"M={{m}}, the {7 * N_LAYERS} {f} weights of {f} Qwen3-8B: 36 x (wq, wk, "
            "wv, wo, gate, up, down)") for f in LOWBIT_RECIPES}
    lowbit_rows = [(dm.LOWBIT_GEMV[GGMLType[f]], f, 1, LOWBIT_CALLS,
                    lowbit_work[f].format(m=1)) for f in LOWBIT_RECIPES]
    legacy_rows = [
        (table[GGMLType[f]], f, m,
         LEGACY_CALLS if f in LEGACY_RECIPES else LEGACY_MIN_CALLS,
         f"M={m}, {legacy_work[f]}")
        for f in ("Q4_0", "Q4_1", "Q5_0", "Q5_1")
        for table, m in ((dm.HALVES_GEMV, 1), (dm.HALVES_GEMM, N_PREFILL))]

    def summed(name, fmt, m, calls):
        sel = [r for r in rows if r["kernel"] == name and r.get("m") == m
               and r.get("fmt") == fmt and r["shape"] in calls]
        tot = {key: sum(r[key] * calls[r["shape"]] for r in sel)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                           "planes_bound_ms")}
        by = {"bytes": 0.0, "operations": 0.0}
        for r in sel:
            by[r["bound_by"]] += r["bound_ms"] * calls[r["shape"]]
        return {**tot, "bound_by": max(by, key=by.get)}

    entries = []
    for name, fmt, m, calls, work in (
            ("q4k_gemv", "Q4_K", 1, q4k_calls, f"M=1, {q4k_work}"),
            ("q4k_gemm", "Q4_K", 64, q4k_calls, f"M=64, {q4k_work}"),
            ("q5k_gemv", "Q5_K", 1, Q5_CALLS, f"M=1, {q5_work}"),
            ("q5k_gemm", "Q5_K", 64, Q5_CALLS, f"M=64, {q5_work}"),
            ("q6k_gemv", "Q6_K", 1, q6k_calls, q6k_work.format(m=1)),
            ("qgemm", "Q6_K", 64, q6k_calls, q6k_work.format(m=1)),
            ("q8_0_gemv", "Q8_0", 1, UNFUSED_CALLS, q8_work), *legacy_rows,
            *codebook_rows, *lowbit_rows):
        tot = summed(name, fmt, m, calls)
        entry = {"name": name, **KERNELS[name], "launches": launches[name],
                 "launches_by_path": {p: lp[name] for p, lp in launches_by_path.items()},
                 "max_abs_err": max_err[name], "ms": tot["ms"],
                 "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                 "bound_by": tot["bound_by"], "library_ms": tot["library_ms"],
                 "planes_bound_ms": tot["planes_bound_ms"], "work": work}
        # the mma.sync GEMVs outside kernel A: the same calls at M = 8
        if name in dm.CODEBOOK_GEMV.values():
            entry["m8"] = {**summed(name, fmt, 8, calls),
                           "work": codebook_work[fmt].format(m=8)}
        elif name in dm.LOWBIT_GEMV.values():
            entry["m8"] = {**summed(name, fmt, 8, calls),
                           "work": lowbit_work[fmt].format(m=8)}
        elif name == "q6k_gemv":
            entry["m8"] = {**summed(name, fmt, 8, calls), "work": q6k_work.format(m=8)}
        if name == "qgemm":
            entry["launches_by_format"] = {
                f: launches[f"qgemm {f}"] for f in dm.qgemm_launches}
            # the codebook branches: every prefill weight of their files
            for f in CODEBOOK_RECIPES:
                entry[f.lower()] = {**KERNELS["qgemm"],
                                    **summed("qgemm", f, N_PREFILL, CODEBOOK_CALLS),
                                    "launches": launches[f"qgemm {f}"],
                                    "max_abs_err": max_err[f"qgemm {f}"],
                                    "work": codebook_work[f].format(m=N_PREFILL)}
            # the low-bit branches: every prefill weight of their files
            for f in LOWBIT_RECIPES:
                entry[f.lower()] = {**KERNELS["qgemm"],
                                    **summed("qgemm", f, N_PREFILL, LOWBIT_CALLS),
                                    "launches": launches[f"qgemm {f}"],
                                    "max_abs_err": max_err[f"qgemm {f}"],
                                    "work": lowbit_work[f].format(m=N_PREFILL)}
            # the legacy branches: the switched turn's prefill (Q4_0, Q4_1)
            # and the same calls of a Q5_0 file (Q5_0, Q5_1)
            for f in ("Q4_0", "Q4_1", "Q5_0", "Q5_1"):
                minor = f not in LEGACY_RECIPES
                entry[f.lower()] = {
                    **KERNELS["qgemm"],
                    **summed("qgemm", f, N_PREFILL,
                             LEGACY_MIN_CALLS if minor else LEGACY_CALLS),
                    "launches": launches[f"qgemm {f}"],
                    "max_abs_err": max_err[f"qgemm {f}"],
                    "work": f"M={N_PREFILL}, {legacy_work[f]} (routes switched off)"}
            entry["q8_0"] = {**summed("qgemm", "Q8_0", 64, UNFUSED_CALLS),
                             "launches": launches["qgemm Q8_0"],
                             "max_abs_err": max_err["qgemm Q8_0"], "work": q8_work}
            # the Q5_K branch serves Q5_K weights whose K is no multiple of
            # 2048 (held at ODD_K_SHAPE); Qwen3-8B has none, so the main
            # paths count no launch of it: its time is that of its law on
            # the Q5_K_M path's 216 calls, beside q5k_gemm's
            entry["q5_k"] = {**KERNELS["qgemm"], "launches": launches["qgemm Q5_K"],
                             **summed("qgemm", "Q5_K", 64, Q5_CALLS),
                             "max_abs_err": max_err["qgemm Q5_K"],
                             "work": f"M=64, {q5_work}"}
        entries.append(entry)
    # kernel F per decode token (T = 1 over the served turns' kv bucket) and
    # per 64-token ubatch (over the whole pool), x 36 layers
    def flash(cells, t, s):
        r = next(r for r in rows if r.get("cells") == cells and (r["t"], r["s"]) == (t, s))
        return {**{key: r[key] * N_LAYERS for key in ("ms", "plain_ms", "library_ms",
                                                       "bound_ms")},
                "bound_by": r["bound_by"]}

    flash_work = (f"{N_LAYERS} layers x (T=1 over {KV_BUCKET} cells) per decode "
                  f"token; per_ubatch: {N_LAYERS} x (T={N_PREFILL} over the "
                  f"{N_CTX}-cell pool)")
    for name, cells in (("flash_decode", "int8"), ("flash_decode4", "int4")):
        entry = {"name": name, **KERNELS[name], "launches": launches[name],
                 "launches_by_path": {p: lp[name] for p, lp in launches_by_path.items()},
                 "max_abs_err": max_err[name], **flash(cells, 1, KV_BUCKET),
                 "work": f"{cells} cells: {flash_work}",
                 "per_ubatch": flash(cells, N_PREFILL, N_CTX),
                 "per_call": [r for r in rows if r.get("cells") == cells]}
        if name == "flash_decode":
            entry["bf16"] = {**flash("bf16", 1, KV_BUCKET),
                             "per_ubatch": flash("bf16", N_PREFILL, N_CTX),
                             "per_call": [r for r in rows if r.get("cells") == "bf16"]}
        entries.append(entry)
    # kernel I per decode token and per 64-token ubatch: the 36 calls of a
    # Qwen3-8B step at M = 1 or M = 64, for every pair; the headline is the
    # all-Q4_K model's Q4_K/Q4_K
    def qffn_sum(pair, m):
        r = next(r for r in qffn_rows if r["pair"] == pair and r["m"] == m)
        return {**{key: r[key] * N_LAYERS for key in (
            "ms", "plain_ms", "library_ms", "composition_ms", "bound_ms",
            "planes_bound_ms", "gated_ms", "down_ms")}, "bound_by": r["bound_by"],
                "regime": r["regime"], "splits": r["splits"]}

    qffn_work = (f"{N_LAYERS} calls per decode token (M=1; per_ubatch: M={N_PREFILL}) "
                 f"of Qwen3-8B's FFN: gate/up {2 * d_ff}x{d_model}, down {d_model}x{d_ff}; "
                 "library: torch.matmul on weights pre-dequantised to bf16; composition: "
                 "the port's unfused matmul, SiLU, matmul")
    main_pair = "Q4_K/Q4_K"
    entries.append({
        "name": "qffn", **KERNELS["qffn"], "launches": launches["qffn"],
        "launches_by_path": {p: lp.get("qffn", 0) for p, lp in launches_by_path.items()},
        "launches_by_pair": {k[5:]: v for k, v in launches.items()
                             if k.startswith("qffn ") and v},
        "max_abs_err": max_err["qffn"], **qffn_sum(main_pair, 1),
        "per_ubatch": qffn_sum(main_pair, N_PREFILL), "pair": main_pair,
        "work": qffn_work,
        "pairs": {f"{g}/{d}": {"per_token": qffn_sum(f"{g}/{d}", 1),
                               "per_ubatch": qffn_sum(f"{g}/{d}", N_PREFILL),
                               "max_abs_err": max_err[f"qffn {g}/{d}"]}
                  for g, d in QFFN_PAIRS}})
    dense = {f"per_{unit}": {**summed("dense_matmul", "dense", m, UNFUSED_CALLS),
                             "work": f"M={m}: the 253 dense dots of a 36-layer "
                                     "F16 Qwen3-8B step"}
             for unit, m in (("token", 1), ("ubatch", N_PREFILL))}

    print(json.dumps({"paths": paths, "dense_matmul": dense}), flush=True)
    print(f"chip_smoke total {time.perf_counter() - T_START:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
