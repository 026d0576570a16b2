// qgemm: out[m, n] = sum_k bf16(x)[m, k] * bf16(dequant(W))[n, k], any M,
// W in any of the thirteen formats the JAX package keeps quantized (Q4_K,
// Q5_K, Q6_K, Q8_0, Q2_K, Q3_K, Q4_0, Q4_1, Q5_0, Q5_1, IQ4_NL, IQ4_XS,
// MXFP4) — the generic fused dequant x matmul.
//
// Replaces omni_tpu/kernels/dequant_matmul.py::qmatmul_pallas (:103, body
// _make_kernel :55-76, law qformats.dequant_tile :289-360) for all of them.
// On a Q4_K_M or Q5_K_M checkpoint it runs the prefill (M > 8) of the Q6_K
// tensors (attn_v and ffn_down on the promoted layers, the output head),
// and every Q4_K or Q5_K weight whose K is not a multiple of 2048, at any
// M. On a Q8_0, Q2_K, Q3_K, IQ4_NL, IQ4_XS or MXFP4 checkpoint it runs the
// prefill of every weight (neither Q2_K nor Q3_K is a halves-packed format
// that kernel B takes), any Q8_0, IQ4_NL or MXFP4 weight whose K is not a
// multiple of 256 and any Q2_K, Q3_K or IQ4_XS one whose K is not a
// multiple of 2048, at any M. The legacy formats reach it only with one of
// the dispatcher's switches off (OMNI_GP_DECODE, OMNI_GP_SMALLM,
// OMNI_SH_PREFILL).
//
// The law is the TPU kernel's: each weight element is dequantised in f32
// and rounded once to bf16, then multiplied against bf16 x with f32
// accumulation:
// - Q4_K: w = bf16(q * dl - ml), the UNCENTERED law of dequant_tile (not
//   kernel B's centered one: the two round differently), dl = d * sc and
//   ml = dm * mn per 32-group;
// - Q5_K: the same with q = nibble + 16 * bit (0..31), the bit from the
//   plane qh u8 [N, K/8] (decoded by kquant.cuh);
// - Q6_K: w = bf16((q - 32) * dl), dl = d * sc per 16-group;
// - Q8_0: w = bf16(q * d), d per 32-group;
// - IQ4_NL and MXFP4: w = bf16(v * d), v the codebook value of the nibble
//   index in the q plane (codebook.cuh: an exact integer of at most 7
//   bits), d per 32-group (MXFP4's d = 2^(e - 128) may be subnormal, and the
//   default build keeps subnormals: no -ftz, no fast math);
// - IQ4_XS: w = bf16(v * dl), dl = d * sc per 32-group formed first in f32
//   (d per 256, sc the int8 sub-scale), in dequant_tile's order (d holds an
//   f16's 11 significant bits, v and sc 7 and 6: both f32 products are
//   exact, and the cast to bf16 is the one rounding);
// - Q2_K: w = bf16(q * dl - ml), q in 0..3 from the quarter plane, dl =
//   d * sc and ml = dm * mn per 16-group;
// - Q3_K: w = bf16(q * dl), q = quarter + 4 * hbit - 4 in -4..3, dl =
//   d * sc per 16-group (sc signed 6-bit). For both, d and dm hold an
//   f16's 11 significant bits and sc, mn at most 6, so dl and ml are exact
//   in f32, and so is q * dl (q needs at most 3 bits): the one rounding of
//   a Q3_K weight is the cast to bf16, and a Q2_K weight's f32 difference
//   is the correctly rounded q * dl - ml, so a contracted multiply-add
//   would round it the same way;
// - Q4_0 and Q5_0: w = bf16((q - 8) * d) and bf16((q - 16) * d), q the
//   nibble (plus 16 x the high bit), d per 32; Q4_1 and Q5_1: w =
//   bf16(q * d + m), m the added min per 32. This is dequant_tile's law,
//   not kernel B's centered one (bf16((q - t) * d) with t = -m / d, the
//   rest folded through the sums of x), which rounds otherwise.
// The products, sums and differences are rounded one at a time (__fmul_rn,
// __fadd_rn, __fsub_rn: no fused multiply-add), so the bf16 weights equal
// the plain version's bit for bit.
//
// Bound on the H100: at prefill M (64..512) the bf16 tensor-core work per
// weight byte nears the card's ~295 operations per byte; at M = 1 it is
// bytes. The kernel runs on the pipelined mainloop that it shares with
// kernel B (qmma.cuh: split K over a persistent grid, two producer warp
// groups staging a three-slot ring, one consumer warp group on ldmatrix +
// mma.sync, f32 partials summed in split order). D's own part is the
// staging: per K step of 256 elements (one superblock; for Q8_0, IQ4_NL
// and MXFP4, eight 32-blocks, the last step ragged where K % 256 != 0, its
// missing chunks staged as zeros in x and w; for the legacy formats eight
// 32-blocks of the halves plane) a producer group dequantises the weight
// tile [64, 256] by its format's chunk type in qstage.cuh (one per kind
// of plane: halves, quarters, codebook nibbles, int8 values and Q6_K's),
// whose weight formula kernel I shares, staged on prefill and in registers
// at decode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmma.cuh"

namespace {

using namespace qstage;

template <int QT>
int launch(const void* x, Planes p, void* out, void* ws, int m, int n, int k, int splits,
           int out_f32, void* stream) {
  constexpr int granule = qstage::granule(QT);  // K multiple of the planes
  const bool needs_qh = QT == kQ5K || QT == kQ5_0 || QT == kQ5_1 || QT == kQ3K;
  const bool needs_sc = QT == kIQ4XS || QT == kQ2K || QT == kQ3K;
  const bool needs_min = QT == kQ2K || QT == kQ4_1 || QT == kQ5_1;  // dm (and Q2_K's mn)
  if (m < 1 || n < 1 || k < granule || k % granule != 0 ||
      (m + qmma::BM - 1) / qmma::BM > 65535 || (needs_qh && p.qh == nullptr) ||
      (needs_sc && p.sc == nullptr) || (needs_min && p.dm == nullptr) ||
      (QT == kQ2K && p.mn == nullptr))
    return (int)cudaErrorInvalidValue;
  return qmma::launch<false>(static_cast<const __nv_bfloat16*>(x), out,
                             static_cast<float*>(ws), m, n, k, splits, out_f32,
                             qmma::FormatStage<QT>{p, n, k}, static_cast<cudaStream_t>(stream));
}

}  // namespace

// One entry point per format, each with the signature of kernel B's; the
// planes a format lacks are unused (Q4_K: qh; Q6_K: mn, dm, qh; Q8_0,
// IQ4_NL, MXFP4: all but q and d; IQ4_XS: mn, dm, qh; Q2_K: qh; Q3_K: mn,
// dm; the legacy formats: sc, mn, and dm for Q4_0/Q5_0, qh for Q4_0/Q4_1).
// ws: the split partials, qmma::workspace_floats(false, m, n, k, splits)
// f32, null for one split; splits in 1..ceil(k/256)
// (dequant_matmul.gemm_splits). Each returns the first CUDA error of the
// attribute call or the launches (0 = launched).
#define QGEMM_ENTRY(NAME, QT)                                                        \
  extern "C" int NAME(const void* x, const void* q, const void* sc, const void* mn,   \
                      const void* d, const void* dm, const void* qh, void* out,       \
                      void* ws, int m, int n, int k, int splits, int out_f32,          \
                      void* stream) {                                                  \
    const Planes p{q, static_cast<const int8_t*>(sc), static_cast<const int8_t*>(mn),  \
                   static_cast<const float*>(d), static_cast<const float*>(dm),       \
                   static_cast<const uint8_t*>(qh)};                                   \
    return launch<QT>(x, p, out, ws, m, n, k, splits, out_f32, stream);               \
  }

QGEMM_ENTRY(qgemm_q4k, kQ4K)
QGEMM_ENTRY(qgemm_q5k, kQ5K)
QGEMM_ENTRY(qgemm_q6k, kQ6K)
QGEMM_ENTRY(qgemm_q8_0, kQ8_0)
QGEMM_ENTRY(qgemm_iq4_nl, kIQ4NL)
QGEMM_ENTRY(qgemm_iq4_xs, kIQ4XS)
QGEMM_ENTRY(qgemm_mxfp4, kMXFP4)
QGEMM_ENTRY(qgemm_q2k, kQ2K)
QGEMM_ENTRY(qgemm_q3k, kQ3K)
QGEMM_ENTRY(qgemm_q4_0, kQ4_0)
QGEMM_ENTRY(qgemm_q4_1, kQ4_1)
QGEMM_ENTRY(qgemm_q5_0, kQ5_0)
QGEMM_ENTRY(qgemm_q5_1, kQ5_1)
