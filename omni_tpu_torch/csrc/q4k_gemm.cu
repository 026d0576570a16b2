// q4k_gemm (kernel B) and its branches q5k_gemm, q4_0_gemm, q4_1_gemm,
// q5_0_gemm and q5_1_gemm: out[m, n] = sum_k x[m, k] * W[n, k] for M > 8,
// W in Q4_K, Q5_K, Q4_0, Q4_1, Q5_0 or Q5_1.
//
// Replaces omni_tpu/kernels/dequant_matmul.py::qmatmul_splith_pallas (:565)
// for all six of its formats (`_SH_QTYPES`) — the prefill matmul of every
// layer and of the output head. Q5_K, Q5_0 and Q5_1 are the TPU kernel's
// `five_bit` case: each half's value gains 16 x its high bit
// (`_sh_qh_halves` :466-477) before the centered law, the high-bit plane qh
// u8 [N, K/8] decoded with the chunk of q it goes with by kquant.cuh. The
// legacy formats keep the K-quants' q and qh planes with one scale d (and
// Q4_1/Q5_1's added min m, in dm) per 32-element group, f32 [N, K/32]:
// their group law is dl = d with ml = 8d, 16d or -m (kquant.cuh), and
// t = ml / dl below is then `_sh_scales`'s: 8 and 16 exactly for Q4_0 and
// Q5_0 (a zero residual), -m/d for Q4_1 and Q5_1. One template serves all
// six; its format F picks the planes.
//
// Bound on the H100: at prefill M (64..512) the bf16 tensor-core work per
// weight byte (2*M operations per 0.59 B) nears or passes the card's
// ~295 operations per byte, so the kernel must feed the tensor cores and
// keep the dequantisation off the critical path. It runs on the pipelined
// mainloop that it shares with kernel D (qmma.cuh: split K over a
// persistent grid, two producer warp groups staging a three-slot ring, one
// consumer warp group on ldmatrix + mma.sync, f32 partials summed in split
// order). What is B's own:
// - the weight tile is dequantised on the way in (stage_w_centered, called
//   by a producer group with its local thread index), 8 bf16 per 16-byte
//   store, with the CENTERED law of the TPU kernel,
//   w = bf16((q - t) * dl) with t = ml / dl, so the bf16 weight keeps the
//   reference's centered magnitude (the uncentered q*dl - ml doubles the
//   rounding error);
// - the residual ml - t*dl (zero except on dl == 0 guard groups and f32
//   rounding) is folded back as a side term sum_g xs[m, g] * ml_res[n, g],
//   as the TPU kernel's side dot does: the x group sums xs are summed once
//   per call by a pre-pass (qmma_group_sums), as the TPU kernel sums them
//   outside its kernel (dequant_matmul.py:601-605); the producer stages
//   the step's residuals beside the weight tile, and the consumer sums the
//   side dot in its registers beside the products. Q4_0 and Q5_0, whose
//   residual is exactly zero (t = 8 and 16), drop the side term at compile
//   time;
// - Q5_K: t = ml / dl may pass 31 only where dl == 0, and there t = 0 as in
//   the TPU kernel, so the residual takes the whole min (for Q4_1 and Q5_1,
//   where a block's d is 0, the whole -m).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmma.cuh"

namespace {

using kquant::Fmt;
using qstage::BN;
using qstage::LD;
using qstage::kThreads;
using qstage::pack_bf16;
using qstage::Planes;

// the formats whose residual ml - t*dl is not identically zero
__host__ __device__ constexpr bool has_side(Fmt f) { return f != Fmt::kQ4_0 && f != Fmt::kQ5_0; }

// Kernel B's weight tile of superblock s: BN rows x 8 chunks of 16 packed
// bytes; chunk c holds the low nibbles of elements 16c.. (group c/2) and
// the high nibbles of elements 128+16c.. (group 4+c/2), with the five-bit
// formats' high bits of both. The K-quants load their superblock's d, dm
// and the two groups' sc, mn; the legacy formats the two groups' d (in
// dsv) and m (in dmsv). Writes the centered bf16 weights into ws_t and,
// where the format has a side term, each (row, group)'s residual into
// res [BN][8]. Called by kThreads threads (tid 0..kThreads-1), no barrier;
// every global load is issued before any is used.
template <Fmt F>
__device__ __forceinline__ void stage_w_centered(const Planes& p, __nv_bfloat16* ws_t,
                                                 float* res, int n0, int N, int K, int s,
                                                 int tid) {
  constexpr int kWLoads = BN * 8 / kThreads;  // weight chunks per thread
  const uint8_t* q = static_cast<const uint8_t*>(p.q);
  const int n_groups = K >> 5, n_sb = K >> 8;
  const size_t half = (size_t)(K >> 1);
  uint4 qv[kWLoads];
  float dsv[kWLoads][2], dmsv[kWLoads][2];
  int scv[kWLoads][2], mnv[kWLoads][2];
  uint2 hbv[kWLoads];
#pragma unroll
  for (int i = 0; i < kWLoads; ++i) {
    const int idx = tid + kThreads * i;
    const int r = idx >> 3, c = idx & 7;
    const int gn = n0 + r;
    qv[i] = make_uint4(0, 0, 0, 0);
    dsv[i][0] = dsv[i][1] = dmsv[i][0] = dmsv[i][1] = 0.f;
    scv[i][0] = scv[i][1] = mnv[i][0] = mnv[i][1] = 0;
    hbv[i] = make_uint2(0u, 0u);
    if (gn < N) {
      hbv[i] = kquant::high_words<kquant::five_bit(F)>(p.qh, (size_t)gn * (K >> 3), s, c);
      qv[i] = __ldg(reinterpret_cast<const uint4*>(q + (size_t)gn * half + (size_t)s * 128) + c);
      const size_t g = (size_t)gn * n_groups + s * 8 + (c >> 1);
      if constexpr (kquant::legacy(F)) {
        dsv[i][0] = __ldg(p.d + g);
        dsv[i][1] = __ldg(p.d + g + 4);
        if constexpr (kquant::added_min(F)) {
          dmsv[i][0] = __ldg(p.dm + g);
          dmsv[i][1] = __ldg(p.dm + g + 4);
        }
      } else {
        dsv[i][0] = __ldg(p.d + (size_t)gn * n_sb + s);
        dmsv[i][0] = __ldg(p.dm + (size_t)gn * n_sb + s);
        scv[i][0] = __ldg(p.sc + g);
        scv[i][1] = __ldg(p.sc + g + 4);
        mnv[i][0] = __ldg(p.mn + g);
        mnv[i][1] = __ldg(p.mn + g + 4);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kWLoads; ++i) {
    const int idx = tid + kThreads * i;
    const int r = idx >> 3, c = idx & 7;
    // rows past N have d = 0 (and m = 0): zero weights and a zero residual
    float dl_lo, ml_lo, dl_hi, ml_hi;
    if constexpr (kquant::legacy(F)) {
      dl_lo = dsv[i][0];
      dl_hi = dsv[i][1];
      ml_lo = kquant::legacy_min<F>(dl_lo, dmsv[i][0]);
      ml_hi = kquant::legacy_min<F>(dl_hi, dmsv[i][1]);
    } else {
      dl_lo = dsv[i][0] * (float)scv[i][0];
      ml_lo = dmsv[i][0] * (float)mnv[i][0];
      dl_hi = dsv[i][0] * (float)scv[i][1];
      ml_hi = dmsv[i][0] * (float)mnv[i][1];
    }
    const float t_lo = dl_lo != 0.f ? ml_lo / dl_lo : 0.f;
    const float t_hi = dl_hi != 0.f ? ml_hi / dl_hi : 0.f;
    if constexpr (has_side(F)) {
      if ((c & 1) == 0) {  // one writer per (row, group) of the residual
        res[r * 8 + (c >> 1)] = ml_lo - t_lo * dl_lo;
        res[r * 8 + 4 + (c >> 1)] = ml_hi - t_hi * dl_hi;
      }
    }
    const uint32_t w32[4] = {qv[i].x, qv[i].y, qv[i].z, qv[i].w};
    __nv_bfloat16* wrow = ws_t + r * LD;
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t word = w32[v * 2 + (e >> 1)];
        const int sh = (e & 1) * 16;  // bytes 2e, 2e+1 of this 8-byte run
        const uint32_t q0 = (word >> sh) & 0xFFu, q1 = (word >> (sh + 8)) & 0xFFu;
        const uint4 w = kquant::values<kquant::five_bit(F)>(q0, q1, hbv[i], v * 8 + 2 * e);
        lo[e] = pack_bf16(((float)w.x - t_lo) * dl_lo, ((float)w.y - t_lo) * dl_lo);
        hi[e] = pack_bf16(((float)w.z - t_hi) * dl_hi, ((float)w.w - t_hi) * dl_hi);
      }
      *reinterpret_cast<uint4*>(wrow + c * 16 + v * 8) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(wrow + 128 + c * 16 + v * 8) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
  }
}

// the producer groups' staging of format F for the mainloop
template <Fmt F>
struct CenteredStage {
  Planes p;
  int N, K;
  __device__ __forceinline__ void operator()(__nv_bfloat16* ws_t, float* res, int n0, int s,
                                             int tid) const {
    stage_w_centered<F>(p, ws_t, res, n0, N, K, s, tid);
  }
};

template <Fmt F>
int gemm(const void* x, const Planes& p, void* out, void* ws, int m, int n, int k, int splits,
         int out_f32, void* stream) {
  if (m < 1 || n < 1 || k < 256 || k % 256 != 0 || (m + qmma::BM - 1) / qmma::BM > 65535 ||
      (kquant::five_bit(F) && p.qh == nullptr) || (kquant::added_min(F) && p.dm == nullptr))
    return (int)cudaErrorInvalidValue;
  return qmma::launch<has_side(F)>(static_cast<const __nv_bfloat16*>(x), out,
                                   static_cast<float*>(ws), m, n, k, splits, out_f32,
                                   CenteredStage<F>{p, n, k}, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Each returns the first CUDA error of the attribute call or the launches
// (0 = ok). A format ignores the planes it lacks (null): Q4_K and
// Q4_0/Q4_1 have no qh, the legacy formats no sc or mn, Q4_0 and Q5_0 no dm.
// ws: qmma::workspace_floats(has_side, m, n, k, splits) f32 (the x group
// sums, then the split partials), null where that is 0; splits in
// 1..k/256 (dequant_matmul.gemm_splits).
#define GEMM_ENTRY(name, fmt)                                                            \
  extern "C" int name(const void* x, const void* q, const void* sc, const void* mn,     \
                      const void* d, const void* dm, const void* qh, void* out, void* ws, \
                      int m, int n, int k, int splits, int out_f32, void* stream) {      \
    const Planes p{q, static_cast<const int8_t*>(sc), static_cast<const int8_t*>(mn),    \
                   static_cast<const float*>(d), static_cast<const float*>(dm),          \
                   static_cast<const uint8_t*>(qh)};                                      \
    return gemm<fmt>(x, p, out, ws, m, n, k, splits, out_f32, stream);                   \
  }

GEMM_ENTRY(q4k_gemm, Fmt::kQ4K)
GEMM_ENTRY(q5k_gemm, Fmt::kQ5K)
GEMM_ENTRY(q4_0_gemm, Fmt::kQ4_0)
GEMM_ENTRY(q4_1_gemm, Fmt::kQ4_1)
GEMM_ENTRY(q5_0_gemm, Fmt::kQ5_0)
GEMM_ENTRY(q5_1_gemm, Fmt::kQ5_1)
