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
// keep the dequantisation off the critical path. This first version is
// simple and right rather than fast:
// - a 2-D grid of 64 x 64 output tiles, 4 warps, each warp a 32 x 32
//   sub-tile of 2 x 2 WMMA m16n16k16 bf16 products with f32 accumulators;
// - per K step of one 256-element superblock, the x tile [64, 256] bf16
//   (cp.async, no registers) and the weight tile [64, 256] are staged in
//   shared memory, every global load of the step issued before any is used;
//   the weight tile is dequantised on the way in, 8 bf16 per 16-byte store,
//   with the CENTERED law of the TPU kernel,
//   w = bf16((q - t) * dl) with t = ml / dl, so the bf16 weight keeps the
//   reference's centered magnitude (the uncentered q*dl - ml doubles the
//   rounding error);
// - the residual ml - t*dl (zero except on dl == 0 guard groups and f32
//   rounding) is folded back as a side term sum_g xs[m, g] * ml_res[n, g],
//   as the TPU kernel's side dot does;
// - each superblock's products are summed by the tensor cores in fresh
//   accumulators and added to the running f32 sums with IEEE adds, so the
//   long-K sums round as an f32 sum does;
// - ragged M and N edges are masked; 64-bit offsets throughout;
// - Q5_K: t = ml / dl may pass 31 only where dl == 0, and there t = 0 as in
//   the TPU kernel, so the residual takes the whole min (for Q4_1 and Q5_1,
//   where a block's d is 0, the whole -m).
// 70 KB of dynamic shared memory, above the 48 KB default, so the launcher
// raises the limit with cudaFuncSetAttribute. wgmma, TMA, a multi-stage
// ring and warp specialisation are for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "kquant.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 256;
constexpr int LD = BK + 8;   // bf16 row pitch of the staged tiles
constexpr int LDC = BN + 4;  // f32 row pitch of the epilogue tile
constexpr int LDG = 9;       // f32 row pitch of the per-group side arrays
constexpr int kThreads = 128;
constexpr int kPairs = BM * BN / kThreads;
constexpr int kXLoads = BM * (BK / 8) / kThreads;  // x chunks per thread
constexpr int kWLoads = BN * 8 / kThreads;         // weight chunks per thread
constexpr size_t kTileBytes = (size_t)BM * LD * sizeof(__nv_bfloat16);
constexpr size_t kSmem = 2 * kTileBytes + (size_t)(BM + BN) * LDG * sizeof(float);
static_assert((size_t)BM * LDC * sizeof(float) <= kTileBytes, "epilogue tile");

// 16-byte global -> shared copy that bypasses registers; src_bytes = 0
// fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// two floats -> two round-to-nearest bf16 in one 32-bit word (a first)
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

using kquant::Fmt;

template <Fmt F>
__global__ void __launch_bounds__(kThreads)
q4k_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                const uint8_t* __restrict__ q, const int8_t* __restrict__ sc,
                const int8_t* __restrict__ mn, const float* __restrict__ d,
                const float* __restrict__ dm, const uint8_t* __restrict__ qh,
                void* __restrict__ out, int M, int N, int K, int out_f32) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs_t = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws_t = reinterpret_cast<__nv_bfloat16*>(smem + kTileBytes);
  float* xsum = reinterpret_cast<float*>(smem + 2 * kTileBytes);  // [BM][LDG]
  float* mlres = xsum + BM * LDG;                                 // [BN][LDG]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_groups = K >> 5, n_sb = K >> 8;
  const size_t half = (size_t)(K >> 1);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  float side[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) side[i] = 0.f;

  for (int s = 0; s < n_sb; ++s) {
    // Every global load of this step is issued before any result is used,
    // so their latencies overlap. x tile (BM rows x 32 chunks of 8 bf16):
    // asynchronous copies straight into shared memory, rows past M
    // zero-filled.
#pragma unroll
    for (int i = 0; i < kXLoads; ++i) {
      const int idx = tid + kThreads * i;
      const int r = idx >> 5, c = idx & 31;
      const bool live = m0 + r < M;
      const __nv_bfloat16* src = x + (live ? (size_t)(m0 + r) * K + (size_t)s * BK + c * 8 : 0);
      cp_async16(xs_t + r * LD + c * 8, src, live);
    }
    cp_async_commit();
    // weight tile: BN rows x 8 chunks of 16 packed bytes; chunk c holds the
    // low nibbles of elements 16c.. (group c/2) and the high nibbles of
    // elements 128+16c.. (group 4+c/2), with the five-bit formats' high
    // bits of both. The K-quants load their superblock's d, dm and the two
    // groups' sc, mn; the legacy formats the two groups' d (in dsv) and m
    // (in dmsv).
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
        hbv[i] = kquant::high_words<kquant::five_bit(F)>(qh, (size_t)gn * (K >> 3), s, c);
        qv[i] = __ldg(reinterpret_cast<const uint4*>(q + (size_t)gn * half + (size_t)s * 128) + c);
        const size_t g = (size_t)gn * n_groups + s * 8 + (c >> 1);
        if constexpr (kquant::legacy(F)) {
          dsv[i][0] = __ldg(d + g);
          dsv[i][1] = __ldg(d + g + 4);
          if constexpr (kquant::added_min(F)) {
            dmsv[i][0] = __ldg(dm + g);
            dmsv[i][1] = __ldg(dm + g + 4);
          }
        } else {
          dsv[i][0] = __ldg(d + (size_t)gn * n_sb + s);
          dmsv[i][0] = __ldg(dm + (size_t)gn * n_sb + s);
          scv[i][0] = __ldg(sc + g);
          scv[i][1] = __ldg(sc + g + 4);
          mnv[i][0] = __ldg(mn + g);
          mnv[i][1] = __ldg(mn + g + 4);
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
      if ((c & 1) == 0) {  // one writer per (row, group) of the residual
        mlres[r * LDG + (c >> 1)] = ml_lo - t_lo * dl_lo;
        mlres[r * LDG + 4 + (c >> 1)] = ml_hi - t_hi * dl_hi;
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
    cp_async_wait_all();
    __syncthreads();

    // group sums of the staged x tile for the side term
    for (int idx = tid; idx < BM * 8; idx += kThreads) {
      const int r = idx >> 3, gi = idx & 7;
      const __nv_bfloat16* xr = xs_t + r * LD + gi * 32;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) sum += __bfloat162float(xr[j]);
      xsum[r * LDG + gi] = sum;
    }
    // this superblock's products in fresh accumulators, then added to the
    // running sums with IEEE f32 adds: the tensor cores' own accumulation
    // is not rounded to nearest, and chained over all of K it flipped 25x
    // more bf16 outputs than an f32 sum does
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> part[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(part[i][j], 0.f);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs_t + (wm + 16 * i) * LD + kk, LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], ws_t + (wn + 16 * j) * LD + kk, LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(part[i][j], a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int t = 0; t < part[i][j].num_elements; ++t) acc[i][j].x[t] += part[i][j].x[t];
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int p = tid + kThreads * i;
      const int r = p / BN, c = p % BN;
      float v = 0.f;
#pragma unroll
      for (int gi = 0; gi < 8; ++gi) v += xsum[r * LDG + gi] * mlres[c * LDG + gi];
      side[i] += v;
    }
    __syncthreads();
  }

  // epilogue: accumulators -> shared f32 tile -> masked global store
  float* ctile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(ctile + (wm + 16 * i) * LDC + wn + 16 * j, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int p = tid + kThreads * i;
    const int r = p / BN, c = p % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) {
      const float v = ctile[r * LDC + c] - side[i];
      const size_t o = (size_t)gm * N + gn;
      if (out_f32)
        static_cast<float*>(out)[o] = v;
      else
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(v);
    }
  }
}

template <Fmt F>
int gemm(const void* x, const void* q, const void* sc, const void* mn,
         const void* d, const void* dm, const void* qh, void* out, int m,
         int n, int k, int out_f32, void* stream) {
  if (m < 1 || n < 1 || k < 256 || k % 256 != 0 || (m + BM - 1) / BM > 65535 ||
      (kquant::five_bit(F) && qh == nullptr) || (kquant::added_min(F) && dm == nullptr))
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        q4k_gemm_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM), block(kThreads);
  q4k_gemm_kernel<F><<<grid, block, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const int8_t*>(sc), static_cast<const int8_t*>(mn),
      static_cast<const float*>(d), static_cast<const float*>(dm),
      static_cast<const uint8_t*>(qh), out, m, n, k, out_f32);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns the first CUDA error of the attribute call or the launch
// (0 = ok). A format ignores the planes it lacks (null): Q4_K and
// Q4_0/Q4_1 have no qh, the legacy formats no sc or mn, Q4_0 and Q5_0 no dm.
#define GEMM_ENTRY(name, fmt)                                                          \
  extern "C" int name(const void* x, const void* q, const void* sc, const void* mn,   \
                      const void* d, const void* dm, const void* qh, void* out, int m, \
                      int n, int k, int out_f32, void* stream) {                       \
    return gemm<fmt>(x, q, sc, mn, d, dm, qh, out, m, n, k, out_f32, stream);          \
  }

GEMM_ENTRY(q4k_gemm, Fmt::kQ4K)
GEMM_ENTRY(q5k_gemm, Fmt::kQ5K)
GEMM_ENTRY(q4_0_gemm, Fmt::kQ4_0)
GEMM_ENTRY(q4_1_gemm, Fmt::kQ4_1)
GEMM_ENTRY(q5_0_gemm, Fmt::kQ5_0)
GEMM_ENTRY(q5_1_gemm, Fmt::kQ5_1)
