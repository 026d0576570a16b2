// q4k_gemv (kernel A), q5k_gemv (kernel G) and A's legacy branches
// q4_0_gemv, q4_1_gemv, q5_0_gemv, q5_1_gemv: out[m, n] = sum_k x[m, k] *
// W[n, k] for M = 1..8, W in Q4_K, Q5_K, Q4_0, Q4_1, Q5_0 or Q5_1.
//
// Replaces omni_tpu/kernels/dequant_matmul.py::qmatmul_gp_pallas (:333) for
// those six formats — the decode matmul of every layer and of the output
// head. Q5_K is Q4_K with a fifth bit per value (q = nibble + 16 * bit,
// 0..31, still exact in bf16, `_gp_slice` :208-215), and the legacy formats
// keep the same q (and qh) planes with one scale (and min) per 32-element
// group in place of d*sc (`_gp_slice` :240-255), so all six run one
// template; its format F picks the high-bit plane and the scales' source
// (kquant.cuh). The legacy formats need only K % 256 (their d, dm planes
// have a row per 32 elements, where the TPU kernel's K-quant planes need
// K % 2048).
//
// Bound on the H100: device-memory bytes. Each weight element is read once
// (0.5 B of nibbles + 1/16 B of int8 scale/min + 1/32 B of f32 super
// scales; Q5_K 1/8 B more of high bits) and used M <= 8 times, far below
// the ~295 operations per byte where the card turns compute-bound. The design streams the packed planes
// once and never widens them in memory:
// - one warp per output row; lanes take 16-byte loads of packed nibbles,
//   neighbouring lanes on neighbouring addresses;
// - the group law of the TPU kernel, dl*P - ml*xs per 32-group, runs in
//   registers: P and xs are f32 partial dots of the bf16 activation with
//   the raw nibbles, dl = d*sc and ml = dm*mn the exact f32 products of the
//   reference dequantiser;
// - f32 accumulation per row, then a warp-shuffle reduction.
// The TPU kernel's block-diagonal MXU trick is a TPU workaround and is
// dropped. x (at most 8 x 12288 bf16) stays in L1/L2.
//
// Plane layout (N-major, the transpose of the JAX K-major planes): q u8
// [N, K/2] with superblock-local halves (byte r of superblock s holds
// element s*256+r low and s*256+128+r high), sc/mn int8 [N, K/32], d/dm f32
// [N, K/256]; Q5_K's qh u8 [N, K/8], decoded with the chunk of q it goes
// with by kquant.cuh. The legacy formats: q and qh the same, d f32 [N, K/32]
// and, for Q4_1 and Q5_1, dm f32 [N, K/32] (the min m); sc, mn unused.
// Offsets are 64-bit: the output head's planes pass 3e8 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kquant.cuh"

namespace {

constexpr int kWarps = 8;  // rows per block

using kquant::Fmt;

template <int M, Fmt F>
__global__ void __launch_bounds__(kWarps * 32)
q4k_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                const uint8_t* __restrict__ q, const int8_t* __restrict__ sc,
                const int8_t* __restrict__ mn, const float* __restrict__ d,
                const float* __restrict__ dm, const uint8_t* __restrict__ qh,
                void* __restrict__ out, int n_rows, int k, int out_f32) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int half = k >> 1;
  const int n_groups = k >> 5;
  const int n_sb = k >> 8;
  const uint8_t* qrow = q + (size_t)row * half;
  const int8_t* scrow = sc + (size_t)row * n_groups;
  const int8_t* mnrow = mn + (size_t)row * n_groups;
  const float* drow = d + (size_t)row * n_sb;
  const float* dmrow = dm + (size_t)row * n_sb;

  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.f;

  // chunk c = bytes [16c, 16c + 16) of the row; 8 chunks per superblock
  for (int c = lane; c < (half >> 4); c += 32) {
    const int s = c >> 3;
    const int r0 = (c & 7) << 4;
    const int g_lo = s * 8 + (r0 >> 5);
    const int g_hi = g_lo + 4;
    float dl_lo, ml_lo, dl_hi, ml_hi;
    if constexpr (kquant::legacy(F)) {
      const float* dg = d + (size_t)row * n_groups;
      float m_lo = 0.f, m_hi = 0.f;
      if constexpr (kquant::added_min(F)) {
        m_lo = __ldg(dm + (size_t)row * n_groups + g_lo);
        m_hi = __ldg(dm + (size_t)row * n_groups + g_hi);
      }
      dl_lo = __ldg(dg + g_lo);
      dl_hi = __ldg(dg + g_hi);
      ml_lo = kquant::legacy_min<F>(dl_lo, m_lo);
      ml_hi = kquant::legacy_min<F>(dl_hi, m_hi);
    } else {
      const float ds = __ldg(drow + s), dms = __ldg(dmrow + s);
      dl_lo = ds * (float)__ldg(scrow + g_lo);
      ml_lo = dms * (float)__ldg(mnrow + g_lo);
      dl_hi = ds * (float)__ldg(scrow + g_hi);
      ml_hi = dms * (float)__ldg(mnrow + g_hi);
    }
    union {
      uint4 v;
      uint8_t b[16];
    } pk;
    pk.v = __ldg(reinterpret_cast<const uint4*>(qrow) + c);
    const uint2 hb = kquant::high_words<kquant::five_bit(F)>(qh, (size_t)row * (k >> 3), s,
                                                             c & 7);
    const int e_lo = s * 256 + r0;  // first element of the low half
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const uint4* xm = reinterpret_cast<const uint4*>(x + (size_t)m * k);
      uint4 xl[2], xh[2];  // 16 bf16 of each half
      xl[0] = __ldg(xm + (e_lo >> 3));
      xl[1] = __ldg(xm + (e_lo >> 3) + 1);
      xh[0] = __ldg(xm + ((e_lo + 128) >> 3));
      xh[1] = __ldg(xm + ((e_lo + 128) >> 3) + 1);
      const __nv_bfloat162* hl = reinterpret_cast<const __nv_bfloat162*>(xl);
      const __nv_bfloat162* hh = reinterpret_cast<const __nv_bfloat162*>(xh);
      float p_lo = 0.f, s_lo = 0.f, p_hi = 0.f, s_hi = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 fl = __bfloat1622float2(hl[j]);
        const float2 fh = __bfloat1622float2(hh[j]);
        const uint4 v =
            kquant::values<kquant::five_bit(F)>(pk.b[2 * j], pk.b[2 * j + 1], hb, 2 * j);
        p_lo += fl.x * (float)v.x + fl.y * (float)v.y;
        p_hi += fh.x * (float)v.z + fh.y * (float)v.w;
        s_lo += fl.x + fl.y;
        s_hi += fh.x + fh.y;
      }
      acc[m] += (dl_lo * p_lo - ml_lo * s_lo) + (dl_hi * p_hi - ml_hi * s_hi);
    }
  }

#pragma unroll
  for (int m = 0; m < M; ++m) {
    float v = acc[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) {
      const size_t o = (size_t)m * n_rows + row;
      if (out_f32)
        static_cast<float*>(out)[o] = v;
      else
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(v);
    }
  }
}

template <int M, Fmt F>
void launch(const void* x, const void* q, const void* sc, const void* mn,
            const void* d, const void* dm, const void* qh, void* out, int n,
            int k, int out_f32, cudaStream_t st) {
  const dim3 grid((n + kWarps - 1) / kWarps), block(kWarps * 32);
  q4k_gemv_kernel<M, F><<<grid, block, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const int8_t*>(sc), static_cast<const int8_t*>(mn),
      static_cast<const float*>(d), static_cast<const float*>(dm),
      static_cast<const uint8_t*>(qh), out, n, k, out_f32);
}

template <Fmt F>
int gemv(const void* x, const void* q, const void* sc, const void* mn,
         const void* d, const void* dm, const void* qh, void* out, int m,
         int n, int k, int out_f32, void* stream) {
  if (m < 1 || m > 8 || n < 1 || k < 256 || k % 256 != 0 ||
      (kquant::five_bit(F) && qh == nullptr) || (kquant::added_min(F) && dm == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: launch<1, F>(x, q, sc, mn, d, dm, qh, out, n, k, out_f32, st); break;
    case 2: launch<2, F>(x, q, sc, mn, d, dm, qh, out, n, k, out_f32, st); break;
    case 3: launch<3, F>(x, q, sc, mn, d, dm, qh, out, n, k, out_f32, st); break;
    case 4: launch<4, F>(x, q, sc, mn, d, dm, qh, out, n, k, out_f32, st); break;
    case 5: launch<5, F>(x, q, sc, mn, d, dm, qh, out, n, k, out_f32, st); break;
    case 6: launch<6, F>(x, q, sc, mn, d, dm, qh, out, n, k, out_f32, st); break;
    case 7: launch<7, F>(x, q, sc, mn, d, dm, qh, out, n, k, out_f32, st); break;
    default: launch<8, F>(x, q, sc, mn, d, dm, qh, out, n, k, out_f32, st); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 = launched). A format
// ignores the planes it lacks (null): Q4_K and Q4_0/Q4_1 have no qh, the
// legacy formats no sc or mn, Q4_0 and Q5_0 no dm.
#define GEMV_ENTRY(name, fmt)                                                          \
  extern "C" int name(const void* x, const void* q, const void* sc, const void* mn,   \
                      const void* d, const void* dm, const void* qh, void* out, int m, \
                      int n, int k, int out_f32, void* stream) {                       \
    return gemv<fmt>(x, q, sc, mn, d, dm, qh, out, m, n, k, out_f32, stream);          \
  }

GEMV_ENTRY(q4k_gemv, Fmt::kQ4K)
GEMV_ENTRY(q5k_gemv, Fmt::kQ5K)
GEMV_ENTRY(q4_0_gemv, Fmt::kQ4_0)
GEMV_ENTRY(q4_1_gemv, Fmt::kQ4_1)
GEMV_ENTRY(q5_0_gemv, Fmt::kQ5_0)
GEMV_ENTRY(q5_1_gemv, Fmt::kQ5_1)
