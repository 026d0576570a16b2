// q2k_gemv and q3k_gemv (kernel H): out[m, n] = sum_k x[m, k] * W[n, k]
// for M = 1..8, W in Q2_K or Q3_K.
//
// Replaces omni_tpu/kernels/dequant_matmul.py::qmatmul_gp_pallas (:333,
// body _make_gp_kernel :258-309) for the two low-bit K-quants — the decode
// matmul of every layer of a Q2_K or Q3_K checkpoint. The law is the TPU
// kernel's `_gp_slice` (:221-232): per 16-element group g,
//   out += dl_g * P_g - ml_g * xs_g,
// P_g the f32 dot of bf16 x with the group's raw values, xs_g the f32 sum of
// bf16 x over the group, dl = d * sc and ml = dm * mn the exact f32
// products of the reference dequantiser:
// - Q2_K: the value q in 0..3, a 4-bit scale and a 4-bit min per 16;
// - Q3_K: q = quarter + 4 * hbit - 4 in -4..3, a signed 6-bit scale per
//   16, no min term.
// Every value is exact in bf16 and in f32, so each product x * q is exact.
//
// Bound on the H100: device-memory bytes. Per element 0.25 B of quarters,
// 1/16 B of int8 scale (Q2_K also 1/16 B of min), 1/64 B of f32 super
// scales, Q3_K 1/8 B of high bits — 0.406 B (Q2_K) and 0.453 B (Q3_K) of
// planes, used M <= 8 times, far below the ~295 operations per byte where
// the card turns compute-bound. The design streams the planes once:
// - one warp per output row, as kernels A and C (q4k_gemv.cu,
//   q6k_gemv.cu); each lane takes 16-byte loads of the quarter plane,
//   neighbouring lanes on neighbouring addresses;
// - a quarter byte r of superblock s holds elements s*256 + 64j + r at
//   shift 2j, four elements 64 apart, in four different 16-groups. The
//   16 bytes of chunk p (r = 16p..16p + 15) therefore hold exactly four
//   whole groups, 4j + p for j = 0..3: one load, four groups, 64 elements,
//   and the group law runs once per group in registers (kernel C's
//   16-group scale law, with the min of kernel A's);
// - Q3_K's high bits: the plane qh u8 [N, K/8] holds them in element order
//   (bit b of byte r: element 8r + b, as Q5_K's qh), so group 4j + p's
//   sixteen bits are the 16-bit word s*16 + 4j + p of the row's qh, bit i
//   for element i (kquant.cuh's `high_words` reads Q5_K's the same way);
// - f32 accumulation per row, then a warp-shuffle reduction.
// x (at most 8 x 12288 bf16) stays in L1/L2. At N = 1024 (wk, wv) one warp
// per row fills only 128 blocks of 8 warps: the card is underfed there.
//
// Plane layout (N-major, the transpose of the JAX K-major planes): q u8
// [N, K/4] quarters, sc int8 [N, K/16], d f32 [N, K/256]; Q2_K mn int8
// [N, K/16] and dm f32 [N, K/256]; Q3_K qh u8 [N, K/8]. Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block

enum class Fmt { kQ2K, kQ3K };

template <int M, Fmt F>
__global__ void __launch_bounds__(kWarps * 32)
lowbit_gemv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                   const int8_t* __restrict__ sc, const int8_t* __restrict__ mn,
                   const float* __restrict__ d, const float* __restrict__ dm,
                   const uint8_t* __restrict__ qh, void* __restrict__ out, int n_rows,
                   int k, int out_f32) {
  constexpr bool kQ3 = F == Fmt::kQ3K;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int n_groups = k >> 4;
  const int n_sb = k >> 8;
  const uint8_t* qrow = q + (size_t)row * (k >> 2);
  const size_t g_row = (size_t)row * n_groups;
  const size_t sb_row = (size_t)row * n_sb;

  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.f;

  // chunk c = bytes [16c, 16c + 16) of the row: part p of superblock s
  for (int c = lane; c < (k >> 6); c += 32) {
    const int s = c >> 2, p = c & 3;
    union {
      uint4 v;
      uint8_t b[16];
    } pk;
    pk.v = __ldg(reinterpret_cast<const uint4*>(qrow) + c);
    const float ds = __ldg(d + sb_row + s);
    float dms = 0.f;
    if constexpr (!kQ3) dms = __ldg(dm + sb_row + s);
    float dl[4], ml[4];
    uint32_t hb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const size_t g = g_row + s * 16 + 4 * j + p;  // group 4j + p of superblock s
      dl[j] = ds * (float)__ldg(sc + g);
      if constexpr (kQ3) {
        hb[j] = __ldg(reinterpret_cast<const uint16_t*>(qh + (size_t)row * (k >> 3)) +
                      s * 16 + 4 * j + p);
        ml[j] = 0.f;
      } else {
        ml[j] = dms * (float)__ldg(mn + g);
        hb[j] = 0u;
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const uint4* xm = reinterpret_cast<const uint4*>(x + (size_t)m * k);
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e0 = s * 256 + 64 * j + 16 * p;  // the group's first element
        uint4 xv[2];  // its 16 bf16
        xv[0] = __ldg(xm + (e0 >> 3));
        xv[1] = __ldg(xm + (e0 >> 3) + 1);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(xv);
        float pj = 0.f, sj = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 f = __bfloat1622float2(h[i]);
          int v0 = (pk.b[2 * i] >> (2 * j)) & 3;
          int v1 = (pk.b[2 * i + 1] >> (2 * j)) & 3;
          if constexpr (kQ3) {
            v0 += 4 * (int)((hb[j] >> (2 * i)) & 1u) - 4;
            v1 += 4 * (int)((hb[j] >> (2 * i + 1)) & 1u) - 4;
          }
          pj += f.x * (float)v0 + f.y * (float)v1;
          if constexpr (!kQ3) sj += f.x + f.y;
        }
        part += kQ3 ? dl[j] * pj : dl[j] * pj - ml[j] * sj;
      }
      acc[m] += part;
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
void launch(const void* x, const void* q, const void* sc, const void* mn, const void* d,
            const void* dm, const void* qh, void* out, int n, int k, int out_f32,
            cudaStream_t st) {
  const dim3 grid((n + kWarps - 1) / kWarps), block(kWarps * 32);
  lowbit_gemv_kernel<M, F><<<grid, block, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const int8_t*>(sc), static_cast<const int8_t*>(mn),
      static_cast<const float*>(d), static_cast<const float*>(dm),
      static_cast<const uint8_t*>(qh), out, n, k, out_f32);
}

template <Fmt F>
int gemv(const void* x, const void* q, const void* sc, const void* mn, const void* d,
         const void* dm, const void* qh, void* out, int m, int n, int k, int out_f32,
         void* stream) {
  const bool planes_ok = F == Fmt::kQ3K ? qh != nullptr : mn != nullptr && dm != nullptr;
  if (m < 1 || m > 8 || n < 1 || k < 256 || k % 256 != 0 || sc == nullptr || !planes_ok)
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

// Each returns cudaGetLastError() after the launch (0 = launched). Q2_K
// ignores qh, Q3_K mn and dm (null).
#define GEMV_ENTRY(name, fmt)                                                          \
  extern "C" int name(const void* x, const void* q, const void* sc, const void* mn,   \
                      const void* d, const void* dm, const void* qh, void* out, int m, \
                      int n, int k, int out_f32, void* stream) {                       \
    return gemv<fmt>(x, q, sc, mn, d, dm, qh, out, m, n, k, out_f32, stream);          \
  }

GEMV_ENTRY(q2k_gemv, Fmt::kQ2K)
GEMV_ENTRY(q3k_gemv, Fmt::kQ3K)
