// q8_0_gemv (kernel E): out[m, n] = sum_k x[m, k] * W[n, k] for M = 1..8,
// W in Q8_0.
//
// Replaces omni_tpu/kernels/dequant_matmul.py::qmatmul_gp_pallas (:333,
// law _gp_slice :233-239) for Q8_0: the decode matmul of every weight of a
// Q8_0 checkpoint (253 per token of a Qwen3-8B). E's codebook entries
// (IQ4_NL, IQ4_XS, MXFP4) are codebook_gemv.cu.
//
// The law is the int8-plane group law of _gp_slice, one f32 scale per 32
// elements:
//   P[m, n, g] = sum over the 32 elements of group g of bf16(x[m, k]) * q[n, k]
//   out[m, n]  = sum_g d[n, g] * P[m, n, g]
// all in f32. x stays bf16 and q int8: each product is exact in f32, so the
// kernel and its plain version differ only in the order of the f32 sums.
// (No dp4a or IMMA: those quantize x to int8, which is another law.)
//
// Bound on the H100: device-memory bytes. Each weight element is read once
// (1 B of int8 value + 1/8 B of f32 scale) and used M <= 8 times, far below
// the ~295 operations per byte where the card turns compute-bound. The
// design streams the planes once, in the shape of kernel C (q6k_gemv.cu):
// - one warp per output row; each lane takes 16-byte loads of the int8
//   plane (16 values, half a group), neighbouring lanes on neighbouring
//   addresses, so a warp reads 512 contiguous bytes per load;
// - lanes 2t and 2t+1 hold the two halves of one group: each sums its 16
//   exact products, the pair adds the halves with one shuffle, and the even
//   lane adds d * P to its running f32 sum (the group law, P whole);
// - a warp-shuffle reduction of the lanes' sums per row at the end.
// The M <= 8 rows of x share one read of the weights; x (at most
// 8 x 12288 bf16) stays in L1/L2. At N = 1024 (attn_k, attn_v) one warp per
// row fills only 128 blocks of 8 warps: the card is underfed there.
//
// Plane layout (N-major, the transpose of the JAX K-major planes): q int8
// [N, K] in element order, d f32 [N, K/32]; K % 32 == 0. Offsets are
// 64-bit: the output head's q plane is 621.6 MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block

template <int M>
__global__ void __launch_bounds__(kWarps * 32)
q8_0_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ q, const float* __restrict__ d,
                 void* __restrict__ out,
                 int n_rows, int k, int out_f32) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warps leave together
  const int n_chunks = k >> 4;  // 16-element chunks, an even count
  const int8_t* qrow = q + (size_t)row * k;
  const float* drow = d + (size_t)row * (k >> 5);  // d per 32

  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.f;

  // chunk j = elements [16j, 16j + 16) = bytes [16j, 16j + 16) of the row,
  // the low (j even) or high (j odd) half of group j / 2. Every lane runs
  // every iteration, so the pair shuffle below always has the whole warp.
  for (int base = 0; base < n_chunks; base += 32) {
    const int j = base + lane;
    const bool live = j < n_chunks;  // both lanes of a pair live or not
    union {
      uint4 v;
      int8_t b[16];
    } pk;
    pk.v = live ? __ldg(reinterpret_cast<const uint4*>(qrow) + j) : make_uint4(0, 0, 0, 0);
    const float dg = live ? __ldg(drow + (j >> 1)) : 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float p = 0.f;
      if (live) {
        const uint4* xm = reinterpret_cast<const uint4*>(x + (size_t)m * k) + 2 * j;
        uint4 xv[2];  // the chunk's 16 bf16
        xv[0] = __ldg(xm);
        xv[1] = __ldg(xm + 1);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(xv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          p += f.x * (float)pk.b[2 * e] + f.y * (float)pk.b[2 * e + 1];
        }
      }
      p += __shfl_xor_sync(0xffffffffu, p, 1);  // the group's P
      if ((lane & 1) == 0) acc[m] += dg * p;
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

template <int M>
void launch(const void* x, const void* q, const void* d, void* out, int n, int k,
            int out_f32, cudaStream_t st) {
  const dim3 grid((n + kWarps - 1) / kWarps), block(kWarps * 32);
  q8_0_gemv_kernel<M><<<grid, block, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(d), out, n, k, out_f32);
}

int dispatch(const void* x, const void* q, const void* d, void* out, int m, int n, int k,
             int out_f32, void* stream) {
  if (m < 1 || m > 8 || n < 1 || k < 32 || k % 32 != 0)  // K multiple of the planes
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: launch<1>(x, q, d, out, n, k, out_f32, st); break;
    case 2: launch<2>(x, q, d, out, n, k, out_f32, st); break;
    case 3: launch<3>(x, q, d, out, n, k, out_f32, st); break;
    case 4: launch<4>(x, q, d, out, n, k, out_f32, st); break;
    case 5: launch<5>(x, q, d, out, n, k, out_f32, st); break;
    case 6: launch<6>(x, q, d, out, n, k, out_f32, st); break;
    case 7: launch<7>(x, q, d, out, n, k, out_f32, st); break;
    default: launch<8>(x, q, d, out, n, k, out_f32, st); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). The sc, mn,
// dm and qh arguments keep the signature of the other matmul entries; Q8_0
// has none of them, so they are unused.
extern "C" int q8_0_gemv(const void* x, const void* q, const void* sc, const void* mn,
                         const void* d, const void* dm, const void* qh, void* out, int m,
                         int n, int k, int out_f32, void* stream) {
  (void)sc;
  (void)mn;
  (void)dm;
  (void)qh;
  return dispatch(x, q, d, out, m, n, k, out_f32, stream);
}
