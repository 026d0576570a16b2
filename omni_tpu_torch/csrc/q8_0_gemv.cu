// q8_0_gemv: out[m, n] = sum_k x[m, k] * W[n, k] for M = 1..8, W in Q8_0,
// IQ4_NL, MXFP4 or IQ4_XS (the int8 value planes).
//
// Replaces omni_tpu/kernels/dequant_matmul.py::qmatmul_gp_pallas (:333,
// law _gp_slice :233-239) for Q8_0, IQ4_NL, MXFP4 and IQ4_XS: the decode
// matmul of every weight of a Q8_0 checkpoint (253 per token of a
// Qwen3-8B), and of every layer weight of an IQ4_NL, IQ4_XS or MXFP4 one
// (252 per token; their head is Q6_K).
//
// The device code is written on the law of the int8 value planes with one
// f32 scale per 32 elements, which _gp_slice gives to Q8_0, IQ4_NL and
// MXFP4 alike (their repack applies the codebook at load and yields the
// same two planes):
//   P[m, n, g] = sum over the 32 elements of group g of bf16(x[m, k]) * q[n, k]
//   out[m, n]  = sum_g dl[n, g] * P[m, n, g]
// all in f32, with dl = d[n, g]. IQ4_XS is the one template branch (kSub):
// dl = d[n, g / 8] * sc[n, g], the f32 product of its per-256 scale and its
// int8 per-32 sub-scale, rounded once (__fmul_rn, never fused into the
// multiply-add that follows), as _gp_slice forms it. x stays bf16 and q
// int8: each product is exact in f32, so the kernel and its plain version
// differ only in the order of the f32 sums. (No dp4a or IMMA: those
// quantize x to int8, which is another law.) The four formats have one C
// entry each, so each counts its own launches.
//
// The codebook formats' planes are twice their file's bytes (1.125 B per
// element, IQ4_XS 1.047, against 0.5625 and 0.53125): the JAX package's
// design, kept here, so on them this kernel reaches at most about half the
// bound of the format's own bytes.
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
// [N, K] in element order, d f32 [N, K/32]; K % 32 == 0. IQ4_XS: d f32
// [N, K/256] and sc int8 [N, K/32]; K % 256 == 0. Offsets are 64-bit: the
// output head's q plane is 621.6 MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block

template <int M, bool kSub>
__global__ void __launch_bounds__(kWarps * 32)
q8_0_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ q, const float* __restrict__ d,
                 const int8_t* __restrict__ sc, void* __restrict__ out,
                 int n_rows, int k, int out_f32) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warps leave together
  const int n_chunks = k >> 4;  // 16-element chunks, an even count
  const int8_t* qrow = q + (size_t)row * k;
  // kSub: d per 256 elements (16 chunks), sc per 32; else d per 32
  const float* drow = d + (size_t)row * (kSub ? k >> 8 : k >> 5);
  const int8_t* scrow = kSub ? sc + (size_t)row * (k >> 5) : nullptr;

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
    float dg = 0.f;
    if (live) {
      if constexpr (kSub)
        dg = __fmul_rn(__ldg(drow + (j >> 4)), (float)__ldg(scrow + (j >> 1)));
      else
        dg = __ldg(drow + (j >> 1));
    }
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

template <int M, bool kSub>
void launch(const void* x, const void* q, const void* d, const void* sc, void* out,
            int n, int k, int out_f32, cudaStream_t st) {
  const dim3 grid((n + kWarps - 1) / kWarps), block(kWarps * 32);
  q8_0_gemv_kernel<M, kSub><<<grid, block, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(d), static_cast<const int8_t*>(sc), out, n, k,
      out_f32);
}

template <bool kSub>
int dispatch(const void* x, const void* q, const void* d, const void* sc, void* out,
             int m, int n, int k, int out_f32, void* stream) {
  const int granule = kSub ? 256 : 32;  // K multiple of the planes
  if (m < 1 || m > 8 || n < 1 || k < granule || k % granule != 0 ||
      (kSub && sc == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: launch<1, kSub>(x, q, d, sc, out, n, k, out_f32, st); break;
    case 2: launch<2, kSub>(x, q, d, sc, out, n, k, out_f32, st); break;
    case 3: launch<3, kSub>(x, q, d, sc, out, n, k, out_f32, st); break;
    case 4: launch<4, kSub>(x, q, d, sc, out, n, k, out_f32, st); break;
    case 5: launch<5, kSub>(x, q, d, sc, out, n, k, out_f32, st); break;
    case 6: launch<6, kSub>(x, q, d, sc, out, n, k, out_f32, st); break;
    case 7: launch<7, kSub>(x, q, d, sc, out, n, k, out_f32, st); break;
    default: launch<8, kSub>(x, q, d, sc, out, n, k, out_f32, st); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One entry point per format, each returning cudaGetLastError() after the
// launch (0 = launched). The mn, dm and qh arguments (and sc but for
// IQ4_XS) keep the signature of the other kernels; the int8-plane formats
// have none of them, so they are unused.
#define INT8_GEMV_ENTRY(NAME, SUB)                                                  \
  extern "C" int NAME(const void* x, const void* q, const void* sc, const void* mn, \
                      const void* d, const void* dm, const void* qh, void* out,     \
                      int m, int n, int k, int out_f32, void* stream) {            \
    (void)mn;                                                                       \
    (void)dm;                                                                       \
    (void)qh;                                                                       \
    return dispatch<SUB>(x, q, d, SUB ? sc : nullptr, out, m, n, k, out_f32, stream); \
  }

INT8_GEMV_ENTRY(q8_0_gemv, false)
INT8_GEMV_ENTRY(iq4_nl_gemv, false)
INT8_GEMV_ENTRY(mxfp4_gemv, false)
INT8_GEMV_ENTRY(iq4_xs_gemv, true)
