// q6k_gemv: out[m, n] = sum_k x[m, k] * W[n, k] for M = 1..8, W in Q6_K.
//
// Replaces omni_tpu/kernels/dequant_matmul.py::qmatmul_gp_pallas (:333) for
// Q6_K — the decode matmul of the Q6_K tensors of a Q4_K_M checkpoint
// (attn_v and ffn_down on the promoted layers, and the output head).
//
// Bound on the H100: device-memory bytes. Each weight element is read once
// (1 B of int8 value + 1/16 B of int8 scale + 1/64 B of f32 super scale)
// and used M <= 8 times, far below the ~295 operations per byte where the
// card turns compute-bound. The design streams the planes once:
// - one warp per output row, as kernel A (q4k_gemv.cu); each lane takes
//   16-byte loads of the int8 plane, neighbouring lanes on neighbouring
//   addresses; one load is one whole 16-element scale group;
// - the group law of the TPU kernel (_gp_slice, dequant_matmul.py:217-220):
//   P_g = sum over the group of bf16 x times the raw value q - 32, in f32,
//   then out = sum_g (d * sc)_g * P_g in f32 — no min term;
// - f32 accumulation per row, then a warp-shuffle reduction.
// The M <= 8 rows of x share one read of the weights; x (at most
// 8 x 12288 bf16) stays in L1/L2. At N = 1024 (attn_v) one warp per row
// fills only 128 blocks of 8 warps: the card is underfed there.
//
// Plane layout (N-major, the transpose of the JAX K-major planes): q int8
// [N, K] in element order, sc int8 [N, K/16], d f32 [N, K/256]. Offsets are
// 64-bit: the output head's q plane is 621.6 MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block

template <int M>
__global__ void __launch_bounds__(kWarps * 32)
q6k_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ q, const int8_t* __restrict__ sc,
                const float* __restrict__ d, void* __restrict__ out,
                int n_rows, int k, int out_f32) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int n_groups = k >> 4;
  const int8_t* qrow = q + (size_t)row * k;
  const int8_t* scrow = sc + (size_t)row * n_groups;
  const float* drow = d + (size_t)row * (k >> 8);

  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) acc[m] = 0.f;

  // group g = elements [16g, 16g + 16) = bytes [16g, 16g + 16) of the row
  for (int g = lane; g < n_groups; g += 32) {
    const float dl = __ldg(drow + (g >> 4)) * (float)__ldg(scrow + g);
    union {
      uint4 v;
      int8_t b[16];
    } pk;
    pk.v = __ldg(reinterpret_cast<const uint4*>(qrow) + g);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const uint4* xm = reinterpret_cast<const uint4*>(x + (size_t)m * k) + 2 * g;
      uint4 xv[2];  // the group's 16 bf16
      xv[0] = __ldg(xm);
      xv[1] = __ldg(xm + 1);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(xv);
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        p += f.x * (float)pk.b[2 * j] + f.y * (float)pk.b[2 * j + 1];
      }
      acc[m] += dl * p;
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
void launch(const void* x, const void* q, const void* sc, const void* d,
            void* out, int n, int k, int out_f32, cudaStream_t st) {
  const dim3 grid((n + kWarps - 1) / kWarps), block(kWarps * 32);
  q6k_gemv_kernel<M><<<grid, block, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const int8_t*>(sc), static_cast<const float*>(d), out, n, k,
      out_f32);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). The mn, dm and
// qh arguments keep the signature of the other kernels; Q6_K has no min
// and no high-bit plane, so they are unused.
extern "C" int q6k_gemv(const void* x, const void* q, const void* sc,
                        const void* mn, const void* d, const void* dm,
                        const void* qh, void* out, int m, int n, int k,
                        int out_f32, void* stream) {
  (void)mn;
  (void)dm;
  (void)qh;
  if (m < 1 || m > 8 || n < 1 || k < 256 || k % 256 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: launch<1>(x, q, sc, d, out, n, k, out_f32, st); break;
    case 2: launch<2>(x, q, sc, d, out, n, k, out_f32, st); break;
    case 3: launch<3>(x, q, sc, d, out, n, k, out_f32, st); break;
    case 4: launch<4>(x, q, sc, d, out, n, k, out_f32, st); break;
    case 5: launch<5>(x, q, sc, d, out, n, k, out_f32, st); break;
    case 6: launch<6>(x, q, sc, d, out, n, k, out_f32, st); break;
    case 7: launch<7>(x, q, sc, d, out, n, k, out_f32, st); break;
    default: launch<8>(x, q, sc, d, out, n, k, out_f32, st); break;
  }
  return (int)cudaGetLastError();
}
