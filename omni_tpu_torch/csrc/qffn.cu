// qffn (kernel I): the whole gated FFN of a layer,
//   out = cast(sum_f h[m, f] * Wd[n, f]),  h = bf16(act(g) * u),
//   g = bf16(x) . Wg^T,  u = bf16(x) . Wu^T  (f32 sums),
// with the gate and up weights fused as one [2F, K] tensor (gate rows
// [0, F), up rows [F, 2F)) and the down weight [N, F]. The gate/up format
// and the down format are each any of the thirteen formats the JAX package
// keeps quantized (Q4_K, Q5_K, Q6_K, Q8_0, Q2_K, Q3_K, Q4_0, Q4_1, Q5_0,
// Q5_1, IQ4_NL, IQ4_XS, MXFP4), independently: the Q4_K_M recipe pairs
// Q4_K with Q6_K, llama.cpp's importance-matrix Q4_0 file Q4_0 with Q4_1.
//
// Replaces omni_tpu/kernels/fused_ffn.py::qffn_pallas (:80; body
// _make_kernel :32-75). The law is the TPU kernel's:
// - x rounded to bf16; every weight dequantised in f32 and rounded once to
//   bf16 by its format's weight formula (qstage.cuh: dequant_tile's law);
// - g and u summed in f32 and never rounded; h = act(g) * u in f32, rounded
//   to bf16 once: act(g) = g * logistic(g) (SiLU) or jax.nn.gelu's tanh
//   form g * 0.5 * (1 + tanh(sqrt(2/pi) * (g + 0.044715 g^3))), each
//   product and sum rounded one at a time (no fused multiply-add), expf and
//   tanhf at full precision (no fast math);
// - the down product summed in f32 over all of F, cast once to the output
//   type.
// h lives in device memory as bf16 [M, F] between two passes: that rounds
// it exactly as the law does.
//
// Bound on the H100: the weight bytes (Qwen3-8B: 151 M elements a layer,
// 85 MB in Q4_K, 25 us at 3.35 TB/s) at M = 1..64, where the bf16 work per
// weight byte stays far below the card's ~295 operations per byte. The TPU
// kernel walks F in order per M tile, carrying the down sum in VMEM; on the
// card that leaves most SMs idle, so the call is two passes, each of which
// fills the card, in one of two regimes (a plain branch on M):
//
// Decode, M <= 8 (kGemvMaxM, dequant_matmul.GP_MAX_M): a register-dequant
// GEMV in the shape of kernels A, C, E and H, with no shared-memory
// staging (at M = 1 a staged 64 x 256 tile costs an SM ~2 us against the
// ~0.36 us of its bytes):
// - a block owns 16 weight rows: in the gated pass the gate rows f0..f0+7
//   and the up rows F+f0..F+f0+7 of eight h columns (F / 8 blocks: 1,536
//   at F = 12288), in the down pass 16 output rows (N / 16 blocks); its
//   warps (4 and 8) share out the rows' 16-byte chunks, neighbouring lanes
//   on neighbouring chunks of a row, one or two chunks per row in flight
//   per lane (Shape);
// - each lane forms its chunks' bf16 weights in registers with the format's
//   chunk type (qstage.cuh, the same code as kernel D's staging) and hands
//   them, with the matching 16 bf16 of x, to mma.sync.m16n8k16: the 16 rows
//   are the MMA's M, the <= 8 rows of x its N, and the K order inside each
//   16-deep product is permuted alike in both operands (lane (g, t) takes
//   elements 4i..4i+3 of its run for product i, as columns 2t, 2t+1, 2t+8,
//   2t+9), so a product's sum is a sum over 16 distinct elements of K;
// - each 16-deep product is formed in a fresh f32 accumulator and added to
//   the running sums with IEEE f32 adds (the tensor cores' own chained
//   accumulation truncates: kernel I's chained products once flipped 5.6x
//   the bf16 outputs of its plain version); the warps' sums are added in
//   warp order through shared memory, so the result is the same bit for bit
//   from run to run;
// - the gated pass's lane then holds g and u of one h column for two rows
//   of x and writes h = bf16(act(g) * u) to the workspace; the down pass
//   sums over all of F in f32 and casts once: no f32 partials.
//
// Prefill, M > 8: qmma.cuh's pipelined mainloop (a persistent grid, two
// producer warp groups staging a three-slot ring with kernel D's staging,
// one consumer warp group on ldmatrix + mma.sync, fresh f32 accumulators
// per 256-element step added with IEEE adds, split partials summed in split
// order), unchanged and shared with kernels B and D:
// - the gate/up pass runs it over the fused [2F, K] weight with f32 output
//   g|u [M, 2F] (never rounded), and a small elementwise pass writes
//   h = bf16(act(g) * u). (An epilogue that held the gate and up tiles of
//   the same 64 columns in one unit would need two weight tiles per ring
//   slot, ~100 KB, leaving room for two slots; the f32 round trip of g|u
//   costs ~6 MB of traffic at M = 64, a few microseconds.)
// - the down pass runs it over h [M, F] as x against the down weight.
// Both take their split counts from dequant_matmul.gemm_splits.
//
// The workspace (bytes, 16-byte aligned, laid out by qffn_plan in
// kernels/fused_ffn.py): h bf16 [M, F] at 0; on prefill g|u f32 [M, 2F] at
// 2MF, then the split partials of whichever pass has more than one split
// (the passes run one after the other on the stream, so they share it).
// Rows past M are zero in x and are not written; gate/up rows past F and
// down rows past N are zero weights. Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "qmma.cuh"

namespace {

using namespace qstage;

constexpr int kGemvMaxM = 8;  // decode rows: the N of mma.m16n8k16

// The decode passes' launch shape per format, from a sweep on the card
// (`python -m omni_tpu_torch.qffn_shape_probe`). The chunks of one scale (Q8_0, Q6_K
// and the codebook formats) are light enough in registers for a lane to keep two chunks of each
// row in flight; the halves-packed and low-bit chunks keep one, with more
// blocks per SM instead. The blocks per SM set the register budget
// (__launch_bounds__: 65,536 / (threads x blocks) registers a thread).
template <int QT>
struct Shape {
  static constexpr bool kLight =
      QT == kQ8_0 || QT == kIQ4NL || QT == kIQ4XS || QT == kMXFP4 || QT == kQ6K;
  static constexpr int kU = kLight ? 2 : 1;  // chunks of each row a lane loads before using any
  __host__ __device__ static constexpr int warps(bool gated) { return gated ? 4 : 8; }
  __host__ __device__ static constexpr int blocks(bool gated) {
    return gated ? (kLight ? 4 : 5) : 2;
  }
};

// act(g) * u in f32, one rounding per operation: act 0 is SiLU (jax.nn.silu,
// g * logistic(g)), 1 the tanh form of GELU (jax.nn.gelu(approximate=True))
__device__ __forceinline__ float gated(float g, float u, int act) {
  float a;
  if (act == 0) {
    a = __fmul_rn(g, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-g))));
  } else {
    const float g3 = __fmul_rn(__fmul_rn(g, g), g);
    const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(g, __fmul_rn(0.044715f, g3)));
    a = __fmul_rn(g, __fmul_rn(0.5f, __fadd_rn(1.f, tanhf(inner))));
  }
  return __fmul_rn(a, u);
}

// One decode pass: x [M, K] (M <= 8) against 16 weight rows per block.
struct RowPass {
  const __nv_bfloat16* x;  // the gated pass: x; the down pass: h
  Planes w;                // the fused gate/up weight, or the down weight
  void* out;               // the gated pass: h bf16 [M, F]; the down pass: out [M, N]
  int M, K, N;             // N: the gated pass's F, the down pass's N
  int act, out_f32;
};

// kGated: block b's rows are gate rows 8b + g and up rows F + 8b + g
// (g = 0..7), and it writes h columns 8b..8b+7; else rows 16b + g and
// 16b + 8 + g of the down weight, and it writes those outputs.
template <int QT, bool kGated>
__global__ void __launch_bounds__(Shape<QT>::warps(kGated) * 32, Shape<QT>::blocks(kGated))
    rows_kernel(const RowPass a) {
  using C = Chunk<QT>;
  constexpr int kWarps = Shape<QT>::warps(kGated), kU = Shape<QT>::kU;
  __shared__ float red[kWarps - 1][32][4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // the MMA's group and thread in group
  const int r0 = blockIdx.x * (kGated ? 8 : 16) + g;
  const int row_lo = r0, row_hi = kGated ? a.N + r0 : r0 + 8;
  const bool live_lo = r0 < a.N, live_hi = kGated ? live_lo : r0 + 8 < a.N;
  const bool x_live = g < a.M;  // lane g feeds row g of x as the MMA's column g
  const __nv_bfloat16* xg = a.x + (size_t)(x_live ? g : 0) * a.K;
  const int n_chunks = C::count(a.K);

  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // rows lo, hi x rows 2t, 2t + 1 of x
  for (int base = warp * 4 * kU; base < n_chunks; base += kWarps * 4 * kU) {
    C lo[kU], hi[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int cl = base + 4 * u + t;
      const int s = cl / C::kPerStep, c = cl % C::kPerStep;
      lo[u].load(a.w, row_lo, a.K, s, c, cl < n_chunks && live_lo);
      hi[u].load(a.w, row_hi, a.K, s, c, cl < n_chunks && live_hi);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int cl = base + 4 * u + t;
      const int s = cl / C::kPerStep, c = cl % C::kPerStep;
      const bool xl = x_live && cl < n_chunks;
#pragma unroll
      for (int j = 0; j < C::kRuns; ++j) {
        uint4 xv[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
        if (xl) {
          const uint4* xp =
              reinterpret_cast<const uint4*>(xg + (size_t)s * BK + C::offset(c, j));
          xv[0] = __ldg(xp);
          xv[1] = __ldg(xp + 1);
        }
        uint32_t wl[8], wh[8];
        lo[u].run(j, wl);
        hi[u].run(j, wh);
        const uint32_t xw[8] = {xv[0].x, xv[0].y, xv[0].z, xv[0].w,
                                xv[1].x, xv[1].y, xv[1].z, xv[1].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // elements 4i..4i+3 of the run
          const uint32_t af[4] = {wl[2 * i], wh[2 * i], wl[2 * i + 1], wh[2 * i + 1]};
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          qmma::mma_bf16(part, af, xw[2 * i], xw[2 * i + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], part[e]);
        }
      }
    }
  }
  // the warps' sums, added in warp order
  if (warp > 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp - 1][lane][e] = acc[e];
  }
  __syncthreads();
  if (warp > 0) return;
#pragma unroll
  for (int w = 0; w < kWarps - 1; ++w)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], red[w][lane][e]);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int m = 2 * t + e;
    if (m >= a.M) continue;
    if constexpr (kGated) {
      if (live_lo)
        static_cast<__nv_bfloat16*>(a.out)[(size_t)m * a.N + r0] =
            __float2bfloat16_rn(gated(acc[e], acc[2 + e], a.act));
    } else {
      const float v[2] = {acc[e], acc[2 + e]};
      const bool live[2] = {live_lo, live_hi};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!live[h]) continue;
        const size_t o = (size_t)m * a.N + r0 + 8 * h;
        if (a.out_f32)
          static_cast<float*>(a.out)[o] = v[h];
        else
          static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(v[h]);
      }
    }
  }
}

// h[m, f] = bf16(act(gu[m, f]) * gu[m, F + f]) (the prefill gated pass)
__global__ void gated_kernel(const float* __restrict__ gu, __nv_bfloat16* __restrict__ h, int M,
                             int F, int act) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * F) return;
  const size_t m = i / F, f = i % F;
  h[i] = __float2bfloat16_rn(gated(gu[m * 2 * F + f], gu[m * 2 * F + F + f], act));
}

bool known(int qt) {
  return qt == kQ4K || qt == kQ5K || qt == kQ6K || qt == kQ8_0 || qt == kQ2K || qt == kQ3K ||
         qt == kQ4_0 || qt == kQ4_1 || qt == kQ5_0 || qt == kQ5_1 || qt == kIQ4NL ||
         qt == kIQ4XS || qt == kMXFP4;
}

// every plane format qt reads is there (qformats.plane_specs)
bool planes_ok(int qt, const Planes& p) {
  const bool kq = qt == kQ4K || qt == kQ5K;
  const bool sc = kq || qt == kQ6K || qt == kQ2K || qt == kQ3K || qt == kIQ4XS;
  const bool mn = kq || qt == kQ2K;
  const bool dm = kq || qt == kQ2K || qt == kQ4_1 || qt == kQ5_1;
  const bool qh = qt == kQ5K || qt == kQ3K || qt == kQ5_0 || qt == kQ5_1;
  return p.q && p.d && (!sc || p.sc) && (!mn || p.mn) && (!dm || p.dm) && (!qh || p.qh);
}

Planes planes(const void* q, const void* sc, const void* mn, const void* d, const void* dm,
              const void* qh) {
  return Planes{q, static_cast<const int8_t*>(sc), static_cast<const int8_t*>(mn),
                static_cast<const float*>(d), static_cast<const float*>(dm),
                static_cast<const uint8_t*>(qh)};
}

// fn(std::integral_constant<int, QT>{}) for format qt
template <class Fn>
int by_format(int qt, Fn&& fn) {
  switch (qt) {
    case kQ4K: return fn(std::integral_constant<int, kQ4K>{});
    case kQ5K: return fn(std::integral_constant<int, kQ5K>{});
    case kQ6K: return fn(std::integral_constant<int, kQ6K>{});
    case kQ8_0: return fn(std::integral_constant<int, kQ8_0>{});
    case kQ2K: return fn(std::integral_constant<int, kQ2K>{});
    case kQ3K: return fn(std::integral_constant<int, kQ3K>{});
    case kQ4_0: return fn(std::integral_constant<int, kQ4_0>{});
    case kQ4_1: return fn(std::integral_constant<int, kQ4_1>{});
    case kQ5_0: return fn(std::integral_constant<int, kQ5_0>{});
    case kQ5_1: return fn(std::integral_constant<int, kQ5_1>{});
    case kIQ4NL: return fn(std::integral_constant<int, kIQ4NL>{});
    case kIQ4XS: return fn(std::integral_constant<int, kIQ4XS>{});
    case kMXFP4: return fn(std::integral_constant<int, kMXFP4>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// the workspace's g|u [M, 2F] (prefill) and the split partials after it
float* gu_area(void* ws, int m, int f) {
  return reinterpret_cast<float*>(static_cast<unsigned char*>(ws) + (size_t)2 * m * f);
}
float* part_area(void* ws, int m, int f) { return gu_area(ws, m, f) + (size_t)2 * m * f; }

}  // namespace

// The gated pass: h = bf16(act(x . Wg^T) * (x . Wu^T)) into the workspace.
// x [m, k] bf16; the fused gate/up weight [2f, k] of format qtype (planes
// q, sc, mn, d, dm, qh, null where the format has none; up is rows
// [f, 2f)); ws the workspace (fused_ffn.qffn_plan); act 0 = SiLU, 1 =
// tanh-GELU; splits the mainloop's split count of a [m, k] x [2f, k]
// product (prefill, m > 8; unused at m <= 8). Returns the first CUDA error
// of the launches (0 = launched).
extern "C" int qffn_gated(const void* x, const void* q, const void* sc, const void* mn,
                          const void* d, const void* dm, const void* qh, void* ws, int m, int k,
                          int f, int qtype, int act, int splits, void* stream) {
  const Planes p = planes(q, sc, mn, d, dm, qh);
  if (!known(qtype) || m < 1 || f < 1 || f % 32 != 0 || k < granule(qtype) ||
      k % granule(qtype) != 0 || (act != 0 && act != 1) || !planes_ok(qtype, p) ||
      x == nullptr || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* h = static_cast<__nv_bfloat16*>(ws);
  return by_format(qtype, [&](auto fmt) {
    constexpr int QT = decltype(fmt)::value;
    if (m <= kGemvMaxM) {
      rows_kernel<QT, true><<<(f + 7) / 8, Shape<QT>::warps(true) * 32, 0, st>>>(
          RowPass{xb, p, h, m, k, f, act, 0});
      return (int)cudaGetLastError();
    }
    float* gu = gu_area(ws, m, f);
    const int e = qmma::launch<false>(xb, gu, part_area(ws, m, f), m, 2 * f, k, splits, 1,
                                      qmma::FormatStage<QT>{p, 2 * f, k}, st);
    if (e != 0) return e;
    const size_t mf = (size_t)m * f;
    gated_kernel<<<(unsigned)((mf + 255) / 256), 256, 0, st>>>(gu, h, m, f, act);
    return (int)cudaGetLastError();
  });
}

// The down pass: out = cast(h . Wd^T), h bf16 [m, f] from the workspace
// (written by qffn_gated with the same m and f); the down weight [n, f] of
// format qtype (six planes as above); out [m, n], f32 where out_f32, else
// bf16; splits the mainloop's split count of a [m, f] x [n, f] product
// (prefill; unused at m <= 8). Returns the first CUDA error of the
// launches (0 = launched).
extern "C" int qffn_down(void* ws, const void* q, const void* sc, const void* mn, const void* d,
                         const void* dm, const void* qh, void* out, int m, int f, int n,
                         int qtype, int out_f32, int splits, void* stream) {
  const Planes p = planes(q, sc, mn, d, dm, qh);
  if (!known(qtype) || m < 1 || n < 1 || f < granule(qtype) || f % granule(qtype) != 0 ||
      !planes_ok(qtype, p) || ws == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* h = static_cast<const __nv_bfloat16*>(ws);
  return by_format(qtype, [&](auto fmt) {
    constexpr int QT = decltype(fmt)::value;
    if (m <= kGemvMaxM) {
      rows_kernel<QT, false><<<(n + 15) / 16, Shape<QT>::warps(false) * 32, 0, st>>>(
          RowPass{h, p, out, m, f, n, 0, out_f32});
      return (int)cudaGetLastError();
    }
    return qmma::launch<false>(h, out, part_area(ws, m, f), m, n, f, splits, out_f32,
                               qmma::FormatStage<QT>{p, n, f}, st);
  });
}
