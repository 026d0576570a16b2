// The pipelined mainloop of kernels B (q4k_gemm.cu), D (qgemm.cu) and I's
// prefill passes (qffn.cu):
//   out[m, n] = sum_k bf16(x)[m, k] * w[n, k]  (- side[m, n] for B),
// w a bf16 weight tile that the kernel's own staging function dequantises
// into shared memory, one 256-element K step (BK) at a time.
//
// Bound on the H100: at prefill M (9..512) the weight bytes (0.56-1.13 B
// per element) and the bf16 tensor-core work (2M operations per element)
// are of one order, and the dequantisation costs ALU work and a load
// latency per tile on top, so the three have to overlap and every SM has
// to be busy:
// - work units: one 64 x 64 output tile (BM x BN) and one of `splits`
//   even ranges of its K steps. The caller picks `splits`
//   (dequant_matmul.gemm_splits) so that the busiest SM is done soonest,
//   which splits K where the tiles are fewer than the SMs. A persistent
//   grid of min(units, SMs) blocks walks the units, so a block's ring runs
//   on from one unit into the next;
// - a block has three warp groups of 128 threads: two producers and one
//   consumer. Producer g stages the block's steps i with i % 2 == g into
//   ring slot i % kStages: the x tile [64, 256] by cp.async (rows past M
//   and chunks past K zero), B's x group sums of the step, and the weight
//   tile through the format's staging function, which takes the
//   group-local thread index and no block-wide barrier (qstage.cuh,
//   unchanged, and B's centered staging). Two tiles are staged at once
//   while the consumer multiplies a third;
// - the consumer warp group runs the products: ldmatrix and
//   mma.sync.m16n8k16 (bf16 in, f32 out), each warp a 32 x 32 sub-tile.
//   Full and empty mbarriers per slot hand the slots back and forth; no
//   __syncthreads after the set-up;
// - the law of accumulation: each step's products are summed by the
//   tensor cores in fresh f32 accumulators and added to the running sums
//   with IEEE f32 adds (the tensor cores' own accumulation is not rounded
//   to nearest: chained over all of K it flipped 25x more bf16 outputs);
//   B's side dot sum_g xs[m, g] * res[n, g] of the step is subtracted from
//   the step's products in f32 before that add, in the consumer's
//   registers;
// - with one split the consumer stores the output tile straight from its
//   registers, masked at the ragged M and N edges; with more, each split
//   stores f32 partials [splits, M, N] into the caller's workspace, and a
//   second launch sums them in split order with IEEE adds and casts once
//   (no atomics: the same bits from run to run);
// - 64-bit offsets throughout (the head's Q6_K plane is 621.6 MB).
// Shared memory: three slots of (x tile, weight tile[, B's 64 x 8 x sums
// and residuals]), 202,752 or 215,040 bytes: one block per SM.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qstage.cuh"

namespace qmma {

using qstage::BK;
using qstage::BN;
using qstage::LD;
using qstage::kThreads;

constexpr int BM = 64;                          // rows of x per tile
constexpr int kProducers = 2;                   // producer warp groups
constexpr int kStages = 3;                      // ring slots
constexpr int kBlock = (kProducers + 1) * kThreads;
constexpr int kGroups = BK / 32;                // 32-element groups per step (B's side term)
constexpr int kXLoads = BM * (BK / 8) / kThreads;  // x chunks per producer thread
constexpr size_t kTileBytes = (size_t)BM * LD * sizeof(__nv_bfloat16);
static_assert(BM == BN && kXLoads * kThreads == BM * (BK / 8), "tile shapes");
static_assert(BM * kGroups / 4 == kThreads, "one 16-byte x-sum chunk per producer thread");

template <bool kSide>
__host__ __device__ constexpr size_t stage_bytes() {
  return 2 * kTileBytes + (kSide ? (size_t)(BM + BN) * kGroups * sizeof(float) : 0);
}
template <bool kSide>
__host__ __device__ constexpr size_t smem_bytes() {
  return kStages * stage_bytes<kSide>() + 2 * kStages * sizeof(uint64_t);
}

struct Problem {
  const __nv_bfloat16* x;  // [M, K]
  const float* xs;         // [M, K/32] f32 group sums of x (B's side term), else null
  void* out;               // [M, N], f32 where out_f32, else bf16
  float* part;             // [splits, M, N] f32 partials where splits > 1
  int M, N, K, splits, out_f32;
};

__host__ __device__ constexpr int n_steps(int K) { return (K + BK - 1) / BK; }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// release: this thread's earlier shared-memory writes (and cp.async copies
// it has waited for) are seen by a thread whose wait sees the phase end
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// acquire: wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The block's view of work unit u: its output tile and its K steps [s0, s1).
struct Unit {
  int m0, n0, z, s0, s1;
};
__device__ __forceinline__ Unit unit_at(int u, int m_tiles, int splits, int steps) {
  // M tiles of one weight tile are neighbours, so their blocks share its
  // bytes in the L2
  const int mt = u % m_tiles, rest = u / m_tiles;
  const int z = rest % splits, nt = rest / splits;
  return Unit{mt * BM, nt * BN, z, (int)((long long)z * steps / splits),
              (int)((long long)(z + 1) * steps / splits)};
}

// Stager: a weight tile's staging, with members
//   qstage::Planes p; int N, K;
//   void operator()(bf16* w_tile, float* residual [BN][kGroups], int n0,
//                   int s, int tid) const;  (tid 0..kThreads-1)
// kSide: B's side term (x group sums and the residual per step).
template <bool kSide, class Stager>
__global__ void __launch_bounds__(kBlock, 1) qmma_kernel(Problem pr, Stager stage) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * stage_bytes<kSide>());
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, kThreads);   // one producer group's arrivals
      mbar_init(empty + i, kThreads);  // the consumer group's
    }
  }
  __syncthreads();

  const int M = pr.M, N = pr.N, K = pr.K, splits = pr.splits;
  const int m_tiles = (M + BM - 1) / BM, steps = n_steps(K);
  const int units = (N + BN - 1) / BN * m_tiles * splits;
  const int group = tid / kThreads, gtid = tid % kThreads;
  int i = 0;  // the block's running step count: ring slot i % kStages

  if (group < kProducers) {
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_at(u, m_tiles, splits, steps);
      for (int s = w.s0; s < w.s1; ++s, ++i) {
        if (i % kProducers != group) continue;
        const int slot = i % kStages;
        if (i >= kStages) mbar_wait(empty + slot, (unsigned)((i / kStages - 1) & 1));
        unsigned char* st = smem + slot * stage_bytes<kSide>();
        __nv_bfloat16* xt = reinterpret_cast<__nv_bfloat16*>(st);
        __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(st + kTileBytes);
        float* xsum = reinterpret_cast<float*>(st + 2 * kTileBytes);  // [BM][kGroups]
        float* res = xsum + BM * kGroups;                              // [BN][kGroups]
        // x tile (BM rows x 32 chunks of 8 bf16), rows past M and chunks
        // past K zero-filled
#pragma unroll
        for (int j = 0; j < kXLoads; ++j) {
          const int idx = gtid + kThreads * j;
          const int r = idx >> 5, c = idx & 31;
          const bool live = w.m0 + r < M && s * BK + c * 8 < K;
          const __nv_bfloat16* src =
              pr.x + (live ? (size_t)(w.m0 + r) * K + (size_t)s * BK + c * 8 : 0);
          qstage::cp_async16(xt + r * LD + c * 8, src, live);
        }
        if constexpr (kSide) {  // the step's x group sums: 64 rows x 2 chunks of 4
          const int r = gtid >> 1, h = gtid & 1;
          const bool live = w.m0 + r < M;
          const float* src =
              pr.xs + (live ? (size_t)(w.m0 + r) * (K / 32) + (size_t)s * kGroups + h * 4 : 0);
          qstage::cp_async16(xsum + r * kGroups + h * 4, src, live);
        }
        qstage::cp_async_commit();
        stage(wt, res, w.n0, s, gtid);
        qstage::cp_async_wait_all();
        mbar_arrive(full + slot);
      }
    }
    return;
  }

  // ---- the consumer warp group ---------------------------------------------
  const int warp = gtid >> 5, lane = gtid & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  // ldmatrix rows: A (x) 16 x 16 tiles, lanes 0-15 rows at k, 16-31 at k + 8;
  // B (w, [n][k]) 16 x 16 tiles as two n8 fragments: lanes 0-7 n 0-7 at k,
  // 8-15 n 0-7 at k + 8, 16-23 n 8-15 at k, 24-31 n 8-15 at k + 8
  const int a_off = (wm + (lane & 15)) * LD + (lane >> 4) * 8;
  const int b_off = (wn + (lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const int fr = lane >> 2, fc = 2 * (lane & 3);  // accumulator fragment row, column
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = unit_at(u, m_tiles, splits, steps);
    float acc[2][4][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;
    for (int s = w.s0; s < w.s1; ++s, ++i) {
      const int slot = i % kStages;
      mbar_wait(full + slot, (unsigned)((i / kStages) & 1));
      const unsigned char* st = smem + slot * stage_bytes<kSide>();
      const __nv_bfloat16* xt = reinterpret_cast<const __nv_bfloat16*>(st);
      const __nv_bfloat16* wt = reinterpret_cast<const __nv_bfloat16*>(st + kTileBytes);
      // this step's products in fresh accumulators
      float part[2][4][4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[a][b][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[2][4], bf[2][4];
        ldsm_x4(af[0], xt + a_off + kk);
        ldsm_x4(af[1], xt + a_off + 16 * LD + kk);
        ldsm_x4(bf[0], wt + b_off + kk);
        ldsm_x4(bf[1], wt + b_off + 16 * LD + kk);
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            mma_bf16(part[a][b], af[a], bf[b >> 1][(b & 1) * 2], bf[b >> 1][(b & 1) * 2 + 1]);
      }
      if constexpr (kSide) {
        // minus this step's side dot sum_g xs[m, g] * res[n, g], in f32
        const float* xsum = reinterpret_cast<const float*>(st + 2 * kTileBytes);
        const float* res = xsum + BM * kGroups;
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4* rp = reinterpret_cast<const float4*>(res + (wn + 8 * b + fc + e) * kGroups);
            const float4 r0 = rp[0], r1 = rp[1];
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float4* xp =
                    reinterpret_cast<const float4*>(xsum + (wm + 16 * a + fr + 8 * h) * kGroups);
                const float4 x0 = xp[0], x1 = xp[1];
                float v = x0.x * r0.x;
                v += x0.y * r0.y;
                v += x0.z * r0.z;
                v += x0.w * r0.w;
                v += x1.x * r1.x;
                v += x1.y * r1.y;
                v += x1.z * r1.z;
                v += x1.w * r1.w;
                part[a][b][2 * h + e] -= v;
              }
          }
      }
      mbar_arrive(empty + slot);  // every read of the slot is done
      // added to the running sums with IEEE f32 adds
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][b][e] += part[a][b][e];
    }
    // epilogue: straight from the registers, masked
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gm = w.m0 + wm + 16 * a + fr + 8 * (e >> 1);
          const int gn = w.n0 + wn + 8 * b + fc + (e & 1);
          if (gm < M && gn < N) {
            const float v = acc[a][b][e];
            const size_t o = (size_t)gm * N + gn;
            if (splits > 1)
              pr.part[(size_t)w.z * M * N + o] = v;
            else if (pr.out_f32)
              static_cast<float*>(pr.out)[o] = v;
            else
              static_cast<__nv_bfloat16*>(pr.out)[o] = __float2bfloat16(v);
          }
        }
  }
}

// The producer groups' staging of format QT (a GGML type id) for the
// mainloop: kernel D's law (qstage.cuh), used by kernels D and I. It lives
// in an unnamed namespace so that each library that includes this header
// instantiates the mainloop and `launch` for its own type: a static local
// of a template instantiated alike in two libraries is one GNU-unique
// symbol across the process, so the second library's `attr_set` would read
// true and its kernel would launch without its shared-memory attribute.
namespace {
template <int QT>
struct FormatStage {
  qstage::Planes p;
  int N, K;
  __device__ __forceinline__ void operator()(__nv_bfloat16* ws_t, float*, int n0, int s,
                                             int tid) const {
    qstage::stage_w<QT>(p, ws_t, n0, N, K, s, tid);
  }
};
}  // namespace

// out[i] = cast(part[0][i] + part[1][i] + ... + part[splits-1][i]), in order
__global__ void qmma_reduce(const float* __restrict__ part, void* __restrict__ out, int splits,
                            size_t mn, int out_f32) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = part[i];
  for (int c = 1; c < splits; ++c) s = __fadd_rn(s, part[(size_t)c * mn + i]);
  if (out_f32)
    static_cast<float*>(out)[i] = s;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(s);
}

// xs[i] = sum of the 32 bf16 of x's i-th 32-element group, in f32, in order
__global__ void qmma_group_sums(const __nv_bfloat16* __restrict__ x, float* __restrict__ xs,
                                size_t groups) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= groups) return;
  const uint4* src = reinterpret_cast<const uint4*>(x + i * 32);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint4 v = __ldg(src + c);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s += __uint_as_float(w[j] << 16);
      s += __uint_as_float(w[j] & 0xFFFF0000u);
    }
  }
  xs[i] = s;
}

// The f32 floats of the workspace a call needs: B's x group sums [M, K/32]
// (kSide), then the partials [splits, M, N] (splits > 1).
__host__ inline size_t workspace_floats(bool side, int m, int n, int k, int splits) {
  return (side ? (size_t)m * (k / 32) : 0) + (splits > 1 ? (size_t)splits * m * n : 0);
}

// Launch the mainloop (and B's group sums before it, the reduction after
// it) on `stream`; ws holds workspace_floats(kSide, ...) floats. Returns
// the first CUDA error (0 = launched).
template <bool kSide, class Stager>
int launch(const __nv_bfloat16* x, void* out, float* ws, int m, int n, int k, int splits,
           int out_f32, const Stager& stage, cudaStream_t stream) {
  if (splits < 1 || splits > n_steps(k) ||
      (workspace_floats(kSide, m, n, k, splits) > 0 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(qmma_kernel<kSide, Stager>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem_bytes<kSide>());
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  Problem pr{x, kSide ? ws : nullptr, out, nullptr, m, n, k, splits, out_f32};
  if (splits > 1) pr.part = ws + (kSide ? (size_t)m * (k / 32) : 0);
  if constexpr (kSide) {
    const size_t groups = (size_t)m * (k / 32);
    qmma_group_sums<<<(unsigned)((groups + 255) / 256), 256, 0, stream>>>(x, ws, groups);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long units = (long long)((n + BN - 1) / BN) * ((m + BM - 1) / BM) * splits;
  if (units > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const int grid = (int)(units < sms ? units : sms);
  qmma_kernel<kSide, Stager><<<grid, kBlock, smem_bytes<kSide>(), stream>>>(pr, stage);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t mn = (size_t)m * n;
  qmma_reduce<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(pr.part, out, splits, mn, out_f32);
  return (int)cudaGetLastError();
}

}  // namespace qmma
