// qffn (kernel I): the whole gated FFN of a layer in one call,
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
//   bf16 by kernel D's staging functions (qstage.cuh: dequant_tile's law);
// - g and u summed in f32 and never rounded; h = act(g) * u in f32, rounded
//   to bf16 once: act(g) = g * logistic(g) (SiLU) or jax.nn.gelu's tanh
//   form g * 0.5 * (1 + tanh(sqrt(2/pi) * (g + 0.044715 g^3))), each
//   product and sum rounded one at a time (no fused multiply-add), expf and
//   tanhf at full precision (no fast math);
// - the down product summed in f32 over all of F, cast once to the output
//   type. The [M, F] intermediate never leaves shared memory.
//
// Bound on the H100: the weight bytes (Qwen3-8B: 151 M elements a layer,
// 85 MB in Q4_K) at M = 1..64, where the bf16 work per weight byte stays far
// below the card's ~295 operations per byte. The TPU kernel walks F in
// order per M tile, carrying the down sum in VMEM; on the card that would
// leave one block busy at M = 1. This first version is simple and right
// rather than fast:
// - the grid runs over chunks of FC = 256 columns of F (blockIdx.x) and
//   tiles of 64 rows of x (blockIdx.y): 48 blocks at F = 12288 and M <= 64;
// - a block has four groups of four warps; each group stages its own weight
//   tile (64 rows x 256 of K, kernel D's staging) per K step, so four tiles
//   are in flight at once. Groups 0-1 run the gate and groups 2-3 the up
//   weight for two 64-column sub-tiles of the chunk, as 2 x 2 WMMA
//   m16n16k16 bf16 products per warp, each 16-deep product added to the
//   running f32 sums with an IEEE add (`warp_products`); two such rounds
//   cover the chunk. h = bf16(act(g) * u) of the chunk goes to shared
//   memory;
// - then the groups walk the down weight's row tiles, four at a time: the
//   tile of K step `chunk` (the chunk's 256 columns of F) is staged and
//   multiplied by h into an f32 partial [M, N] of this chunk, written to a
//   workspace [chunks, M, N];
// - a second launch sums the partials of each output in chunk order with
//   IEEE adds and casts: no atomics, so the result is the same bit for bit
//   from run to run.
// Rows past M are zero in x and so in h; gate/up rows past F (a ragged last
// chunk, possible only for the int8-plane formats) are staged as zeros, and
// so are the down columns past F. 202,752 bytes of dynamic shared memory (x,
// h and four weight tiles), one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "qstage.cuh"

namespace {

using namespace nvcuda;
using namespace qstage;

constexpr int BM = 64;                 // rows of x per block
constexpr int FC = BK;                 // columns of F per chunk: one K step of the down weight
constexpr int kGroups = 4;             // warp groups, each staging one weight tile
constexpr int kPairs = kGroups / 2;    // gate/up sub-tile pairs per round
constexpr int kRounds = FC / BN / kPairs;
constexpr int kBlock = kGroups * kThreads;
constexpr int LDC = BN + 4;  // f32 row pitch of the epilogue tiles
constexpr int kXLoads = BM * (BK / 8) / kBlock;  // x chunks per thread
constexpr size_t kTileBytes = (size_t)BM * LD * sizeof(__nv_bfloat16);
constexpr size_t kSmem = (2 + kGroups) * kTileBytes;  // x, h, the groups' weight tiles
static_assert(BM == BN && FC % (BN * kPairs) == 0 && kXLoads * kBlock == BM * (BK / 8),
              "tile shapes");
static_assert((size_t)BM * LDC * sizeof(float) <= kTileBytes, "epilogue tile");

using Frag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// The weight tile of K step s of a weight of format qt (a GGML type id,
// uniform over the block).
__device__ __forceinline__ void stage_any(int qt, const Planes& p, __nv_bfloat16* ws, int n0,
                                          int N, int K, int s, int tid) {
  switch (qt) {
    case kQ4K: stage_w<kQ4K>(p, ws, n0, N, K, s, tid); break;
    case kQ5K: stage_w<kQ5K>(p, ws, n0, N, K, s, tid); break;
    case kQ6K: stage_w<kQ6K>(p, ws, n0, N, K, s, tid); break;
    case kQ8_0: stage_w<kQ8_0>(p, ws, n0, N, K, s, tid); break;
    case kQ2K: stage_w<kQ2K>(p, ws, n0, N, K, s, tid); break;
    case kQ3K: stage_w<kQ3K>(p, ws, n0, N, K, s, tid); break;
    case kQ4_0: stage_w<kQ4_0>(p, ws, n0, N, K, s, tid); break;
    case kQ4_1: stage_w<kQ4_1>(p, ws, n0, N, K, s, tid); break;
    case kQ5_0: stage_w<kQ5_0>(p, ws, n0, N, K, s, tid); break;
    case kQ5_1: stage_w<kQ5_1>(p, ws, n0, N, K, s, tid); break;
    case kIQ4NL: stage_w<kIQ4NL>(p, ws, n0, N, K, s, tid); break;
    case kIQ4XS: stage_w<kIQ4XS>(p, ws, n0, N, K, s, tid); break;
    default: stage_w<kMXFP4>(p, ws, n0, N, K, s, tid); break;
  }
}

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

struct FfnArgs {
  const __nv_bfloat16* x;  // [M, K]
  Planes gate, up, down;   // gate and up: rows [0, F) and [F, 2F) of the fused weight
  float* part;             // [chunks, M, N]
  int M, K, F, N;
  int t_gu, t_dn, act;
};

// The 2 x 2 WMMA products of one warp over BK (one K step): a [32, BK] of
// `as` (row-major, rows wm..) times the [32, BK] rows wn.. of `bs`
// (transposed), added into `acc`. Each 16-deep product is formed in a fresh
// accumulator and added to `acc` with IEEE f32 adds, so g and u are f32 sums:
// the tensor cores' own accumulation truncates, and chained over a K step it
// left g and u far enough from the f32 law that h = bf16(act(g) * u)
// rounded otherwise more often than the plain version's, and each such h
// moves every output of its row (chip_smoke.py holds the share).
__device__ __forceinline__ void warp_products(const __nv_bfloat16* as, const __nv_bfloat16* bs,
                                              int wm, int wn, Frag (&acc)[2][2]) {
#pragma unroll 2
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], as + (wm + 16 * i) * LD + kk, LD);
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], bs + (wn + 16 * j) * LD + kk, LD);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        Frag part;
        wmma::fill_fragment(part, 0.f);
        wmma::mma_sync(part, a[i], b[j], part);
#pragma unroll
        for (int t = 0; t < part.num_elements; ++t) acc[i][j].x[t] += part.x[t];
      }
  }
}

__device__ __forceinline__ void store_tile(float* ct, int wm, int wn, const Frag (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(ct + (wm + 16 * i) * LDC + wn + 16 * j, acc[i][j], LDC,
                              wmma::mem_row_major);
}

__global__ void __launch_bounds__(kBlock, 1) qffn_kernel(const FfnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem + kTileBytes);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int grp = warp >> 2, gtid = tid & (kThreads - 1), gw = warp & 3;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + (2 + grp) * kTileBytes);
  float* ct = reinterpret_cast<float*>(ws);
  const int wm = (gw >> 1) * 32, wn = (gw & 1) * 32;
  const int chunk = blockIdx.x, f0 = chunk * FC;
  const int m0 = blockIdx.y * BM;
  const int k_steps = (a.K + BK - 1) / BK;  // whole superblocks but for the int8 planes
  const bool up = grp >= kPairs;

  // ---- h for the chunk: gate and up sub-tiles, kPairs per round ----------
  for (int r = 0; r < kRounds; ++r) {
    const int sub = r * kPairs + (grp % kPairs);
    Frag acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int s = 0; s < k_steps; ++s) {
      // x tile (BM rows x 32 chunks of 8 bf16), rows past M and chunks past
      // K zero-filled
#pragma unroll
      for (int i = 0; i < kXLoads; ++i) {
        const int idx = tid + kBlock * i;
        const int rr = idx >> 5, c = idx & 31;
        const bool live = m0 + rr < a.M && s * BK + c * 8 < a.K;
        const __nv_bfloat16* src =
            a.x + (live ? (size_t)(m0 + rr) * a.K + (size_t)s * BK + c * 8 : 0);
        cp_async16(xs + rr * LD + c * 8, src, live);
      }
      cp_async_commit();
      stage_any(a.t_gu, up ? a.up : a.gate, ws, f0 + sub * BN, a.F, a.K, s, gtid);
      cp_async_wait_all();
      __syncthreads();
      warp_products(xs, ws, wm, wn, acc);
      __syncthreads();
    }
    // g (groups 0..kPairs-1) and u (the others) to f32 tiles in the groups'
    // own weight buffers, then h for the round's sub-tiles
    store_tile(ct, wm, wn, acc);
    __syncthreads();
    for (int e = tid; e < kPairs * BM * BN; e += kBlock) {
      const int p = e / (BM * BN), rr = (e / BN) % BM, cc = e % BN;
      const float* gt = reinterpret_cast<const float*>(smem + (2 + p) * kTileBytes);
      const float* ut = reinterpret_cast<const float*>(smem + (2 + kPairs + p) * kTileBytes);
      const float h = gated(gt[rr * LDC + cc], ut[rr * LDC + cc], a.act);
      hs[rr * LD + (r * kPairs + p) * BN + cc] = __float2bfloat16_rn(h);
    }
    __syncthreads();
  }

  // ---- the chunk's down partial: h [BM, FC] x Wd[:, f0:f0+FC]^T ----------
  const int rows = min(BM, a.M - m0);
  const int n_tiles = (a.N + BN - 1) / BN;
  for (int t0 = 0; t0 < n_tiles; t0 += kGroups) {
    const int n0 = (t0 + grp) * BN;  // past N: zero weights, nothing stored
    stage_any(a.t_dn, a.down, ws, n0, a.N, a.F, chunk, gtid);
    __syncthreads();
    Frag acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    warp_products(hs, ws, wm, wn, acc);
    __syncthreads();  // every warp has read its group's weight tile
    store_tile(ct, wm, wn, acc);
    __syncthreads();
    for (int e = gtid; e < rows * BN; e += kThreads) {
      const int rr = e / BN, cc = e % BN;
      if (n0 + cc < a.N)
        a.part[((size_t)chunk * a.M + m0 + rr) * a.N + n0 + cc] = ct[rr * LDC + cc];
    }
    __syncthreads();
  }
}

// out[i] = cast(part[0][i] + part[1][i] + ... + part[chunks-1][i]), in order
__global__ void qffn_reduce(const float* __restrict__ part, void* __restrict__ out, int chunks,
                            size_t mn, int out_f32) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = part[i];
  for (int c = 1; c < chunks; ++c) s = __fadd_rn(s, part[(size_t)c * mn + i]);
  if (out_f32)
    static_cast<float*>(out)[i] = s;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(s);
}

bool known(int qt) {
  return qt == kQ4K || qt == kQ5K || qt == kQ6K || qt == kQ8_0 || qt == kQ2K || qt == kQ3K ||
         qt == kQ4_0 || qt == kQ4_1 || qt == kQ5_0 || qt == kQ5_1 || qt == kIQ4NL ||
         qt == kIQ4XS || qt == kMXFP4;
}

int granule(int qt) { return int8_plane(qt) ? 32 : 256; }

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

}  // namespace

// x [m, k] bf16; the gate, up and down planes (q, sc, mn, d, dm, qh each,
// null where the format has none; gate and up are rows [0, f) and [f, 2f)
// of the fused weight, of format t_gu; down [n, f] of format t_dn); part an
// f32 workspace of ceil(f / 256) x m x n; out [m, n] (f32 where out_f32,
// else bf16); act 0 = SiLU, 1 = tanh-GELU. Two launches on `stream`.
// Returns the first CUDA error of the attribute call or the launches (0 =
// launched).
extern "C" int qffn(const void* x, const void* g_q, const void* g_sc, const void* g_mn,
                    const void* g_d, const void* g_dm, const void* g_qh, const void* u_q,
                    const void* u_sc, const void* u_mn, const void* u_d, const void* u_dm,
                    const void* u_qh, const void* d_q, const void* d_sc, const void* d_mn,
                    const void* d_d, const void* d_dm, const void* d_qh, void* part, void* out,
                    int m, int k, int f, int n, int t_gu, int t_dn, int act, int out_f32,
                    void* stream) {
  FfnArgs a{static_cast<const __nv_bfloat16*>(x),
            planes(g_q, g_sc, g_mn, g_d, g_dm, g_qh),
            planes(u_q, u_sc, u_mn, u_d, u_dm, u_qh),
            planes(d_q, d_sc, d_mn, d_d, d_dm, d_qh),
            static_cast<float*>(part), m, k, f, n, t_gu, t_dn, act};
  if (!known(t_gu) || !known(t_dn) || m < 1 || n < 1 || f < 1 || k < granule(t_gu) ||
      k % granule(t_gu) != 0 || f % granule(t_gu) != 0 || f % granule(t_dn) != 0 ||
      (act != 0 && act != 1) || (m + BM - 1) / BM > 65535 || !planes_ok(t_gu, a.gate) ||
      !planes_ok(t_gu, a.up) || !planes_ok(t_dn, a.down) || x == nullptr || part == nullptr ||
      out == nullptr)
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        qffn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (f + FC - 1) / FC;
  qffn_kernel<<<dim3(chunks, (m + BM - 1) / BM), kBlock, kSmem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t mn = (size_t)m * n;
  qffn_reduce<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(a.part, out, chunks, mn, out_f32);
  return (int)cudaGetLastError();
}
