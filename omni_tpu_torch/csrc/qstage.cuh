// Kernel D's weight staging, shared by kernel D (qgemm.cu) and kernel I
// (qffn.cu): for each of the thirteen formats the JAX package keeps
// quantized, the device function that dequantises one weight tile of BN
// rows x BK elements of K (one 256-element superblock; for Q8_0, IQ4_NL and
// MXFP4 eight 32-blocks, ragged where K % 256 != 0) into shared memory as
// bf16, with `dequant_tile`'s law: each element formed in f32 and rounded
// once to bf16, the products, sums and differences one at a time (no fused
// multiply-add; the law per format is set out at the top of qgemm.cu).
// Each staging function is called by kThreads threads (tid 0..kThreads-1)
// and issues every global load of the tile before it uses any. Rows past N
// (and, on the int8 planes, chunks past K) are staged as zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kquant.cuh"

namespace qstage {

using kquant::Fmt;

// GGML type ids
constexpr int kQ4_0 = 2, kQ4_1 = 3, kQ5_0 = 6, kQ5_1 = 7, kQ8_0 = 8, kQ2K = 10, kQ3K = 11,
              kQ4K = 12, kQ5K = 13, kQ6K = 14, kIQ4NL = 20, kIQ4XS = 23, kMXFP4 = 39;
// the formats with an int8 value plane and one scale per 32 elements
constexpr bool int8_plane(int qt) { return qt == kQ8_0 || qt == kIQ4NL || qt == kMXFP4; }
// the halves-packed formats (kquant.cuh), and each one's Fmt
__host__ __device__ constexpr bool halves(int qt) {
  return qt == kQ4K || qt == kQ5K || qt == kQ4_0 || qt == kQ4_1 || qt == kQ5_0 || qt == kQ5_1;
}
__host__ __device__ constexpr Fmt fmt_of(int qt) {
  return qt == kQ5K    ? Fmt::kQ5K
         : qt == kQ4_0 ? Fmt::kQ4_0
         : qt == kQ4_1 ? Fmt::kQ4_1
         : qt == kQ5_0 ? Fmt::kQ5_0
         : qt == kQ5_1 ? Fmt::kQ5_1
                       : Fmt::kQ4K;
}
constexpr int BN = 64, BK = 256;  // rows and K elements of a staged weight tile
constexpr int LD = BK + 8;         // bf16 row pitch of the staged tiles
constexpr int kThreads = 128;      // threads that stage one tile

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  const unsigned dptr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dptr), "l"(src),
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

struct Planes {
  const void* q;
  const int8_t* sc;
  const int8_t* mn;
  const float* d;
  const float* dm;
  const uint8_t* qh;
};

// A halves-packed weight element from its value q and its group's (a, b):
// the K-quants' bf16(q * dl - ml) with (a, b) = (dl, ml); Q4_1 and Q5_1's
// q * d + m with (a, b) = (d, m); Q4_0 and Q5_0's (q - 8) * d and
// (q - 16) * d with a = d (dequant_tile's order in each).
template <Fmt F>
__device__ __forceinline__ float halves_weight(uint32_t q, float a, float b) {
  if constexpr (!kquant::legacy(F))
    return __fsub_rn(__fmul_rn((float)q, a), b);
  else if constexpr (kquant::added_min(F))
    return __fadd_rn(__fmul_rn((float)q, a), b);
  else
    return __fmul_rn(__fsub_rn((float)q, F == Fmt::kQ5_0 ? 16.f : 8.f), a);
}

// Halves-packed weight tile of superblock s (Q4_K, Q5_K and the legacy
// formats): BN rows x 8 chunks of 16 packed bytes; chunk c holds the low
// nibbles of elements 16c.. (group c/2) and the high nibbles of elements
// 128+16c.. (group 4+c/2), with the high bits of both for the five-bit
// formats. A K-quant's group scale is d * sc and min dm * mn, d and dm per
// superblock; a legacy format's d (and Q4_1/Q5_1's m) come per 32-group.
template <Fmt F>
__device__ __forceinline__ void stage_w_halves(const Planes& p, __nv_bfloat16* ws_t,
                                               int n0, int N, int K, int s, int tid) {
  constexpr int kLoads = BN * 8 / kThreads;
  const size_t half = (size_t)(K >> 1);
  const int n_groups = K >> 5, n_sb = K >> 8;
  uint4 qv[kLoads];
  float s0[kLoads][2], s1[kLoads][2];  // K-quants: d, dm; legacy: d, m per half
  int scv[kLoads][2], mnv[kLoads][2];
  uint2 hbv[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int idx = tid + kThreads * i;
    const int r = idx >> 3, c = idx & 7;
    const int gn = n0 + r;
    qv[i] = make_uint4(0, 0, 0, 0);
    s0[i][0] = s0[i][1] = s1[i][0] = s1[i][1] = 0.f;
    scv[i][0] = scv[i][1] = mnv[i][0] = mnv[i][1] = 0;
    hbv[i] = make_uint2(0u, 0u);
    if (gn < N) {
      hbv[i] = kquant::high_words<kquant::five_bit(F)>(p.qh, (size_t)gn * (K >> 3), s, c);
      const uint8_t* qrow = static_cast<const uint8_t*>(p.q) + (size_t)gn * half;
      qv[i] = __ldg(reinterpret_cast<const uint4*>(qrow + (size_t)s * 128) + c);
      const size_t g = (size_t)gn * n_groups + s * 8 + (c >> 1);
      if constexpr (kquant::legacy(F)) {
        s0[i][0] = __ldg(p.d + g);
        s0[i][1] = __ldg(p.d + g + 4);
        if constexpr (kquant::added_min(F)) {
          s1[i][0] = __ldg(p.dm + g);
          s1[i][1] = __ldg(p.dm + g + 4);
        }
      } else {
        s0[i][0] = s0[i][1] = __ldg(p.d + (size_t)gn * n_sb + s);
        s1[i][0] = s1[i][1] = __ldg(p.dm + (size_t)gn * n_sb + s);
        scv[i][0] = __ldg(p.sc + g);
        scv[i][1] = __ldg(p.sc + g + 4);
        mnv[i][0] = __ldg(p.mn + g);
        mnv[i][1] = __ldg(p.mn + g + 4);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int idx = tid + kThreads * i;
    const int r = idx >> 3, c = idx & 7;
    // rows past N have zero scales: zero weights
    float a_lo = s0[i][0], b_lo = s1[i][0], a_hi = s0[i][1], b_hi = s1[i][1];
    if constexpr (!kquant::legacy(F)) {
      a_lo = __fmul_rn(s0[i][0], (float)scv[i][0]);
      b_lo = __fmul_rn(s1[i][0], (float)mnv[i][0]);
      a_hi = __fmul_rn(s0[i][1], (float)scv[i][1]);
      b_hi = __fmul_rn(s1[i][1], (float)mnv[i][1]);
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
        lo[e] = pack_bf16(halves_weight<F>(w.x, a_lo, b_lo), halves_weight<F>(w.y, a_lo, b_lo));
        hi[e] = pack_bf16(halves_weight<F>(w.z, a_hi, b_hi), halves_weight<F>(w.w, a_hi, b_hi));
      }
      *reinterpret_cast<uint4*>(wrow + c * 16 + v * 8) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(wrow + 128 + c * 16 + v * 8) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
  }
}

// Q2_K (Q3_K where kQ3) weight tile of superblock s: BN rows x 4 chunks of
// 16 quarter bytes; byte i of chunk c holds, at shift 2j, element
// 64j + 16c + i of the superblock (group 4j + c), with Q3_K's high bit in
// bit i of the 16-bit word s*16 + 4j + c of the row's qh (element order).
template <bool kQ3>
__device__ __forceinline__ void stage_w_lowbit(const Planes& p, __nv_bfloat16* ws_t,
                                               int n0, int N, int K, int s, int tid) {
  constexpr int kLoads = BN * 4 / kThreads;
  const int n_groups = K >> 4, n_sb = K >> 8;
  uint4 qv[kLoads];
  float dsv[kLoads], dmsv[kLoads];
  int scv[kLoads][4], mnv[kLoads][4];
  uint32_t hbv[kLoads][4];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int idx = tid + kThreads * i;
    const int r = idx >> 2, c = idx & 3;
    const int gn = n0 + r;
    qv[i] = make_uint4(0, 0, 0, 0);
    dsv[i] = dmsv[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) scv[i][j] = mnv[i][j] = 0, hbv[i][j] = 0u;
    if (gn < N) {
      const uint8_t* qrow = static_cast<const uint8_t*>(p.q) + (size_t)gn * (K >> 2);
      qv[i] = __ldg(reinterpret_cast<const uint4*>(qrow + (size_t)s * 64) + c);
      dsv[i] = __ldg(p.d + (size_t)gn * n_sb + s);
      if constexpr (!kQ3) dmsv[i] = __ldg(p.dm + (size_t)gn * n_sb + s);
      const size_t g = (size_t)gn * n_groups + s * 16 + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        scv[i][j] = __ldg(p.sc + g + 4 * j);
        if constexpr (kQ3)
          hbv[i][j] = __ldg(reinterpret_cast<const uint16_t*>(p.qh + (size_t)gn * (K >> 3)) +
                            s * 16 + 4 * j + c);
        else
          mnv[i][j] = __ldg(p.mn + g + 4 * j);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int idx = tid + kThreads * i;
    const int r = idx >> 2, c = idx & 3;
    const uint32_t w32[4] = {qv[i].x, qv[i].y, qv[i].z, qv[i].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // rows past N have d = dm = 0: zero weights
      const float dl = __fmul_rn(dsv[i], (float)scv[i][j]);
      const float ml = __fmul_rn(dmsv[i], (float)mnv[i][j]);
      uint32_t wv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {  // bytes 2e, 2e+1 of the chunk
        const uint32_t word = w32[e >> 1];
        const int sh = (e & 1) * 16;
        int v0 = (int)((word >> (sh + 2 * j)) & 3u);
        int v1 = (int)((word >> (sh + 8 + 2 * j)) & 3u);
        float w0, w1;
        if constexpr (kQ3) {
          v0 += 4 * (int)((hbv[i][j] >> (2 * e)) & 1u) - 4;
          v1 += 4 * (int)((hbv[i][j] >> (2 * e + 1)) & 1u) - 4;
          w0 = __fmul_rn((float)v0, dl);
          w1 = __fmul_rn((float)v1, dl);
        } else {
          w0 = __fsub_rn(__fmul_rn((float)v0, dl), ml);
          w1 = __fsub_rn(__fmul_rn((float)v1, dl), ml);
        }
        wv[e] = pack_bf16(w0, w1);
      }
      __nv_bfloat16* dst = ws_t + r * LD + 64 * j + 16 * c;
      *reinterpret_cast<uint4*>(dst) = make_uint4(wv[0], wv[1], wv[2], wv[3]);
      *reinterpret_cast<uint4*>(dst + 8) = make_uint4(wv[4], wv[5], wv[6], wv[7]);
    }
  }
}

// Q6_K weight tile of superblock s: BN rows x 16 chunks of 16 int8 values;
// chunk c is group s*16 + c, elements 16c.. of the superblock.
__device__ __forceinline__ void stage_w_q6k(const Planes& p, __nv_bfloat16* ws_t,
                                            int n0, int N, int K, int s, int tid) {
  constexpr int kLoads = BN * 16 / kThreads;
  const int n_groups = K >> 4, n_sb = K >> 8;
  uint4 qv[kLoads];
  float dsv[kLoads];
  int scv[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int idx = tid + kThreads * i;
    const int r = idx >> 4, c = idx & 15;
    const int gn = n0 + r;
    qv[i] = make_uint4(0, 0, 0, 0);
    dsv[i] = 0.f;
    scv[i] = 0;
    if (gn < N) {
      const int8_t* qrow = static_cast<const int8_t*>(p.q) + (size_t)gn * K;
      qv[i] = __ldg(reinterpret_cast<const uint4*>(qrow + (size_t)s * BK) + c);
      dsv[i] = __ldg(p.d + (size_t)gn * n_sb + s);
      scv[i] = __ldg(p.sc + (size_t)gn * n_groups + s * 16 + c);
    }
  }
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int idx = tid + kThreads * i;
    const int r = idx >> 4, c = idx & 15;
    const float dl = __fmul_rn(dsv[i], (float)scv[i]);  // 0 past N
    const uint32_t w32[4] = {qv[i].x, qv[i].y, qv[i].z, qv[i].w};
    uint32_t wv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t word = w32[e >> 1];
      const int sh = (e & 1) * 16;
      const float v0 = (float)(int8_t)((word >> sh) & 0xFFu);
      const float v1 = (float)(int8_t)((word >> (sh + 8)) & 0xFFu);
      wv[e] = pack_bf16(__fmul_rn(v0, dl), __fmul_rn(v1, dl));
    }
    __nv_bfloat16* dst = ws_t + r * LD + c * 16;
    *reinterpret_cast<uint4*>(dst) = make_uint4(wv[0], wv[1], wv[2], wv[3]);
    *reinterpret_cast<uint4*>(dst + 8) = make_uint4(wv[4], wv[5], wv[6], wv[7]);
  }
}

// Int8-plane weight tile of K step s: BN rows x 16 chunks of 16 int8
// values; chunk c is half of 32-group s*8 + c/2, elements s*256 + 16c...
// Chunks past K (K % 32 == 0, so a chunk is wholly in or out) and rows past
// N are zero. The group scale is d (Q8_0, IQ4_NL, MXFP4) or, kSub (IQ4_XS,
// K % 256 == 0), dl = d[superblock s] * sc[group], rounded once.
template <bool kSub>
__device__ __forceinline__ void stage_w_int8(const Planes& p, __nv_bfloat16* ws_t,
                                             int n0, int N, int K, int s, int tid) {
  constexpr int kLoads = BN * 16 / kThreads;
  const int n_groups = K >> 5;
  uint4 qv[kLoads];
  float dv[kLoads];
  int scv[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int idx = tid + kThreads * i;
    const int r = idx >> 4, c = idx & 15;
    const int gn = n0 + r;
    const int k0 = s * BK + c * 16;
    qv[i] = make_uint4(0, 0, 0, 0);
    dv[i] = 0.f;
    scv[i] = 0;
    if (gn < N && k0 < K) {
      const int8_t* qrow = static_cast<const int8_t*>(p.q) + (size_t)gn * K;
      qv[i] = __ldg(reinterpret_cast<const uint4*>(qrow + k0));
      if constexpr (kSub) {
        dv[i] = __ldg(p.d + (size_t)gn * (K >> 8) + s);
        scv[i] = __ldg(p.sc + (size_t)gn * n_groups + (k0 >> 5));
      } else {
        dv[i] = __ldg(p.d + (size_t)gn * n_groups + (k0 >> 5));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int idx = tid + kThreads * i;
    const int r = idx >> 4, c = idx & 15;
    if constexpr (kSub) dv[i] = __fmul_rn(dv[i], (float)scv[i]);  // 0 past N
    const uint32_t w32[4] = {qv[i].x, qv[i].y, qv[i].z, qv[i].w};
    uint32_t wv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t word = w32[e >> 1];
      const int sh = (e & 1) * 16;
      const float v0 = (float)(int8_t)((word >> sh) & 0xFFu);
      const float v1 = (float)(int8_t)((word >> (sh + 8)) & 0xFFu);
      wv[e] = pack_bf16(__fmul_rn(v0, dv[i]), __fmul_rn(v1, dv[i]));
    }
    __nv_bfloat16* dst = ws_t + r * LD + c * 16;
    *reinterpret_cast<uint4*>(dst) = make_uint4(wv[0], wv[1], wv[2], wv[3]);
    *reinterpret_cast<uint4*>(dst + 8) = make_uint4(wv[4], wv[5], wv[6], wv[7]);
  }
}

// The weight tile of K step s of format QT (a GGML type id), staged by the
// format's own device function.
template <int QT>
__device__ __forceinline__ void stage_w(const Planes& p, __nv_bfloat16* ws_t, int n0, int N,
                                        int K, int s, int tid) {
  if constexpr (halves(QT))
    stage_w_halves<fmt_of(QT)>(p, ws_t, n0, N, K, s, tid);
  else if constexpr (QT == kQ2K || QT == kQ3K)
    stage_w_lowbit<QT == kQ3K>(p, ws_t, n0, N, K, s, tid);
  else if constexpr (QT == kQ6K)
    stage_w_q6k(p, ws_t, n0, N, K, s, tid);
  else
    stage_w_int8<QT == kIQ4XS>(p, ws_t, n0, N, K, s, tid);
}

}  // namespace qstage
