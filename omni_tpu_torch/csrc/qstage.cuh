// The weight formula of each of the thirteen formats the JAX package keeps
// quantized (Q4_K, Q5_K, Q6_K, Q8_0, Q2_K, Q3_K, Q4_0, Q4_1, Q5_0, Q5_1,
// IQ4_NL, IQ4_XS, MXFP4), in one place: `dequant_tile`'s law, each element
// formed in f32 and rounded once to bf16, the products, sums and
// differences one at a time (no fused multiply-add; the law per format is
// set out at the top of qgemm.cu). A format's chunk type (below) loads 16
// bytes of a weight row and forms their weights; two users share it:
// - kernel D's staging (stage_w, used by kernels D and I through
//   qmma.cuh's mainloop): one weight tile of BN rows x BK elements of K
//   (one 256-element superblock; for Q8_0, IQ4_NL and MXFP4 eight
//   32-blocks, ragged where K % 256 != 0) dequantised into shared memory.
//   It is called by kThreads threads (tid 0..kThreads-1) and issues every
//   global load of the tile before it uses any. Rows past N (and, on the
//   planes of 32-element granule, chunks past K) are staged as zeros;
// - kernel I's register path at decode M (qffn.cu), which hands the
//   weights to the tensor cores straight from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "codebook.cuh"
#include "kquant.cuh"

namespace qstage {

using kquant::Fmt;

// GGML type ids
constexpr int kQ4_0 = 2, kQ4_1 = 3, kQ5_0 = 6, kQ5_1 = 7, kQ8_0 = 8, kQ2K = 10, kQ3K = 11,
              kQ4K = 12, kQ5K = 13, kQ6K = 14, kIQ4NL = 20, kIQ4XS = 23, kMXFP4 = 39;
// the K multiple of a format's planes: one scale per 32 elements (Q8_0,
// IQ4_NL, MXFP4) or per 256
__host__ __device__ constexpr int granule(int qt) {
  return qt == kQ8_0 || qt == kIQ4NL || qt == kMXFP4 ? 32 : 256;
}
// the codebook formats, whose q plane holds nibble indexes
__host__ __device__ constexpr bool codebook_fmt(int qt) {
  return qt == kIQ4NL || qt == kIQ4XS || qt == kMXFP4;
}
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

// The exact f32 of byte b of v, less `off`: the byte put under the
// exponent of 2^23 by one byte permute (the bits of 2^23 + byte), then
// 2^23 + off taken off, exactly (both are integers below 2^24). The same
// value as (float)byte - off, with no conversion instruction and the offset
// for free.
__device__ __forceinline__ float byte_float(uint32_t v, int b, float off = 0.f) {
  return __fsub_rn(__uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650u | b)),
                   8388608.f + off);
}

// A halves-packed weight element from its value q (less the legacy
// offset, exact) and its group's (a, b): the K-quants' bf16(q * dl - ml)
// with (a, b) = (dl, ml); Q4_1 and Q5_1's q * d + m with (a, b) = (d, m);
// Q4_0 and Q5_0's (q - 8) * d and (q - 16) * d with a = d (dequant_tile's
// order in each).
template <Fmt F>
constexpr float halves_offset = kquant::legacy(F) && !kquant::added_min(F)
                                    ? (F == Fmt::kQ5_0 ? 16.f : 8.f)
                                    : 0.f;
template <Fmt F>
__device__ __forceinline__ float halves_weight(float q, float a, float b) {
  if constexpr (!kquant::legacy(F))
    return __fsub_rn(__fmul_rn(q, a), b);
  else if constexpr (kquant::added_min(F))
    return __fadd_rn(__fmul_rn(q, a), b);
  else
    return __fmul_rn(q, a);
}

// ---- chunks: each format's weight formula, in one place --------------------
// A chunk is 16 bytes of a weight row's q plane and the scales they need.
// Each format's chunk type has
//   kPerStep      chunks per 256-element K step (BK) of a row;
//   kRuns         runs of 16 consecutive elements in a chunk;
//   offset(c, j)  the first element of run j of chunk c in its K step;
//   count(K)      the chunks of a row (K steps x kPerStep, or K / 16 and
//                 K / 32 for the planes of 32-element granule, whose last
//                 step may be ragged);
//   load(p, row, K, s, c, live)  every global load of chunk c of K step s
//                 of `row` (zeros where !live: zero weights);
//   run(j, w)     the bf16 weights of run j with dequant_tile's law, two to
//                 a word (elements 2e and 2e + 1 in w[e]).
// Kernel D's staging (stage_w below) writes the runs to shared memory;
// kernel I's register path (qffn.cu) hands them to the tensor cores from
// registers. The weights are formed by the same code in both, so the same
// bits.

// Halves-packed chunk (Q4_K, Q5_K and the legacy formats): chunk c of
// superblock s, bytes [16c, 16c + 16), holds the low nibbles of elements
// 16c.. (group c/2: run 0) and the high nibbles of elements 128+16c..
// (group 4+c/2: run 1), with the high bits of both for the five-bit formats
// (kquant.cuh). A K-quant's group scale is d * sc and min dm * mn, d and dm
// per superblock; a legacy format's d (and Q4_1/Q5_1's m) come per 32-group.
template <Fmt F>
struct HalvesChunk {
  static constexpr int kPerStep = 8, kRuns = 2;
  uint4 q;
  float s0[2], s1[2];  // K-quants: d, dm; legacy: d, m per half
  int sc[2], mn[2];
  uint2 hb;
  __device__ static int offset(int c, int j) { return j * 128 + c * 16; }
  __device__ static int count(int K) { return (K >> 8) * kPerStep; }
  __device__ __forceinline__ void load(const Planes& p, int row, int K, int s, int c, bool live) {
    q = make_uint4(0, 0, 0, 0);
    s0[0] = s0[1] = s1[0] = s1[1] = 0.f;
    sc[0] = sc[1] = mn[0] = mn[1] = 0;
    hb = make_uint2(0u, 0u);
    if (!live) return;
    const int n_groups = K >> 5, n_sb = K >> 8;
    hb = kquant::high_words<kquant::five_bit(F)>(p.qh, (size_t)row * (K >> 3), s, c);
    const uint8_t* qrow = static_cast<const uint8_t*>(p.q) + (size_t)row * (size_t)(K >> 1);
    q = __ldg(reinterpret_cast<const uint4*>(qrow + (size_t)s * 128) + c);
    const size_t g = (size_t)row * n_groups + s * 8 + (c >> 1);
    if constexpr (kquant::legacy(F)) {
      s0[0] = __ldg(p.d + g);
      s0[1] = __ldg(p.d + g + 4);
      if constexpr (kquant::added_min(F)) {
        s1[0] = __ldg(p.dm + g);
        s1[1] = __ldg(p.dm + g + 4);
      }
    } else {
      s0[0] = s0[1] = __ldg(p.d + (size_t)row * n_sb + s);
      s1[0] = s1[1] = __ldg(p.dm + (size_t)row * n_sb + s);
      sc[0] = __ldg(p.sc + g);
      sc[1] = __ldg(p.sc + g + 4);
      mn[0] = __ldg(p.mn + g);
      mn[1] = __ldg(p.mn + g + 4);
    }
  }
  __device__ __forceinline__ void run(int j, uint32_t (&w)[8]) const {
    float a = s0[j], b = s1[j];
    if constexpr (!kquant::legacy(F)) {
      a = __fmul_rn(s0[j], (float)sc[j]);
      b = __fmul_rn(s1[j], (float)mn[j]);
    }
    const uint32_t w32[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bytes 4i..4i+3 of the chunk: the run's nibbles, one a byte
      const uint32_t v = ((j == 0 ? w32[i] : w32[i] >> 4) & 0x0F0F0F0Fu) |
                         kquant::high_bytes<kquant::five_bit(F)>(hb, j, i);
      constexpr float off = halves_offset<F>;
      w[2 * i] = pack_bf16(halves_weight<F>(byte_float(v, 0, off), a, b),
                           halves_weight<F>(byte_float(v, 1, off), a, b));
      w[2 * i + 1] = pack_bf16(halves_weight<F>(byte_float(v, 2, off), a, b),
                               halves_weight<F>(byte_float(v, 3, off), a, b));
    }
  }
};

// Q2_K (Q3_K where kQ3) chunk c of superblock s: 16 quarter bytes; byte i
// holds, at shift 2j, element 64j + 16c + i of the superblock (group 4j + c:
// run j), with Q3_K's high bit in bit i of the 16-bit word s*16 + 4j + c of
// the row's qh (element order). Q2_K: bf16(q * dl - ml), q in 0..3; Q3_K:
// bf16(q * dl), q = quarter + 4 * hbit - 4; dl = d * sc, ml = dm * mn.
template <bool kQ3>
struct LowbitChunk {
  static constexpr int kPerStep = 4, kRuns = 4;
  uint4 q;
  float d, dm;
  int sc[4], mn[4];
  uint32_t hb[4];
  __device__ static int offset(int c, int j) { return 64 * j + 16 * c; }
  __device__ static int count(int K) { return (K >> 8) * kPerStep; }
  __device__ __forceinline__ void load(const Planes& p, int row, int K, int s, int c, bool live) {
    q = make_uint4(0, 0, 0, 0);
    d = dm = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[j] = mn[j] = 0, hb[j] = 0u;
    if (!live) return;
    const int n_groups = K >> 4, n_sb = K >> 8;
    const uint8_t* qrow = static_cast<const uint8_t*>(p.q) + (size_t)row * (K >> 2);
    q = __ldg(reinterpret_cast<const uint4*>(qrow + (size_t)s * 64) + c);
    d = __ldg(p.d + (size_t)row * n_sb + s);
    if constexpr (!kQ3) dm = __ldg(p.dm + (size_t)row * n_sb + s);
    const size_t g = (size_t)row * n_groups + s * 16 + c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sc[j] = __ldg(p.sc + g + 4 * j);
      if constexpr (kQ3)
        hb[j] = __ldg(reinterpret_cast<const uint16_t*>(p.qh + (size_t)row * (K >> 3)) +
                      s * 16 + 4 * j + c);
      else
        mn[j] = __ldg(p.mn + g + 4 * j);
    }
  }
  __device__ __forceinline__ void run(int j, uint32_t (&w)[8]) const {
    const float dl = __fmul_rn(d, (float)sc[j]);
    const float ml = __fmul_rn(dm, (float)mn[j]);
    const uint32_t w32[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bytes 4i..4i+3: the run's quarters, one a byte
      uint32_t v = (w32[i] >> (2 * j)) & 0x03030303u;
      if constexpr (kQ3)  // + 4 x the high bit (bit i of the field at bit 8i + 2), then - 4
        v |= (((hb[j] >> (4 * i)) & 0xFu) * 0x00810204u) & 0x04040404u;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        float w0, w1;
        if constexpr (kQ3) {
          w0 = __fmul_rn(byte_float(v, 2 * p, 4.f), dl);
          w1 = __fmul_rn(byte_float(v, 2 * p + 1, 4.f), dl);
        } else {
          w0 = __fsub_rn(__fmul_rn(byte_float(v, 2 * p), dl), ml);
          w1 = __fsub_rn(__fmul_rn(byte_float(v, 2 * p + 1), dl), ml);
        }
        w[2 * i + p] = pack_bf16(w0, w1);
      }
    }
  }
};

// 16 int8 values, elements 16c.. of K step s, times one f32 scale dl:
// bf16(q * dl). Q6_K (kQ6): dl = d[superblock] * sc[16-group], rounded
// once. Q8_0: dl = d[32-group]; chunks past K (K % 32 == 0, so a chunk is
// wholly in or out) are zero.
template <bool kQ6>
struct Int8Chunk {
  static constexpr int kPerStep = 16, kRuns = 1;
  uint4 q;
  float d;
  int sc;
  __device__ static int offset(int c, int) { return c * 16; }
  __device__ static int count(int K) { return K >> 4; }
  __device__ __forceinline__ void load(const Planes& p, int row, int K, int s, int c, bool live) {
    const int k0 = s * BK + c * 16;
    q = make_uint4(0, 0, 0, 0);
    d = 0.f;
    sc = 0;
    if (!live || k0 >= K) return;
    const int8_t* qrow = static_cast<const int8_t*>(p.q) + (size_t)row * K;
    q = __ldg(reinterpret_cast<const uint4*>(qrow + k0));
    if constexpr (kQ6) {
      d = __ldg(p.d + (size_t)row * (K >> 8) + s);
      sc = __ldg(p.sc + (size_t)row * (K >> 4) + s * 16 + c);
    } else {
      d = __ldg(p.d + (size_t)row * (K >> 5) + (k0 >> 5));
    }
  }
  __device__ __forceinline__ void run(int, uint32_t (&w)[8]) const {
    const float dl = kQ6 ? __fmul_rn(d, (float)sc) : d;
    const uint32_t w32[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t v = w32[i] ^ 0x80808080u;  // each int8 plus 128, one a byte
      w[2 * i] = pack_bf16(__fmul_rn(byte_float(v, 0, 128.f), dl),
                           __fmul_rn(byte_float(v, 1, 128.f), dl));
      w[2 * i + 1] = pack_bf16(__fmul_rn(byte_float(v, 2, 128.f), dl),
                               __fmul_rn(byte_float(v, 3, 128.f), dl));
    }
  }
};

// IQ4_NL, IQ4_XS or MXFP4 chunk c of K step s: one 32-group's 16 bytes of
// nibble indexes, byte i holding element 32c + i in its low nibble (run 0)
// and 32c + 16 + i in its high one (run 1), the value v the codebook's,
// times one f32 scale dl: bf16(v * dl), the product exact in f32 (v needs
// at most 7 bits, dl at most 17). dl = d[32-group] (IQ4_NL, MXFP4) or
// d[superblock] * sc[32-group] rounded once (IQ4_XS, K % 256 == 0); chunks
// past K (K % 32 == 0) are zero. The weights are looked up in the
// codebook scaled by dl (codebook.cuh: 16 products for the group's 32
// weights), both nibbles of a byte at once, so run(0) keeps run 1's
// weights for run(1): both callers take run 0 before run 1.
template <int QT>
struct CodebookChunk {
  static constexpr int kPerStep = 8, kRuns = 2;
  using Book = codebook::Codebook<QT == kMXFP4>;
  uint4 q;
  float d;
  int sc;
  mutable uint32_t high[8];  // run 1's weights, from run(0)
  __device__ static int offset(int c, int j) { return c * 32 + j * 16; }
  __device__ static int count(int K) { return K >> 5; }
  __device__ __forceinline__ void load(const Planes& p, int row, int K, int s, int c, bool live) {
    const int k0 = s * BK + c * 32;
    q = make_uint4(0, 0, 0, 0);
    d = 0.f;
    sc = 0;
    if (!live || k0 >= K) return;
    const uint8_t* qrow = static_cast<const uint8_t*>(p.q) + (size_t)row * (K >> 1);
    q = __ldg(reinterpret_cast<const uint4*>(qrow + (k0 >> 1)));
    if constexpr (QT == kIQ4XS) {
      d = __ldg(p.d + (size_t)row * (K >> 8) + s);
      sc = __ldg(p.sc + (size_t)row * (K >> 5) + (k0 >> 5));
    } else {
      d = __ldg(p.d + (size_t)row * (K >> 5) + (k0 >> 5));
    }
  }
  __device__ __forceinline__ void run(int j, uint32_t (&w)[8]) const {
    if (j == 0) {
      // IQ4_XS: (float)sc as 1.5 * 2^23 + sc less 1.5 * 2^23, exactly
      const codebook::Table t = codebook::scaled<QT == kMXFP4>(
          QT == kIQ4XS ? __fmul_rn(d, __int_as_float(0x4B400000 + sc) - 12582912.f) : d);
      const uint32_t w32[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // bytes 4i..4i+3: elements 4i..4i+3 of each run
        uint32_t lo[2], hi[2];
        codebook::word_pairs<Book::kLowRepeats>(t, w32[i], lo, hi);
        w[2 * i] = lo[0], w[2 * i + 1] = lo[1];
        high[2 * i] = hi[0], high[2 * i + 1] = hi[1];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) w[e] = high[e];
    }
  }
};

// The chunk type of format QT (a GGML type id)
template <int QT>
using Chunk = std::conditional_t<
    halves(QT), HalvesChunk<fmt_of(QT)>,
    std::conditional_t<QT == kQ2K || QT == kQ3K, LowbitChunk<QT == kQ3K>,
                       std::conditional_t<codebook_fmt(QT), CodebookChunk<QT>,
                                          Int8Chunk<QT == kQ6K>>>>;

// The weight tile of K step s of format QT: BN rows of C::kPerStep chunks,
// rows past N zero. Every global load of the tile is issued before any is
// used.
template <int QT>
__device__ __forceinline__ void stage_w(const Planes& p, __nv_bfloat16* ws_t, int n0, int N,
                                        int K, int s, int tid) {
  using C = Chunk<QT>;
  constexpr int kLoads = BN * C::kPerStep / kThreads;
  C ch[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int idx = tid + kThreads * i;
    const int r = idx / C::kPerStep;
    ch[i].load(p, n0 + r, K, s, idx % C::kPerStep, n0 + r < N);
  }
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int idx = tid + kThreads * i;
    const int r = idx / C::kPerStep, c = idx % C::kPerStep;
#pragma unroll
    for (int j = 0; j < C::kRuns; ++j) {
      uint32_t w[8];
      ch[i].run(j, w);
      __nv_bfloat16* dst = ws_t + r * LD + C::offset(c, j);
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<uint4*>(dst + 8) = make_uint4(w[4], w[5], w[6], w[7]);
    }
  }
}

}  // namespace qstage
