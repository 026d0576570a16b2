// q4k_gemv (kernel A), q5k_gemv (kernel G) and A's legacy branches
// q4_0_gemv, q4_1_gemv, q5_0_gemv, q5_1_gemv: out[m, n] = sum_k x[m, k] *
// W[n, k] for M = 1..8, W in Q4_K, Q5_K, Q4_0, Q4_1, Q5_0 or Q5_1.
//
// Replaces omni_tpu/kernels/dequant_matmul.py::qmatmul_gp_pallas (:333) for
// those six formats — the decode matmul of every layer and of the output
// head. The law is the TPU kernel's (`_gp_slice` and the `_make_gp_kernel`
// body, :200-300; dequant_matmul.q4k_gemv_plain): per 32-element group g,
// P = sum x_bf16 * q over the raw values q (the nibbles; Q5_K, Q5_0 and
// Q5_1 add 16 x their high bit, 0..31), xs = sum x_bf16, both in f32, and
// out = sum_g (dl * P - ml * xs) in f32, dl and ml the exact f32 products
// of kquant.cuh (d * sc and dm * mn per superblock for the K-quants;
// `legacy_min` for the per-32 d and m of the legacy formats). Q5_K is Q4_K
// with the fifth bit, and the legacy formats keep the same q (and qh)
// planes with one scale (and min) per group, so all six run one template
// whose format F picks the high-bit plane and the scales' source. The
// legacy formats need only K % 256.
//
// Bound on the H100: device-memory bytes. Each weight is read once (0.5 B
// of nibbles, 1/16 B of int8 scale and min, 1/32 B of f32 superblock
// scales; Q5_K 1/8 B more of high bits) and used M <= 8 times, far below
// the ~295 operations per byte where the card turns compute-bound. What
// kept the earlier kernel from its bytes was instructions: ~5 a weight for
// every row of x (the unpacking, an int-to-float conversion and two FMAs
// per pair, per row), so ~40 at M = 8. The design:
// - raw values on the tensor cores, once for all M rows: a block owns 16
//   weight rows, the A operand of mma.sync.m16n8k16 (bf16 in, f32 out);
//   the <= 8 rows of x are its B operand (columns past M repeat row M - 1
//   and are not written). Lane
//   (g, t) of a warp holds rows g and g + 8 and takes, per 64-element step
//   of a superblock, bytes 32h + 8t .. 32h + 8t + 7 of each row (one 8-byte
//   load): their low nibbles are elements 8t .. 8t + 7 of group h, their
//   high nibbles the same elements of group h + 4 (kquant.cuh's halves), so
//   the four lanes t of a quad hold one whole group, and each 16-deep
//   product (one 4-byte word of each lane: columns 2t, 2t + 1, 2t + 8,
//   2t + 9 take its bytes 0..3, x the same four elements) lies inside one
//   group;
// - a value becomes an MMA operand without a float conversion: a byte
//   permute makes bf16 0x4300 | v = 128 + v (exact for v <= 127; the fifth
//   bit is OR-ed into the byte first), one packed bf16 fma subtracts 128
//   exactly: about 1.4 instructions a value, the same at M = 1 and M = 8;
// - fresh f32 accumulators: each product starts from zero, the group's two
//   products are added with an IEEE f32 add into P (the tensor cores'
//   chained accumulation truncates: kernel I's once flipped 5.6x its plain
//   version's bf16 outputs); xs comes the same way from a product of x with
//   an all-ones A, once per block for all 16 rows, and dl * P - ml * xs is
//   added to a running f32 sum per output;
// - scales per superblock: a row's eight sc and eight mn bytes in one 8-byte
//   load each, d and dm once (the legacy formats' eight d and m in two
//   16-byte loads each); a superblock's loads are all issued before its
//   math, and the next superblock's weight bytes with them;
// - x (at most 8 x 12288 bf16) is read through L1 in 16-byte fragments,
//   never staged; the weight bytes, read once, bypass L1 (no_allocate), so
//   x and the scales stay there; no weight tile is staged in shared memory;
// - a block's up to 8 warps (4 where the row tiles fill two waves of
//   blocks: longer runs a warp) share out its superblocks; their sums are
//   added in warp order through shared memory, so a repeat launch gives
//   the same bits;
// - one block per 16-row tile at every shape, K never split: a call is
//   one launch of one kernel, with no workspace, counter or cached
//   buffer. At N = 1024 (wk, wv: 64 tiles for 132 SMs) a split in two, the
//   two blocks of a tile adding their partials through distributed shared
//   memory, was no faster for Q4_K and Q4_0 on the H100 and 7 % faster for
//   Q5_K (PERF.md section 6): not worth a second path.
//
// Plane layout (N-major, the transpose of the JAX K-major planes): q u8
// [N, K/2] with superblock-local halves (byte r of superblock s holds
// element s*256+r low and s*256+128+r high), sc/mn int8 [N, K/32], d/dm f32
// [N, K/256]; Q5_K's qh u8 [N, K/8] (bit b of byte r: element 8r + b). The
// legacy formats: q and qh the same, d f32 [N, K/32] and, for Q4_1 and
// Q5_1, dm f32 [N, K/32] (the min m); sc, mn unused. x and q must be
// 16-byte aligned, qh 2-byte aligned (dequant_matmul checks); the other
// planes are read 8 or 16 bytes at a time where their pointers allow, else
// byte by byte (a second instantiation). The K-quants' sc and mn hold the
// 6-bit fields, 0..63 (qformats), which d * sc reads as bytes. Offsets are
// 64-bit: the output head's planes pass 3e8 bytes. Rows past N are read as
// row N - 1 and not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kquant.cuh"

namespace {

using kquant::Fmt;

constexpr int kRows = 16;       // weight rows a block owns: the MMA's M
constexpr int kMaxWarps = 8;    // warps sharing out a block's superblocks
constexpr int kManyWarps = 4;   // ... where the row tiles fill two waves of blocks
constexpr int kSms = 132;       // the H100's SMs (dequant_matmul.GEMM_SMS)
constexpr uint32_t kOnes = 0x3F803F80u;  // bf16 {1, 1}

// Warps a block: one a superblock, at most kMaxWarps, or kManyWarps where
// the row tiles fill two waves of blocks (each warp then walks more
// superblocks, its next one's bytes in flight, and a block's start and end
// are paid over more)
int block_warps(int n, int k) {
  const int sbs = k / 256;
  const long long tiles = (n + kRows - 1) / kRows;
  const int most = tiles >= 2 * kSms ? kManyWarps : kMaxWarps;
  return sbs < most ? sbs : most;
}

struct Args {
  const __nv_bfloat16* x;
  const uint8_t* q;
  const int8_t* sc;
  const int8_t* mn;
  const float* d;
  const float* dm;
  const uint8_t* qh;
  void* out;
  int m, n, k, out_f32;
};

// a V (8 or 16 bytes) at p: one load where kAligned, else byte by byte
template <class V, bool kAligned>
__device__ __forceinline__ V ldv(const void* p) {
  if constexpr (kAligned) {
    return __ldg(static_cast<const V*>(p));
  } else {
    union {
      V v;
      uint8_t b[sizeof(V)];
    } u;
#pragma unroll
    for (int i = 0; i < (int)sizeof(V); ++i) u.b[i] = __ldg(static_cast<const uint8_t*>(p) + i);
    return u.v;
  }
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 2^23 + b as f32, b = byte i of v (0..255; exact)
__device__ __forceinline__ float magic_byte(uint32_t v, int i) {
  return __int_as_float((int)__byte_perm(v, 0x4B000000u, 0x7650 | i));
}

// c = A B with A 16 x 16 and B 16 x 8 bf16, into a fresh f32 accumulator
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.f), "f"(0.f), "f"(0.f),
        "f"(0.f));
}

// v less 128 in both bf16 halves, exactly: v * 1 + (-128)
__device__ __forceinline__ uint32_t less128(uint32_t v) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(v), "r"(kOnes), "r"(0xC300C300u));
  return r;
}

// The bf16 pairs {v0, v1} and {v2, v3} of the values held one to a byte in
// t (0..31 each): bytes 0x43 v = bf16 128 + v, less 128
__device__ __forceinline__ void pairs(uint32_t t, uint32_t& p01, uint32_t& p23) {
  p01 = less128(__byte_perm(t, 0x43u, 0x4140));
  p23 = less128(__byte_perm(t, 0x43u, 0x4342));
}

// bit i of the 4-bit field b at bit 4 of byte i (kquant::high_bytes' spread)
__device__ __forceinline__ uint32_t spread(uint32_t b) {
  return ((b & 0xFu) * 0x02040810u) & 0x10101010u;
}

// What a lane reads of one superblock of its two rows (lo = g, hi = g + 8):
// its weight bytes (Words), and the superblock's scales and high bits (Side)
struct Words {
  uint2 q[2][4];  // [row][step h]: bytes 32h + 8t .. 32h + 8t + 7
};
struct Side {
  uint4 qh[2][2];             // five-bit: [row][half] the 16 qh bytes of each half
  float d[2], dm[2];          // K-quants: the superblock's d and dm
  float nd[2], ndm[2];        // K-quants: -2^23 d and -2^23 dm (exact)
  uint2 sc[2], mn[2];         // K-quants: the eight group scales and mins
  float4 gd[2][2], gm[2][2];  // legacy: the eight groups' d and m
};

__device__ __forceinline__ void load_words(Words& w, const Args& a, const size_t (&row)[2], int s,
                                           int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const uint2* qp =
        reinterpret_cast<const uint2*>(a.q + row[r] * ((size_t)a.k >> 1) + (size_t)s * 128) + t;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
                   : "=r"(w.q[r][h].x), "=r"(w.q[r][h].y)
                   : "l"(qp + 4 * h));
    }
  }
}

template <Fmt F, bool kAligned>
__device__ __forceinline__ void load_side(Side& b, const Args& a, const size_t (&row)[2],
                                          int s) {
  const size_t k = (size_t)a.k;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (kquant::five_bit(F)) {
      const uint8_t* hp = a.qh + row[r] * (k >> 3) + (size_t)s * 32;
      b.qh[r][0] = ldv<uint4, kAligned>(hp);
      b.qh[r][1] = ldv<uint4, kAligned>(hp + 16);
    }
    if constexpr (kquant::legacy(F)) {
      const size_t g0 = row[r] * (k >> 5) + (size_t)s * 8;
      b.gd[r][0] = ldv<float4, kAligned>(a.d + g0);
      b.gd[r][1] = ldv<float4, kAligned>(a.d + g0 + 4);
      if constexpr (kquant::added_min(F)) {
        b.gm[r][0] = ldv<float4, kAligned>(a.dm + g0);
        b.gm[r][1] = ldv<float4, kAligned>(a.dm + g0 + 4);
      }
    } else {
      b.d[r] = __ldg(a.d + row[r] * (k >> 8) + s);
      b.dm[r] = __ldg(a.dm + row[r] * (k >> 8) + s);
      b.nd[r] = -8388608.f * b.d[r];
      b.ndm[r] = -8388608.f * b.dm[r];
      b.sc[r] = ldv<uint2, kAligned>(a.sc + row[r] * (k >> 5) + (size_t)s * 8);
      b.mn[r] = ldv<uint2, kAligned>(a.mn + row[r] * (k >> 5) + (size_t)s * 8);
    }
  }
}

// dl and ml of group i (0..7) of row r of the superblock
template <Fmt F>
__device__ __forceinline__ void scales(const Side& b, int r, int i, float& dl, float& ml) {
  if constexpr (kquant::legacy(F)) {
    dl = lane4(b.gd[r][i >> 2], i & 3);
    float m = 0.f;
    if constexpr (kquant::added_min(F)) m = lane4(b.gm[r][i >> 2], i & 3);
    ml = kquant::legacy_min<F>(dl, m);
  } else {  // d * sc as one rounding of d (2^23 + sc) - 2^23 d: the f32 product
    dl = fmaf(magic_byte(i < 4 ? b.sc[r].x : b.sc[r].y, i & 3), b.d[r], b.nd[r]);
    ml = fmaf(magic_byte(i < 4 ? b.mn[r].x : b.mn[r].y, i & 3), b.dm[r], b.ndm[r]);
  }
}

// Step h of a superblock: groups h (low nibbles) and h + 4 (high nibbles)
// of both rows against x's fragments xl (elements 32h + 8t ..) and xh
// (128 + 32h + 8t ..), into acc (rows g, g + 8 x columns 2t, 2t + 1).
template <Fmt F>
__device__ __forceinline__ void step(float (&acc)[4], const Words& w4, const Side& b, int h,
                                     int t, const uint4& xl, const uint4& xh) {
  float p_lo[4], p_hi[4], s_lo[2], s_hi[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {  // word j of the lane's 8 bytes: elements 4j .. 4j + 3
    uint32_t lo[2][2], hi[2][2];  // [row][pair]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t w = j ? w4.q[r][h].y : w4.q[r][h].x;
      uint32_t tl = w & 0x0F0F0F0Fu, th = (w >> 4) & 0x0F0F0F0Fu;
      if constexpr (kquant::five_bit(F)) {  // qh byte 4h + t of each half, bits 4j ..
        tl |= spread(word(b.qh[r][0], h) >> (8 * t + 4 * j));
        th |= spread(word(b.qh[r][1], h) >> (8 * t + 4 * j));
      }
      pairs(tl, lo[r][0], lo[r][1]);
      pairs(th, hi[r][0], hi[r][1]);
    }
    const uint32_t xl0 = j ? xl.z : xl.x, xl1 = j ? xl.w : xl.y;
    const uint32_t xh0 = j ? xh.z : xh.x, xh1 = j ? xh.w : xh.y;
    float c[4], o[4];
    mma(c, lo[0][0], lo[1][0], lo[0][1], lo[1][1], xl0, xl1);
    mma(o, kOnes, kOnes, kOnes, kOnes, xl0, xl1);
#pragma unroll
    for (int e = 0; e < 4; ++e) p_lo[e] = j ? __fadd_rn(p_lo[e], c[e]) : c[e];
#pragma unroll
    for (int e = 0; e < 2; ++e) s_lo[e] = j ? __fadd_rn(s_lo[e], o[e]) : o[e];
    mma(c, hi[0][0], hi[1][0], hi[0][1], hi[1][1], xh0, xh1);
    mma(o, kOnes, kOnes, kOnes, kOnes, xh0, xh1);
#pragma unroll
    for (int e = 0; e < 4; ++e) p_hi[e] = j ? __fadd_rn(p_hi[e], c[e]) : c[e];
#pragma unroll
    for (int e = 0; e < 2; ++e) s_hi[e] = j ? __fadd_rn(s_hi[e], o[e]) : o[e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float dl_lo, ml_lo, dl_hi, ml_hi;
    scales<F>(b, r, h, dl_lo, ml_lo);
    scales<F>(b, r, h + 4, dl_hi, ml_hi);
#pragma unroll
    for (int c = 0; c < 2; ++c) {  // acc += dl P - ml xs, group by group, in f32
      const int e = 2 * r + c;
      acc[e] = fmaf(-ml_lo, s_lo[c], fmaf(dl_lo, p_lo[e], acc[e]));
      acc[e] = fmaf(-ml_hi, s_hi[c], fmaf(dl_hi, p_hi[e], acc[e]));
    }
  }
}

// Block tile: weight rows 16 tile .. 16 tile + 15 over all of K, its warps
// taking every warps-th superblock.
template <Fmt F, bool kAligned>
__global__ void __launch_bounds__(kMaxWarps * 32, 2) gemv_kernel(const Args a) {
  __shared__ float red[kMaxWarps][32][4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // the MMA's group and thread in group
  const int r0 = blockIdx.x * kRows + g;
  const size_t row[2] = {(size_t)min(r0, a.n - 1), (size_t)min(r0 + 8, a.n - 1)};
  const int s_end = a.k >> 8;
  // lane g feeds row g of x as the MMA's column g; past M it repeats row
  // M - 1, and those columns' outputs are not written
  const uint4* xg = reinterpret_cast<const uint4*>(a.x + (size_t)min(g, a.m - 1) * a.k);

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  // superblock s's side data, x fragments and math, on its weight bytes w
  const auto superblock = [&](const Words& w, int s) {
    Side side;
    load_side<F, kAligned>(side, a, row, s);
#pragma unroll
    for (int h = 0; h < 4; ++h)  // 8 bf16 = one uint4: elements s*256 + 32h + 8t and + 128
      step<F>(acc, w, side, h, t, __ldg(xg + s * 32 + 4 * h + t),
           __ldg(xg + s * 32 + 16 + 4 * h + t));
  };
  // the weight bytes of the warp's next superblock load while this one's
  // math runs (two buffers in turn)
  Words wa, wb;
  int s = warp;
  if (s < s_end) load_words(wa, a, row, s, t);
  for (; s < s_end; s += 2 * warps) {
    if (s + warps < s_end) load_words(wb, a, row, s + warps, t);
    superblock(wa, s);
    if (s + warps >= s_end) break;
    if (s + 2 * warps < s_end) load_words(wa, a, row, s + 2 * warps, t);
    superblock(wb, s + warps);
  }

  // the warps' sums, added in warp order
  if (warp > 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][lane][e] = acc[e];
  }
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < warps; ++w)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] += red[w][lane][e];
  }
  if (warp > 0) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = 2 * t + (e & 1), r = r0 + 8 * (e >> 1);
    if (m >= a.m || r >= a.n) continue;
    const size_t o = (size_t)m * a.n + r;
    if (a.out_f32)
      static_cast<float*>(a.out)[o] = acc[e];
    else
      static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(acc[e]);
  }
}

template <Fmt F>
int gemv(const void* x, const void* q, const void* sc, const void* mn, const void* d,
         const void* dm, const void* qh, void* out, int m, int n, int k, int out_f32,
         void* stream) {
  if (m < 1 || m > 8 || n < 1 || k < 256 || k % 256 != 0 ||
      (kquant::five_bit(F) && qh == nullptr) || (kquant::added_min(F) && dm == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto bits = [](const void* v) { return reinterpret_cast<uintptr_t>(v); };
  const bool aligned = (bits(sc) | bits(mn)) % 8 == 0 &&
                       (bits(qh) | (kquant::legacy(F) ? bits(d) | bits(dm) : 0)) % 16 == 0;
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
               static_cast<const int8_t*>(sc), static_cast<const int8_t*>(mn),
               static_cast<const float*>(d), static_cast<const float*>(dm),
               static_cast<const uint8_t*>(qh), out, m, n, k, out_f32};
  const dim3 grid((unsigned)((n + kRows - 1) / kRows)), block(32 * block_warps(n, k));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aligned)
    gemv_kernel<F, true><<<grid, block, 0, st>>>(a);
  else
    gemv_kernel<F, false><<<grid, block, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns the CUDA error of the launch (0 = launched). A format
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
