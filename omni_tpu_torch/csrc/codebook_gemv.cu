// iq4_nl_gemv, iq4_xs_gemv and mxfp4_gemv (kernel E's codebook entries):
// out[m, n] = sum_k x[m, k] * W[n, k] for M = 1..8, W in IQ4_NL, IQ4_XS or
// MXFP4.
//
// Replaces omni_tpu/kernels/dequant_matmul.py::qmatmul_gp_pallas (:333) for
// the three codebook formats: the decode matmul of every layer weight of
// an IQ4_NL, IQ4_XS or MXFP4 checkpoint (252 per token of a Qwen3-8B; its
// head is Q6_K). The law is the TPU kernel's int8-plane law (`_gp_slice`,
// :200-239; dequant_matmul.codebook_gemv_plain): per 32-element group g,
// P = sum x_bf16 * v over the codebook values v (exact integers), in f32,
// and out = sum_g dl * P in f32, dl = d (IQ4_NL, MXFP4) or the f32 product
// d * sc rounded once (IQ4_XS: d per 256, sc the int8 sub-scale per 32).
// The JAX package applies the codebook at load (int8 value planes); here
// the plane keeps the file's nibble indexes and the codebook is applied in
// registers (codebook.cuh), which halves the bytes a token reads.
//
// Bound on the H100: device-memory bytes. Each weight is read once (0.5 B
// of nibbles, 1/8 B of f32 d; IQ4_XS 1/32 B of int8 sc and 1/64 B of f32
// d) and used M <= 8 times, far below the ~295 operations per byte where
// the card turns compute-bound. What it costs besides the bytes is
// instructions, so the design is kernel A's (q4k_gemv.cu):
// - raw values on the tensor cores, once for all M rows: a block owns 16
//   weight rows, the A operand of mma.sync.m16n8k16 (bf16 in, f32 out);
//   the <= 8 rows of x are its B operand (columns past M repeat row M - 1
//   and are not written). Lane (g, t) of a warp holds rows g and g + 8 and
//   takes, per 32-group, its bytes 4t .. 4t + 3 (one 4-byte load a row):
//   their low nibbles are elements 4t .. 4t + 3 of the group, their high
//   nibbles elements 16 + 4t .. 16 + 4t + 3, so the four lanes t of a quad
//   hold one whole group: one 16-deep product takes its low nibbles (x's
//   elements 4t .. 4t + 3 as the lane's B fragment, in K order), one its
//   high nibbles;
// - a value becomes an MMA operand by table lookups in byte permutes
//   (codebook.cuh: 21 instructions for a word's 8 values, 17 for MXFP4),
//   the same at M = 1 and M = 8;
// - fresh f32 accumulators: each product starts from zero, the group's two
//   products are added with an IEEE f32 add into P, and dl * P is added to
//   a running f32 sum per output (the tensor cores' chained accumulation
//   truncates);
// - scales per superblock of 256 elements: a row's eight d in two 16-byte
//   loads (IQ4_XS: its d and eight sc in one 8-byte load, dl = d * sc as a
//   byte permute and one fma, exact and rounded once: group_scale); IQ4_XS's
//   load with the superblock's weight bytes, a superblock ahead of their
//   math;
// - x (at most 8 x 12288 bf16) is read through L1 in 8-byte fragments,
//   and so are the weight bytes: a quad's 4-byte loads take half of a
//   32-byte sector, whose other half the next group's load finds in L1
//   (past L1, as kernel A reads its weights, the calls at N >= 4096 read
//   longer on the H100: `python -m omni_tpu_torch.gemv_plan_probe`,
//   PERF.md section 6); no tile is staged in shared memory;
// - a block's up to 8 warps (4 where the row tiles fill two waves of
//   blocks) share out its superblocks, each warp's next superblock's bytes
//   in flight during this one's math; their sums are added in warp
//   order through shared memory, so a repeat launch gives the same bits;
// - one block per 16-row tile, K never split: a call is one launch of one
//   kernel, with no workspace.
//
// Plane layout (N-major): q u8 [N, K/2], each 32-group's 16 bytes as the
// file holds them (byte j: element j in the low nibble, j + 16 in the
// high one), the nibble an index into the format's 16-entry codebook; d
// f32 [N, K/32] (IQ4_NL: the file's f16 d widened; MXFP4: 2^(e - 128) from
// the e8m0 byte); IQ4_XS: d f32 [N, K/256] and sc int8 [N, K/32] (-32..31).
// K % 256 == 0 (dequant_matmul sends a codebook weight here only then). x
// and q must be 16-byte aligned (dequant_matmul checks); d and sc are read
// 16 and 8 bytes at a time where their pointers allow, else byte by byte (a
// second instantiation). Offsets are 64-bit. Rows past N are read as row
// N - 1 and not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "codebook.cuh"

namespace {

enum class Fmt { kIQ4NL, kIQ4XS, kMXFP4 };

__host__ __device__ constexpr bool mxfp4(Fmt f) { return f == Fmt::kMXFP4; }
__host__ __device__ constexpr bool sub_scales(Fmt f) { return f == Fmt::kIQ4XS; }

constexpr int kRows = 16;      // weight rows a block owns: the MMA's M
constexpr int kMaxWarps = 8;   // warps sharing out a block's superblocks
constexpr int kManyWarps = 4;  // ... where the row tiles fill two waves of blocks
constexpr int kSms = 132;      // the H100's SMs (dequant_matmul.GEMM_SMS)

// Warps a block: one a superblock, at most kMaxWarps, or kManyWarps where
// the row tiles fill two waves of blocks (kernel A's rule)
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
  const float* d;
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

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
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

// What a lane reads of one superblock of its two rows (lo = g, hi = g + 8)
// a superblock ahead of its math: its weight bytes and, for IQ4_XS, its
// scales (IQ4_NL's and MXFP4's eight d a row, 16 registers, load at the
// superblock's start: held across the previous superblock's math they
// cost more than their latency)
struct Stage {
  uint32_t q[2][8];  // [row][group]: bytes 4t .. 4t + 3 of the group
  float xd[2];       // IQ4_XS: the superblock's d
  uint2 sc[2];       // IQ4_XS: the eight sub-scales, one a byte
};

// A lane's two rows of each plane (lo = g, hi = g + 8)
struct Rows {
  const uint8_t* q[2];
  const float* d[2];
  const int8_t* sc[2];
};

template <Fmt F, bool kAligned>
__device__ __forceinline__ void load_stage(Stage& b, const Rows& p, int s, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const uint32_t* qp = reinterpret_cast<const uint32_t*>(p.q[r] + (size_t)s * 128) + t;
#pragma unroll
    for (int i = 0; i < 8; ++i) b.q[r][i] = __ldg(qp + 4 * i);
    if constexpr (sub_scales(F)) {
      b.xd[r] = __ldg(p.d[r] + s);
      b.sc[r] = ldv<uint2, kAligned>(p.sc[r] + (size_t)s * 8);
    }
  }
}

// A superblock's scales as group_scale takes them, per row
struct Scales {
  float4 d[2][2];  // IQ4_NL, MXFP4: [row][half] the eight groups' d
  float xd[2];     // IQ4_XS: 2^-16 d
  float nxd[2];    // IQ4_XS: -160 d (exact)
  uint2 sc[2];     // IQ4_XS: the eight sub-scales plus 32 (0..63), one a byte
};

template <Fmt F, bool kAligned>
__device__ __forceinline__ Scales scales_of(const Stage& b, const Rows& p, int s) {
  Scales u;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (sub_scales(F)) {
      u.xd[r] = 0x1p-16f * b.xd[r];
      u.nxd[r] = -160.f * b.xd[r];
      // sc + 32 = the low 6 bits of sc with bit 5 flipped (sc in -32..31)
      u.sc[r] = make_uint2((b.sc[r].x & 0x3F3F3F3Fu) ^ 0x20202020u,
                           (b.sc[r].y & 0x3F3F3F3Fu) ^ 0x20202020u);
    } else {
      const float* dp = p.d[r] + (size_t)s * 8;
      u.d[r][0] = ldv<float4, kAligned>(dp);
      u.d[r][1] = ldv<float4, kAligned>(dp + 4);
    }
  }
  return u;
}

// dl of group i (0..7) of row r of the superblock
template <Fmt F>
__device__ __forceinline__ float group_scale(const Scales& u, int r, int i) {
  if constexpr (sub_scales(F)) {
    // d * sc, rounded once: the byte sc + 32 put in bits 16..22 of 2^23 by
    // one permute, f = 2^23 + 2^16 (sc + 32), then f 2^-16 d - 160 d in one
    // fma, the exact (128 + sc + 32) d - 160 d rounded once
    const uint32_t w = i < 4 ? u.sc[r].x : u.sc[r].y;
    const float f = __uint_as_float(codebook::prmt(w, 0x4B000000u, 0x7054u | (i & 3) << 8));
    return fmaf(f, u.xd[r], u.nxd[r]);
  } else {
    return lane4(u.d[r][i >> 2], i & 3);
  }
}

// Group i of a superblock: both rows' words against x's fragments xl
// (elements 32i + 4t ..) and xh (32i + 16 + 4t ..), into acc (rows g,
// g + 8 x columns 2t, 2t + 1).
template <Fmt F>
__device__ __forceinline__ void group(float (&acc)[4], const Stage& b, const Scales& u, int i,
                                      const uint2& xl, const uint2& xh) {
  using C = codebook::Codebook<mxfp4(F)>;
  uint32_t lo[2][2], hi[2][2];  // [row][pair]
#pragma unroll
  for (int r = 0; r < 2; ++r)
    codebook::word_pairs<C::kLowRepeats>(C::raw(), b.q[r][i], lo[r], hi[r]);
  float c[4], o[4];
  mma(c, lo[0][0], lo[1][0], lo[0][1], lo[1][1], xl.x, xl.y);
  mma(o, hi[0][0], hi[1][0], hi[0][1], hi[1][1], xh.x, xh.y);
  const float dl[2] = {group_scale<F>(u, 0, i), group_scale<F>(u, 1, i)};
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = fmaf(dl[e >> 1], __fadd_rn(c[e], o[e]), acc[e]);
}

// Block tile: weight rows 16 tile .. 16 tile + 15 over all of K, its warps
// taking every warps-th superblock.
template <Fmt F, bool kAligned>
__global__ void __launch_bounds__(kMaxWarps * 32, 2) gemv_kernel(const Args a) {
  __shared__ float red[kMaxWarps][32][4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // the MMA's group and thread in group
  const int r0 = blockIdx.x * kRows + g;
  Rows p;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t row = (size_t)min(r0 + 8 * r, a.n - 1), k = (size_t)a.k;
    p.q[r] = a.q + row * (k >> 1);
    p.d[r] = a.d + row * (sub_scales(F) ? k >> 8 : k >> 5);
    p.sc[r] = sub_scales(F) ? a.sc + row * (k >> 5) : nullptr;
  }
  const int s_end = a.k >> 8;
  // lane g feeds row g of x as the MMA's column g; past M it repeats row
  // M - 1, and those columns' outputs are not written
  const uint2* xg = reinterpret_cast<const uint2*>(a.x + (size_t)min(g, a.m - 1) * a.k);

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  // superblock s's x fragments and math, on its stage b
  const auto superblock = [&](const Stage& b, int s) {
    const Scales u = scales_of<F, kAligned>(b, p, s);
#pragma unroll
    for (int i = 0; i < 8; ++i)  // 4 bf16 = one uint2: elements s*256 + 32i + 4t and + 16
      group<F>(acc, b, u, i, __ldg(xg + s * 64 + 8 * i + t), __ldg(xg + s * 64 + 8 * i + 4 + t));
  };
  // the warp's next superblock loads while this one's math runs (two
  // stages in turn)
  Stage sa, sb;
  int s = warp;
  if (s < s_end) load_stage<F, kAligned>(sa, p, s, t);
  for (; s < s_end; s += 2 * warps) {
    if (s + warps < s_end) load_stage<F, kAligned>(sb, p, s + warps, t);
    superblock(sa, s);
    if (s + warps >= s_end) break;
    if (s + 2 * warps < s_end) load_stage<F, kAligned>(sa, p, s + 2 * warps, t);
    superblock(sb, s + warps);
  }

  // the warps' sums, added in warp order
  if (warp > 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][lane][e] = acc[e];
  }
  __syncthreads();
  if (warp > 0) return;
  for (int w = 1; w < warps; ++w)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += red[w][lane][e];
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
int gemv(const void* x, const void* q, const void* sc, const void* d, void* out, int m, int n,
         int k, int out_f32, void* stream) {
  if (m < 1 || m > 8 || n < 1 || k < 256 || k % 256 != 0 || d == nullptr ||
      (sub_scales(F) && sc == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto bits = [](const void* v) { return reinterpret_cast<uintptr_t>(v); };
  const bool aligned = sub_scales(F) ? bits(sc) % 8 == 0 : bits(d) % 16 == 0;
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
               static_cast<const int8_t*>(sc), static_cast<const float*>(d), out, m, n, k,
               out_f32};
  const dim3 grid((unsigned)((n + kRows - 1) / kRows)), block(32 * block_warps(n, k));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aligned)
    gemv_kernel<F, true><<<grid, block, 0, st>>>(a);
  else
    gemv_kernel<F, false><<<grid, block, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns the CUDA error of the launch (0 = launched). The mn, dm and
// qh planes keep the signature of the other matmul entries; no codebook
// format has them, and only IQ4_XS has sc.
#define CODEBOOK_GEMV_ENTRY(name, fmt)                                                       \
  extern "C" int name(const void* x, const void* q, const void* sc, const void* mn,         \
                      const void* d, const void* dm, const void* qh, void* out, int m,       \
                      int n, int k, int out_f32, void* stream) {                             \
    (void)mn;                                                                                \
    (void)dm;                                                                                \
    (void)qh;                                                                                \
    return gemv<fmt>(x, q, sc, d, out, m, n, k, out_f32, stream);                            \
  }

CODEBOOK_GEMV_ENTRY(iq4_nl_gemv, Fmt::kIQ4NL)
CODEBOOK_GEMV_ENTRY(iq4_xs_gemv, Fmt::kIQ4XS)
CODEBOOK_GEMV_ENTRY(mxfp4_gemv, Fmt::kMXFP4)
