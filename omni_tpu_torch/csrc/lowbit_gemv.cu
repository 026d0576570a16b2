// q2k_gemv and q3k_gemv (kernel H): out[m, n] = sum_k x[m, k] * W[n, k]
// for M = 1..8, W in Q2_K or Q3_K.
//
// Replaces omni_tpu/kernels/dequant_matmul.py::qmatmul_gp_pallas (:333,
// body _make_gp_kernel :258-309) for the two low-bit K-quants — the decode
// matmul of every layer of a Q2_K or Q3_K checkpoint. The law is the TPU
// kernel's `_gp_slice` (:221-232; dequant_matmul.q2k_gemv_plain): per
// 16-element group g,
//   out += dl_g * P_g - ml_g * xs_g,
// P_g the f32 dot of bf16 x with the group's raw values, xs_g the f32 sum of
// bf16 x over the group, dl = d * sc and ml = dm * mn the exact f32
// products of the reference dequantiser:
// - Q2_K: the value q in 0..3, a 4-bit scale and a 4-bit min per 16;
// - Q3_K: q = quarter + 4 * hbit - 4 in -4..3, a signed 6-bit scale per
//   16, no min term.
//
// Bound on the H100: device-memory bytes. Per element 0.25 B of quarters,
// 1/16 B of int8 scale (Q2_K also 1/16 B of min), 1/64 B of f32 super
// scales, Q3_K 1/8 B of high bits — 0.406 B (Q2_K) and 0.453 B (Q3_K) of
// planes, used M <= 8 times, far below the ~295 operations per byte where
// the card turns compute-bound. What kept the earlier kernel (one warp a
// row, scalar f32 for every row of x) from its bytes was instructions:
// ~5-6 a weight at M = 1, about M times that at M = 8. The design is
// kernel A's (q4k_gemv.cu):
// - raw values on the tensor cores, once for all M rows: a block owns 16
//   weight rows, the A operand of mma.sync.m16n8k16 (bf16 in, f32 out);
//   the <= 8 rows of x are its B operand (columns past M repeat row M - 1
//   and are not written);
// - one 16-deep product is one 16-group: byte r of superblock s's quarters
//   holds element 64j + r at shift 2j, so bytes 4t .. 4t + 3 of 16-byte
//   chunk p hold elements 4t .. 4t + 3 of group 4j + p, for j = 0..3. Lane
//   (g, t) loads that 4-byte word of rows g and g + 8 (through L1: a
//   quad's loads take half a 32-byte sector, the next chunk's the other
//   half) and it feeds four products, one per j; x comes at the same
//   elements, in the same k-slots (columns 2t, 2t + 1, 2t + 8, 2t + 9);
// - a value becomes an MMA operand without a float conversion: the
//   quarters (w >> 2j) & 0x03030303 (Q3_K ORs its high bit in as bit 2 of
//   each byte, from one nibble of qh), a byte permute to bf16
//   0x4300 | v = 128 + v, and one packed bf16 fma less 128 (Q3_K: 132)
//   exactly;
// - each product starts from a fresh f32 accumulator (the tensor cores'
//   chained accumulation truncates); Q2_K's xs comes the same way from a
//   product of x with an all-ones A, once per group for all 16 rows; then
//   acc += dl * P - ml * xs in f32 FMAs;
// - dl and ml are the exact f32 products, each one byte permute and one
//   fma: Q2_K's unsigned sc and mn as A's magic_byte (2^23 + b) d - 2^23 d;
//   Q3_K's signed sc with its sign bit flipped, put in bits 8..15 of 2^23,
//   (2^15 + sc + 128) d - (2^15 + 128) d (exact: d is the file's f16, and
//   32896 d needs 20 bits). Groups of 16 put four times A's scale work on a
//   weight, and the four lanes of a quad need the same ones: so a warp
//   forms each of its 16 rows x 16 groups once a superblock, eight a lane
//   (from one 8-byte load of sc, and of mn), into a table in shared memory,
//   and each lane reads its two rows' four groups at a time in 16-byte
//   loads;
// - a warp's next superblock (weights, scales, high bits) loads while this
//   one's math runs (two stages in turn);
// - a block's up to 8 warps (4 where the row tiles fill two waves of
//   blocks, 2 where that would leave a part-filled second wave:
//   block_warps) share out its superblocks; their sums are added in warp order
//   through shared memory, so a repeat launch gives the same bits;
// - one block per 16-row tile, K never split: a call is one launch of one
//   kernel, with no workspace (dequant_matmul.gemv_plan).
//
// Plane layout (N-major, the transpose of the JAX K-major planes): q u8
// [N, K/4] quarters, sc int8 [N, K/16], d f32 [N, K/256]; Q2_K mn int8
// [N, K/16] and dm f32 [N, K/256]; Q3_K qh u8 [N, K/8] in element order
// (bit b of byte r: element 8r + b, as Q5_K's). x and q must be 16-byte
// aligned (dequant_matmul checks), qh 2-byte aligned; sc and mn are read
// 8 bytes at a time, qh 16, where their pointers allow, else byte by byte
// (a second instantiation). Offsets are 64-bit. Rows past N are read as row
// N - 1 and not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum class Fmt { kQ2K, kQ3K };

__host__ __device__ constexpr bool has_min(Fmt f) { return f == Fmt::kQ2K; }

constexpr int kRows = 16;       // weight rows a block owns: the MMA's M
constexpr int kMaxWarps = 8;    // warps sharing out a block's superblocks
constexpr int kManyWarps = 4;   // ... where the row tiles fill two waves of blocks
constexpr int kFewWarps = 2;    // ... where that leaves a part-filled second wave
constexpr int kSms = 132;       // the H100's SMs (dequant_matmul.GEMM_SMS)
constexpr uint32_t kOnes = 0x3F803F80u;  // bf16 {1, 1}

// Warps a block: one a superblock, at most kMaxWarps; kManyWarps where the
// row tiles fill two waves of blocks; kFewWarps where every tile is on the
// card at once at kFewWarps a block but not at kManyWarps (no second,
// part-filled wave: Qwen3-8B's gate, 768 tiles, read 11-17 % faster so on
// the H100, `gemv_plan_probe`). A block's threads take 128 registers each
// (__launch_bounds__), so an SM holds 16 / warps of them.
int block_warps(int n, int k) {
  const int steps = k / 256;
  const long long tiles = (n + kRows - 1) / kRows;
  const auto on_card = [](int warps) { return (long long)kSms * (16 / warps); };
  int most = kMaxWarps;
  if (tiles >= 2 * kSms)
    most = tiles > on_card(kManyWarps) && tiles <= on_card(kFewWarps) ? kFewWarps : kManyWarps;
  return steps < most ? steps : most;
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

// a uint4 at p: one load where kAligned, else byte by byte
template <bool kAligned>
__device__ __forceinline__ uint4 ld16(const void* p) {
  if constexpr (kAligned) {
    return __ldg(static_cast<const uint4*>(p));
  } else {
    union {
      uint4 v;
      uint8_t b[16];
    } u;
#pragma unroll
    for (int i = 0; i < 16; ++i) u.b[i] = __ldg(static_cast<const uint8_t*>(p) + i);
    return u.v;
  }
}

// a uint2 at p: one load where kAligned, else byte by byte
template <bool kAligned>
__device__ __forceinline__ uint2 ld8(const void* p) {
  if constexpr (kAligned) {
    return __ldg(static_cast<const uint2*>(p));
  } else {
    union {
      uint2 v;
      uint8_t b[8];
    } u;
#pragma unroll
    for (int i = 0; i < 8; ++i) u.b[i] = __ldg(static_cast<const uint8_t*>(p) + i);
    return u.v;
  }
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
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

// The bf16 pairs {v0, v1} and {v2, v3} of the values held one to a byte in
// v (0..7): bytes 0x43 v = bf16 128 + v, less the format's offset exactly
// (v * 1 + neg, neg = bf16 -128 for Q2_K's 0..3, -132 for Q3_K's -4..3)
template <Fmt F>
__device__ __forceinline__ void pairs(uint32_t v, uint32_t& p01, uint32_t& p23) {
  constexpr uint32_t neg = has_min(F) ? 0xC300C300u : 0xC304C304u;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(p01)
      : "r"(__byte_perm(v, 0x43u, 0x4140)), "r"(kOnes), "r"(neg));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(p23)
      : "r"(__byte_perm(v, 0x43u, 0x4342)), "r"(kOnes), "r"(neg));
}

// What a lane reads of one superblock, a superblock ahead of its math: the
// quarters (and Q3_K's high bits) of its two MMA rows (lo = g, hi = g + 8),
// and the scales of the table row it forms (row lane / 2, groups
// 8 (lane & 1) .. + 7)
struct Stage {
  uint32_t q[2][4];  // [row][chunk p]: quarter bytes 16p + 4t .. 16p + 4t + 3
  uint4 qh[2][2];    // Q3_K: [row][half] the superblock's 32 high-bit bytes
  uint2 sc;          // the table row's eight group scales (Q3_K: signed)
  uint2 mn;          // Q2_K: its eight group mins
  float d, dm;       // its super-scale (Q2_K: and super-min-scale)
};

// Where a lane reads: its two MMA rows of q and qh, its table row of the
// scales
struct Rows {
  const uint8_t* q[2];
  const uint8_t* qh[2];
  const int8_t* sc;
  const int8_t* mn;
  const float* d;
  const float* dm;
};

template <Fmt F, bool kAligned>
__device__ __forceinline__ void load_stage(Stage& b, const Rows& p, int s, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const uint32_t* qp = reinterpret_cast<const uint32_t*>(p.q[r] + (size_t)s * 64) + t;
#pragma unroll
    for (int c = 0; c < 4; ++c) b.q[r][c] = __ldg(qp + 4 * c);
    if constexpr (!has_min(F)) {
      b.qh[r][0] = ld16<kAligned>(p.qh[r] + (size_t)s * 32);
      b.qh[r][1] = ld16<kAligned>(p.qh[r] + (size_t)s * 32 + 16);
    }
  }
  b.sc = ld8<kAligned>(p.sc + (size_t)s * 16);
  b.d = __ldg(p.d + s);
  if constexpr (has_min(F)) {
    b.mn = ld8<kAligned>(p.mn + (size_t)s * 16);
    b.dm = __ldg(p.dm + s);
  }
}

// The exact f32 product of each scale byte of w (4 bytes) with its
// super-scale d, rounded once: fma(f, d', nd) with f the byte under a power
// of two
// - unsigned (Q2_K's sc and mn, 0..15): f = 2^23 + b, d' = d, nd = -2^23 d;
// - signed (Q3_K's sc, -32..31): the sign bit flipped (b + 128, 0..255)
//   and put in bits 8..15, f = 2^23 + 2^8 (b + 128), d' = 2^-8 d,
//   nd = -(2^15 + 128) d.
template <bool kSigned>
__device__ __forceinline__ float4 products(uint32_t w, float d) {
  const uint32_t u = kSigned ? w ^ 0x80808080u : w;
  const float d1 = kSigned ? 0x1p-8f * d : d, nd = (kSigned ? -32896.f : -8388608.f) * d;
  const auto one = [&](uint32_t i) {
    const uint32_t sel = kSigned ? 0x7604u | i << 4 : 0x7650u | i;
    return fmaf(__uint_as_float(__byte_perm(u, 0x4B000000u, sel)), d1, nd);
  };
  return make_float4(one(0), one(1), one(2), one(3));
}

// A warp's scales of one superblock: dl (and Q2_K's ml) of its 16 rows x 16
// groups, each formed once (the four lanes of a quad need the same ones)
struct Table {
  float dl[kRows][16];
  float ml[kRows][16];
};

// bit i of the 4-bit field b at bit 2 of byte i (each bit times 2^(7i + 2);
// the other products fall outside the mask, and none carries)
__device__ __forceinline__ uint32_t spread(uint32_t b) {
  return ((b & 0xFu) * 0x00810204u) & 0x04040404u;
}

// Group 4j + p of a superblock: both rows' values against x's fragment xf
// (elements 64j + 16p + 4t ..), into acc (rows g, g + 8 x columns 2t,
// 2t + 1), with the rows' dl (and ml).
template <Fmt F>
__device__ __forceinline__ void group(float (&acc)[4], const Stage& b, const float (&dl)[2],
                                      const float (&ml)[2], int j, int p, int t,
                                      const uint2& xf) {
  uint32_t a[2][2];  // [row][pair]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    uint32_t v = (b.q[r][p] >> (2 * j)) & 0x03030303u;
    if constexpr (!has_min(F)) {
      // the group's elements 4t .. 4t + 3 are bits 4(t & 1) .. + 3 of qh
      // byte 8j + 2p + t / 2: bits 16(p & 1) + 4t .. of word 2j + p / 2
      const int w = 2 * j + (p >> 1);
      v |= spread(word(b.qh[r][w >> 2], w & 3) >> (16 * (p & 1) + 4 * t));
    }
    pairs<F>(v, a[r][0], a[r][1]);
  }
  float c[4];
  mma(c, a[0][0], a[1][0], a[0][1], a[1][1], xf.x, xf.y);
  if constexpr (has_min(F)) {
    float o[4];
    mma(o, kOnes, kOnes, kOnes, kOnes, xf.x, xf.y);
#pragma unroll
    for (int e = 0; e < 4; ++e)  // acc += dl P - ml xs, in f32
      acc[e] = fmaf(-ml[e >> 1], o[e & 1], fmaf(dl[e >> 1], c[e], acc[e]));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = fmaf(dl[e >> 1], c[e], acc[e]);
  }
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Block tile: weight rows 16 tile .. 16 tile + 15 over all of K, its warps
// taking every warps-th superblock.
template <Fmt F, bool kAligned>
__global__ void __launch_bounds__(kMaxWarps * 32, 2) gemv_kernel(const Args a) {
  __shared__ float red[kMaxWarps][32][4];
  __shared__ __align__(16) Table table[kMaxWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // the MMA's group and thread in group
  const int tile = blockIdx.x * kRows, r0 = tile + g;
  Rows p;
  {
    const size_t k = (size_t)a.k, tr = (size_t)min(tile + (lane >> 1), a.n - 1);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t row = (size_t)min(r0 + 8 * r, a.n - 1);
      p.q[r] = a.q + row * (k >> 2);
      p.qh[r] = has_min(F) ? nullptr : a.qh + row * (k >> 3);
    }
    p.sc = a.sc + tr * (k >> 4) + 8 * (lane & 1);
    p.mn = has_min(F) ? a.mn + tr * (k >> 4) + 8 * (lane & 1) : nullptr;
    p.d = a.d + tr * (k >> 8);
    p.dm = has_min(F) ? a.dm + tr * (k >> 8) : nullptr;
  }
  Table& tab = table[warp];
  const int s_end = a.k >> 8;
  // lane g feeds row g of x as the MMA's column g; past M it repeats row
  // M - 1, and those columns' outputs are not written
  const uint2* xg = reinterpret_cast<const uint2*>(a.x + (size_t)min(g, a.m - 1) * a.k);

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  // superblock s's scales into the table, then its x fragments and math,
  // on its stage b
  const auto superblock = [&](const Stage& b, int s) {
    __syncwarp();  // the last superblock's reads of the table are done
    float4* dl_row = reinterpret_cast<float4*>(&tab.dl[lane >> 1][8 * (lane & 1)]);
    dl_row[0] = products<!has_min(F)>(b.sc.x, b.d);
    dl_row[1] = products<!has_min(F)>(b.sc.y, b.d);
    if constexpr (has_min(F)) {
      float4* ml_row = reinterpret_cast<float4*>(&tab.ml[lane >> 1][8 * (lane & 1)]);
      ml_row[0] = products<false>(b.mn.x, b.dm);
      ml_row[1] = products<false>(b.mn.y, b.dm);
    }
    __syncwarp();
    const uint2* xs = xg + s * 64 + t;
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // groups 4j .. 4j + 3: their dl (ml) in one load a row
      const float4 dlo = *reinterpret_cast<const float4*>(&tab.dl[g][4 * j]);
      const float4 dhi = *reinterpret_cast<const float4*>(&tab.dl[g + 8][4 * j]);
      float4 mlo = dlo, mhi = dhi;
      if constexpr (has_min(F)) {
        mlo = *reinterpret_cast<const float4*>(&tab.ml[g][4 * j]);
        mhi = *reinterpret_cast<const float4*>(&tab.ml[g + 8][4 * j]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // 4 bf16 = one uint2: elements s*256 + 64j + 16c + 4t
        const float dl[2] = {lane4(dlo, c), lane4(dhi, c)};
        const float ml[2] = {lane4(mlo, c), lane4(mhi, c)};
        group<F>(acc, b, dl, ml, j, c, t, __ldg(xs + 16 * j + 4 * c));
      }
    }
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
int gemv(const void* x, const void* q, const void* sc, const void* mn, const void* d,
         const void* dm, const void* qh, void* out, int m, int n, int k, int out_f32,
         void* stream) {
  const bool planes_ok = has_min(F) ? mn != nullptr && dm != nullptr : qh != nullptr;
  if (m < 1 || m > 8 || n < 1 || k < 256 || k % 256 != 0 || sc == nullptr || d == nullptr ||
      !planes_ok)
    return (int)cudaErrorInvalidValue;
  const auto bits = [](const void* v) { return reinterpret_cast<uintptr_t>(v); };
  const bool aligned = (bits(sc) | bits(mn)) % 8 == 0 && bits(qh) % 16 == 0;
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

// Each returns the CUDA error of the launch (0 = launched). Q2_K ignores
// qh, Q3_K mn and dm (null).
#define GEMV_ENTRY(name, fmt)                                                          \
  extern "C" int name(const void* x, const void* q, const void* sc, const void* mn,   \
                      const void* d, const void* dm, const void* qh, void* out, int m, \
                      int n, int k, int out_f32, void* stream) {                       \
    return gemv<fmt>(x, q, sc, mn, d, dm, qh, out, m, n, k, out_f32, stream);          \
  }

GEMV_ENTRY(q2k_gemv, Fmt::kQ2K)
GEMV_ENTRY(q3k_gemv, Fmt::kQ3K)
