// q6k_gemv (kernel C): out[m, n] = sum_k x[m, k] * W[n, k] for M = 1..8, W
// in Q6_K.
//
// Replaces omni_tpu/kernels/dequant_matmul.py::qmatmul_gp_pallas (:333) for
// Q6_K — the decode matmul of the Q6_K tensors of a Q4_K_M checkpoint
// (attn_v and ffn_down on the promoted layers, and the output head). The
// law is the TPU kernel's (`_gp_slice`, :217-220; dequant_matmul.
// q6k_gemv_plain): per 16-element group g, P = sum x_bf16 * (q - 32) in
// f32, and out = sum_g dl * P in f32, dl = d * sc the exact f32 product
// (d per 256 elements, sc the signed int8 scale per 16) — no min term.
//
// Bound on the H100: device-memory bytes. Each weight is read once (1 B of
// int8 value, 1/16 B of int8 scale, 1/64 B of f32 super-scale) and used
// M <= 8 times, far below the ~295 operations per byte where the card
// turns compute-bound. What kept the earlier kernel (one warp a row, a
// conversion and an FMA per weight for every row of x) from its bytes was
// instructions at M = 8. The design is kernel A's (q4k_gemv.cu):
// - raw values on the tensor cores, once for all M rows: a block owns 16
//   weight rows, the A operand of mma.sync.m16n8k16 (bf16 in, f32 out);
//   the <= 8 rows of x are its B operand (columns past M repeat row M - 1
//   and are not written);
// - one 16-deep product is one 16-group: lane (g, t) takes bytes
//   4t .. 4t + 3 of each group of rows g and g + 8, and x comes at the same
//   elements, in the same k-slots (columns 2t, 2t + 1, 2t + 8, 2t + 9);
// - the weight bytes go through shared memory: a warp steps through K 128
//   elements at a time, and copies a step's 16 rows x 128 bytes with
//   16-byte cp.async (4 rows of 128 contiguous bytes a warp instruction,
//   past L1) kStages - 1 steps ahead of its math; ldmatrix then hands each
//   lane its four bytes of two groups of both rows in one instruction (the
//   8 x 16-byte matrices of a group's rows, 16-byte chunks swizzled by row
//   so that neither side meets a bank conflict). 4-byte loads straight to
//   registers, a quad taking half a 32-byte sector, read the head at 61-69 %
//   of the planes' bytes on the H100;
// - a value becomes an MMA operand without a float conversion: the plane's
//   int8 holds q - 32, whose low six bits XOR 0x20 are q itself (0..63),
//   one lop3 per four values; a byte permute to bf16 0x4300 | q = 128 + q,
//   and one packed bf16 fma less 160 gives q - 32 exactly;
// - each product starts from a fresh f32 accumulator (the tensor cores'
//   chained accumulation truncates), and dl * P is added to a running f32
//   sum per output;
// - dl = d * sc exactly, rounded once: the sign bit of sc flipped (sc +
//   128) and put in bits 8..15 of 2^23 by a byte permute, then one fma,
//   (2^15 + sc + 128) d - (2^15 + 128) d (exact: d is the file's f16, and
//   32896 d needs 20 bits). The four lanes of a quad need the same dl, so
//   a warp forms each of its 16 rows x 8 groups once, four a lane, into a
//   table in shared memory, and each lane reads its two rows' two groups
//   at a time;
// - the step's scales (the table row's four sc bytes and d) load a step
//   ahead into registers;
// - a block's up to 8 warps (4 where the row tiles fill two waves of
//   blocks, 2 where that would leave a part-filled second wave:
//   block_warps) share out its steps; their sums are added in warp order
//   through shared memory, so a repeat launch gives the same bits;
// - one block per 16-row tile, K never split: a call is one launch of one
//   kernel, with no workspace (dequant_matmul.gemv_plan).
//
// Plane layout (N-major, the transpose of the JAX K-major planes): q int8
// [N, K] in element order, sc int8 [N, K/16], d f32 [N, K/256]. x and q
// must be 16-byte aligned (dequant_matmul checks); sc is read 4 bytes at a
// time where its pointer allows, else byte by byte (a second
// instantiation). Offsets are 64-bit: the output head's q plane is 621.6
// MB. Rows past N are read as row N - 1 and not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;       // weight rows a block owns: the MMA's M
constexpr int kStep = 128;      // elements of K a warp takes at a time
constexpr int kStages = 3;      // steps of weight bytes a warp holds in shared memory
constexpr int kMaxWarps = 8;    // warps sharing out a block's steps
constexpr int kManyWarps = 4;   // ... where the row tiles fill two waves of blocks
constexpr int kFewWarps = 2;    // ... where that leaves a part-filled second wave
constexpr int kSms = 132;       // the H100's SMs (dequant_matmul.GEMM_SMS)
constexpr int kGroups = kStep / 16;      // 16-groups a step
constexpr int kStageBytes = kRows * kStep;  // a step's weight bytes
// a warp's shared memory: its ring of steps, then its table of dl (16 rows
// x kGroups f32); the ring's first 512 bytes take its sums at the end
constexpr int kWarpSmem = kStages * kStageBytes + kRows * kGroups * 4;
constexpr uint32_t kOnes = 0x3F803F80u;  // bf16 {1, 1}

// Warps a block: one a step, at most kMaxWarps; kManyWarps where the
// row tiles fill two waves of blocks; kFewWarps where every tile is on the
// card at once at kFewWarps a block but not at kManyWarps (no second,
// part-filled wave: Qwen3-8B's gate, 768 tiles, read 11-17 % faster so on
// the H100, `gemv_plan_probe`). A block's threads take 128 registers each
// (__launch_bounds__), so an SM holds 16 / warps of them.
int block_warps(int n, int k) {
  const int steps = k / kStep;
  const long long tiles = (n + kRows - 1) / kRows;
  const auto on_card = [](int warps) { return (long long)kSms * (16 / warps); };
  int most = kMaxWarps;
  if (tiles >= 2 * kSms)
    most = tiles > on_card(kManyWarps) && tiles <= on_card(kFewWarps) ? kFewWarps : kManyWarps;
  return steps < most ? steps : most;
}

struct Args {
  const __nv_bfloat16* x;
  const int8_t* q;
  const int8_t* sc;
  const float* d;
  void* out;
  int m, n, k, out_f32;
};

// four bytes at p: one load where kAligned, else byte by byte
template <bool kAligned>
__device__ __forceinline__ uint32_t ld4(const void* p) {
  if constexpr (kAligned) {
    return __ldg(static_cast<const uint32_t*>(p));
  } else {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    return __ldg(b) | (uint32_t)__ldg(b + 1) << 8 | (uint32_t)__ldg(b + 2) << 16 |
           (uint32_t)__ldg(b + 3) << 24;
  }
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 16 bytes from global memory to shared memory, past L1
__device__ __forceinline__ void copy16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void copies_commit() { asm volatile("cp.async.commit_group;\n"); }
// wait until at most N of this lane's copy groups are in flight
template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 b16 matrices from shared memory: lane (g, t) gets b16
// elements 2t, 2t + 1 of row g of matrix i in r[i]; lanes 8i .. 8i + 7
// give the addresses of matrix i's rows
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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

// v less 160 in both bf16 halves, exactly: v * 1 + (-160)
__device__ __forceinline__ uint32_t less160(uint32_t v) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(v), "r"(kOnes), "r"(0xC320C320u));
  return r;
}

// The bf16 pairs {v0, v1} and {v2, v3} of the four int8 values q - 32 in
// w: q = (w & 0x3F) ^ 0x20 per byte, bytes 0x43 q = bf16 128 + q, less 160
__device__ __forceinline__ void pairs(uint32_t w, uint32_t& p01, uint32_t& p23) {
  const uint32_t q = (w & 0x3F3F3F3Fu) ^ 0x20202020u;
  p01 = less160(__byte_perm(q, 0x43u, 0x4140));
  p23 = less160(__byte_perm(q, 0x43u, 0x4342));
}

// The scales a lane reads of one step, a step ahead of its math: those of
// the table row it forms (row lane / 2, groups 4 (lane & 1) .. + 3)
struct Scales {
  uint32_t sc;  // the four group scales
  float d;      // the super-scale of the step's superblock
};

template <bool kAligned>
__device__ __forceinline__ Scales load_scales(const int8_t* sc, const float* d, int s) {
  return {ld4<kAligned>(sc + (size_t)s * kGroups), __ldg(d + (s >> 1))};
}

// The four dl of a table row: d * sc rounded once, each sc byte with its
// sign bit flipped (u = sc + 128, 0..255) put in bits 8..15 of 2^23,
// f = 2^23 + 2^8 u, then f 2^-8 d - 32896 d in one fma
__device__ __forceinline__ float4 table_row(Scales b) {
  const uint32_t u = b.sc ^ 0x80808080u;
  const float d8 = 0x1p-8f * b.d, nd = -32896.f * b.d;
  const auto dl = [&](uint32_t sel) {
    return fmaf(__uint_as_float(__byte_perm(u, 0x4B000000u, sel)), d8, nd);
  };
  return make_float4(dl(0x7604u), dl(0x7614u), dl(0x7624u), dl(0x7634u));
}

// Block tile: weight rows 16 tile .. 16 tile + 15 over all of K, its warps
// taking every warps-th step.
template <bool kAligned>
__global__ void __launch_bounds__(kMaxWarps * 32, 2) gemv_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // the MMA's group and thread in group
  const int tile = blockIdx.x * kRows, r0 = tile + g;
  const size_t k = (size_t)a.k;
  uint8_t* ring = smem + warp * kWarpSmem;
  float(*tab)[kGroups] = reinterpret_cast<float(*)[kGroups]>(ring + kStages * kStageBytes);
  const uint32_t ring_at = (uint32_t)__cvta_generic_to_shared(ring);
  // the lane's copies: 16-byte chunk lane & 7 of rows lane / 8 + 4i (a
  // warp instruction covers 4 whole rows of a step), stored at chunk
  // (lane & 7) ^ (row & 7) of its row
  const int8_t* src[4];
  uint32_t dst[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = (lane >> 3) + 4 * i, c = lane & 7;
    src[i] = a.q + (size_t)min(tile + row, a.n - 1) * k + 16 * c;
    dst[i] = ring_at + row * kStep + 16 * (c ^ (row & 7));
  }
  // the lane's ldmatrix row: row (lane & 7) + 8 (lane / 8 & 1) of group
  // 2h + lane / 16
  const int lm_row = (lane & 7) + 8 * ((lane >> 3) & 1), lm_group = lane >> 4;
  const uint32_t lm_at = ring_at + lm_row * kStep;
  // the lane's table row, tile row lane / 2, and its scales
  const size_t tr = (size_t)min(tile + (lane >> 1), a.n - 1);
  const int8_t* sc = a.sc + tr * (k >> 4) + 4 * (lane & 1);
  const float* d = a.d + tr * (k >> 8);
  const int s_end = a.k / kStep;
  const int steps = warp < s_end ? (s_end - warp + warps - 1) / warps : 0;  // the warp's
  // lane g feeds row g of x as the MMA's column g; past M it repeats row
  // M - 1, and those columns' outputs are not written
  const uint2* xg = reinterpret_cast<const uint2*>(a.x + (size_t)min(g, a.m - 1) * a.k);

  // the warp's step i (K step warp + i * warps) into ring slot i % kStages
  const auto copy_step = [&](int i) {
    if (i < steps) {
      const size_t off = (size_t)(warp + i * warps) * kStep;
      const uint32_t slot = (uint32_t)(i % kStages) * kStageBytes;
#pragma unroll
      for (int r = 0; r < 4; ++r) copy16(dst[r] + slot, src[r] + off);
    }
    copies_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) copy_step(i);
  Scales next = steps > 0 ? load_scales<kAligned>(sc, d, warp) : Scales{0u, 0.f};

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < steps; ++i) {
    const int s = warp + i * warps;
    copy_step(i + kStages - 1);  // into the slot step i - 1 left
    const Scales cur = next;
    if (i + 1 < steps) next = load_scales<kAligned>(sc, d, s + warps);
    *reinterpret_cast<float4*>(&tab[lane >> 1][4 * (lane & 1)]) = table_row(cur);
    copies_wait<kStages - 1>();  // step i's copies are in
    __syncwarp();
    const uint32_t slot = lm_at + (uint32_t)(i % kStages) * kStageBytes;
    const uint2* xs = xg + s * (kStep / 4) + t;
#pragma unroll
    for (int h = 0; h < kGroups / 2; ++h) {  // groups 2h, 2h + 1
      uint32_t w[4];  // rows g, g + 8 of group 2h, then of 2h + 1
      ldmatrix4(w, slot + 16 * ((2 * h + lm_group) ^ (lane & 7)));
      const float2 dlo = *reinterpret_cast<const float2*>(&tab[g][2 * h]);
      const float2 dhi = *reinterpret_cast<const float2*>(&tab[g + 8][2 * h]);
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // group i: 4 bf16 = one uint2, elements s*128 + 16i + 4t
        const uint2 xf = __ldg(xs + 4 * (2 * h + c));
        uint32_t lo[2], hi[2];  // [pair]: row g, row g + 8
        pairs(w[2 * c], lo[0], lo[1]);
        pairs(w[2 * c + 1], hi[0], hi[1]);
        float o[4];
        mma(o, lo[0], hi[0], lo[1], hi[1], xf.x, xf.y);
        const float dl[2] = {c ? dlo.y : dlo.x, c ? dhi.y : dhi.x};
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = fmaf(dl[e >> 1], o[e], acc[e]);
      }
    }
    __syncwarp();  // step i's slot and the table are read
  }
  copies_wait<0>();

  // the warps' sums, added in warp order (each warp's in its own ring)
  float(*red)[4] = reinterpret_cast<float(*)[4]>(ring);
  if (warp > 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) red[lane][e] = acc[e];
  }
  __syncthreads();
  if (warp > 0) return;
  for (int w = 1; w < warps; ++w) {
    const float(*other)[4] = reinterpret_cast<const float(*)[4]>(smem + w * kWarpSmem);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += other[lane][e];
  }
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

template <bool kAligned>
int launch(const Args& a, cudaStream_t st) {
  // one attribute per instance; this namespace keeps it out of other
  // libraries (a template static is otherwise one GNU-unique symbol)
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemv_kernel<kAligned>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxWarps * kWarpSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int warps = block_warps(a.n, a.k);
  gemv_kernel<kAligned><<<(unsigned)((a.n + kRows - 1) / kRows), 32 * warps,
                          warps * kWarpSmem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 = launched). The mn, dm and qh
// arguments keep the signature of the other matmul entries; Q6_K has no
// min and no high-bit plane, so they are unused.
extern "C" int q6k_gemv(const void* x, const void* q, const void* sc, const void* mn,
                        const void* d, const void* dm, const void* qh, void* out, int m, int n,
                        int k, int out_f32, void* stream) {
  (void)mn;
  (void)dm;
  (void)qh;
  if (m < 1 || m > 8 || n < 1 || k < 256 || k % 256 != 0 || sc == nullptr || d == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
               static_cast<const int8_t*>(sc), static_cast<const float*>(d), out, m, n, k,
               out_f32};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return reinterpret_cast<uintptr_t>(sc) % 4 == 0 ? launch<true>(a, st) : launch<false>(a, st);
}
