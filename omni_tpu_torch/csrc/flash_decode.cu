// flash_decode: attention of T*G query rows per KV head over one layer of
// the head-major KV cell pool, bf16, int8 or packed-int4 cells.
//
// Replaces omni_tpu/kernels/flash_attention.py::flash_decode (:141, body
// _kernel :24-73; bf16 and int8 cells) and ::_flash_decode4 (:217, body
// _kernel4 :76-136; packed int4 cells): the attention of every layer when
// the KV cache is quantized (`--cache-type-k q8_0 | q4_0`).
//
// The law (that of the Pallas kernels, and of flash_decode_plain in
// omni_tpu_torch/kernels/flash_attention.py), per query row and cell c:
//   sc = (bf16(q) . k[c]) * scale            f32, k exact in bf16
//   sc = sc * ks[c]                          quantized cells
//   sc = -1e30 where the mask is false       finite: a row masked
//                                            everywhere gives the mean of V
//   online softmax over tiles: m = max(m, max sc); p = exp(sc - m);
//   corr = exp(m_old - m); l = corr * l + sum p (unscaled p);
//   acc = corr * acc + bf16(p * vs[c]) . v[c]   (vs only for quantized)
//   out = acc / max(l, 1e-30)                f32
// int4 cells: byte d of a row holds logical column d in its low nibble and
// column d + D/2 in its high nibble, each biased +8; q and out keep the
// natural [.., D] order (the Pallas kernel's split halves are a Mosaic
// workaround, not part of the law).
//
// What bounds it on the H100, by rows = T*G per KV head (a plain branch,
// the regime, chosen on the host by split_plan):
// - prefill (rows > 8; a 64-token ubatch has 256 rows per head):
//   operations. 4 * rows * S * D per head (2.15 GFLOP a call at T = 64 over
//   2,048 cells, 2.2 us at the bf16 tensor-core peak) against ~1 MB of
//   cells: each cell is used by every row, so the products must run on the
//   tensor cores and a cell tile must serve many rows;
// - decode (rows <= 8: T = 1 or 2 at G = 4): bytes, ~4 FLOP per cell byte
//   against the card's ~295; and at the served 512-cell bucket (0.6-2.1 MB
//   a call by cell type, 0.2-0.6 us of HBM time) launches and latency.
// The design:
// - a block of 4 warps streams one split of one head's cells in tiles of
//   64, staged by cp.async into a three-slot ring (the next two tiles'
//   copies run while one is used; neighbouring threads copy neighbouring
//   16-byte chunks), each lane's mask bits of a tile loaded before the
//   tile's wait. bf16 cells land straight in ldmatrix-ready rows; int8 and
//   int4 cells land raw with their scales, and the block widens each tile
//   once into bf16 rows (exact: |int8| <= 128 and a nibble - 8 lies in
//   [-8, 7]; int4 takes the natural column order there). Rows are padded by
//   16 bytes so that the 8 rows of each ldmatrix fall on distinct banks;
// - both products run on mma.sync.m16n8k16 (bf16 in, f32 accumulators):
//   S = Q.K^T with a warp's 16 query rows as M (q rounded to bf16 once and
//   held as A fragments in registers; row r of a head is token r / G, group
//   member r % G, each row reading its own token's mask row), cells as N
//   and ldmatrix for the K rows; then ·scale and ·ks[c] in f32, -1e30 where
//   masked, -inf past the split's end (p = 0); the online softmax on the
//   accumulator fragments (a row's max and sum over the 4 lanes holding it,
//   shuffles 1 and 2; expf, not __expf); p·vs rounded to bf16 to nearest
//   even and packed straight into the A fragments of P.V (two n8
//   accumulator tiles are one k16 A operand); V through ldmatrix.trans; acc
//   16 x D in f32 registers per warp;
// - prefill: the 4 warps own 64 different rows and share every tile, so a
//   tile serves 64 rows. 4 warps of 16 rows, not 8: a thread holds ~230
//   registers (acc 64, q 32, S 32), so an SM takes two 4-warp blocks or one
//   8-warp block; two blocks overlap one's barriers with the other's work;
// - decode: the <= 8 rows sit in the first half of one 16-row fragment and
//   the 4 warps split each tile's cells, 16 each, so every cell's K and V
//   bytes are read once per block for all of its rows; at the end the
//   warps' (m, l, acc) are merged through shared memory:
//   m = max m_i, l = sum e^(m_i - m) l_i, acc = sum e^(m_i - m) acc_i;
// - splits: a head's cells are split only as far as filling the 132 SMs
//   two blocks deep needs (split_plan), at most 64. Each split writes its
//   partial (m, l, acc) to the workspace, and merge_rows merges them with
//   the same formula, acc in split order and l in a fixed order, so the
//   bits do not depend on which block runs it. At decode the last split of
//   a head to arrive (a counter per head, atomicAdd after a fence) merges
//   them and resets its counter to zero: one launch a call. At prefill a
//   second launch, merge_kernel, spreads the merge over the card: there the
//   last split of a 64-row block would read 33 KB from every split alone
//   (~10 us at T = 64 against ~2 us spread). A split whose cells are all
//   masked for a row gives m_i = -1e30 and is wiped by the merge
//   (e^(-1e30 - m) = 0) unless every split is.
// The kernel's p is rounded against its own running maximum (per warp over
// 64-cell tiles at prefill, over its 16 cells of each tile at decode) where
// the Pallas kernel's runs over 512-cell tiles: the two differ by those bf16
// roundings, and sums taken in another order.
//
// Layout: q bf16 [T, Hq, D] (Hq = Hkv * G, row r = t * G + g), cells of
// head h at k + h * head_stride (elements), each cell D elements (D/2
// bytes for int4) contiguous, scales f32 at ks + h * scale_stride + c, mask
// bool [T, S], out f32 [T, Hq, D].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;         // cells per shared-memory tile
constexpr int kStages = 3;        // ring slots: two tiles in flight while one is used
constexpr int kDecodeRows = 8;    // most rows per head the decode regime takes
constexpr int kBlockRows = 16 * kWarps;  // rows per block at prefill
constexpr int kMaxSplits = 64;            // splits of a head's cells, at most
constexpr int kMergeRows = 16;            // rows a prefill merge block takes
constexpr float kNegInf = -1e30f;

enum CellType { kBf16 = 0, kInt8 = 1, kInt4 = 2 };
enum Regime { kDecode = 0, kPrefill = 1 };

// Shared memory of one block (mirrored by flash_attention.shared_bytes):
// kStages ring slots, then for quantized cells the widened bf16 tiles.
template <int CT, int D>
struct Layout {
  // bytes of one cell's row as stored
  static constexpr int kRowBytes = CT == kBf16 ? 2 * D : (CT == kInt8 ? D : D / 2);
  static constexpr int kChunks = kRowBytes / 16;
  // a bf16 row padded by 16 bytes: 4 banks further on per row
  static constexpr int kPitch = 2 * D + 16;
  static constexpr int kTileBytes = kTile * kPitch;  // one bf16 tile, K or V
  // a ring slot: bf16 K and V tiles; or raw K rows, raw V rows, ks, vs
  static constexpr int kSlotBytes =
      CT == kBf16 ? 2 * kTileBytes : 2 * kTile * kRowBytes + 2 * kTile * 4;
  static constexpr int kWideOffset = kStages * kSlotBytes;
  static constexpr int kSmem = kWideOffset + (CT == kBf16 ? 0 : 2 * kTileBytes);
  // the decode regime's merges reuse it: the warps' (m, l, acc [D]) per
  // row, then the splits' weights (merge_rows)
  static_assert(kWarps * kDecodeRows * (D + 2) * 4 <= kSmem, "warp merge");
  static_assert(kDecodeRows * (2 * kMaxSplits + 1) * 4 <= kSmem, "split merge");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes; a dead source (live false) reads nothing and
// fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// two f32 as bf16 rounded to nearest even, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Byte i of x as an f32 without I2F (a quarter-rate instruction): the bits
// 0x4B0000xx are the float 2^23 + xx exactly, so subtracting 2^23 + 128
// gives xx - 128; x is an int8 word ^ 0x80808080 (xx = b + 128).
template <int I>
__device__ __forceinline__ float byte_f32(unsigned x) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 | I)) - (8388608.f + 128.f);
}

// Two nibbles (bytes of x, each < 16, picked by `sel`) as a bf16 pair
// n - 8: the bits 0x43nn are the bf16 128 + nn exactly, then one exact
// bf16x2 subtraction of 136.
__device__ __forceinline__ uint32_t nibbles_bf16(unsigned x, unsigned sel) {
  const uint32_t w = __byte_perm(x, 0x43434343u, sel);
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&w), __float2bfloat162_rn(136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Start copying cells [c0, c0 + n) of one head (and their scales) into a
// ring slot. Cells past n are zeros, which add nothing: their p is 0.
template <int CT, int D>
__device__ __forceinline__ void stage(uint8_t* __restrict__ dst,
                                      const uint8_t* __restrict__ kh,
                                      const uint8_t* __restrict__ vh,
                                      const float* __restrict__ ksh,
                                      const float* __restrict__ vsh, int c0, int n) {
  using L = Layout<CT, D>;
  // bf16: straight into the padded tiles; quantized: raw rows, V after K
  constexpr int kPitch = CT == kBf16 ? L::kPitch : L::kRowBytes;
  constexpr int kVOffset = kTile * kPitch;
  for (int i = threadIdx.x; i < kTile * L::kChunks; i += kThreads) {
    const int cell = i / L::kChunks, part = i % L::kChunks;
    const bool live = cell < n;
    const size_t off = (size_t)(c0 + (live ? cell : 0)) * L::kRowBytes + part * 16;
    cp_async16(dst + cell * kPitch + part * 16, kh + off, live);
    cp_async16(dst + kVOffset + cell * kPitch + part * 16, vh + off, live);
  }
  if (CT != kBf16 && threadIdx.x < 2 * kTile) {
    float* sc = reinterpret_cast<float*>(dst + 2 * kTile * L::kRowBytes);
    const int c = threadIdx.x & (kTile - 1);
    const bool live = c < n;
    cp_async4(sc + threadIdx.x, (threadIdx.x < kTile ? ksh : vsh) + c0 + (live ? c : 0),
              live);
  }
}

// Widen a slot's raw K and V rows into the bf16 tiles, 8 columns (16
// bytes) per thread at a time, natural column order.
template <int CT, int D>
__device__ __forceinline__ void widen(uint8_t* __restrict__ wide,
                                      const uint8_t* __restrict__ raw) {
  using L = Layout<CT, D>;
  constexpr int kOcts = D / 8;
  for (int i = threadIdx.x; i < 2 * kTile * kOcts; i += kThreads) {
    const int row = i / kOcts, col = (i % kOcts) * 8;  // rows: K cells, then V cells
    uint4 o;
    if (CT == kInt8) {
      const uint2 w = *reinterpret_cast<const uint2*>(raw + row * L::kRowBytes + col);
      const unsigned x0 = w.x ^ 0x80808080u, x1 = w.y ^ 0x80808080u;
      o.x = pack_bf16(byte_f32<0>(x0), byte_f32<1>(x0));
      o.y = pack_bf16(byte_f32<2>(x0), byte_f32<3>(x0));
      o.z = pack_bf16(byte_f32<0>(x1), byte_f32<1>(x1));
      o.w = pack_bf16(byte_f32<2>(x1), byte_f32<3>(x1));
    } else {
      // columns [col, col + 8): the low nibbles of bytes col.. for the first
      // D/2 columns, the high nibbles of bytes col - D/2.. after
      const int shift = col >= D / 2 ? 4 : 0;
      const uint2 w =
          *reinterpret_cast<const uint2*>(raw + row * L::kRowBytes + col % (D / 2));
      const unsigned x0 = (w.x >> shift) & 0x0F0F0F0Fu, x1 = (w.y >> shift) & 0x0F0F0F0Fu;
      o.x = nibbles_bf16(x0, 0x4140);
      o.y = nibbles_bf16(x0, 0x4342);
      o.z = nibbles_bf16(x1, 0x4140);
      o.w = nibbles_bf16(x1, 0x4342);
    }
    *reinterpret_cast<uint4*>(wide + row * L::kPitch + col * 2) = o;
  }
}

// Mask bytes c and c + 1 of a mask row (c even) as bits 0 and 8; cells at
// or past c_end read nothing. `even`: the row and c are 2-byte aligned and
// c + 1 lies inside the row.
__device__ __forceinline__ unsigned mask_pair(const uint8_t* __restrict__ mrow, int c,
                                              int c_end, bool even) {
  if (even) return c < c_end ? __ldg(reinterpret_cast<const unsigned short*>(mrow + c)) : 0u;
  unsigned r = c < c_end ? __ldg(mrow + c) : 0u;
  if (c + 1 < c_end) r |= (unsigned)__ldg(mrow + c + 1) << 8;
  return r;
}

// The merged (m, l, acc) of row `row`, column d: out, or this split's
// partial in the workspace (acc [Hkv, nsplit, TG, D], then m and l
// [Hkv, nsplit, TG]).
template <int D>
__device__ __forceinline__ void finish(float* __restrict__ out, float* __restrict__ ws,
                                       int h, int hkv, int split, int nsplit, int tg, int g,
                                       int row, int d, float m, float l, float acc0,
                                       float acc1, bool write_ml) {
  if (nsplit == 1) {
    const int t = row / g;
    float* o = out + ((size_t)t * hkv * g + (size_t)h * g + row % g) * D + d;
    const float den = fmaxf(l, 1e-30f);
    o[0] = acc0 / den;
    o[1] = acc1 / den;
  } else {
    const size_t slot = ((size_t)h * nsplit + split) * tg + row;
    const size_t n_slots = (size_t)hkv * nsplit * tg;
    *reinterpret_cast<float2*>(ws + slot * D + d) = make_float2(acc0, acc1);
    if (write_ml) {
      ws[n_slots * D + slot] = m;
      ws[n_slots * (D + 1) + slot] = l;
    }
  }
}

// Merge the splits' partials (finish's workspace layout) of rows
// [r_lo, r_lo + n_rows) of head h into out, with the formula
// m = max m_i, l = sum e^(m_i - m) l_i, acc = sum e^(m_i - m) acc_i:
// acc in split order, l in a fixed order, so the bits do not depend on
// which block runs it. sm: shared memory for n_rows * (2 * kMaxSplits + 1)
// floats. REG picks the shape: at decode <= 8 rows and up to 64 splits (a
// warp per row, its lanes over the splits; one item a thread, 16 splits of
// loads in flight), at prefill kMergeRows rows and a few splits (a thread
// per row; four items a thread, 8 splits of loads in flight). The loads go
// out together (every load of a chunk before a store, the first acc loads
// before the weights are made): loops that loaded and stored in turn, or
// left the splits to a serial remainder, cost 3-10 us.
template <int D, int REG>
__device__ __forceinline__ void merge_rows(const float* __restrict__ ws,
                                           float* __restrict__ out, float* __restrict__ sm,
                                           int h, int hkv, int g, int tg, int nsplit,
                                           int r_lo, int n_rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, hq = hkv * g;
  const size_t n_slots = (size_t)hkv * nsplit * tg;
  const size_t first = (size_t)h * nsplit * tg + r_lo;  // split 0's slot of row r_lo
  const float* ws_m = ws + n_slots * D;
  const float* ws_l = ws + n_slots * (D + 1);
  float* wts = sm;                          // [row][split]: m_i, then e^(m_i - m)
  float* ls = wts + n_rows * kMaxSplits;    // [row][split]: l_i
  float* den = ls + n_rows * kMaxSplits;    // [row]: max(l, 1e-30)
  // acc, four columns (an item) at a time; the first chunk's loads go out
  // before the weights are made, so that the two wait together
  constexpr int kItems = REG == kPrefill ? 4 : 1;
  constexpr int kChunk = REG == kPrefill ? 8 : 16;
  const int n_items = n_rows * (D / 4);
  float4 x[kChunk][kItems];
  auto load_chunk = [&](int base, int i0) {
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        const int idx = min(base + u * kThreads, n_items - 1);
        const float* a = ws + (first + idx / (D / 4)) * D + 4 * (idx % (D / 4));
        x[c][u] = i0 + c < nsplit
                      ? __ldcg(reinterpret_cast<const float4*>(a + (size_t)(i0 + c) * tg * D))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
  };
  load_chunk(threadIdx.x, 0);
  if (REG == kPrefill) {
    // a thread per row: every split's m and l, their loads in flight
    // together, then the row's max, the weights and l in split order
    for (int r = threadIdx.x; r < n_rows; r += kThreads) {
      float* wr = wts + r * kMaxSplits;
      float* lr = ls + r * kMaxSplits;
      for (int i0 = 0; i0 < nsplit; i0 += 16) {  // whole chunks, every load before a store
        float mv[16], lv[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const size_t slot = first + (size_t)min(i0 + u, nsplit - 1) * tg + r;
          mv[u] = __ldcg(ws_m + slot);
          lv[u] = __ldcg(ws_l + slot);
        }
#pragma unroll
        for (int u = 0; u < 16; ++u)
          if (i0 + u < nsplit) {
            wr[i0 + u] = mv[u];
            lr[i0 + u] = lv[u];
          }
      }
      float mm = -INFINITY;
      for (int i = 0; i < nsplit; ++i) mm = fmaxf(mm, wr[i]);
      float ll = 0.f;
      for (int i = 0; i < nsplit; ++i) {
        const float wt = expf(wr[i] - mm);
        wr[i] = wt;
        ll = fmaf(wt, lr[i], ll);
      }
      den[r] = fmaxf(ll, 1e-30f);
    }
  } else {
    // a warp per row, its lanes over the splits (lane, lane + 32): the
    // row's max and l by shuffles
    for (int r = warp; r < n_rows; r += kWarps) {
      float mi[2], li[2], mm = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = lane + 32 * j;
        const size_t slot = first + (size_t)min(i, nsplit - 1) * tg + r;
        mi[j] = i < nsplit ? __ldcg(ws_m + slot) : -INFINITY;
        li[j] = i < nsplit ? __ldcg(ws_l + slot) : 0.f;
        mm = fmaxf(mm, mi[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
      float ll = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = lane + 32 * j;
        const float wt = i < nsplit ? expf(mi[j] - mm) : 0.f;
        if (i < nsplit) wts[r * kMaxSplits + i] = wt;
        ll = fmaf(wt, li[j], ll);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ll += __shfl_xor_sync(0xffffffffu, ll, off);
      if (lane == 0) den[r] = fmaxf(ll, 1e-30f);
    }
  }
  __syncthreads();
  for (int base = threadIdx.x; base < n_items; base += kItems * kThreads) {
    float4 sum[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) sum[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i0 = 0; i0 < nsplit; i0 += kChunk) {  // whole chunks, the loads first
      if (base != threadIdx.x || i0 != 0) load_chunk(base, i0);
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (i0 + c >= nsplit) break;
#pragma unroll
        for (int u = 0; u < kItems; ++u) {
          const int r = min(base + u * kThreads, n_items - 1) / (D / 4);
          const float wt = wts[r * kMaxSplits + i0 + c];
          sum[u].x = fmaf(wt, x[c][u].x, sum[u].x);
          sum[u].y = fmaf(wt, x[c][u].y, sum[u].y);
          sum[u].z = fmaf(wt, x[c][u].z, sum[u].z);
          sum[u].w = fmaf(wt, x[c][u].w, sum[u].w);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int idx = base + u * kThreads;
      if (idx >= n_items) break;
      const int r = idx / (D / 4), row_g = r_lo + r, t = row_g / g, d = 4 * (idx % (D / 4));
      const float dn = den[r];
      *reinterpret_cast<float4*>(out + ((size_t)t * hq + (size_t)h * g + row_g % g) * D + d) =
          make_float4(sum[u].x / dn, sum[u].y / dn, sum[u].z / dn, sum[u].w / dn);
    }
  }
}

template <int CT, int D, int REG>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k,
             const uint8_t* __restrict__ v, const uint8_t* __restrict__ mask,
             const float* __restrict__ ks, const float* __restrict__ vs,
             float* __restrict__ out, float* __restrict__ ws,
             unsigned* __restrict__ counters, int t_rows, int g, int s,
             long long head_stride, long long scale_stride, float scale, int per_split,
             int nsplit) {
  using L = Layout<CT, D>;
  constexpr bool kQuant = CT != kBf16;
  constexpr int kNT = REG == kPrefill ? kTile / 8 : 2;  // n8 cell tiles a warp scores
  constexpr int kDT = D / 8;                            // n8 tiles of output columns
  constexpr int kKS = D / 16;                           // k16 steps of Q.K^T
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ bool last;

  const int split = blockIdx.x, rb = blockIdx.y, h = blockIdx.z, hkv = gridDim.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tg = t_rows * g, hq = hkv * g;
  const int c_begin = split * per_split;
  const int c_end = min(s, c_begin + per_split);
  const size_t itemsize = CT == kBf16 ? 2 : 1;
  const uint8_t* kh = k + (size_t)h * head_stride * itemsize;
  const uint8_t* vh = v + (size_t)h * head_stride * itemsize;
  const float* ksh = kQuant ? ks + (size_t)h * scale_stride : nullptr;
  const float* vsh = kQuant ? vs + (size_t)h * scale_stride : nullptr;

  // this lane's two rows (fragment rows lane/4 and lane/4 + 8): at prefill
  // the warp's 16 rows, at decode rows 0..15 of which the first tg <= 8
  // are real; rows past T*G run masked and are never written
  const int r0 = REG == kPrefill ? rb * kBlockRows + 16 * warp : 0;
  const int row[2] = {r0 + (lane >> 2), r0 + (lane >> 2) + 8};
  bool real[2];
  const uint8_t* mrow[2];
  const uint32_t* qrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    real[i] = row[i] < tg;
    const int r = min(row[i], tg - 1), t = r / g;
    mrow[i] = mask + (size_t)t * s;
    qrow[i] = reinterpret_cast<const uint32_t*>(q + ((size_t)t * hq + (size_t)h * g + r % g) * D);
  }
  // q as the A fragments of Q.K^T, bf16, for every k16 step
  uint32_t qf[kKS][4];
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    qf[kk][0] = real[0] ? qrow[0][8 * kk + (lane & 3)] : 0u;
    qf[kk][1] = real[1] ? qrow[1][8 * kk + (lane & 3)] : 0u;
    qf[kk][2] = real[0] ? qrow[0][8 * kk + 4 + (lane & 3)] : 0u;
    qf[kk][3] = real[1] ? qrow[1][8 * kk + 4 + (lane & 3)] : 0u;
  }
  // then the first tiles' copies (a group per tile, empty past the split's
  // end)
  const int n_tiles = (c_end - c_begin + kTile - 1) / kTile;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles)
      stage<CT, D>(smem + i * L::kSlotBytes, kh, vh, ksh, vsh, c_begin + i * kTile,
                   min(kTile, c_end - c_begin - i * kTile));
    cp_async_commit();
  }
  const bool even = ((reinterpret_cast<uintptr_t>(mask) | (uintptr_t)s) & 1) == 0;
  // the warp's first cell of each tile: all 64 at prefill, 16 at decode
  const int cw = REG == kPrefill ? 0 : 16 * warp;
  const bool active = REG == kDecode || r0 < tg;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int c0 = c_begin + it * kTile;
    const uint8_t* slot = smem + (it % kStages) * L::kSlotBytes;
    // this tile's mask bits (row a's pair in the low half, row b's in the
    // high), loaded before the wait so that their latency hides behind it
    unsigned vis[kNT];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int c = c0 + cw + 8 * j + 2 * (lane & 3);
      vis[j] = (active && real[0] ? mask_pair(mrow[0], c, c_end, even) : 0u) |
               (active && real[1] ? mask_pair(mrow[1], c, c_end, even) << 16 : 0u);
    }
    cp_async_wait<kStages - 2>();  // tile it has landed (tile it + 1 may not)
    __syncthreads();  // tile it in every thread's view; every warp done with it - 1
    if (it + kStages - 1 < n_tiles)  // into the slot tile it - 1 used
      stage<CT, D>(smem + ((it + kStages - 1) % kStages) * L::kSlotBytes, kh, vh, ksh, vsh,
                   c0 + (kStages - 1) * kTile, min(kTile, c_end - c0 - (kStages - 1) * kTile));
    cp_async_commit();
    const uint8_t* kt = slot;
    const float* ks_t = nullptr;
    const float* vs_t = nullptr;
    if constexpr (kQuant) {
      widen<CT, D>(smem + L::kWideOffset, slot);
      ks_t = reinterpret_cast<const float*>(slot + 2 * kTile * L::kRowBytes);
      vs_t = ks_t + kTile;
      kt = smem + L::kWideOffset;
      __syncthreads();  // the widened tiles in every warp's view
    }
    const uint8_t* vt = kt + L::kTileBytes;
    if (!active) continue;

    // S = Q.K^T over this warp's cells: K rows through ldmatrix (lanes
    // 0-7 cells 0-7 at d, 8-15 the same cells at d + 8, 16-31 cells 8-15)
    float sc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    const uint8_t* k_lane =
        kt + (cw + (lane & 7) + ((lane >> 4) << 3)) * L::kPitch + ((lane >> 3) & 1) * 16;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, k_lane + 16 * np * L::kPitch + kk * 32);
        mma_bf16(sc[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], b[2], b[3]);
      }

    // scale, K scale, mask; the tile's row max over the 4 lanes of a row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int lc = cw + 8 * j + 2 * (lane & 3);  // this lane's first cell in the tile
      const int c = c0 + lc;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[j][2 * i + e] * scale;
          if (kQuant) x = x * ks_t[lc + e];
          // masked: -1e30 as the law; past the split's end: no cell at all
          x = (vis[j] >> (16 * i + 8 * e)) & 0xFFu ? x : (c + e < c_end ? kNegInf : -INFINITY);
          sc[j][2 * i + e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
    // p = exp(sc - m); l from the unscaled p (this lane's share of the
    // row, summed over the 4 lanes at the end); then p * vs
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int lc = cw + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = expf(sc[j][e] - m[e >> 1]);
        lsum[e >> 1] += p;
        if (kQuant) p = p * vs_t[lc + (e & 1)];
        sc[j][e] = p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = corr[i] * l[i] + lsum[i];
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // acc += bf16(p) . V: two n8 tiles of p are one k16 A operand; V rows
    // through ldmatrix.trans (lanes 0-7 cells 0-7 at d, 8-15 cells 8-15 at
    // d, 16-31 the same at d + 8)
    const uint8_t* v_lane =
        vt + (cw + (lane & 7) + (((lane >> 3) & 1) << 3)) * L::kPitch + (lane >> 4) * 16;
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, v_lane + 16 * kk * L::kPitch + dp * 32);
        mma_bf16(acc[2 * dp], pa, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();  // the last (empty) groups

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  if (REG == kPrefill) {
    // each warp owns its rows: finish them from the registers
    if (active) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!real[i]) continue;
#pragma unroll
        for (int j = 0; j < kDT; ++j)
          finish<D>(out, ws, h, hkv, split, nsplit, tg, g, row[i], 8 * j + 2 * (lane & 3),
                    m[i], l[i], acc[j][2 * i], acc[j][2 * i + 1], j == 0 && (lane & 3) == 0);
      }
    }
  } else {
    // decode: merge the warps' (m, l, acc) of rows 0..tg-1 through shared
    // memory, in warp order
    __syncthreads();  // every warp is done with the tiles
    float* mg_m = reinterpret_cast<float*>(smem);
    float* mg_l = mg_m + kWarps * kDecodeRows;
    float* mg_acc = mg_l + kWarps * kDecodeRows;  // [warp][row][D]
    if (real[0]) {
      const int slot = warp * kDecodeRows + row[0];
      if ((lane & 3) == 0) {
        mg_m[slot] = m[0];
        mg_l[slot] = l[0];
      }
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        mg_acc[slot * D + 8 * j + 2 * (lane & 3)] = acc[j][0];
        mg_acc[slot * D + 8 * j + 2 * (lane & 3) + 1] = acc[j][1];
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < tg * (D / 2); idx += kThreads) {
      const int r = idx / (D / 2), d = 2 * (idx % (D / 2));
      float mm = mg_m[r];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, mg_m[w * kDecodeRows + r]);
      float ll = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int slot = w * kDecodeRows + r;
        const float wt = expf(mg_m[slot] - mm);
        ll = fmaf(wt, mg_l[slot], ll);
        a0 = fmaf(wt, mg_acc[slot * D + d], a0);
        a1 = fmaf(wt, mg_acc[slot * D + d + 1], a1);
      }
      finish<D>(out, ws, h, hkv, split, nsplit, tg, g, r, d, mm, ll, a0, a1, d == 0);
    }
  }
  // one split: done; prefill: merge_kernel merges the splits
  if (nsplit == 1 || REG == kPrefill) return;

  // decode: the last split of this head to arrive merges them all
  __threadfence();  // this block's partials before its arrival
  __syncthreads();
  unsigned* counter = counters + h;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == (unsigned)nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();  // every split's partials before they are read
  merge_rows<D, kDecode>(ws, out, reinterpret_cast<float*>(smem), h, hkv, g, tg, nsplit, 0, tg);
  if (threadIdx.x == 0) *counter = 0u;  // ready for the next call
}

// Prefill: merge the splits' partials of kMergeRows rows of one head (grid
// (row groups, Hkv)), after flash_kernel on the same stream. Spread over
// the card, where the last split of a 64-row block would read its 33 KB
// partials of every split alone.
template <int D>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ ws, float* __restrict__ out, int tg, int g,
             int nsplit) {
  __shared__ float sm[kMergeRows * (2 * kMaxSplits + 1)];
  const int r_lo = blockIdx.x * kMergeRows;
  merge_rows<D, kPrefill>(ws, out, sm, blockIdx.y, gridDim.y, g, tg, nsplit, r_lo,
                          min(kMergeRows, tg - r_lo));
}

template <int CT, int D, int REG>
int launch(const void* q, const void* k, const void* v, const void* mask, const void* ks,
           const void* vs, void* out, void* ws, void* counters, int t, int hkv, int g,
           int s, long long head_stride, long long scale_stride, float scale,
           int per_split, int nsplit, cudaStream_t st) {
  using L = Layout<CT, D>;
  // one attribute per instance; this namespace keeps it out of other
  // libraries (a template static is otherwise one GNU-unique symbol)
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<CT, D, REG>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int rows = t * g;
  const int row_blocks = REG == kPrefill ? (rows + kBlockRows - 1) / kBlockRows : 1;
  const dim3 grid(nsplit, row_blocks, hkv);
  flash_kernel<CT, D, REG><<<grid, kThreads, L::kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<float*>(out), static_cast<float*>(ws), static_cast<unsigned*>(counters),
      t, g, s, head_stride, scale_stride, scale, per_split, nsplit);
  if (REG == kPrefill && nsplit > 1) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    merge_kernel<D><<<dim3((rows + kMergeRows - 1) / kMergeRows, hkv), kThreads, 0, st>>>(
        static_cast<const float*>(ws), static_cast<float*>(out), rows, g, nsplit);
  }
  return (int)cudaGetLastError();
}

template <int CT>
int dispatch(const void* q, const void* k, const void* v, const void* mask,
             const void* ks, const void* vs, void* out, void* ws, void* counters, int t,
             int hkv, int g, int s, int d, long long head_stride, long long scale_stride,
             float scale, int regime, int per_split, int nsplit, void* stream) {
  const long long rows = (long long)t * g;
  if (t < 1 || hkv < 1 || g < 1 || s < 1 || per_split < 1 || per_split % kTile ||
      nsplit < 1 || (long long)per_split * nsplit < s ||
      (long long)per_split * (nsplit - 1) >= s || nsplit > kMaxSplits || hkv > 65535 ||
      rows > (1ll << 30) || (d != 64 && d != 128) ||
      (regime != kDecode && regime != kPrefill) ||
      (regime == kDecode && rows > kDecodeRows) ||
      (regime == kPrefill && (rows + kBlockRows - 1) / kBlockRows > 65535) ||
      (CT != kBf16 && (ks == nullptr || vs == nullptr)) ||
      (nsplit > 1 && ws == nullptr) ||
      (regime == kDecode && nsplit > 1 && counters == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FD_LAUNCH(DD, RR)                                                                \
  launch<CT, DD, RR>(q, k, v, mask, ks, vs, out, ws, counters, t, hkv, g, s, head_stride, \
                     scale_stride, scale, per_split, nsplit, st)
  if (d == 128)
    return regime == kDecode ? FD_LAUNCH(128, kDecode) : FD_LAUNCH(128, kPrefill);
  return regime == kDecode ? FD_LAUNCH(64, kDecode) : FD_LAUNCH(64, kPrefill);
#undef FD_LAUNCH
}

}  // namespace

// Each entry returns cudaGetLastError() after its launches (0 = launched):
// one, and at prefill with more than one split a second, merge_kernel.
// regime 0 (decode, T*G <= 8) or 1 (prefill); per_split cells per split (a
// multiple of 64), nsplit <= 64 splits; with nsplit > 1, ws holds
// Hkv * nsplit * T * G * (D + 2) floats, and at decode counters Hkv zeroed
// uint32, which the kernel leaves zeroed. bf16 cells take null scale
// pointers.
#define FD_ENTRY(NAME, CT)                                                                \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* mask,       \
                      const void* ks, const void* vs, void* out, void* ws, void* counters, \
                      int t, int hkv, int g, int s, int d, long long head_stride,         \
                      long long scale_stride, float scale, int regime, int per_split,     \
                      int nsplit, void* stream) {                                         \
    return dispatch<CT>(q, k, v, mask, ks, vs, out, ws, counters, t, hkv, g, s, d,        \
                        head_stride, scale_stride, scale, regime, per_split, nsplit,      \
                        stream);                                                          \
  }

FD_ENTRY(flash_decode_bf16, kBf16)
FD_ENTRY(flash_decode_i8, kInt8)
FD_ENTRY(flash_decode_i4, kInt4)
