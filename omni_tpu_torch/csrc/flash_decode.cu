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
// Bound on the H100: at decode (T = 1, G = 4 rows per head) device-memory
// bytes, ~4 FLOP per cell byte of int8 against the card's ~295 (bf16
// tensor cores; ~20 on the CUDA cores in f32); prefill rows (T = 64: 256
// rows per head) reuse each tile 256 times and become compute-bound. The
// design is split-S flash-decoding (the role of llama.cpp's fattn-vec):
// - grid (splits, row tiles, Hkv). The splits of a head's S cells are
//   chosen on the host (split_plan) so that Hkv x row tiles x splits fills
//   the 132 SMs several times over at T = 1;
// - a block of 4 warps copies 32 cells of K and V (and their scales) at a
//   time into shared memory as raw bytes, with cp.async into two stages:
//   the next tile's copy runs while this one is used. Neighbouring threads
//   copy neighbouring 16-byte chunks; K rows are padded by 16 bytes so that
//   lane j's 16-byte reads of row j fall on distinct banks;
// - each warp runs RW query rows against the tile: lane j scores cell j,
//   dequantizing its K row as it reads it (int8 and nibbles - 8 are exact
//   in f32), the warp reduces max and sum with shuffles, then each lane
//   accumulates D/32 contiguous output columns over the tile's 32
//   probabilities, reading one word of each V row;
// - expf, not __expf; IEEE division; p rounded to bf16 to nearest even, as
//   the law rounds it. The kernel's p is rounded against its running max
//   of 32-cell tiles where the Pallas kernel's max runs over 512-cell tiles:
//   the two differ by those roundings only;
// - with one split the block writes the output; otherwise each split writes
//   its partial (m, l, acc[D]) to a workspace and a second launch merges
//   them: m = max m_i, l = sum e^(m_i - m) l_i, acc = sum e^(m_i - m) acc_i.
//   A split whose cells are all masked for a row gives m_i = -1e30 and is
//   wiped by the merge (e^(-1e30 - m) = 0) unless every split is.
// No tensor cores yet (mma.sync / wgmma are later work): the prefill rows
// run on the CUDA cores in f32.
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
constexpr int kTile = 32;  // cells per shared-memory tile, one per lane
constexpr float kNegInf = -1e30f;

enum CellType { kBf16 = 0, kInt8 = 1, kInt4 = 2 };

template <int CT, int D>
struct Cells {
  // bytes of one cell's row and the 16-byte chunks it spans
  static constexpr int kRowBytes = CT == kBf16 ? 2 * D : (CT == kInt8 ? D : D / 2);
  static constexpr int kChunks = kRowBytes / 16;
  // K rows padded by 16 bytes: lane j reads 16 bytes of row j, and the 8
  // lanes of each quarter warp then start on distinct groups of 4 banks
  // (kRowBytes / 16 is even for every cell type and D)
  static constexpr int kKPitch = kRowBytes + 16;
  static constexpr int kStageBytes = kTile * (kKPitch + kRowBytes);  // K, then V
  static constexpr int kCols = D / 32;  // contiguous output columns per lane
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// cp.async of 16 (or 4) bytes; a dead source (live false) reads nothing and
// fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(live ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float bf16_bits(unsigned h) { return __uint_as_float(h << 16); }

// Byte i of x as an f32 without I2F (a quarter-rate instruction): the bits
// 0x4B0000xx are the float 2^23 + xx exactly, so subtracting 2^23 + bias
// gives xx - bias. For signed bytes x is w ^ 0x80808080 (xx = b + 128,
// bias 128); for nibbles x is one nibble per byte (bias 8, the +8 of q4_0).
template <int I>
__device__ __forceinline__ float byte_f32(unsigned x, float bias) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540 | I)) - (8388608.f + bias);
}

// Start copying the raw bytes of cells [c0, c0 + n) of one head (and their
// scales) into one stage: K rows at kKPitch, V rows at kRowBytes. Cells
// past n are zeros, which add nothing: their p is 0.
template <int CT, int D>
__device__ __forceinline__ void stage(uint8_t* __restrict__ dst, float* __restrict__ sc,
                                      const uint8_t* __restrict__ kh,
                                      const uint8_t* __restrict__ vh,
                                      const float* __restrict__ ksh,
                                      const float* __restrict__ vsh, int c0, int n) {
  using C = Cells<CT, D>;
  for (int i = threadIdx.x; i < kTile * C::kChunks; i += kThreads) {
    const int cell = i / C::kChunks, part = i % C::kChunks;
    const bool live = cell < n;
    const size_t off = (size_t)(c0 + (live ? cell : 0)) * C::kRowBytes + part * 16;
    cp_async16(dst + cell * C::kKPitch + part * 16, kh + off, live);
    cp_async16(dst + kTile * C::kKPitch + cell * C::kRowBytes + part * 16, vh + off, live);
  }
  if (CT != kBf16 && threadIdx.x < 2 * kTile) {
    const int c = threadIdx.x & (kTile - 1);
    const bool live = c < n;
    cp_async4(sc + threadIdx.x, (threadIdx.x < kTile ? ksh : vsh) + c0 + (live ? c : 0),
              live);
  }
}

// q_row . the 16-byte chunk `ch` of a K row, added to acc (f32 FMAs; every
// product is exact, k being a bf16 value or a small integer)
template <int CT, int D>
__device__ __forceinline__ float dot_chunk(const float* __restrict__ q_row, uint4 raw,
                                           int ch, float acc) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
  if (CT == kBf16) {  // 8 values, columns 8 ch ..
    const float4 a = *reinterpret_cast<const float4*>(q_row + ch * 8);
    const float4 b = *reinterpret_cast<const float4*>(q_row + ch * 8 + 4);
    acc = fmaf(a.x, bf16_bits(w[0] & 0xFFFFu), acc);
    acc = fmaf(a.y, bf16_bits(w[0] >> 16), acc);
    acc = fmaf(a.z, bf16_bits(w[1] & 0xFFFFu), acc);
    acc = fmaf(a.w, bf16_bits(w[1] >> 16), acc);
    acc = fmaf(b.x, bf16_bits(w[2] & 0xFFFFu), acc);
    acc = fmaf(b.y, bf16_bits(w[2] >> 16), acc);
    acc = fmaf(b.z, bf16_bits(w[3] & 0xFFFFu), acc);
    acc = fmaf(b.w, bf16_bits(w[3] >> 16), acc);
  } else if (CT == kInt8) {  // 16 values, columns 16 ch ..
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 a = *reinterpret_cast<const float4*>(q_row + ch * 16 + 4 * e);
      const unsigned x = w[e] ^ 0x80808080u;
      acc = fmaf(a.x, byte_f32<0>(x, 128.f), acc);
      acc = fmaf(a.y, byte_f32<1>(x, 128.f), acc);
      acc = fmaf(a.z, byte_f32<2>(x, 128.f), acc);
      acc = fmaf(a.w, byte_f32<3>(x, 128.f), acc);
    }
  } else {  // 32 nibbles: low ones columns 16 ch .., high ones D/2 + 16 ch ..
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 a =
            *reinterpret_cast<const float4*>(q_row + half * (D / 2) + ch * 16 + 4 * e);
        const unsigned x = (w[e] >> (4 * half)) & 0x0F0F0F0Fu;
        acc = fmaf(a.x, byte_f32<0>(x, 8.f), acc);
        acc = fmaf(a.y, byte_f32<1>(x, 8.f), acc);
        acc = fmaf(a.z, byte_f32<2>(x, 8.f), acc);
        acc = fmaf(a.w, byte_f32<3>(x, 8.f), acc);
      }
    }
  }
  return acc;
}

// This lane's kCols contiguous columns (kCols * lane ..) of a V row
template <int CT, int D>
__device__ __forceinline__ void v_cols(const uint8_t* __restrict__ row, int lane,
                                       float (&v)[D / 32]) {
  constexpr int kCols = D / 32;
  if (CT == kBf16) {
    const unsigned* w = reinterpret_cast<const unsigned*>(row + 2 * kCols * lane);
#pragma unroll
    for (int j = 0; j < kCols / 2; ++j) {
      const unsigned x = w[j];
      v[2 * j] = bf16_bits(x & 0xFFFFu);
      v[2 * j + 1] = bf16_bits(x >> 16);
    }
  } else {
    // int8: bytes kCols * lane ..; int4: the low nibbles of bytes
    // kCols * lane .. for the first D/2 columns, the high ones after
    const int byte = CT == kInt8 ? kCols * lane : (kCols * lane) % (D / 2);
    const unsigned x = kCols == 4 ? *reinterpret_cast<const unsigned*>(row + byte)
                                  : *reinterpret_cast<const unsigned short*>(row + byte);
    const int shift = CT == kInt4 && kCols * lane >= D / 2 ? 4 : 0;
    const unsigned y = CT == kInt8 ? x ^ 0x80808080u : (x >> shift) & 0x0F0F0F0Fu;
    const float bias = CT == kInt8 ? 128.f : 8.f;
    v[0] = byte_f32<0>(y, bias);
    v[1] = byte_f32<1>(y, bias);
    if (kCols == 4) {
      v[kCols == 4 ? 2 : 0] = byte_f32<2>(y, bias);
      v[kCols == 4 ? 3 : 1] = byte_f32<3>(y, bias);
    }
  }
}

template <int CT, int D, int RW>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ k,
             const uint8_t* __restrict__ v, const uint8_t* __restrict__ mask,
             const float* __restrict__ ks, const float* __restrict__ vs,
             float* __restrict__ out, float* __restrict__ ws, int t_rows, int g,
             int s, long long head_stride, long long scale_stride, float scale,
             int per_split, int nsplit) {
  using C = Cells<CT, D>;
  constexpr int kCols = C::kCols;
  constexpr int kRows = kWarps * RW;
  __shared__ __align__(16) uint8_t tiles[2][C::kStageBytes];
  __shared__ __align__(16) float q_s[kRows * D];
  __shared__ __align__(16) float sc_s[2][2 * kTile];  // per stage: ks, then vs

  const int split = blockIdx.x, h = blockIdx.z, hkv = gridDim.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tg = t_rows * g, hq = hkv * g;
  const int c_begin = split * per_split;
  const int c_end = min(s, c_begin + per_split);
  const size_t itemsize = CT == kBf16 ? 2 : 1;
  const uint8_t* kh = k + (size_t)h * head_stride * itemsize;
  const uint8_t* vh = v + (size_t)h * head_stride * itemsize;
  const float* ksh = ks + (size_t)h * scale_stride;
  const float* vsh = vs + (size_t)h * scale_stride;

  // the first tile's copy runs while the rows are set up
  stage<CT, D>(tiles[0], sc_s[0], kh, vh, ksh, vsh, c_begin, min(kTile, c_end - c_begin));
  cp_async_commit();

  // this warp's rows, their mask rows; rows past T*G run masked, unwritten
  int row[RW];
  const uint8_t* mrow[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    row[i] = blockIdx.y * kRows + warp * RW + i;
    const int t = min(row[i], tg - 1) / g;
    mrow[i] = mask + (size_t)t * s;
    float* qd = q_s + (warp * RW + i) * D;
    const __nv_bfloat16* qr =
        q + ((size_t)t * hq + (size_t)h * g + min(row[i], tg - 1) % g) * D;
    for (int d = lane; d < D; d += 32)
      qd[d] = row[i] < tg ? __bfloat162float(qr[d]) : 0.f;
  }

  float m[RW], l[RW], acc[RW][kCols];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = (c_end - c_begin + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int c0 = c_begin + it * kTile, b = it & 1;
    const int n = min(kTile, c_end - c0);
    if (it + 1 < n_tiles) {  // the next tile's copy overlaps this one's work
      stage<CT, D>(tiles[b ^ 1], sc_s[b ^ 1], kh, vh, ksh, vsh, c0 + kTile,
                   min(kTile, c_end - c0 - kTile));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and q_s) visible to every warp
    const uint8_t* k_t = tiles[b];
    const uint8_t* v_t = tiles[b] + kTile * C::kKPitch;
    const float* ks_t = sc_s[b];
    const float* vs_t = sc_s[b] + kTile;

    // scores: lane j against cell c0 + j, every row of the warp
    float sc[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) sc[i] = 0.f;
    const uint4* kr = reinterpret_cast<const uint4*>(k_t + lane * C::kKPitch);
#pragma unroll
    for (int ch = 0; ch < C::kChunks; ++ch) {
      const uint4 raw = kr[ch];
#pragma unroll
      for (int i = 0; i < RW; ++i)
        sc[i] = dot_chunk<CT, D>(q_s + (warp * RW + i) * D, raw, ch, sc[i]);
    }

    const bool live = lane < n;
    float pb[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      float x = sc[i] * scale;
      if (CT != kBf16) x = x * ks_t[lane];
      const bool vis = live && row[i] < tg && mrow[i][c0 + lane] != 0;
      // masked: -1e30 as the law; past the split's end: no cell at all
      x = vis ? x : (live ? kNegInf : -INFINITY);
      const float m_new = fmaxf(m[i], warp_max(x));
      float p = expf(x - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = corr * l[i] + warp_sum(p);
      m[i] = m_new;
      if (CT != kBf16) p = p * vs_t[lane];
      pb[i] = __bfloat162float(__float2bfloat16(p));
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }

    // p . V over the tile's cells (dead cells have p = 0 and zero bytes)
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float vv[kCols];
      v_cols<CT, D>(v_t + c * C::kRowBytes, lane, vv);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float pc = __shfl_sync(0xffffffffu, pb[i], c);
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(pc, vv[j], acc[i][j]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (row[i] >= tg) continue;
    if (nsplit == 1) {
      const int t = row[i] / g;
      float* o = out + ((size_t)t * hq + (size_t)h * g + row[i] % g) * D + kCols * lane;
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < kCols; ++j) o[j] = acc[i][j] / den;
    } else {
      // workspace: acc [Hkv, nsplit, TG, D], then m and l [Hkv, nsplit, TG]
      const size_t slot = ((size_t)h * nsplit + split) * tg + row[i];
      const size_t n_slots = (size_t)hkv * nsplit * tg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) ws[slot * D + kCols * lane + j] = acc[i][j];
      if (lane == 0) {
        ws[n_slots * D + slot] = m[i];
        ws[n_slots * (D + 1) + slot] = l[i];
      }
    }
  }
}

// One warp per (head, row): merge the splits' partials into the output.
// The lanes share the splits (lane j reads splits j, j + 32, ...), so the
// partials' loads are in flight together rather than one after another.
template <int D>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ ws, float* __restrict__ out, int hkv, int tg,
             int g, int nsplit) {
  constexpr int kCols = D / 32;
  const int lane = threadIdx.x & 31;
  const int idx = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (idx >= hkv * tg) return;  // whole warps leave together
  const int h = idx / tg, r = idx % tg;
  const size_t n_slots = (size_t)hkv * nsplit * tg;
  const size_t first = (size_t)h * nsplit * tg + r;
  const float* ws_m = ws + n_slots * D;
  const float* ws_l = ws + n_slots * (D + 1);
  float m = -INFINITY;
  for (int i = lane; i < nsplit; i += 32) m = fmaxf(m, ws_m[first + (size_t)i * tg]);
  m = warp_max(m);
  float l = 0.f, acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  for (int base = 0; base < nsplit; base += 32) {
    const int i = base + lane;
    const size_t slot = first + (size_t)i * tg;
    const float w = i < nsplit ? expf(ws_m[slot] - m) : 0.f;
    if (i < nsplit) l = fmaf(w, ws_l[slot], l);
    const int n = min(32, nsplit - base);
#pragma unroll 8
    for (int c = 0; c < n; ++c) {
      const float wc = __shfl_sync(0xffffffffu, w, c);
      const float* a = ws + (first + (size_t)(base + c) * tg) * D + kCols * lane;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j] = fmaf(wc, a[j], acc[j]);
    }
  }
  l = warp_sum(l);
  const int t = r / g;
  float* o = out + ((size_t)t * hkv * g + (size_t)h * g + r % g) * D + kCols * lane;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < kCols; ++j) o[j] = acc[j] / den;
}

template <int CT, int D, int RW>
void launch_main(const void* q, const void* k, const void* v, const void* mask,
                 const void* ks, const void* vs, void* out, void* ws, int t, int hkv,
                 int g, int s, long long head_stride, long long scale_stride,
                 float scale, int per_split, int nsplit, cudaStream_t st) {
  const int row_tiles = (t * g + kWarps * RW - 1) / (kWarps * RW);
  const dim3 grid(nsplit, row_tiles, hkv);
  flash_kernel<CT, D, RW><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<float*>(out), static_cast<float*>(ws), t, g, s, head_stride,
      scale_stride, scale, per_split, nsplit);
  if (nsplit > 1) {
    const int blocks = (hkv * t * g + kWarps - 1) / kWarps;
    merge_kernel<D><<<blocks, kThreads, 0, st>>>(static_cast<const float*>(ws),
                                                 static_cast<float*>(out), hkv,
                                                 t * g, g, nsplit);
  }
}

template <int CT>
int dispatch(const void* q, const void* k, const void* v, const void* mask,
             const void* ks, const void* vs, void* out, void* ws, int t, int hkv,
             int g, int s, int d, long long head_stride, long long scale_stride,
             float scale, int rows_per_warp, int per_split, int nsplit, void* stream) {
  if (t < 1 || hkv < 1 || g < 1 || s < 1 || per_split < 1 || per_split % kTile ||
      nsplit < 1 || (long long)per_split * nsplit < s ||
      (long long)per_split * (nsplit - 1) >= s || nsplit > 65535 || hkv > 65535 ||
      (d != 64 && d != 128) || (rows_per_warp != 1 && rows_per_warp != 4) ||
      (CT != kBf16 && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  if ((t * g + kWarps * rows_per_warp - 1) / (kWarps * rows_per_warp) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FD_LAUNCH(DD, RR)                                                            \
  launch_main<CT, DD, RR>(q, k, v, mask, ks, vs, out, ws, t, hkv, g, s, head_stride, \
                          scale_stride, scale, per_split, nsplit, st)
  if (d == 128) {
    if (rows_per_warp == 1) FD_LAUNCH(128, 1); else FD_LAUNCH(128, 4);
  } else {
    if (rows_per_warp == 1) FD_LAUNCH(64, 1); else FD_LAUNCH(64, 4);
  }
#undef FD_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry returns cudaGetLastError() after its launches (0 = launched).
// per_split cells per split (a multiple of 32), nsplit splits; with
// nsplit > 1, ws holds Hkv * nsplit * T * G * (D + 2) floats. bf16 cells
// take null scale pointers.
#define FD_ENTRY(NAME, CT)                                                          \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* mask, \
                      const void* ks, const void* vs, void* out, void* ws, int t,   \
                      int hkv, int g, int s, int d, long long head_stride,          \
                      long long scale_stride, float scale, int rows_per_warp,       \
                      int per_split, int nsplit, void* stream) {                    \
    return dispatch<CT>(q, k, v, mask, ks, vs, out, ws, t, hkv, g, s, d,            \
                        head_stride, scale_stride, scale, rows_per_warp, per_split, \
                        nsplit, stream);                                            \
  }

FD_ENTRY(flash_decode_bf16, kBf16)
FD_ENTRY(flash_decode_i8, kInt8)
FD_ENTRY(flash_decode_i4, kInt4)
