// The values of a 16-byte chunk of a Q4_K or Q5_K weight, shared by kernels
// B (q4k_gemm.cu) and D (qgemm.cu): the one place that knows which bits of
// the high-bit plane qh go with which bytes of q. Kernels A and G
// (q4k_gemv.cu) take the formats and their scale rules (Fmt, legacy_min).
//
// q u8 [N, K/2] holds each 256-element superblock s in halves: byte r of
// the superblock holds element r in its low nibble and element 128 + r in
// its high nibble. Chunk c (0..7) of superblock s, bytes [16c, 16c + 16),
// covers elements 16c.. (low nibbles) and 128+16c.. (high nibbles). Q5_K's
// qh u8 [N, K/8] holds the fifth bit of every element in the row's element
// order (bit b of byte r: element 8r + b), so the chunk's high bits are the
// 16-bit words s*16 + c (low half) and s*16 + 8 + c (high half) of the
// row's qh, bit j of each for byte j of the chunk. Q5_K's value is
// nibble + 16 x bit (0..31, `_gp_slice` and `_sh_qh_halves` of the TPU
// kernels).
//
// Kernels A and B also take the 32-element legacy formats Q4_0, Q4_1, Q5_0
// and Q5_1, whose q and qh planes are laid out as Q4_K's and Q5_K's: only
// where a group's scale and min come from differs (`Fmt`, `legacy_min`).
#pragma once

#include <stdint.h>

namespace kquant {

// The halves-packed formats. Per 32-element group g the TPU kernels' law
// (`_gp_slice`) is w = q * dl - ml with
// - Q4_K, Q5_K: dl = d[s] * sc[g], ml = dm[s] * mn[g] (d, dm one per
//   256-element superblock s; sc, mn int8 per group);
// - Q4_0, Q5_0: dl = d[g], ml = 8 d[g] or 16 d[g] (the offset folded into
//   the min: exact in f32);
// - Q4_1, Q5_1: dl = d[g], ml = -dm[g] (dm holds the min m, which these
//   formats ADD: w = q * d + m).
enum class Fmt { kQ4K, kQ5K, kQ4_0, kQ4_1, kQ5_0, kQ5_1 };

__host__ __device__ constexpr bool five_bit(Fmt f) {
  return f == Fmt::kQ5K || f == Fmt::kQ5_0 || f == Fmt::kQ5_1;
}
__host__ __device__ constexpr bool legacy(Fmt f) { return f != Fmt::kQ4K && f != Fmt::kQ5K; }
__host__ __device__ constexpr bool added_min(Fmt f) { return f == Fmt::kQ4_1 || f == Fmt::kQ5_1; }

// A legacy group's ml from its d (dl) and, for Q4_1/Q5_1, its m.
template <Fmt F>
__device__ __forceinline__ float legacy_min(float d, float m) {
  if constexpr (added_min(F)) return -m;
  else return (F == Fmt::kQ5_0 ? 16.f : 8.f) * d;
}

// The chunk's high-bit words {low half, high half}, read from qh + row_off
// (the row's qh, 2-byte aligned); zeros for Q4_K, whose qh is unused.
template <bool kFive>
__device__ __forceinline__ uint2 high_words(const uint8_t* qh, size_t row_off,
                                            int s, int c) {
  uint2 hb = make_uint2(0u, 0u);
  if constexpr (kFive) {
    const uint16_t* w = reinterpret_cast<const uint16_t*>(qh + row_off);
    hb.x = __ldg(w + s * 16 + c);
    hb.y = __ldg(w + s * 16 + 8 + c);
  }
  return hb;
}

// The values of bytes j and j + 1 of a chunk (q0, q1), with the chunk's
// high-bit words hb: {low half's element j, j + 1, high half's j, j + 1}.
template <bool kFive>
__device__ __forceinline__ uint4 values(uint32_t q0, uint32_t q1, uint2 hb, int j) {
  uint4 v = make_uint4(q0 & 15u, q1 & 15u, q0 >> 4, q1 >> 4);
  if constexpr (kFive) {
    v.x |= ((hb.x >> j) & 1u) << 4;
    v.y |= ((hb.x >> (j + 1)) & 1u) << 4;
    v.z |= ((hb.y >> j) & 1u) << 4;
    v.w |= ((hb.y >> (j + 1)) & 1u) << 4;
  }
  return v;
}

// The same bits for four bytes at once: bit 4 of byte b of the result is
// the high bit of byte 4i + b of the chunk's half h (0 low, 1 high), to OR
// into four nibbles held one to a byte. (Bit b of the 4-bit field, times
// 2^4 + 2^11 + 2^18 + 2^25, lands at bit 8b + 4; the other products fall
// outside the mask, and none carries.)
template <bool kFive>
__device__ __forceinline__ uint32_t high_bytes(uint2 hb, int h, int i) {
  if constexpr (!kFive)
    return 0u;
  else
    return ((((h ? hb.y : hb.x) >> (4 * i)) & 0xFu) * 0x02040810u) & 0x10101010u;
}

}  // namespace kquant
