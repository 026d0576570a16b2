// The 16-entry codebooks of IQ4_NL (IQ4_XS shares it) and MXFP4, looked up
// in registers: a nibble index becomes a bf16 bit pattern with byte
// permutes (prmt), no float conversion and no memory table. Kernel E's
// codebook entries (codebook_gemv.cu) look up the values themselves and
// hand them to the tensor cores raw; kernel D's and kernel I's weight
// formula (qstage.cuh's CodebookChunk) looks up bf16(v * dl) in the
// codebook scaled by a group's dl, so 16 products a group make all 32 of
// its weights.
//
// A codebook value v is an integer of at most 8 significant bits (IQ4_NL
// -127..113; MXFP4 the e2m1 values pre-doubled, 0, ±1, ±2, ±3, ±4, ±6, ±8,
// ±12), so bf16(v) is exact. A table's 16 bf16 patterns are split into a
// low-byte and a high-byte half of 16 bytes each (four words, byte i entry
// i's). One prmt picks four bytes out of eight by 3-bit selectors, so a
// 16-entry half takes two of them (entries 0..7 and 8..15, selected by the
// index less its bit 3) and a third that takes each byte from one or the
// other by that bit: three prmt for four bytes. MXFP4's low bytes repeat in
// both halves of the index range (its sign is the index's bit 3, and sits
// in the high byte, scaled or not), so one prmt does. MXFP4's index 8 is
// +0, as in the JAX package's int8 value plane.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace codebook {

// A table of 16 bf16 patterns: byte b of word i of lo (hi) is the low
// (high) byte of entry 4i + b's.
struct Table {
  uint32_t lo[4], hi[4];
};

// a format's codebook: its values, the table of their bf16 patterns, and
// whether its low bytes repeat (entries 8..15's equal 0..7's)
template <bool kMxfp4>
struct Codebook;
template <>
struct Codebook<false> {  // IQ4_NL and IQ4_XS: kvalues_iq4nl
  static constexpr bool kLowRepeats = false;
  __device__ static constexpr float value(int i) {
    constexpr float v[16] = {-127.f, -104.f, -83.f, -65.f, -49.f, -35.f, -22.f, -10.f,
                             1.f,    13.f,   25.f,  38.f,  53.f,  69.f,  89.f,  113.f};
    return v[i];
  }
  __device__ static constexpr Table raw() {
    return {{0x82A6D0FEu, 0x20B00C44u, 0x18C85080u, 0xE2B28A54u},
            {0xC2C2C2C2u, 0xC1C1C2C2u, 0x4241413Fu, 0x42424242u}};
  }
};
template <>
struct Codebook<true> {  // MXFP4: 0, 1, 2, 3, 4, 6, 8, 12, then the negatives
  static constexpr bool kLowRepeats = true;
  __device__ static constexpr float value(int i) {
    constexpr float v[16] = {0.f, 1.f,  2.f,  3.f,  4.f,  6.f,  8.f,  12.f,
                             0.f, -1.f, -2.f, -3.f, -4.f, -6.f, -8.f, -12.f};
    return v[i];
  }
  __device__ static constexpr Table raw() {
    return {{0x40008000u, 0x4000C080u, 0x40008000u, 0x4000C080u},
            {0x40403F00u, 0x41414040u, 0xC0C0BF00u, 0xC1C1C0C0u}};
  }
};

// prmt.b32 in its default mode: byte i of the result is byte (sel nibble i)
// of {b, a} (a bytes 0..3), where the nibble's bit 3 is clear
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// The table of bf16(v * dl) over the codebook's values v, each product
// formed in f32 and rounded once (16 products, 8 conversions, 8 permutes)
template <bool kMxfp4>
__device__ __forceinline__ Table scaled(float dl) {
  using C = Codebook<kMxfp4>;
  Table t;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // entries 4i .. 4i + 3, two to a word
    const __nv_bfloat162 p0 = __floats2bfloat162_rn(__fmul_rn(C::value(4 * i), dl),
                                                    __fmul_rn(C::value(4 * i + 1), dl));
    const __nv_bfloat162 p1 = __floats2bfloat162_rn(__fmul_rn(C::value(4 * i + 2), dl),
                                                    __fmul_rn(C::value(4 * i + 3), dl));
    const uint32_t a = *reinterpret_cast<const uint32_t*>(&p0);
    const uint32_t b = *reinterpret_cast<const uint32_t*>(&p1);
    t.lo[i] = prmt(a, b, 0x6420u);
    t.hi[i] = prmt(a, b, 0x7531u);
  }
  return t;
}

// The selectors of the 8 indexes held one to a nibble in v: s each index
// less its bit 3 (its entry in a half of the table), m the half (nibble i
// is i, or i + 4 for the second half). prmt reads bits 0..15 of a
// selector: nibbles 0..3 of v; s >> 16 and m >> 16 select nibbles 4..7.
__device__ __forceinline__ void selectors(uint32_t v, uint32_t& s, uint32_t& m) {
  s = v & 0x77777777u;
  m = ((v >> 1) & 0x44444444u) | 0x32103210u;
}

// The low (L) and high (H) bytes of table t's entries at the four indexes
// of selectors (s, m): byte i of each for nibble i
template <bool kLowRepeats>
__device__ __forceinline__ void lookup4(const Table& t, uint32_t s, uint32_t m, uint32_t& L,
                                        uint32_t& H) {
  H = prmt(prmt(t.hi[0], t.hi[1], s), prmt(t.hi[2], t.hi[3], s), m);
  if constexpr (kLowRepeats)
    L = prmt(t.lo[0], t.lo[1], s);
  else
    L = prmt(prmt(t.lo[0], t.lo[1], s), prmt(t.lo[2], t.lo[3], s), m);
}

// Table t's bf16 pairs at the 8 indexes of a plane word w: its bytes 0..3
// hold, as a 32-group's bytes do, elements j (low nibble) and j + 16 (high
// nibble) of the group for four consecutive j. lo[h] = {element of byte
// 2h, of byte 2h + 1}'s low nibbles, hi[h] the same bytes' high nibbles
// (the low element in the low half of each pair).
template <bool kLowRepeats>
__device__ __forceinline__ void word_pairs(const Table& t, uint32_t w, uint32_t (&lo)[2],
                                           uint32_t (&hi)[2]) {
  uint32_t s, m;
  selectors(w, s, m);
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // nibbles: low of byte 2h, high, low of byte 2h + 1, high
    uint32_t L, H;
    lookup4<kLowRepeats>(t, h ? s >> 16 : s, h ? m >> 16 : m, L, H);
    lo[h] = prmt(L, H, 0x6240u);
    hi[h] = prmt(L, H, 0x7351u);
  }
}

}  // namespace codebook
