// BabyBear field arithmetic for the port's kernels (p = 15 * 2^27 + 1).
//
// Values are Montgomery residues (x stored as x * 2^32 mod p) in [0, p),
// the same bits as the reference's uint32 arrays. Every function that
// returns a uint32_t returns the canonical residue, so it agrees bit for bit
// with any exact reduction.
//
// The product is a signed Montgomery reduction: one 32x32->64 signed
// product t = a*b, m = lo(t) * p^-1 mod 2^32, and r = hi(t) - hi(m*p),
// which is exact (the low words cancel) and lies in (-p, p) whenever
// |a*b| < p * 2^31. So `smul` needs no correction step, accepts one operand
// anywhere in int32 if the other lies in (-p, p), and its output can feed
// the next `smul` directly; `canon` maps (-p, p) to [0, p) with one
// add-and-min. On Hopper the two wide multiplies (IMAD.WIDE, IMAD.HI) issue
// at a quarter of the ALU rate and are what bounds Poseidon2; this form
// adds one ALU op to them where the unsigned REDC added three.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bb {

constexpr uint32_t P = 2013265921u;
constexpr uint32_t NP = 0x77FFFFFFu;  // -p^-1 mod 2^32
// 2^64 mod p: the Montgomery form of 2^32, so mul(x, R2) = x * 2^32 mod p.
constexpr uint32_t R2 = 1172168163u;

// s < 2p -> s mod p (unsigned min: s - p wraps above s when s < p)
__device__ __forceinline__ uint32_t reduce(uint32_t s) { return min(s, s - P); }

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  return reduce(a + b);  // a + b < 2p < 2^32
}

__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  uint32_t d = a - b;
  return a >= b ? d : d + P;
}

// (-p, p) -> [0, p): a negative r wraps above r + p
__device__ __forceinline__ uint32_t canon(int32_t r) {
  const uint32_t u = static_cast<uint32_t>(r);
  return min(u, u + P);
}

// a * b * 2^-32 mod p in (-p, p), for |a * b| < p * 2^31.
__device__ __forceinline__ int32_t smul(int32_t a, int32_t b) {
  int32_t r;
  // PTX, so that the product stays one 32x32 signed IMAD.WIDE: from C the
  // compiler widens a constant-memory operand and multiplies 64x64.
  asm("{\n\t.reg .s64 t;\n\t.reg .s32 lo, hi, m, h2;\n\t"
      "mul.wide.s32 t, %1, %2;\n\t"
      "mov.b64 {lo, hi}, t;\n\t"
      "mul.lo.s32 m, lo, 0x88000001;\n\t"  // p^-1 mod 2^32
      "mul.hi.s32 h2, m, 0x78000001;\n\t"  // hi(m * p)
      "sub.s32 %0, hi, h2;\n\t}"
      : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  return canon(smul(static_cast<int32_t>(a), static_cast<int32_t>(b)));
}

// REDC of t < p * 2^32: t * 2^-32 mod p, in [0, p).
__device__ __forceinline__ uint32_t redc(uint64_t t) {
  uint32_t m = static_cast<uint32_t>(t) * NP;
  uint64_t u = (t + static_cast<uint64_t>(m) * P) >> 32;  // < 2p
  uint32_t r = static_cast<uint32_t>(u);
  return r >= P ? r - P : r;
}

// x mod p for x < p * 2^32: redc takes off 2^32, mul by R2 puts it back.
__device__ __forceinline__ uint32_t mod_p(uint64_t x) { return mul(redc(x), R2); }

// a * b + c as one 32x32->64 multiply-add (IMAD.WIDE.U32 with its addend).
__device__ __forceinline__ uint64_t mad_wide(uint32_t a, uint32_t b, uint64_t c) {
  uint64_t r;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(r) : "r"(a), "r"(b), "l"(c));
  return r;
}

// An exact sum of products in 96 bits (lo, hi, top), for the dot products of
// K3. Four products of values below p sum below 4p^2 < 2^64, so a caller
// chains four `mad_wide` into one 64-bit word and adds that here with one
// carry chain (3 ALU ops, no compare and no fold). Each product is below
// 2^62, so `top` stays below p, as `mont` needs, for fewer than 2^33 products.
struct Acc96 {
  uint32_t lo = 0, hi = 0, top = 0;

  __device__ __forceinline__ void add(uint64_t t) {
    asm("add.cc.u32 %0, %0, %3;\n\taddc.cc.u32 %1, %1, %4;\n\taddc.u32 %2, %2, 0;"
        : "+r"(lo), "+r"(hi), "+r"(top)
        : "r"(static_cast<uint32_t>(t)), "r"(static_cast<uint32_t>(t >> 32)));
  }

  // (top * 2^64 + hi * 2^32 + lo) * 2^-32 mod p, in [0, p):
  // (top * 2^32 + hi) mod p plus lo * 2^-32, each reduced without a division.
  __device__ __forceinline__ uint32_t mont() const {
    return bb::add(mod_p((static_cast<uint64_t>(top) << 32) | hi), redc(lo));
  }
};

}  // namespace bb
