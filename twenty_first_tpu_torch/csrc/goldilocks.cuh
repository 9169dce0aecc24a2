// Goldilocks field (p = 2^64 - 2^32 + 1) on the device: the one header
// every kernel of this package shares.
//
// Values are canonical residues in [0, p) held in uint64_t, the bit pattern
// of the int64 carrier tensors. Hopper has a native 64x64 -> 128-bit
// multiply-high (__umul64hi), so a product is one wide multiply and one
// reduction with 2^64 == 2^32 - 1 and 2^96 == -1 (mod p).
#pragma once

#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPSILON = 0xFFFFFFFFull;  // 2^64 mod p

// One conditional subtract of p; valid for every x < 2^64 (2^64 < 2p).
__device__ __forceinline__ uint64_t canon(uint64_t x) {
  return x >= P ? x - P : x;
}

// lo + hi * 2^64 mod p, canonical. With hi = hh * 2^32 + hl the value is
// lo + hl * (2^32 - 1) - hh (mod p); each wrap is worth EPSILON.
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  const uint64_t hh = hi >> 32;
  const uint64_t hl = hi & EPSILON;
  uint64_t t = lo - hh;
  if (lo < hh) t -= EPSILON;  // cannot borrow again
  const uint64_t m = (hl << 32) - hl;
  uint64_t r = t + m;
  if (r < m) r += EPSILON;  // cannot wrap again
  return canon(r);
}

// Product of any two u64 values, canonical out.
__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(a * b, __umul64hi(a, b));
}

// Canonical in, canonical out.
__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += EPSILON;
  return canon(s);
}

// Canonical in, canonical out.
__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  const uint64_t d = a - b;
  return a < b ? d - EPSILON : d;
}

// Lazy forms (any u64 residue in, a u64 residue out), bit for bit the
// representatives of twenty_first_tpu/math/gf.py's reduce128_lazy (:304),
// mul_lazy (:329) and add_lazy (:337): every fix-up wraps mod 2^64.
__device__ __forceinline__ uint64_t reduce128_lazy(uint64_t lo, uint64_t hi) {
  const uint64_t hh = hi >> 32;
  const uint64_t hl = hi & EPSILON;
  uint64_t t = lo - hh;
  if (lo < hh) t -= EPSILON;
  const uint64_t m = (hl << 32) - hl;
  uint64_t r = t + m;
  if (r < m) r += EPSILON;
  return r;
}

__device__ __forceinline__ uint64_t mul_lazy(uint64_t a, uint64_t b) {
  return reduce128_lazy(a * b, __umul64hi(a, b));
}

// A wrap adds EPSILON, and a second one when the wrapped sum is >= p.
__device__ __forceinline__ uint64_t add_lazy(uint64_t a, uint64_t b) {
  const uint64_t s = a + b;
  const uint64_t k = s < a ? (s >= P ? 2 : 1) : 0;
  return s + k * EPSILON;
}

__device__ __forceinline__ uint32_t lo32(uint64_t x) {
  return static_cast<uint32_t>(x);
}
__device__ __forceinline__ uint32_t hi32(uint64_t x) {
  return static_cast<uint32_t>(x >> 32);
}
__device__ __forceinline__ uint64_t join(uint32_t lo, uint32_t hi) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// The carry-chain forms below give the same representatives as the C forms
// above (and as twenty_first_tpu/math/gf.py's lazy forms) with no compares
// or selects: each EPSILON fix-up is the carry or borrow of a 32-bit chain
// turned into a 0 / 2^32 - 1 mask. K1-K3 and K6-K8 use them; K5
// (probes.cu) times them beside the C forms, the yardstick of earlier
// measurements. sqr_red alone gives a representative of its own (K8's
// inverse chain).

// a * b for any u64 residues, a lazy residue out: the 128-bit product
// p = (p3, p2, p1, p0) as a carry chain of 32-bit multiply-adds, then
// p mod p = (p1, p0) + p2 * (2^32 - 1) - p3 (2^64 = 2^32 - 1, 2^96 = -1),
// each wrap of the 64-bit sum worth 2^32 - 1 through the carry: the value
// of mul_lazy.
__device__ __forceinline__ uint64_t mul_red(uint64_t a, uint64_t b) {
  uint32_t r0, r1;
  asm("{\n\t.reg .u32 p0, p1, p2, p3, m0, m1, c;\n\t"
      "mul.lo.u32 p0, %2, %4;\n\t"
      "mul.hi.u32 p1, %2, %4;\n\t"
      "mad.lo.cc.u32 p1, %2, %5, p1;\n\t"
      "madc.hi.u32 p2, %2, %5, 0;\n\t"
      "mad.lo.cc.u32 p1, %3, %4, p1;\n\t"
      "madc.hi.cc.u32 p2, %3, %4, p2;\n\t"
      "madc.hi.u32 p3, %3, %5, 0;\n\t"
      "mad.lo.cc.u32 p2, %3, %5, p2;\n\t"
      "addc.u32 p3, p3, 0;\n\t"
      "sub.cc.u32 %0, p0, p3;\n\t"  // (p1, p0) - p3
      "subc.cc.u32 %1, p1, 0;\n\t"
      "subc.u32 c, 0, 0;\n\t"  // 2^32 - 1 on a borrow, else 0
      "sub.cc.u32 %0, %0, c;\n\t"
      "subc.u32 %1, %1, 0;\n\t"
      "sub.cc.u32 m0, 0, p2;\n\t"  // m = p2 * 2^32 - p2
      "subc.u32 m1, p2, 0;\n\t"
      "add.cc.u32 %0, %0, m0;\n\t"
      "addc.cc.u32 %1, %1, m1;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "neg.s32 c, c;\n\t"  // 2^32 - 1 on a carry, else 0
      "add.cc.u32 %0, %0, c;\n\t"
      "addc.u32 %1, %1, 0;\n\t}"
      : "=r"(r0), "=r"(r1)
      : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)));
  return join(r0, r1);
}

// x * x for any u64 x, a lazy residue out (not mul_red's representative).
// The 128-bit square (p3, p2, p1, p0) from three 32x32 partial products,
// the cross product once and doubled; then V = (p1, p0) + p2 2^32 - (p2 +
// p3), which is x^2 mod p (2^64 = 2^32 - 1, 2^96 = -1), lies in (-2^33,
// 2^65 - 2^32), so V mod 2^64 = r and V = r + d 2^64 with d = carry - borrow
// in {-1, 0, 1}. The one fix r + d (2^32 - 1) cannot wrap: d = 1 leaves r
// below 2^64 - 2^32, d = -1 leaves it above 2^64 - 2^33.
__device__ __forceinline__ uint64_t sqr_red(uint64_t x) {
  uint32_t r0, r1;
  asm("{\n\t.reg .u32 p0, p1, p2, p3, t0, t1, t2, q0, q1, c, b, s;\n\t"
      "mul.lo.u32 p0, %2, %2;\n\t"
      "mul.hi.u32 p1, %2, %2;\n\t"
      "mul.lo.u32 p2, %3, %3;\n\t"
      "mul.hi.u32 p3, %3, %3;\n\t"
      "mul.lo.u32 t0, %2, %3;\n\t"
      "mul.hi.u32 t1, %2, %3;\n\t"
      "add.cc.u32 t0, t0, t0;\n\t"  // (t2, t1, t0) = 2 x_lo x_hi
      "addc.cc.u32 t1, t1, t1;\n\t"
      "addc.u32 t2, 0, 0;\n\t"
      "add.cc.u32 p1, p1, t0;\n\t"
      "addc.cc.u32 p2, p2, t1;\n\t"
      "addc.u32 p3, p3, t2;\n\t"
      "add.cc.u32 t1, p1, p2;\n\t"  // (t1, p0) = (p1, p0) + p2 2^32, carry c
      "addc.u32 c, 0, 0;\n\t"
      "add.cc.u32 q0, p2, p3;\n\t"  // q = p2 + p3
      "addc.u32 q1, 0, 0;\n\t"
      "sub.cc.u32 %0, p0, q0;\n\t"  // r = (t1, p0) - q, borrow b
      "subc.cc.u32 %1, t1, q1;\n\t"
      "subc.u32 b, 0, 0;\n\t"
      "add.u32 s, b, c;\n\t"  // d
      "neg.s32 c, s;\n\t"  // r + d (2^32 - 1): add (d < 0 ? -1 : 0, -d)
      "shr.s32 b, s, 31;\n\t"
      "add.cc.u32 %0, %0, c;\n\t"
      "addc.u32 %1, %1, b;\n\t}"
      : "=r"(r0), "=r"(r1)
      : "r"(lo32(x)), "r"(hi32(x)));
  return join(r0, r1);
}

// add_lazy: a wrap adds 2^32 - 1, and a second time when that wraps too
// (exactly when the wrapped sum is >= p).
__device__ __forceinline__ uint64_t add_lazy_cc(uint64_t a, uint64_t b) {
  uint32_t r0, r1;
  asm("{\n\t.reg .u32 c;\n\t"
      "add.cc.u32 %0, %2, %4;\n\t"
      "addc.cc.u32 %1, %3, %5;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "neg.s32 c, c;\n\t"
      "add.cc.u32 %0, %0, c;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "neg.s32 c, c;\n\t"
      "add.cc.u32 %0, %0, c;\n\t"
      "addc.u32 %1, %1, 0;\n\t}"
      : "=r"(r0), "=r"(r1)
      : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)));
  return join(r0, r1);
}

// Bit for bit gf.py's sub_lazy (:189): a borrow subtracts 2^32 - 1, and a
// second time when that borrows too (exactly when a - b < 2^32 - 1).
__device__ __forceinline__ uint64_t sub_lazy(uint64_t a, uint64_t b) {
  uint32_t r0, r1;
  asm("{\n\t.reg .u32 c;\n\t"
      "sub.cc.u32 %0, %2, %4;\n\t"
      "subc.cc.u32 %1, %3, %5;\n\t"
      "subc.u32 c, 0, 0;\n\t"
      "sub.cc.u32 %0, %0, c;\n\t"
      "subc.cc.u32 %1, %1, 0;\n\t"
      "subc.u32 c, 0, 0;\n\t"
      "sub.cc.u32 %0, %0, c;\n\t"
      "subc.u32 %1, %1, 0;\n\t}"
      : "=r"(r0), "=r"(r1)
      : "r"(lo32(a)), "r"(hi32(a)), "r"(lo32(b)), "r"(hi32(b)));
  return join(r0, r1);
}

// reduce128_lazy's representative of lo + hi * 2^64 as one carry chain:
// (lo - hh) + hl * (2^32 - 1), each borrow or wrap worth 2^32 - 1.
__device__ __forceinline__ uint64_t reduce128_lazy_cc(uint64_t lo,
                                                      uint64_t hi) {
  uint32_t r0, r1;
  asm("{\n\t.reg .u32 m0, m1, c;\n\t"
      "sub.cc.u32 %0, %2, %5;\n\t"  // lo - hh
      "subc.cc.u32 %1, %3, 0;\n\t"
      "subc.u32 c, 0, 0;\n\t"
      "sub.cc.u32 %0, %0, c;\n\t"
      "subc.u32 %1, %1, 0;\n\t"
      "sub.cc.u32 m0, 0, %4;\n\t"  // m = hl * 2^32 - hl
      "subc.u32 m1, %4, 0;\n\t"
      "add.cc.u32 %0, %0, m0;\n\t"
      "addc.cc.u32 %1, %1, m1;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "neg.s32 c, c;\n\t"
      "add.cc.u32 %0, %0, c;\n\t"
      "addc.u32 %1, %1, 0;\n\t}"
      : "=r"(r0), "=r"(r1)
      : "r"(lo32(lo)), "r"(hi32(lo)), "r"(lo32(hi)), "r"(hi32(hi)));
  return join(r0, r1);
}

// Bit for bit gf.py's mul_by_pow2_lazy (:198), x * 2^e for 0 < e < 96 as
// the reduction of the shifted 128-bit word; above 2^128 (e > 64) the
// third word is folded by 2^128 = -2^32. Meant for an e that is a constant
// once the caller is unrolled: the branches then fold away.
__device__ __forceinline__ uint64_t mul_pow2_lazy(uint64_t x, int e) {
  if (e < 64) return reduce128_lazy_cc(x << e, x >> (64 - e));
  const int r = e - 64;
  if (r == 0) return reduce128_lazy_cc(0, x);
  return sub_lazy(reduce128_lazy_cc(0, x << r), (x >> (64 - r)) << 32);
}

}  // namespace gl
