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

// a^E for a compile-time exponent E > 0, square and multiply; the loops
// have constant trip counts and unroll (x^7: two squares, two products).
template <uint64_t E>
__device__ __forceinline__ uint64_t pow(uint64_t a) {
  static_assert(E > 0, "exponent must be positive");
  uint64_t base = a;
  uint64_t e = E;
  while (!(e & 1)) {
    base = mul(base, base);
    e >>= 1;
  }
  uint64_t result = base;
  for (e >>= 1; e; e >>= 1) {
    base = mul(base, base);
    if (e & 1) result = mul(result, base);
  }
  return result;
}

}  // namespace gl
