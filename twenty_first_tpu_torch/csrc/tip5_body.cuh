// The Tip5 arithmetic of K1/K2 (tip5.cu): the S-box (the byte lookup on
// the Montgomery form and x^7 on lazy residues), the fold of an exact MDS
// sum into a lazy residue, the final canonicalisation and the block's
// table loads. K9 (tip5_mma.cu) takes the Montgomery conversions, the
// canonicalisation and its x^7 three products deep (pow7_k9, which K1's
// lane mode takes too); its lookup and table loads are its own. Each
// translation unit gets its own copy (an anonymous namespace, every
// function inlined), so moving them here changes no instruction of K1, K2
// or K9.
#pragma once

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int kState = 16;
constexpr int kRounds = 5;
constexpr int kSbox = 4;  // words through the byte lookup

// the 32-bit halves and the lazy product, shared with K3 (goldilocks.cuh)
using gl::hi32;
using gl::join;
using gl::lo32;
using gl::mul_red;

__device__ __forceinline__ uint64_t pow7(uint64_t x) {
  const uint64_t x3 = mul_red(mul_red(x, x), x);
  return mul_red(mul_red(x3, x3), x);
}

// a * b for any u64, a lazy residue out: the four 32 x 32 -> 64 partial
// products as wide multiplies, summed into (p3, p2, p1, p0), then
// gl::sqr_red's one fix-up: V = (p1, p0) + p2 2^32 - (p2 + p3), which is
// a * b mod p, lies in (-2^33, 2^65 - 2^32), so with r = V mod 2^64 and
// d = carry - borrow in {-1, 0, 1}, r + d (2^32 - 1) cannot wrap.
__device__ __forceinline__ uint64_t mul_wide(uint64_t a, uint64_t b) {
  const uint64_t ll = static_cast<uint64_t>(lo32(a)) * lo32(b);
  const uint64_t lh = static_cast<uint64_t>(lo32(a)) * hi32(b);
  const uint64_t hl = static_cast<uint64_t>(hi32(a)) * lo32(b);
  const uint64_t hh = static_cast<uint64_t>(hi32(a)) * hi32(b);
  uint32_t r0, r1;
  asm("{\n\t.reg .u32 p1, p2, p3, t1, q0, q1, c, b, s;\n\t"
      "add.cc.u32 p1, %3, %4;\n\t"  // ll.hi + lh.lo
      "addc.cc.u32 p2, %5, %8;\n\t"  // lh.hi + hh.lo
      "addc.u32 p3, %9, 0;\n\t"
      "add.cc.u32 p1, p1, %6;\n\t"  // + hl
      "addc.cc.u32 p2, p2, %7;\n\t"
      "addc.u32 p3, p3, 0;\n\t"
      "add.cc.u32 t1, p1, p2;\n\t"  // (t1, p0) = (p1, p0) + p2 2^32, carry c
      "addc.u32 c, 0, 0;\n\t"
      "add.cc.u32 q0, p2, p3;\n\t"  // q = p2 + p3
      "addc.u32 q1, 0, 0;\n\t"
      "sub.cc.u32 %0, %2, q0;\n\t"  // r = (t1, p0) - q, borrow b
      "subc.cc.u32 %1, t1, q1;\n\t"
      "subc.u32 b, 0, 0;\n\t"
      "add.u32 s, b, c;\n\t"  // d
      "neg.s32 c, s;\n\t"  // r + d (2^32 - 1): add (d < 0 ? -1 : 0, -d)
      "shr.s32 b, s, 31;\n\t"
      "add.cc.u32 %0, %0, c;\n\t"
      "addc.u32 %1, %1, b;\n\t}"
      : "=r"(r0), "=r"(r1)
      : "r"(lo32(ll)), "r"(hi32(ll)), "r"(lo32(lh)), "r"(hi32(lh)),
        "r"(lo32(hl)), "r"(hi32(hl)), "r"(lo32(hh)), "r"(hi32(hh)));
  return join(r0, r1);
}

// x^7 for any u64, a lazy residue out: x^2, then x^3 and x^4 side by side,
// three products deep (pow7 above, K1's thread modes' and K2's, is four)
__device__ __forceinline__ uint64_t pow7_k9(uint64_t x) {
  const uint64_t x2 = gl::sqr_red(x);
  return mul_wide(mul_wide(x2, x), gl::sqr_red(x2));
}

// x * 2^64 mod p, canonical, for any u64 x = x1 * 2^32 + x0: with
// 2^64 = 2^32 - 1 and 2^96 = -1 it is x0 * (2^32 - 1) - x1, and
// x0 * (2^32 - 1) < p, so adding p on a borrow makes it canonical.
__device__ __forceinline__ uint64_t to_montgomery(uint64_t x) {
  uint32_t r0, r1;
  asm("{\n\t.reg .u32 a0, a1, b;\n\t"
      "sub.cc.u32 a0, 0, %2;\n\t"  // a = x0 * 2^32 - x0
      "subc.u32 a1, %2, 0;\n\t"
      "sub.cc.u32 %0, a0, %3;\n\t"  // a - x1
      "subc.cc.u32 %1, a1, 0;\n\t"
      "subc.u32 b, 0, 0;\n\t"  // + p = - (2^32 - 1) mod 2^64 on a borrow
      "sub.cc.u32 %0, %0, b;\n\t"
      "subc.u32 %1, %1, 0;\n\t}"
      : "=r"(r0), "=r"(r1)
      : "r"(lo32(x)), "r"(hi32(x)));
  return join(r0, r1);
}

// x * 2^-64 mod p for any u64 x: one Montgomery reduction of (x, 0), the
// Tip5 reference's montyred with a zero high word (-p^-1 = -(1 + 2^32)
// mod 2^64): b = a - (a >> 32) - carry with a = x + (x << 32) is never
// above p - 1, and the value is p - b (p itself when b = 0: a lazy
// residue, which the MDS takes).
__device__ __forceinline__ uint64_t from_montgomery(uint64_t x) {
  uint32_t r0, r1;
  asm("{\n\t.reg .u32 a1, e, b0, b1;\n\t"
      "add.cc.u32 a1, %3, %2;\n\t"  // a = (x1 + x0) * 2^32 + x0
      "addc.u32 e, 0, 0;\n\t"
      "sub.cc.u32 b0, %2, a1;\n\t"  // b = a - a1 - e
      "subc.u32 b1, a1, 0;\n\t"
      "sub.cc.u32 b0, b0, e;\n\t"
      "subc.u32 b1, b1, 0;\n\t"
      "sub.cc.u32 %0, 1, b0;\n\t"  // p - b
      "subc.u32 %1, 0xFFFFFFFF, b1;\n\t}"
      : "=r"(r0), "=r"(r1)
      : "r"(lo32(x)), "r"(hi32(x)));
  return join(r0, r1);
}

// The byte lookup on the canonical Montgomery form of x.
__device__ __forceinline__ uint64_t sbox_lookup(uint64_t x,
                                                const uint8_t* lut) {
  const uint64_t m = to_montgomery(x);
  uint32_t o0 = 0, o1 = 0;
#pragma unroll
  for (int k = 0; k < 32; k += 8) {
    o0 |= static_cast<uint32_t>(lut[(lo32(m) >> k) & 0xFF]) << k;
    o1 |= static_cast<uint32_t>(lut[(hi32(m) >> k) & 0xFF]) << k;
  }
  return from_montgomery(join(o0, o1));
}

// acc_lo + acc_hi * 2^32 (acc_lo any u64, acc_hi below 2^54) as a lazy
// residue: it is lo64 + q * 2^64 with q < 2^22 and 2^64 = 2^32 - 1, so
// lo64 + q * 2^32 - q, plus 2^32 - 1 if that sum wraps.
__device__ __forceinline__ uint64_t combine(uint64_t acc_lo, uint64_t acc_hi) {
  uint32_t r0, r1;
  asm("{\n\t.reg .u32 q, m0, m1, b;\n\t"
      "add.cc.u32 %1, %3, %4;\n\t"  // lo64 = acc_lo + (acc_hi << 32)
      "addc.u32 q, %5, 0;\n\t"      // q = (acc_hi >> 32) + carry
      "sub.cc.u32 m0, 0, q;\n\t"    // m = q * 2^32 - q
      "subc.u32 m1, q, 0;\n\t"
      "add.cc.u32 %0, %2, m0;\n\t"  // lo64 + m
      "addc.cc.u32 %1, %1, m1;\n\t"
      "addc.u32 b, 0, 0;\n\t"
      "neg.s32 b, b;\n\t"
      "add.cc.u32 %0, %0, b;\n\t"
      "addc.u32 %1, %1, 0;\n\t}"
      : "=r"(r0), "=r"(r1)
      : "r"(lo32(acc_lo)), "r"(hi32(acc_lo)), "r"(lo32(acc_hi)),
        "r"(hi32(acc_hi)));
  return join(r0, r1);
}

// n lazy words made canonical in place: where a permutation writes them.
template <int n>
__device__ __forceinline__ void canon_words(uint64_t* s) {
#pragma unroll
  for (int i = 0; i < n; ++i) s[i] = gl::canon(s[i]);
}

// The block's tables in shared memory: the round constants in the form
// the kernel's MDS starts its sums from (make(c) of each constant c), and
// the byte table.
template <typename T, typename Make>
__device__ __forceinline__ void load_tables(T* rc, uint8_t* lut,
                                            const uint64_t* rc_g,
                                            const uint8_t* lut_g, Make make) {
  for (int i = threadIdx.x; i < kRounds * kState; i += blockDim.x) {
    rc[i] = make(rc_g[i]);
  }
  for (int i = threadIdx.x; i < 256; i += blockDim.x) lut[i] = lut_g[i];
}

}  // namespace
