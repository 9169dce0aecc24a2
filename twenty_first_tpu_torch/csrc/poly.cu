// The device polynomial batch path's kernels (math/poly_batch.py,
// math/gf_ext.py, the NTT-domain convolutions of math/ntt.py): K6
// coset_fold, K7 batch inversion and K8 gf_pointwise.
//
// None of them replaces a Pallas kernel: each replaces plain-jnp work that
// XLA fused on the TPU, and which the port's plain int64 torch would run as
// dozens of launches per field product.
//
// K6 coset_fold_kernel + fold_reduce_kernel <- the coefficient fold of
// twenty_first_tpu/math/poly_batch.py::_coset_extrapolate_pow_core (:152)
// and ::_coset_extrapolate_xfe_pow_core (:226): out[r, j] = sum_k b[r, k]
// w_j^k. JAX builds a (rows, points, n) table of terms; this never does.
// What bounds it: the products, rows * n * m terms (coefficient times point
// power) of one, three or six 32x32 products each by the fewest known
// (base points; xfe points over base coefficients; xfe over xfe), against a
// few bytes. A lane owns one point and one segment of 2^log_l coefficients
// of a row. The cost a term is what the design cuts: the lane keeps w^0 ..
// w^(B-1) in registers (B = 16) and folds B coefficients at a time from the
// top, acc = acc * w^B + sum_i b[k0 + i] w^i, with the block's B + 1
// products (xfe: per component, or the schoolbook product's five columns)
// summed unreduced in 160-bit accumulators of 32-bit multiply-add carry
// chains and reduced once a block. With an xfe point the outer product by
// w^B is its 3x3 matrix over the base field, so it adds into the same
// accumulators. So a term is one, three or nine multiply-add chains and no
// reduction. The lane scales its sum by w^(s 2^log_l); a warp's lanes are
// 2^log_p points of one or a few segments, so a coefficient load is one
// broadcast for those points. A block adds its segments' partial sums in
// shared memory; a second kernel adds the blocks'. The plan
// (ops/poly_cuda.py::fold_plan) picks the segment length.
//
// K7 inv_segment_kernel, inv_zero_rows_kernel <-
// twenty_first_tpu/math/gf.py::batch_inversion (:503), which JAX computes
// as two log-depth Hillis-Steele prefix-product scans. What bounds it: the
// bytes, each element read once and its inverse written once, against
// three products an element. The design is Montgomery's trick in one pass
// over the input, one field inversion a segment: a block copies its
// 4096-element segment of a row into shared memory (cp.async: no register
// holds a word in flight), each thread forms the running products of its
// 16 elements in registers, and the block takes the segment's product by
// one scan both ways (warp shuffles, then warp 0 over the warps). Warp 0
// inverts that product (K8's lazy chain), so every thread gets the
// inverse of its own elements' product as the segment's inverse times its
// exclusive prefix and suffix over the block, and walks its elements
// backwards, writing each inverse once. The segment's serial stages (the
// scans' barriers, the 72-product inversion) are latency: four resident
// blocks an SM, of 4096 elements each, keep the SM busy through them.
// Products are lazy carry chains (gl::mul_red), canonicalised on the way
// out. A 0 makes its segment's product 0 and the segment's inverses 0; the
// block records it in a flag of its (row, segment), and the second launch
// zeroes every row whose flags hold one (a block of a row without a 0
// reads the row's flags and exits), so a row holding a 0 comes out all
// zeros, as in JAX. The second launch is a programmatic dependent of the
// first (Hopper's griddepcontrol), so its launch overlaps the first's end.
//
// K8 gf_pointwise_kernel <- the elementwise ops of the path:
// twenty_first_tpu/math/gf.py::mul, gf_ext.py::mul (:71) and ::mul_base
// (:84), gf.py::inverse_or_zero (:444). What bounds it: the bytes for the
// products (24 a base element), the fixed addition chain's 63 squarings
// and 9 products an element for the inverse. The design is one thread an
// element (an xfe element: its three components) over a row, with a row
// stride for each operand, 0 for a row read for every row. The xfe product
// repeats the JAX package's order of canonical operations, so it gives
// the plain twin's words for any inputs. The inverse runs JAX's chain on
// lazy residues with one canonicalisation at its end: squarings of three
// 32x32 partial products (gl::sqr_red) and carry-chain products, two
// independent elements a thread so that one chain's latency hides the
// other's.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int kPointwiseThreads = 256;
constexpr int kFoldThreads = 256;
// K6's block: the terms a lane sums unreduced between two reductions
constexpr int kFoldBlock = 16;
// K7: a segment (one block, one field inversion) is kInvThreads x
// kInvPerThread elements, staged in shared memory (32 KB); four blocks an SM
// stay resident (at most 64 registers a thread); the zero-row launch runs
// kInvZeroBlocks blocks a row
constexpr int kInvThreads = 256;
constexpr int kInvPerThread = 16;
constexpr int kInvSegment = kInvThreads * kInvPerThread;
constexpr int kInvMinBlocks = 4;
constexpr int kInvZeroBlocks = 64;
constexpr int kMaxGrid = 65535;
constexpr unsigned kFull = 0xffffffffu;

struct Xfe {
  uint64_t c0, c1, c2;
};

// The extension product of twenty_first_tpu/math/gf_ext.py::mul (:71-81),
// canonical operations in its order.
__device__ __forceinline__ Xfe xmul(const Xfe& s, const Xfe& o) {
  using gl::add;
  using gl::mul;
  using gl::sub;
  const uint64_t r0 = sub(mul(s.c0, o.c0), add(mul(s.c2, o.c1),
                                               mul(s.c1, o.c2)));
  uint64_t r1 = add(mul(s.c1, o.c0), mul(s.c0, o.c1));
  r1 = add(r1, mul(s.c2, o.c1));
  r1 = add(r1, mul(sub(s.c1, s.c2), o.c2));
  uint64_t r2 = add(mul(s.c2, o.c0), mul(s.c1, o.c1));
  r2 = add(r2, mul(add(s.c0, s.c2), o.c2));
  return {r0, r1, r2};
}

// The same product on lazy residues (any u64 in, a u64 residue out).
__device__ __forceinline__ Xfe xmul_lazy(const Xfe& s, const Xfe& o) {
  using gl::add_lazy_cc;
  using gl::mul_red;
  using gl::sub_lazy;
  const uint64_t s2o1 = mul_red(s.c2, o.c1);
  const uint64_t r0 = sub_lazy(mul_red(s.c0, o.c0),
                               add_lazy_cc(s2o1, mul_red(s.c1, o.c2)));
  uint64_t r1 = add_lazy_cc(mul_red(s.c1, o.c0), mul_red(s.c0, o.c1));
  r1 = add_lazy_cc(r1, s2o1);
  r1 = add_lazy_cc(r1, mul_red(sub_lazy(s.c1, s.c2), o.c2));
  uint64_t r2 = add_lazy_cc(mul_red(s.c2, o.c0), mul_red(s.c1, o.c1));
  r2 = add_lazy_cc(r2, mul_red(add_lazy_cc(s.c0, s.c2), o.c2));
  return {r0, r1, r2};
}

// kN independent field words, so that their chains interleave.
template <int kN>
struct Words {
  uint64_t v[kN];
};

// x^(2^n), each word, on lazy residues.
template <int kN>
__device__ __forceinline__ Words<kN> nsquare(Words<kN> x, int n) {
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int e = 0; e < kN; ++e) x.v[e] = gl::sqr_red(x.v[e]);
  }
  return x;
}

template <int kN>
__device__ __forceinline__ Words<kN> wmul(Words<kN> x, const Words<kN>& y) {
#pragma unroll
  for (int e = 0; e < kN; ++e) x.v[e] = gl::mul_red(x.v[e], y.v[e]);
  return x;
}

// x^(p - 2) of each word by the fixed addition chain of
// gf.py::inverse_or_zero (:467-477), 63 squarings and 9 products on lazy
// residues, canonical out; 0 -> 0 (every step of 0 is exactly 0).
template <int kN>
__device__ __forceinline__ Words<kN> inverse_or_zero(const Words<kN>& x) {
  const Words<kN> bin2 = wmul(nsquare(x, 1), x);
  const Words<kN> bin3 = wmul(nsquare(bin2, 1), x);
  const Words<kN> bin6 = wmul(nsquare(bin3, 3), bin3);
  const Words<kN> bin12 = wmul(nsquare(bin6, 6), bin6);
  const Words<kN> bin24 = wmul(nsquare(bin12, 12), bin12);
  const Words<kN> bin30 = wmul(nsquare(bin24, 6), bin6);
  const Words<kN> bin31 = wmul(nsquare(bin30, 1), x);
  const Words<kN> bin31_z = nsquare(bin31, 1);
  const Words<kN> bin32 = wmul(bin31_z, x);
  Words<kN> r = wmul(nsquare(bin31_z, 32), bin32);
#pragma unroll
  for (int e = 0; e < kN; ++e) r.v[e] = gl::canon(r.v[e]);
  return r;
}

__device__ __forceinline__ uint64_t inverse_or_zero(uint64_t x) {
  return inverse_or_zero<1>(Words<1>{{x}}).v[0];
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

// Element j of every row r: op(a[r * a_row + ...], b[r * b_row + ...]) into
// out[r * out_row + ...]; an xfe row holds its components n apart.
// The inverse takes elements j and j + 256 of a block's 512, so that a
// thread runs two independent chains.
template <int kOp>
__global__ void __launch_bounds__(kPointwiseThreads)
    gf_pointwise_kernel(const uint64_t* __restrict__ a,
                        const uint64_t* __restrict__ b,
                        uint64_t* __restrict__ out, int64_t rows, int64_t n,
                        int64_t a_row, int64_t b_row, int64_t out_row) {
  constexpr int kPer = kOp == 3 ? 2 : 1;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kPointwiseThreads *
                        kPer + threadIdx.x;
  if (j >= n) return;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint64_t* pa = a + r * a_row + j;
    uint64_t* po = out + r * out_row + j;
    if constexpr (kOp == 3) {
      const bool two = j + kPointwiseThreads < n;  // else past the row's end
      const Words<2> inv = inverse_or_zero<2>(
          Words<2>{{pa[0], two ? pa[kPointwiseThreads] : 0}});
      po[0] = inv.v[0];
      if (two) po[kPointwiseThreads] = inv.v[1];
    } else if constexpr (kOp == 0) {
      po[0] = gl::mul(pa[0], b[r * b_row + j]);
    } else if constexpr (kOp == 1) {
      const uint64_t* pb = b + r * b_row + j;
      const Xfe v = xmul({pa[0], pa[n], pa[2 * n]}, {pb[0], pb[n], pb[2 * n]});
      po[0] = v.c0;
      po[n] = v.c1;
      po[2 * n] = v.c2;
    } else if constexpr (kOp == 2) {
      const uint64_t v = b[r * b_row + j];
      po[0] = gl::mul(pa[0], v);
      po[n] = gl::mul(pa[n], v);
      po[2 * n] = gl::mul(pa[2 * n], v);
    }
  }
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

// The inverse of each thread's t, from the inverse of the block's product:
// the exclusive prefix and suffix products of t over the block (warp
// shuffles both ways, then warp 0 over the warps' products) times that
// inverse, which warp 0 computes once, with each warp's factor. zero: the
// block's product is 0. Every thread of the block calls it.
template <int kThreads>
__device__ __forceinline__ uint64_t thread_inverse(uint64_t t, bool& zero) {
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
  constexpr int kWarps = kThreads / 32;
  __shared__ uint64_t warp_prod[kWarps], warp_factor[kWarps];
  __shared__ bool block_zero;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint64_t pre = t, suf = t;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint64_t up = __shfl_up_sync(kFull, pre, d);
    const uint64_t down = __shfl_down_sync(kFull, suf, d);
    if (lane >= d) pre = gl::mul_red(pre, up);
    if (lane + d < 32) suf = gl::mul_red(suf, down);
  }
  if (lane == 31) warp_prod[warp] = pre;
  __syncthreads();
  if (warp == 0) {
    // lanes past the last warp hold 1, so the scans stop at kWarps
    uint64_t p = lane < kWarps ? warp_prod[lane] : 1;
    uint64_t s = p;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const uint64_t up = __shfl_up_sync(kFull, p, d);
      const uint64_t down = __shfl_down_sync(kFull, s, d);
      if (lane >= d) p = gl::mul_red(p, up);
      if (lane + d < 32) s = gl::mul_red(s, down);
    }
    uint64_t p_ex = __shfl_up_sync(kFull, p, 1);
    uint64_t s_ex = __shfl_down_sync(kFull, s, 1);
    if (lane == 0) p_ex = 1;
    if (lane == kWarps - 1) s_ex = 1;
    const uint64_t total = __shfl_sync(kFull, s, 0);
    const uint64_t inv = inverse_or_zero(total);  // every lane: no divergence
    if (lane < kWarps) {
      warp_factor[lane] = gl::mul_red(inv, gl::mul_red(p_ex, s_ex));
    }
    if (lane == 0) block_zero = gl::canon(total) == 0;
  }
  __syncthreads();
  uint64_t p_ex = __shfl_up_sync(kFull, pre, 1);
  uint64_t s_ex = __shfl_down_sync(kFull, suf, 1);
  if (lane == 0) p_ex = 1;
  if (lane == 31) s_ex = 1;
  const uint64_t inv_t = gl::mul_red(gl::mul_red(warp_factor[warp], p_ex),
                                     s_ex);
  zero = block_zero;
  __syncthreads();  // the shared words are written again by the next row
  return inv_t;
}

// cp.async of one u64 word from device memory into shared memory: the copy
// holds no register while it is in flight.
__device__ __forceinline__ void cp_async8(uint64_t* smem, const uint64_t* g) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(addr),
               "l"(g));
}

// out[r, segment s]: each element's inverse, reading x once (thread k
// holds elements k, k + 256, ..., of the segment, copied into shared
// memory, its running products in registers; a missing element is 1);
// zero[r, s]: the segment's product is 0.
__global__ void __launch_bounds__(kInvThreads, kInvMinBlocks)
    inv_segment_kernel(const uint64_t* __restrict__ x,
                       uint64_t* __restrict__ out,
                       uint8_t* __restrict__ zero, int64_t rows, int64_t n,
                       int64_t nseg) {
  __shared__ uint64_t sv[kInvSegment];
  const int64_t seg = blockIdx.x;
  const int64_t left = n - seg * kInvSegment;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const int64_t base = r * n + seg * kInvSegment;
#pragma unroll
    for (int e = 0; e < kInvPerThread; ++e) {
      const int i = e * kInvThreads + threadIdx.x;
      if (i < left) {
        cp_async8(&sv[i], x + base + i);
      } else {
        sv[i] = 1;
      }
    }
    // a thread reads only the words it copied: no barrier
    asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;\n" ::
                     : "memory");
    uint64_t pre[kInvPerThread];
    pre[0] = sv[threadIdx.x];
#pragma unroll
    for (int e = 1; e < kInvPerThread; ++e) {
      pre[e] = gl::mul_red(pre[e - 1], sv[e * kInvThreads + threadIdx.x]);
    }
    bool zero_seg;
    // the inverse of this thread's product, then back over its elements
    uint64_t a = thread_inverse<kInvThreads>(pre[kInvPerThread - 1], zero_seg);
#pragma unroll
    for (int e = kInvPerThread - 1; e >= 0; --e) {
      const int i = e * kInvThreads + threadIdx.x;
      if (i < left) {
        out[base + i] = gl::canon(e > 0 ? gl::mul_red(a, pre[e - 1]) : a);
      }
      if (e > 0) a = gl::mul_red(a, sv[i]);
    }
    if (threadIdx.x == 0) zero[r * nseg + seg] = zero_seg;
  }
}

// Every row whose flags hold a 0 -> zeros, kInvZeroBlocks blocks a row (a
// block of a row without a 0 reads the row's flags and exits). Launched as
// a programmatic dependent of inv_segment_kernel, so that its launch
// overlaps that kernel's end; griddepcontrol.wait holds it until the flags
// are written.
__global__ void __launch_bounds__(kInvThreads)
    inv_zero_rows_kernel(uint64_t* __restrict__ out,
                         const uint8_t* __restrict__ zero, int64_t rows,
                         int64_t n, int64_t nseg) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    int any = 0;
    for (int64_t s = threadIdx.x; s < nseg; s += kInvThreads) {
      any |= zero[r * nseg + s];
    }
    if (!__syncthreads_or(any)) continue;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kInvThreads +
                     threadIdx.x;
         i < n; i += static_cast<int64_t>(gridDim.x) * kInvThreads) {
      out[r * n + i] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

// An unreduced sum of 128-bit products a * b, kept as two sums so that
// each 64-bit partial product adds into an aligned register pair: e, five
// 32-bit words, of a_lo b_lo + a_hi b_hi 2^64, and x, three words, of the
// cross products a_lo b_hi + a_hi b_lo, worth 2^32 each. Fewer than 2^31
// products stay below 2^160, so nothing wraps.
struct Wide {
  uint32_t e0 = 0, e1 = 0, e2 = 0, e3 = 0, e4 = 0, x0 = 0, x1 = 0, x2 = 0;
};

// s += a * b for any u64 a, b, nothing reduced: three carry chains of
// 32-bit multiply-adds.
__device__ __forceinline__ void mac(Wide& s, uint64_t a, uint64_t b) {
  asm("{\n\t"
      "mad.lo.cc.u32 %0, %8, %10, %0;\n\t"
      "madc.hi.cc.u32 %1, %8, %10, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %11, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %11, %3;\n\t"
      "addc.u32 %4, %4, 0;\n\t"
      "mad.lo.cc.u32 %5, %8, %11, %5;\n\t"
      "madc.hi.cc.u32 %6, %8, %11, %6;\n\t"
      "addc.u32 %7, %7, 0;\n\t"
      "mad.lo.cc.u32 %5, %9, %10, %5;\n\t"
      "madc.hi.cc.u32 %6, %9, %10, %6;\n\t"
      "addc.u32 %7, %7, 0;\n\t}"
      : "+r"(s.e0), "+r"(s.e1), "+r"(s.e2), "+r"(s.e3), "+r"(s.e4),
        "+r"(s.x0), "+r"(s.x1), "+r"(s.x2)
      : "r"(gl::lo32(a)), "r"(gl::hi32(a)), "r"(gl::lo32(b)),
        "r"(gl::hi32(b)));
}

// s mod p as a lazy residue: e + x 2^32 = (w1, w0) + (w3, w2) 2^64 + w4
// 2^128, then reduce128_lazy and w4 2^128 = -w4 2^32.
__device__ __forceinline__ uint64_t reduce_wide(const Wide& s) {
  uint32_t w1, w2, w3, w4;
  asm("add.cc.u32 %0, %4, %8;\n\t"
      "addc.cc.u32 %1, %5, %9;\n\t"
      "addc.cc.u32 %2, %6, %10;\n\t"
      "addc.u32 %3, %7, 0;"
      : "=r"(w1), "=r"(w2), "=r"(w3), "=r"(w4)
      : "r"(s.e1), "r"(s.e2), "r"(s.e3), "r"(s.e4), "r"(s.x0), "r"(s.x1),
        "r"(s.x2));
  const uint64_t r = gl::reduce128_lazy_cc(gl::join(s.e0, w1),
                                           gl::join(w2, w3));
  return gl::sub_lazy(r, static_cast<uint64_t>(w4) << 32);
}

// A point (one word, or an xfe's three) as lazy residues.
template <bool kX>
struct Pt {
  uint64_t c[kX ? 3 : 1];
  __device__ __forceinline__ static Pt one() {
    Pt r{};
    r.c[0] = 1;
    return r;
  }
  __device__ __forceinline__ Pt operator*(const Pt& o) const {
    Pt r;
    if constexpr (kX) {
      const Xfe v = xmul_lazy({c[0], c[1], c[2]}, {o.c[0], o.c[1], o.c[2]});
      r.c[0] = v.c0;
      r.c[1] = v.c1;
      r.c[2] = v.c2;
    } else {
      r.c[0] = gl::mul_red(c[0], o.c[0]);
    }
    return r;
  }
};

// base^e (lazy), e >= 0.
template <bool kX>
__device__ __forceinline__ Pt<kX> power(Pt<kX> base, int64_t e) {
  Pt<kX> result = Pt<kX>::one();
  while (e) {
    if (e & 1) result = result * base;
    e >>= 1;
    if (e) base = base * base;
  }
  return result;
}

// s[0..2] += v * W for the point W, as the product by W's 3x3 matrix over
// the base field (X^3 = X - 1), from the entries o = (W0, W1, W2, -W1,
// -W2, W0 + W2, W1 - W2): every product has non-negative operands.
__device__ __forceinline__ void mac_xmatrix(Wide (&s)[5], const uint64_t* v,
                                            const uint64_t (&o)[7]) {
  mac(s[0], v[0], o[0]);
  mac(s[0], v[1], o[4]);
  mac(s[0], v[2], o[3]);
  mac(s[1], v[0], o[1]);
  mac(s[1], v[1], o[5]);
  mac(s[1], v[2], o[6]);
  mac(s[2], v[0], o[2]);
  mac(s[2], v[1], o[1]);
  mac(s[2], v[2], o[5]);
}

// One block of kFoldBlock coefficients from k0 (the coefficients at hi and
// above read as 0 when kMasked): s[c] += sum_i b[k0 + i] (w^i)_c; with xfe
// coefficients the schoolbook product's five columns.
template <bool kXPts, bool kXCoef, bool kMasked>
__device__ __forceinline__ void fold_block(
    Wide (&s)[5], const uint64_t* __restrict__ row, int64_t k0, int64_t hi,
    int64_t n, const uint64_t (&pw)[kFoldBlock][3]) {
#pragma unroll
  for (int i = 0; i < kFoldBlock; ++i) {
    const int64_t k = k0 + i;
    const bool live = !kMasked || k < hi;
    const uint64_t* v = pw[i];
    if constexpr (kXCoef) {
      const uint64_t c0 = live ? row[k] : 0;
      const uint64_t c1 = live ? row[n + k] : 0;
      const uint64_t c2 = live ? row[2 * n + k] : 0;
      mac(s[0], c0, v[0]);
      mac(s[1], c0, v[1]);
      mac(s[1], c1, v[0]);
      mac(s[2], c0, v[2]);
      mac(s[2], c1, v[1]);
      mac(s[2], c2, v[0]);
      mac(s[3], c1, v[2]);
      mac(s[3], c2, v[1]);
      mac(s[4], c2, v[2]);
    } else {
      const uint64_t c = live ? row[k] : 0;
#pragma unroll
      for (int j = 0; j < (kXPts ? 3 : 1); ++j) mac(s[j], c, v[j]);
    }
  }
}

// partial[r, blockIdx.y, p, c]: the sum over this block's segments s of
// w_p^(s 2^log_l) * sum_{k in s} b[r, k] w_p^(k - s 2^log_l), component c.
// Thread t takes point blockIdx.x * 2^log_p + (t mod 2^log_p) and segment
// blockIdx.y * (256 / 2^log_p) + t / 2^log_p. Its segment is folded B =
// kFoldBlock coefficients at a time from the top: acc = acc * w^B + sum_i
// b[k0 + i] w^i, every product of a block summed unreduced and reduced once.
template <bool kXPts, bool kXCoef>
__global__ void __launch_bounds__(kFoldThreads)
    coset_fold_kernel(const uint64_t* __restrict__ b,
                      const uint64_t* __restrict__ w,
                      uint64_t* __restrict__ partial, int64_t rows, int64_t n,
                      int m, int log_p, int log_l, int64_t nseg, int groups) {
  constexpr int kComps = kXPts ? 3 : 1;
  __shared__ uint64_t red[kComps][kFoldThreads];
  const int tid = threadIdx.x;
  const int pts = 1 << log_p;
  const int per_block = kFoldThreads >> log_p;
  const int p = blockIdx.x * pts + (tid & (pts - 1));
  const int64_t seg = static_cast<int64_t>(blockIdx.y) * per_block +
                      (tid >> log_p);
  const bool active = p < m && seg < nseg;
  // the lane's powers w^0 .. w^(B-1), the outer factor w^B (xfe: as its
  // matrix's entries) and the segment's scale w^(seg 2^log_l)
  uint64_t pw[kFoldBlock][3] = {};
  uint64_t ow[7] = {};
  Pt<kXPts> scale = Pt<kXPts>::one();
  if (active) {
    Pt<kXPts> wp;
#pragma unroll
    for (int c = 0; c < kComps; ++c) wp.c[c] = w[kComps * p + c];
    Pt<kXPts> cur = Pt<kXPts>::one();
#pragma unroll
    for (int i = 0; i < kFoldBlock; ++i) {
#pragma unroll
      for (int c = 0; c < kComps; ++c) pw[i][c] = cur.c[c];
      cur = cur * wp;
    }
    if constexpr (kXPts) {
      ow[0] = cur.c[0];
      ow[1] = cur.c[1];
      ow[2] = cur.c[2];
      ow[3] = gl::sub_lazy(0, cur.c[1]);
      ow[4] = gl::sub_lazy(0, cur.c[2]);
      ow[5] = gl::add_lazy_cc(cur.c[0], cur.c[2]);
      ow[6] = gl::sub_lazy(cur.c[1], cur.c[2]);
    } else {
      ow[0] = cur.c[0];
    }
    Pt<kXPts> step = wp;  // w^(2^log_l), then w^(seg 2^log_l)
    for (int i = 0; i < log_l; ++i) step = step * step;
    scale = power(step, seg);
  }
  const int64_t lo = seg << log_l;
  const int64_t hi = lo + (int64_t{1} << log_l) < n ? lo + (int64_t{1} << log_l)
                                                    : n;
  const int64_t nb = (hi - lo + kFoldBlock - 1) / kFoldBlock;
  for (int64_t r = blockIdx.z; r < rows; r += gridDim.z) {
    Pt<kXPts> acc{};
    if (active) {
      const uint64_t* row = b + r * (kXCoef ? 3 : 1) * n;
      for (int64_t j = nb - 1; j >= 0; --j) {
        const int64_t k0 = lo + j * kFoldBlock;
        Wide s[5];
        if constexpr (kXPts) {
          mac_xmatrix(s, acc.c, ow);
        } else {
          mac(s[0], acc.c[0], ow[0]);
        }
        if (k0 + kFoldBlock <= hi) {
          fold_block<kXPts, kXCoef, false>(s, row, k0, hi, n, pw);
        } else {
          fold_block<kXPts, kXCoef, true>(s, row, k0, hi, n, pw);
        }
#pragma unroll
        for (int c = 0; c < kComps; ++c) acc.c[c] = reduce_wide(s[c]);
        if constexpr (kXCoef) {  // X^3 = X - 1, X^4 = X^2 - X
          const uint64_t c3 = reduce_wide(s[3]);
          const uint64_t c4 = reduce_wide(s[4]);
          acc.c[0] = gl::sub_lazy(acc.c[0], c3);
          acc.c[1] = gl::sub_lazy(gl::add_lazy_cc(acc.c[1], c3), c4);
          acc.c[2] = gl::add_lazy_cc(acc.c[2], c4);
        }
      }
      acc = acc * scale;
#pragma unroll
      for (int c = 0; c < kComps; ++c) acc.c[c] = gl::canon(acc.c[c]);
    }
#pragma unroll
    for (int c = 0; c < kComps; ++c) red[c][tid] = acc.c[c];
    __syncthreads();
    if (tid < pts && p < m) {
#pragma unroll
      for (int c = 0; c < kComps; ++c) {
        uint64_t t = 0;
        for (int q = 0; q < per_block; ++q) t = gl::add(t, red[c][q * pts + tid]);
        partial[((r * groups + blockIdx.y) * m + p) * kComps + c] = t;
      }
    }
    __syncthreads();
  }
}

// out[r, p, c] = sum over the groups of partial[r, g, p, c].
__global__ void __launch_bounds__(kFoldThreads)
    fold_reduce_kernel(const uint64_t* __restrict__ partial,
                       uint64_t* __restrict__ out, int64_t rows, int64_t width,
                       int groups) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= rows * width) return;
  const int64_t r = i / width;
  const int64_t pc = i - r * width;
  uint64_t s = 0;
  for (int g = 0; g < groups; ++g) {
    s = gl::add(s, partial[(r * groups + g) * width + pc]);
  }
  out[i] = s;
}

template <bool kXPts, bool kXCoef>
cudaError_t launch_fold(const uint64_t* b, const uint64_t* w,
                        uint64_t* partial, uint64_t* out, int64_t rows,
                        int64_t n, int m, int log_p, int log_l, int64_t nseg,
                        int groups, cudaStream_t s) {
  const unsigned tiles = static_cast<unsigned>((m + (1 << log_p) - 1) >>
                                               log_p);
  const dim3 grid(tiles, static_cast<unsigned>(groups),
                  static_cast<unsigned>(rows < kMaxGrid ? rows : kMaxGrid));
  coset_fold_kernel<kXPts, kXCoef><<<grid, kFoldThreads, 0, s>>>(
      b, w, partial, rows, n, m, log_p, log_l, nseg, groups);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t width = static_cast<int64_t>(m) * (kXPts ? 3 : 1);
  const int64_t total = rows * width;
  fold_reduce_kernel<<<static_cast<unsigned>((total + kFoldThreads - 1) /
                                             kFoldThreads),
                       kFoldThreads, 0, s>>>(partial, out, rows, width,
                                             groups);
  return cudaGetLastError();
}

}  // namespace

// a, b, out: rows of n elements (xfe rows: 3 components n apart) at row
// strides a_row, b_row (0: one row read for every row) and out_row.
// op: 0 base x base, 1 xfe x xfe, 2 xfe x base, 3 inverse of a (b unused).
extern "C" int tf_gf_pointwise(const void* a, const void* b, void* out,
                               long long rows, long long n, long long a_row,
                               long long b_row, long long out_row, int op,
                               void* stream) {
  if (op < 0 || op > 3 || rows < 0 || n < 0 || (op != 3 && b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows > 0 && n > 0) {
    const int64_t per_block = kPointwiseThreads * (op == 3 ? 2 : 1);
    const dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block),
                    static_cast<unsigned>(rows < kMaxGrid ? rows : kMaxGrid));
    const auto* pa = static_cast<const uint64_t*>(a);
    const auto* pb = static_cast<const uint64_t*>(b);
    auto* po = static_cast<uint64_t*>(out);
    const auto s = static_cast<cudaStream_t>(stream);
    switch (op) {
      case 0:
        gf_pointwise_kernel<0><<<grid, kPointwiseThreads, 0, s>>>(
            pa, pb, po, rows, n, a_row, b_row, out_row);
        break;
      case 1:
        gf_pointwise_kernel<1><<<grid, kPointwiseThreads, 0, s>>>(
            pa, pb, po, rows, n, a_row, b_row, out_row);
        break;
      case 2:
        gf_pointwise_kernel<2><<<grid, kPointwiseThreads, 0, s>>>(
            pa, pb, po, rows, n, a_row, b_row, out_row);
        break;
      default:
        gf_pointwise_kernel<3><<<grid, kPointwiseThreads, 0, s>>>(
            pa, pb, po, rows, n, a_row, b_row, out_row);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// x, out: (rows, n) contiguous; zero: (rows, nseg) flags with nseg =
// ceil(n / 4096), written before they are read (no initial value). out
// gets every element's inverse (a row with a 0: zeros).
extern "C" int tf_batch_inversion(const void* x, void* out, long long rows,
                                  long long n, void* zero, void* stream) {
  if (rows < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  const long long nseg = (n + kInvSegment - 1) / kInvSegment;
  if (nseg > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned ry = static_cast<unsigned>(rows < kMaxGrid ? rows : kMaxGrid);
  auto* po = static_cast<uint64_t*>(out);
  auto* pz = static_cast<uint8_t*>(zero);
  inv_segment_kernel<<<dim3(static_cast<unsigned>(nseg), ry), kInvThreads, 0,
                       s>>>(static_cast<const uint64_t*>(x), po, pz, rows, n,
                            nseg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nseg < kInvZeroBlocks
                                               ? nseg
                                               : kInvZeroBlocks),
                     ry);
  cfg.blockDim = dim3(kInvThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, inv_zero_rows_kernel, po,
                           static_cast<const uint8_t*>(pz),
                           static_cast<int64_t>(rows), static_cast<int64_t>(n),
                           static_cast<int64_t>(nseg));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// b: (rows, n) base or (rows, 3, n) xfe coefficients; w: (m,) base or
// (m, 3) xfe points; partial: (rows, groups, m, comps) scratch; out:
// (rows, m, comps). The plan (log_p, log_l, nseg, groups) is
// ops/poly_cuda.py::fold_plan's.
extern "C" int tf_coset_fold(const void* b, const void* w, void* partial,
                             void* out, long long rows, long long n, int m,
                             int log_p, int log_l, long long nseg, int groups,
                             int xpts, int xcoef, void* stream) {
  const long long per_block = kFoldThreads >> (log_p < 0 ? 0 : log_p);
  if (rows < 0 || n < 1 || m < 1 || log_p < 0 || log_p > 5 || log_l < 0 ||
      log_l > 40 || nseg < 1 || (nseg << log_l) < n ||
      ((nseg - 1) << log_l) >= n || groups < 1 || groups > kMaxGrid ||
      groups * per_block < nseg || (xcoef && !xpts)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  const auto* pb = static_cast<const uint64_t*>(b);
  const auto* pw = static_cast<const uint64_t*>(w);
  auto* pp = static_cast<uint64_t*>(partial);
  auto* po = static_cast<uint64_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!xpts) {
    err = launch_fold<false, false>(pb, pw, pp, po, rows, n, m, log_p, log_l,
                                    nseg, groups, s);
  } else if (!xcoef) {
    err = launch_fold<true, false>(pb, pw, pp, po, rows, n, m, log_p, log_l,
                                   nseg, groups, s);
  } else {
    err = launch_fold<true, true>(pb, pw, pp, po, rows, n, m, log_p, log_l,
                                  nseg, groups, s);
  }
  return static_cast<int>(err);
}
