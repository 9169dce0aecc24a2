// K3's device code: the local-pass kernel template that ntt.cu (natural
// order, with or without a second diagonal) and ntt_order.cu (the two order
// modes) instantiate, each in its own translation unit so that nvcc builds
// them in parallel. The design is described in ntt.cu.
//
// Order modes (a template flag, so the natural passes keep their
// registers):
// * kRevIn: input row r holds element brev(r) of the column (the counterpart
//   of the JAX package's no-reverse DIT core, twenty_first_tpu/math/ntt.py
//   :1153). The DIT's first round then reads rows G * R .. G * R + R - 1 of
//   group G = brev(h) (the natural order's bit reversal cancels), from the
//   device or, for an elements-fast input, from the staged tile (so the
//   device loads stay contiguous).
// * kRevOut: output k is stored at row brev(k) (the counterpart of its DIF
//   core, :941 with dif=True), and the diagonals are read at the row stored
//   to, as the JAX package's DIF tables are laid out.
// Both are address arithmetic only: no pass copies the block to reorder it.
#pragma once

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace k3 {

enum Order { kNatural = 0, kRevIn = 1, kRevOut = 2 };

// The order modes' kernel for 2^log_r elements a thread (ntt_order.cu).
const void* order_kernel(int log_r, int order);

}  // namespace k3

namespace {

using k3::kNatural;
using k3::kRevIn;
using k3::kRevOut;

// A block's thread limit, which caps a thread at 64 registers: two blocks
// of 512 threads (the main path's tile) keep 32 warps on an SM, which ran
// faster than 16 warps of 128 registers without spills.
constexpr int kLogMaxThreads = 10;
constexpr int kMaxThreads = 1 << kLogMaxThreads;
constexpr int kLogR = 4;  // log2 of the elements a thread holds
constexpr int kMaxSmem = 227 * 1024;

// The exponent e with w_{2^k} = 2^e mod p, by k, for the forward
// transform's roots (twenty_first_tpu_torch/math/b_field_element.py's
// PRIMITIVE_ROOTS, which nest: root_{2n}^2 = root_n); the inverse's is
// 192 - e.
__host__ __device__ constexpr int root_exponent(int log_k, bool inverse) {
  const int fwd = log_k == 1   ? 96
                  : log_k == 2 ? 48
                  : log_k == 3 ? 120
                  : log_k == 4 ? 156
                  : log_k == 5 ? 78
                  : log_k == 6 ? 39
                               : 0;
  return inverse ? (192 - fwd) % 192 : fwd;
}

__host__ __device__ constexpr int rev_bits(int x, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((x >> b) & 1) << (bits - 1 - b);
  return r;
}

// (x, y) <- (x + 2^e y, x - 2^e y), lazily.
__device__ __forceinline__ void butterfly(uint64_t& x, uint64_t& y, int e) {
  const bool neg = e >= 96;  // 2^e = -2^(e - 96)
  const int f = neg ? e - 96 : e;
  const uint64_t v = f == 0 ? y : gl::mul_pow2_lazy(y, f);
  const uint64_t s = gl::add_lazy_cc(x, v);
  const uint64_t d = gl::sub_lazy(x, v);
  x = neg ? d : s;
  y = neg ? s : d;
}

// In-place DIT DFT of length K = 2^LOG_K: a[i] holds input rev(i), a[p]
// ends as output p. Stage s twiddles a[j + m] by w_{2m}^(j mod m), m = 2^s.
template <int LOG_K, bool INV>
__device__ __forceinline__ void dft(uint64_t* a) {
#pragma unroll
  for (int s = 0; s < LOG_K; ++s) {
    const int m = 1 << s;
#pragma unroll
    for (int j0 = 0; j0 < (1 << LOG_K); j0 += 2 * m) {
#pragma unroll
      for (int jj = 0; jj < m; ++jj) {
        butterfly(a[j0 + jj], a[j0 + jj + m],
                  root_exponent(s + 1, INV) * jj % 192);
      }
    }
  }
}

struct Pass {
  const uint64_t* in;
  uint64_t* out;
  int log_t, log_tc;
  int64_t ncols, in_e, in_c, out_e, out_c;
  const uint64_t* diag;
  int64_t diag_e, diag_c;
  const uint64_t* diag2;
  int64_t diag2_e, diag2_c;
  uint64_t scale;
  int swz_shift, swz_mask;  // the tile's row swizzle

  __device__ __forceinline__ int addr(int pos, int c) const {
    return ((pos ^ ((pos >> swz_shift) & swz_mask)) << log_tc) + c;
  }

  // DIAG2: a kernel of its own, so that the passes without a second
  // diagonal keep their registers
  template <bool DIAG2, int ORDER>
  __device__ __forceinline__ void store(uint64_t v, int k, int64_t cg) const {
    if (cg >= ncols) return;
    // kRevOut: output k lands on row brev(k), diagonals read at that row
    if (ORDER == kRevOut) k = __brev(static_cast<unsigned>(k)) >> (32 - log_t);
    if (DIAG2) v = gl::mul_red(v, diag2[k * diag2_e + cg * diag2_c]);
    if (diag != nullptr) {
      v = scale != 1 ? gl::mul_red(v, diag[k * diag_e + cg * diag_c])
                     : gl::mul(v, diag[k * diag_e + cg * diag_c]);
    }
    if (scale != 1) {
      v = gl::mul(v, scale);
    } else if (diag == nullptr) {
      v = gl::canon(v);
    }
    out[cg * out_c + k * out_e] = v;
  }
};

// The last round: k = LOG_K stages after s (M = 2^s = t / K), R / K groups
// a thread, group i2 at residue r = i2 * (t / R) + h; outputs go to device
// memory as k = p * M + r.
template <int LOG_R, int LOG_K, bool INV, bool DIAG2, int ORDER>
__device__ __forceinline__ void last_round(const Pass& ps, uint64_t* a,
                                           const uint64_t* sh,
                                           const uint64_t* tab, int s, int c,
                                           int h, int64_t cg) {
  constexpr int K = 1 << LOG_K;
  const int hs = 1 << (ps.log_t - LOG_R);
#pragma unroll
  for (int i2 = 0; i2 < (1 << LOG_R) / K; ++i2) {
    const int r = i2 * hs + h;
    uint64_t* g = a + i2 * K;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int q = rev_bits(i, LOG_K);
      g[i] = sh[ps.addr((i << s) + r, c)];
      if (q != 0) g[i] = gl::mul_red(g[i], tab[((q - 1) << s) + r]);
    }
    dft<LOG_K, INV>(g);
#pragma unroll
    for (int p = 0; p < K; ++p) {
      ps.store<DIAG2, ORDER>(g[p], (p << s) + r, cg);
    }
  }
}

// The input row of a thread's element i in round 0 (group g0 = brev(h)).
template <int LOG_R, int ORDER>
__device__ __forceinline__ int in_row(int i, int log_h, int h, int g0) {
  return ORDER == kRevIn ? (g0 << LOG_R) + i
                         : (rev_bits(i, LOG_R) << log_h) + h;
}

template <int LOG_R, bool INV, bool DIAG2, int ORDER>
__device__ __forceinline__ void run_pass(const Pass& ps, uint64_t* sh,
                                         const uint64_t* tab, bool staged) {
  constexpr int R = 1 << LOG_R;
  const int log_t = ps.log_t;
  const int log_h = log_t - LOG_R;  // t / R threads a column
  const int c = threadIdx.x & ((1 << ps.log_tc) - 1);
  const int h = threadIdx.x >> ps.log_tc;
  const int64_t cg = (static_cast<int64_t>(blockIdx.x) << ps.log_tc) + c;
  const int g0 =
      log_h == 0 ? 0 : __brev(static_cast<unsigned>(h)) >> (32 - log_h);
  uint64_t a[R];

  // round 0: the R-point DFT of elements n * (t / R) + h, which the
  // radix-2 order puts at positions G * R + rev(n) of group G = rev(h);
  // a[i] takes n = rev(i), the DIT's input order. Under kRevIn element
  // n * (t / R) + h lies on row brev of it, G * R + i.
  if (staged) {
    const int stride = (1 << log_t) + ps.swz_mask + 1;  // padded column
#pragma unroll
    for (int i = 0; i < R; ++i) {
      a[i] = sh[c * stride + in_row<LOG_R, ORDER>(i, log_h, h, g0)];
    }
    __syncthreads();  // every staged word read before the tile is written
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int j = in_row<LOG_R, ORDER>(i, log_h, h, g0);
      a[i] = cg < ps.ncols ? ps.in[cg * ps.in_c + j * ps.in_e] : 0;
    }
  }
  dft<LOG_R, INV>(a);
  if (log_h == 0) {  // one round: G = 0, outputs in natural order
#pragma unroll
    for (int p = 0; p < R; ++p) ps.store<DIAG2, ORDER>(a[p], p, cg);
    return;
  }
#pragma unroll
  for (int p = 0; p < R; ++p) sh[ps.addr((g0 << LOG_R) + p, c)] = a[p];
  __syncthreads();

  // the middle rounds: LOG_R stages after s, group h at g = h >> s,
  // r = h mod 2^s; each thread reads and writes the same R positions.
  // a[i], sub-block i, is the DFT's input rev(i): twiddle w^(rev(i) r)
  int s = LOG_R;
  for (; s + LOG_R < log_t; s += LOG_R) {
    const int r = h & ((1 << s) - 1);
    const int base = ((h >> s) << (s + LOG_R)) + r;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int q = rev_bits(i, LOG_R);
      a[i] = sh[ps.addr(base + (i << s), c)];
      if (q != 0) a[i] = gl::mul_red(a[i], tab[((q - 1) << s) + r]);
    }
    dft<LOG_R, INV>(a);
#pragma unroll
    for (int p = 0; p < R; ++p) sh[ps.addr(base + (p << s), c)] = a[p];
    __syncthreads();
    tab += (R - 1) << s;
  }
  switch (log_t - s) {
    case 1: last_round<LOG_R, 1, INV, DIAG2, ORDER>(ps, a, sh, tab, s, c, h,
                                                    cg);
      break;
    case 2: last_round<LOG_R, (LOG_R < 2 ? LOG_R : 2), INV, DIAG2, ORDER>(
        ps, a, sh, tab, s, c, h, cg); break;
    case 3: last_round<LOG_R, (LOG_R < 3 ? LOG_R : 3), INV, DIAG2, ORDER>(
        ps, a, sh, tab, s, c, h, cg); break;
    case 4: last_round<LOG_R, (LOG_R < 4 ? LOG_R : 4), INV, DIAG2, ORDER>(
        ps, a, sh, tab, s, c, h, cg); break;
    default: break;
  }
}

// Entries of the outer-twiddle table: (2^k - 1) * 2^s for every round
// after the first (s = log_r, 2 log_r, ...; k = min(log_r, log_t - s)).
__host__ __device__ int table_len(int log_t, int log_r) {
  int n = 0;
  for (int s = log_r; s < log_t; s += log_r) {
    const int k = log_t - s < log_r ? log_t - s : log_r;
    n += ((1 << k) - 1) << s;
  }
  return n;
}

template <int LOG_R, bool DIAG2, int ORDER>
__global__ void __launch_bounds__(kMaxThreads)
    ntt_local_pass_kernel(Pass ps, int64_t in_b, int64_t out_b,
                          int64_t diag_b, int64_t diag2_b,
                          const uint64_t* __restrict__ tw) {
  extern __shared__ uint64_t smem[];
  const int log_t = ps.log_t;
  const int t = 1 << log_t;
  const int tab_n = table_len(log_t, LOG_R);
  uint64_t* tab = smem;
  uint64_t* sh = smem + tab_n;
  ps.in += blockIdx.y * in_b;
  ps.out += blockIdx.y * out_b;
  if (ps.diag != nullptr) ps.diag += blockIdx.y * diag_b;
  if (DIAG2) ps.diag2 += blockIdx.y * diag2_b;

  // the outer twiddles of every round, from the last stage of tw
  // (w_t^e for e < t/2; w_t^(e + t/2) = -w_t^e)
  if (tab_n > 0) {
    const int half = t >> 1;
    for (int e = threadIdx.x; e < half; e += blockDim.x) {
      sh[e] = tw[half - 1 + e];
    }
    __syncthreads();
    int off = 0;
    for (int s = LOG_R; s < log_t; s += LOG_R) {
      const int k = log_t - s < LOG_R ? log_t - s : LOG_R;
      const int n = ((1 << k) - 1) << s;
      for (int f = threadIdx.x; f < n; f += blockDim.x) {
        const int q = (f >> s) + 1;
        const int r = f & ((1 << s) - 1);
        const int e = (q * r) << (log_t - s - k);  // w_{KM}^(q r), < t
        tab[off + f] = e < half ? sh[e] : gl::P - sh[e - half];
      }
      off += n;
    }
    __syncthreads();
  }
  // an elements-fast input is staged column by column (padded columns),
  // in the order of its rows
  const bool staged = ps.in_e < ps.in_c && log_t > LOG_R;
  if (staged) {
    const int stride = t + ps.swz_mask + 1;
    const int tile = t << ps.log_tc;
    const int64_t c0 = static_cast<int64_t>(blockIdx.x) << ps.log_tc;
    for (int f = threadIdx.x; f < tile; f += blockDim.x) {
      const int c = f >> log_t;
      const int j = f & (t - 1);
      const int64_t cg = c0 + c;
      sh[c * stride + j] = cg < ps.ncols ? ps.in[cg * ps.in_c + j * ps.in_e] : 0;
    }
    __syncthreads();
  }
  // the direction, from w_4 = w_t^(t/4) (forward: 2^48)
  const bool inverse = log_t >= 2 && tw[(t >> 1) - 1 + (t >> 2)] != (1ull << 48);
  if (inverse) {
    run_pass<LOG_R, true, DIAG2, ORDER>(ps, sh, tab, staged);
  } else {
    run_pass<LOG_R, false, DIAG2, ORDER>(ps, sh, tab, staged);
  }
}

template <bool DIAG2, int ORDER>
const void* kernel_for(int log_r) {
  switch (log_r) {
    case 1: return reinterpret_cast<const void*>(
        ntt_local_pass_kernel<1, DIAG2, ORDER>);
    case 2: return reinterpret_cast<const void*>(
        ntt_local_pass_kernel<2, DIAG2, ORDER>);
    case 3: return reinterpret_cast<const void*>(
        ntt_local_pass_kernel<3, DIAG2, ORDER>);
    default: return reinterpret_cast<const void*>(
        ntt_local_pass_kernel<kLogR, DIAG2, ORDER>);
  }
}

}  // namespace
