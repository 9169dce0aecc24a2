// K3: one local pass of the four-step NTT on Hopper.
//
// Replaces twenty_first_tpu/ops/ntt_pallas.py::fused_local_pass (:47), whose
// inner kernel (:72) runs every butterfly stage of a (t, 128) tile in VMEM.
//
// The pass: for each batch b and column c, an NTT of length t = 2^log_t
// (1 <= log_t <= 12) over elements at in[b*in_b + c*in_c + j*in_e], written
// in natural order to out[b*out_b + c*out_c + k*out_e], each output
// optionally multiplied by diag[b*diag_b + k*diag_e + c*diag_c], by
// diag2[b*diag2_b + k*diag2_e + c*diag2_c] and by `scale`, and canonical.
// Arbitrary strides let every pass run with no separate transpose: the
// four-step's pass 1 over j2 (element stride n1, columns contiguous) and
// pass 2 over j1 (contiguous) writing k2 + n2*k1; the three-pass
// transform above 2^24 (math/ntt.py) over each of its three factors. The
// diagonals are broadcast views (zero strides): the three-pass transform's
// outer twiddle w_n^(a (kc + C kb)) is the product of two tables of at most
// 2^22 entries, diag and diag2, where an n-entry table would not fit beside
// a 2^32-element input and output.
//
// What bounds it: device memory (16 bytes an element) only if the
// arithmetic issues fast enough. A radix-2 pass issues log_t / 2 canonical
// products, adds and subtracts per element, each with its compares and
// selects, a global twiddle load and a barrier per stage: at t = 2^11 that
// is more issue time than the 16 bytes take, so the design cuts
// instructions and barriers:
//
// * Register rounds. A thread holds R = 2^kLogR elements of one column and
//   runs log R radix-2 stages on them in registers, so a pass of log_t
//   stages is ceil(log_t / log R) rounds with one exchange through shared
//   memory (and one barrier) between rounds. Round 0 loads from device
//   memory and the last round stores to it, so a pass still reads and
//   writes every element once.
// * Twiddles out of the butterflies. A round of K = 2^k stages after m
//   finished ones is, for each residue r < M = 2^m, T_q = w_{KM}^(q r) Z
//   over the K sub-blocks Z of length M (sub-block rev(q) holds the DFT of
//   the q-th interleaved subsequence; the outer twiddles, one lazy product
//   per element) followed by a K-point DFT of T. Every K-th root of unity (K <= 64) is a power of two
//   mod p (2 has order 192), so the DFT's inner twiddles are shifts
//   (gl::mul_pow2_lazy), not products; a root 2^e with e >= 96 is -2^(e-96)
//   and swaps the butterfly's sum and difference. Which power of two w_K is
//   depends only on the direction (PRIMITIVE_ROOTS nest), read once from tw.
// * Lazy arithmetic. Products, sums and differences are lazy (any u64
//   congruent to the value; gl::mul_red, add_lazy_cc, sub_lazy, carry
//   chains without compares); the store's epilogue makes each output
//   canonical (or multiplies it canonically by diag and scale).
// * Twiddles from shared memory. Each block copies the last stage of tw
//   (w_t^e, e < t/2) once, builds the outer twiddles of every round from it
//   as a [q - 1][r] table (consecutive threads read consecutive words), and
//   never loads a twiddle from device memory in a butterfly.
//
// The block: tc = 2^log_tc columns of one batch, t / R threads per column,
// the column fastest across threads (tc elements a row of a cols-fast view
// form one segment). The tile in shared memory holds row `pos` (bit-reversed
// input order, then the positions of the DIT) of column c at
// row' * tc + c, where row' XORs the low bits of pos with its high ones: the
// half-warp's 8-byte accesses then fall on distinct banks both in round 0's
// writes (bit-reversed groups) and in the later rounds (consecutive r).
// An elements-fast input (pass 2, single passes) is first staged through
// shared memory column by column, so its device loads stay contiguous.
// In place is safe: every load of a block precedes its first barrier after
// the loads, and every store follows the last one.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

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
  template <bool DIAG2>
  __device__ __forceinline__ void store(uint64_t v, int k, int64_t cg) const {
    if (cg >= ncols) return;
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
template <int LOG_R, int LOG_K, bool INV, bool DIAG2>
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
    for (int p = 0; p < K; ++p) ps.store<DIAG2>(g[p], (p << s) + r, cg);
  }
}

template <int LOG_R, bool INV, bool DIAG2>
__device__ __forceinline__ void run_pass(const Pass& ps, uint64_t* sh,
                                         const uint64_t* tab, bool staged) {
  constexpr int R = 1 << LOG_R;
  const int log_t = ps.log_t;
  const int log_h = log_t - LOG_R;  // t / R threads a column
  const int c = threadIdx.x & ((1 << ps.log_tc) - 1);
  const int h = threadIdx.x >> ps.log_tc;
  const int64_t cg = (static_cast<int64_t>(blockIdx.x) << ps.log_tc) + c;
  uint64_t a[R];

  // round 0: the R-point DFT of elements n * (t / R) + h, which the
  // radix-2 order puts at positions G * R + rev(n) of group G = rev(h);
  // a[i] takes n = rev(i), the DIT's input order
  if (staged) {
    const int stride = (1 << log_t) + ps.swz_mask + 1;  // padded column
#pragma unroll
    for (int i = 0; i < R; ++i) {
      a[i] = sh[c * stride + (rev_bits(i, LOG_R) << log_h) + h];
    }
    __syncthreads();  // every staged word read before the tile is written
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int j = (rev_bits(i, LOG_R) << log_h) + h;
      a[i] = cg < ps.ncols ? ps.in[cg * ps.in_c + j * ps.in_e] : 0;
    }
  }
  dft<LOG_R, INV>(a);
  if (log_h == 0) {  // one round: G = 0, outputs in natural order
#pragma unroll
    for (int p = 0; p < R; ++p) ps.store<DIAG2>(a[p], p, cg);
    return;
  }
  const int g0 = __brev(static_cast<unsigned>(h)) >> (32 - log_h);
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
    case 1: last_round<LOG_R, 1, INV, DIAG2>(ps, a, sh, tab, s, c, h, cg);
      break;
    case 2: last_round<LOG_R, (LOG_R < 2 ? LOG_R : 2), INV, DIAG2>(
        ps, a, sh, tab, s, c, h, cg); break;
    case 3: last_round<LOG_R, (LOG_R < 3 ? LOG_R : 3), INV, DIAG2>(
        ps, a, sh, tab, s, c, h, cg); break;
    case 4: last_round<LOG_R, (LOG_R < 4 ? LOG_R : 4), INV, DIAG2>(
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

template <int LOG_R, bool DIAG2>
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
  // an elements-fast input is staged column by column (padded columns)
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
    run_pass<LOG_R, true, DIAG2>(ps, sh, tab, staged);
  } else {
    run_pass<LOG_R, false, DIAG2>(ps, sh, tab, staged);
  }
}

// A launch's shape: elements a thread (2^log_r), columns a tile (2^log_tc,
// narrowed to at most kMaxThreads threads), the row swizzle, threads and
// dynamic shared memory.
struct Plan {
  int log_r, log_tc, swz_shift, swz_mask, threads;
  size_t smem;
  const void* kernel;
};

template <bool DIAG2>
const void* kernel_for(int log_r) {
  switch (log_r) {
    case 1: return reinterpret_cast<const void*>(ntt_local_pass_kernel<1, DIAG2>);
    case 2: return reinterpret_cast<const void*>(ntt_local_pass_kernel<2, DIAG2>);
    case 3: return reinterpret_cast<const void*>(ntt_local_pass_kernel<3, DIAG2>);
    default:
      return reinterpret_cast<const void*>(ntt_local_pass_kernel<kLogR, DIAG2>);
  }
}

Plan plan(int log_t, int log_tc, bool diag2) {
  Plan pl;
  pl.log_r = log_t < kLogR ? log_t : kLogR;
  const int log_h = log_t - pl.log_r;
  pl.log_tc = log_tc > kLogMaxThreads - log_h ? kLogMaxThreads - log_h : log_tc;
  // the row swizzle spreads a half-warp (16 / tc rows) over the banks
  const int swz_bits = pl.log_tc < 4 ? 4 - pl.log_tc : 0;
  const bool swz = 2 * swz_bits <= log_t;
  pl.swz_shift = swz ? log_t - swz_bits : 0;
  pl.swz_mask = swz ? (1 << swz_bits) - 1 : 0;
  pl.threads = 1 << (log_h + pl.log_tc);
  const size_t words =
      static_cast<size_t>(table_len(log_t, pl.log_r)) +
      (static_cast<size_t>((1 << log_t) + pl.swz_mask + 1) << pl.log_tc);
  pl.smem = words * sizeof(uint64_t);
  pl.kernel = diag2 ? kernel_for<true>(pl.log_r) : kernel_for<false>(pl.log_r);
  return pl;
}

cudaError_t prepare(const Plan& pl) {
  if (pl.smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(pl.kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(pl.smem));
}

}  // namespace

extern "C" int tf_ntt_local_pass(
    const void* in, void* out, int log_t, int log_tc, long long ncols,
    int nbatch, long long in_b, long long in_e, long long in_c,
    long long out_b, long long out_e, long long out_c, const void* tw,
    const void* diag, long long diag_b, long long diag_e, long long diag_c,
    const void* diag2, long long diag2_b, long long diag2_e,
    long long diag2_c, unsigned long long scale, void* stream) {
  if (log_t < 1 || log_t > 12 || log_tc < 0 || nbatch < 1 || nbatch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan pl = plan(log_t, log_tc, diag2 != nullptr);
  const cudaError_t err = prepare(pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  Pass ps{static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out),
          log_t, pl.log_tc, ncols, in_e, in_c, out_e, out_c,
          static_cast<const uint64_t*>(diag), diag_e, diag_c,
          static_cast<const uint64_t*>(diag2), diag2_e, diag2_c, scale,
          pl.swz_shift, pl.swz_mask};
  const long long tiles = (ncols + (1ll << pl.log_tc) - 1) >> pl.log_tc;
  if (tiles > 0) {
    const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(nbatch));
    long long in_bb = in_b, out_bb = out_b, diag_bb = diag_b,
              diag2_bb = diag2_b;
    const auto* twd = static_cast<const uint64_t*>(tw);
    void* args[] = {&ps, &in_bb, &out_bb, &diag_bb, &diag2_bb, &twd};
    return static_cast<int>(cudaLaunchKernel(
        pl.kernel, grid, dim3(pl.threads), args, pl.smem,
        static_cast<cudaStream_t>(stream)));
  }
  return static_cast<int>(cudaGetLastError());
}

// The block size and resident blocks per SM of the pass at t = 2^log_t with
// the tile the wrapper asks for (2^log_tc columns), on the current device.
extern "C" int tf_ntt_occupancy(int log_t, int log_tc, int* block,
                                int* blocks_per_sm) {
  if (log_t < 1 || log_t > 12 || log_tc < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan pl = plan(log_t, log_tc, false);
  const cudaError_t err = prepare(pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  *block = pl.threads;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, pl.kernel, pl.threads, pl.smem));
}
