// K3: one local pass of the four-step NTT on Hopper.
//
// Replaces twenty_first_tpu/ops/ntt_pallas.py::fused_local_pass (:47), whose
// inner kernel (:72) runs every butterfly stage of a (t, 128) tile in VMEM.
//
// The pass: for each batch b and column c, an NTT of length t = 2^log_t
// (1 <= log_t <= 12) over elements at in[b*in_b + c*in_c + j*in_e], written
// in natural order to out[b*out_b + c*out_c + k*out_e], each output
// optionally multiplied by diag[k*diag_e + c*diag_c] and by `scale`, and
// canonical. Arbitrary strides let both four-step passes run with no
// separate transpose: pass 1 over j2 (element stride n1, columns
// contiguous), pass 2 over j1 (contiguous) writing k2 + n2*k1.
//
// What bounds it: device memory. A pass reads and writes every element once
// (16 bytes) and does log_t/2 modular products per element; at t = 2^11
// that is about 6 products per 16 bytes, below what the integer units
// sustain at 3.35 TB/s.
//
// What the design does about it: one block per (column tile, batch) loads
// a t x tc tile into dynamic shared memory once, with the bit-reversal
// folded into the load's shared-memory address, runs all log_t radix-2 DIT
// stages there, and applies the diagonal and the 1/n scale in the store's
// epilogue: one read and one write of device memory per pass. Loads and
// stores walk the tile along whichever axis is contiguous in memory, so
// both passes coalesce. A tile is t*tc*8 bytes (64 KB at the main path's
// t = 2^11, tc = 4, 128 KB at t = 2^12), above the 48 KB default, so the
// launcher raises the kernel's dynamic shared-memory limit (Hopper has
// 227 KB per block; the TPU kernel asked for 100 MB of VMEM).
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kDefaultSmem = 48 * 1024;

__global__ void __launch_bounds__(kMaxThreads)
    ntt_local_pass_kernel(const uint64_t* in, uint64_t* out, int log_t,
                          int log_tc, int64_t ncols, int64_t in_b,
                          int64_t in_e, int64_t in_c, int64_t out_b,
                          int64_t out_e, int64_t out_c,
                          const uint64_t* __restrict__ tw,
                          const uint64_t* __restrict__ diag, int64_t diag_e,
                          int64_t diag_c, uint64_t scale) {
  extern __shared__ uint64_t sh[];  // sh[j * tc + c]
  const int t = 1 << log_t;
  const int tc = 1 << log_tc;
  const int tile = t << log_tc;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) << log_tc;
  in += blockIdx.y * in_b;
  out += blockIdx.y * out_b;

  // load, bit-reversing j into the shared-memory row
  const bool in_cols_fast = in_c <= in_e;
  for (int f = threadIdx.x; f < tile; f += blockDim.x) {
    const int c = in_cols_fast ? (f & (tc - 1)) : (f >> log_t);
    const int j = in_cols_fast ? (f >> log_tc) : (f & (t - 1));
    const int64_t cg = c0 + c;
    const uint64_t v = cg < ncols ? in[cg * in_c + j * in_e] : 0;
    const int r = static_cast<int>(__brev(static_cast<unsigned>(j)) >>
                                   (32 - log_t));
    sh[(r << log_tc) + c] = v;
  }
  __syncthreads();

  // radix-2 DIT stages; stage s uses tw[m - 1 + r] = w_{2m}^r, m = 2^s
  for (int s = 0; s < log_t; ++s) {
    const int m = 1 << s;
    for (int f = threadIdx.x; f < (tile >> 1); f += blockDim.x) {
      const int c = f & (tc - 1);
      const int p = f >> log_tc;
      const int r = p & (m - 1);
      const int a = ((p >> s) << (s + 1)) + r;
      const int ia = (a << log_tc) + c;
      const int ib = ((a + m) << log_tc) + c;
      const uint64_t u = sh[ia];
      const uint64_t v = gl::mul(sh[ib], tw[m - 1 + r]);
      sh[ia] = gl::add(u, v);
      sh[ib] = gl::sub(u, v);
    }
    __syncthreads();
  }

  // store, with the diagonal and scale epilogue
  const bool out_cols_fast = out_c <= out_e;
  for (int f = threadIdx.x; f < tile; f += blockDim.x) {
    const int c = out_cols_fast ? (f & (tc - 1)) : (f >> log_t);
    const int k = out_cols_fast ? (f >> log_tc) : (f & (t - 1));
    const int64_t cg = c0 + c;
    if (cg >= ncols) continue;
    uint64_t v = sh[(k << log_tc) + c];
    if (diag != nullptr) v = gl::mul(v, diag[k * diag_e + cg * diag_c]);
    if (scale != 1) v = gl::mul(v, scale);
    out[cg * out_c + k * out_e] = v;
  }
}

}  // namespace

extern "C" int tf_ntt_local_pass(
    const void* in, void* out, int log_t, int log_tc, long long ncols,
    int nbatch, long long in_b, long long in_e, long long in_c,
    long long out_b, long long out_e, long long out_c, const void* tw,
    const void* diag, long long diag_e, long long diag_c,
    unsigned long long scale, void* stream) {
  if (log_t < 1 || log_t > 12 || log_tc < 0 || nbatch < 1 || nbatch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = (sizeof(uint64_t) << log_t) << log_tc;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        ntt_local_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int half = 1 << (log_t + log_tc - 1);
  const int threads = half < 32 ? 32 : (half > kMaxThreads ? kMaxThreads : half);
  const long long tiles = (ncols + (1ll << log_tc) - 1) >> log_tc;
  if (tiles > 0) {
    const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(nbatch));
    ntt_local_pass_kernel<<<grid, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), log_t,
        log_tc, ncols, in_b, in_e, in_c, out_b, out_e, out_c,
        static_cast<const uint64_t*>(tw), static_cast<const uint64_t*>(diag),
        diag_e, diag_c, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
