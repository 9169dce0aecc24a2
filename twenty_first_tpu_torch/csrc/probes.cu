// The Hopper counterparts of the Pallas probes in scripts/: K4 ntt_stage
// and K5 gf_chain. Both are yardsticks for the NTT and Tip5 kernels, not
// parts of the library's main path.
//
// K4 ntt_stage_kernel <- scripts/prof_pallas_pass.py::make_pass (:53) with
// roundtrip=True (kernel :57, :60-80), which writes every butterfly stage
// back to its output ref. Here each launch is ONE radix-2 DIT stage over
// device memory, so a t-point pass costs log_t launches and log_t round
// trips of the whole array where K3 (ntt.cu) keeps the tile in shared
// memory and makes one. What bounds it: device memory, 16 bytes per
// element per stage against one modular product per two elements. The
// design is the plainest that streams: one thread per butterfly, threads
// along whichever axis of the (t, C) view is contiguous, so loads and
// stores coalesce. Stage 0 may read its input at bit-reversed rows (the
// JAX probe hoists that gather out of its kernel, :92-95); it then must not
// write in place. Later stages run in place. Canonical in, canonical out:
// the pass equals K3's.
//
// K5 gf_chain_kernel <- scripts/pallas_alu_probe.py::make_pallas (:38),
// kernel :39: k steps of o = op(o, b) followed by the limb swap
// o = (o.hi, o.lo), which on a u64 is a 32-bit rotation, with op one of
// gf.mul_lazy and gf.add_lazy. The outputs are the raw lazy words, as the
// JAX probe returns them. What bounds it: the integer pipes (k dependent
// ops per element against 24 bytes of traffic). The design keeps four
// independent elements per thread in registers, so each warp has four
// chains in flight, and does not unroll the step loop, so the loop body
// is exactly one step of four chains (what the probe reads in the SASS).
//
// imad_rate_kernel has no TPU counterpart: it measures how fast the integer
// multiply-add forms that K6 and K8 (poly.cu) are built from run on this
// card, one form a launch (probes/fold_probe.py --rates). Each thread runs
// eight independent chains of k steps, and every multiplicand comes from
// the chain's own state, so the pipe, not a chain's latency or a hoisted
// product, sets the time: form 0 mad.lo.u32, 1 mul.hi.u32, 2 mad.wide.u32
// (a 32x32 product into a 64-bit sum), 3 add.u32, 4 fma.rn.f64, 5 K6's
// accumulator step (poly.cu mac): two 32x32 products into three words by
// the carry chain mad.lo.cc, madc.hi.cc, addc.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int kStageThreads = 256;
constexpr int kChainThreads = 256;
constexpr int kChainPer = 4;  // independent chains per thread
constexpr int kMaxGridY = 65535;
constexpr int kRateThreads = 256;
constexpr int kRateChains = 8;

// One stage s (m = 2^s) over the columns of a (t, ncols) view: butterfly
// (p, c) pairs rows a = (p >> s) * 2m + (p & (m - 1)) and a + m of column
// c with twiddle tw[m - 1 + (p & (m - 1))].
__global__ void __launch_bounds__(kStageThreads)
    ntt_stage_kernel(const uint64_t* in, uint64_t* out, int log_t, int s,
                     int64_t ncols, int64_t in_e, int64_t in_c,
                     int64_t out_e, int64_t out_c,
                     const uint64_t* __restrict__ tw, int bit_reverse) {
  const int64_t half = int64_t{1} << (log_t - 1);
  const bool cols_fast = in_c <= in_e;
  const int64_t nfast = cols_fast ? ncols : half;
  const int64_t nslow = cols_fast ? half : ncols;
  const int64_t fast = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  if (fast >= nfast) return;
  const int m = 1 << s;
  for (int64_t slow = blockIdx.y; slow < nslow; slow += gridDim.y) {
    const int64_t c = cols_fast ? fast : slow;
    const int p = static_cast<int>(cols_fast ? slow : fast);
    const int r = p & (m - 1);
    const int a = ((p >> s) << (s + 1)) + r;
    const int b = a + m;
    int ja = a, jb = b;
    if (bit_reverse) {
      ja = static_cast<int>(__brev(static_cast<unsigned>(a)) >> (32 - log_t));
      jb = static_cast<int>(__brev(static_cast<unsigned>(b)) >> (32 - log_t));
    }
    const uint64_t u = in[c * in_c + ja * in_e];
    const uint64_t v = gl::mul(in[c * in_c + jb * in_e], tw[m - 1 + r]);
    out[c * out_c + a * out_e] = gl::add(u, v);
    out[c * out_c + b * out_e] = gl::sub(u, v);
  }
}

template <int kOp>
__device__ __forceinline__ uint64_t chain_op(uint64_t o, uint64_t b) {
  if constexpr (kOp == 0) {
    return gl::mul_lazy(o, b);
  } else {
    return gl::add_lazy(o, b);
  }
}

// out[i] = the k-step chain from a[i] with operand b[i]; thread x holds
// elements x, x + T, x + 2T, x + 3T for T the number of threads.
template <int kOp>
__global__ void __launch_bounds__(kChainThreads)
    gf_chain_kernel(const uint64_t* a, const uint64_t* b, uint64_t* out,
                    int64_t n, int k) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  uint64_t o[kChainPer], w[kChainPer];
#pragma unroll
  for (int j = 0; j < kChainPer; ++j) {
    const int64_t i = base + j * stride;
    o[j] = i < n ? a[i] : 0;
    w[j] = i < n ? b[i] : 0;
  }
#pragma unroll 1
  for (int step = 0; step < k; ++step) {
#pragma unroll
    for (int j = 0; j < kChainPer; ++j) {
      const uint64_t x = chain_op<kOp>(o[j], w[j]);
      o[j] = (x << 32) | (x >> 32);  // the limb swap
    }
  }
#pragma unroll
  for (int j = 0; j < kChainPer; ++j) {
    const int64_t i = base + j * stride;
    if (i < n) out[i] = o[j];
  }
}

// k steps of form kForm on kRateChains chains; out[thread] folds the chains
// together so that none is dead code.
template <int kForm>
__global__ void __launch_bounds__(kRateThreads)
    imad_rate_kernel(uint64_t* out, int k) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t u[kRateChains], v[kRateChains], c[kRateChains];
  double d[kRateChains];
#pragma unroll
  for (int j = 0; j < kRateChains; ++j) {
    u[j] = t * 2654435761u + j * 40503u + 1u;
    v[j] = u[j] ^ 0x9e3779b9u;
    c[j] = 0;
    d[j] = 1.0 + 1e-9 * j;
  }
  const uint32_t m = 0x5bd1e995u + t;
  const double dm = 0.9999999, dc = 1e-7;
#pragma unroll 1
  for (int step = 0; step < k; ++step) {
#pragma unroll
    for (int j = 0; j < kRateChains; ++j) {
      if constexpr (kForm == 0) {
        asm volatile("mad.lo.u32 %0, %0, %1, %2;"
                     : "+r"(u[j]) : "r"(m), "r"(v[j]));
      } else if constexpr (kForm == 1) {
        asm volatile("mul.hi.u32 %0, %0, %1;" : "+r"(u[j]) : "r"(m));
      } else if constexpr (kForm == 2) {
        uint64_t w = gl::join(u[j], v[j]);
        asm volatile("{\n\t.reg .u32 lo;\n\t"
                     "cvt.u32.u64 lo, %0;\n\t"
                     "mad.wide.u32 %0, lo, %1, %0;\n\t}"
                     : "+l"(w) : "r"(m));
        u[j] = gl::lo32(w);
        v[j] = gl::hi32(w);
      } else if constexpr (kForm == 3) {
        asm volatile("add.u32 %0, %0, %1;" : "+r"(u[j]) : "r"(m));
      } else if constexpr (kForm == 4) {
        asm volatile("fma.rn.f64 %0, %0, %1, %2;"
                     : "+d"(d[j]) : "d"(dm), "d"(dc));
      } else {
        asm volatile("mad.lo.cc.u32 %0, %1, %3, %0;\n\t"
                     "madc.hi.cc.u32 %1, %1, %3, %1;\n\t"
                     "addc.u32 %2, %2, 0;"
                     : "+r"(u[j]), "+r"(v[j]), "+r"(c[j]) : "r"(m));
      }
    }
  }
  uint64_t acc = 0;
#pragma unroll
  for (int j = 0; j < kRateChains; ++j) {
    acc ^= gl::join(u[j], v[j] ^ c[j]) ^ static_cast<uint64_t>(d[j]);
  }
  out[t] = acc;
}

}  // namespace

// out: blocks * 256 u64 words; k steps of form (0-5, see the top of this
// file) on eight chains a thread.
extern "C" int tf_imad_rate(void* out, int blocks, int k, int form,
                            void* stream) {
  if (blocks < 1 || k < 0 || form < 0 || form > 5) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* po = static_cast<uint64_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0:
      imad_rate_kernel<0><<<blocks, kRateThreads, 0, s>>>(po, k);
      break;
    case 1:
      imad_rate_kernel<1><<<blocks, kRateThreads, 0, s>>>(po, k);
      break;
    case 2:
      imad_rate_kernel<2><<<blocks, kRateThreads, 0, s>>>(po, k);
      break;
    case 3:
      imad_rate_kernel<3><<<blocks, kRateThreads, 0, s>>>(po, k);
      break;
    case 4:
      imad_rate_kernel<4><<<blocks, kRateThreads, 0, s>>>(po, k);
      break;
    default:
      imad_rate_kernel<5><<<blocks, kRateThreads, 0, s>>>(po, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// in/out: (t, ncols) views with element strides (in_e, in_c), (out_e,
// out_c); tw: the (t - 1,) stage twiddles. With bit_reverse the stage
// reads row rev(j) for row j; out then must not overlap in.
extern "C" int tf_ntt_stage(const void* in, void* out, int log_t, int stage,
                            long long ncols, long long in_e, long long in_c,
                            long long out_e, long long out_c, const void* tw,
                            int bit_reverse, void* stream) {
  if (log_t < 1 || log_t > 30 || stage < 0 || stage >= log_t || ncols < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long half = 1ll << (log_t - 1);
  const bool cols_fast = in_c <= in_e;
  const long long nfast = cols_fast ? ncols : half;
  const long long nslow = cols_fast ? half : ncols;
  if (nfast > 0 && nslow > 0) {
    const long long bx = (nfast + kStageThreads - 1) / kStageThreads;
    const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(
        nslow < kMaxGridY ? nslow : kMaxGridY));
    ntt_stage_kernel<<<grid, kStageThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), log_t,
        stage, ncols, in_e, in_c, out_e, out_c,
        static_cast<const uint64_t*>(tw), bit_reverse);
  }
  return static_cast<int>(cudaGetLastError());
}

// op: 0 mul_lazy, 1 add_lazy; a, b, out: n contiguous u64 words.
extern "C" int tf_gf_chain(const void* a, const void* b, void* out,
                           long long n, int k, int op, void* stream) {
  if (op < 0 || op > 1 || k < 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const long long per_block = static_cast<long long>(kChainThreads) *
                                kChainPer;
    const unsigned blocks = static_cast<unsigned>((n + per_block - 1) /
                                                  per_block);
    const auto* pa = static_cast<const uint64_t*>(a);
    const auto* pb = static_cast<const uint64_t*>(b);
    auto* po = static_cast<uint64_t*>(out);
    const auto s = static_cast<cudaStream_t>(stream);
    if (op == 0) {
      gf_chain_kernel<0><<<blocks, kChainThreads, 0, s>>>(pa, pb, po, n, k);
    } else {
      gf_chain_kernel<1><<<blocks, kChainThreads, 0, s>>>(pa, pb, po, n, k);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
