// Tip5 on Hopper: the permutation (K1) and the multi-level Merkle commit (K2).
//
// Replaces the Pallas kernels of twenty_first_tpu/ops/tip5_pallas.py:
//   * K1 tip5_permute_kernel <- _dense_kernel (:252), launched by
//     permute_packed (:421); it also computes the function of the narrow
//     _permutation_kernel (:102) and of permutation_dense (:383).
//   * K2 merkle_commit_kernel <- _make_dense_multi_kernel (:262), launched
//     by permute_packed_multi (:302), together with the pairing glue of
//     ops/tip5_packed.py (pair_packed :99, _packed_chain :132).
//
// What bounds them: 64-bit integer multiplies. A round costs 8 modular
// products for the S-box's Montgomery conversions, 48 for x^7 on words
// 4..15 and 512 32x32->64 multiply-adds for the MDS; memory traffic (128
// bytes in and out per state) is small beside that.
//
// What the design does about it: one thread owns one state, its 16 words in
// registers, so no data moves between threads inside a permutation. The
// MDS is an exact integer matvec on 32-bit halves (the 16-bit entries keep
// each accumulator below 2^52) followed by ONE 128-bit Goldilocks reduction
// per word, instead of 256 modular products. The round constants and the
// byte table sit in shared memory (every thread of a warp reads the same
// constant: a broadcast). The TPU's (8,16) lane packing and evens-first
// reorder existed only for TPU lanes: K2 has a block read 2^L consecutive
// digests and pair neighbours directly in shared memory.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int kState = 16;
constexpr int kRounds = 5;
constexpr int kRate = 10;
constexpr int kDigest = 5;
constexpr int kSbox = 4;  // words through the byte lookup
constexpr int kMaxThreads = 256;
constexpr uint64_t kR = 0xFFFFFFFFull;             // 2^64 mod p
constexpr uint64_t kRInv = 0xFFFFFFFE00000001ull;  // 2^-64 mod p

__device__ __forceinline__ uint32_t mds_col(int k) {
  // SHA-256("Tip5") as little-endian 16-bit chunks (tip5/constants.py)
  constexpr uint32_t col[16] = {61402, 1108,  28750, 33823, 7454,  43244,
                                53865, 12034, 56951, 27521, 41351, 40901,
                                12021, 59689, 26798, 17845};
  return col[k & 15];
}

// Byte lookup on the Montgomery representative x * 2^64 mod p; the bytes
// after the lookup form any u64, which from-Montgomery accepts.
__device__ __forceinline__ uint64_t sbox_lookup(uint64_t x,
                                                const uint8_t* lut) {
  const uint64_t m = gl::mul(x, kR);
  uint64_t o = 0;
#pragma unroll
  for (int k = 0; k < 64; k += 8) {
    o |= static_cast<uint64_t>(lut[(m >> k) & 0xFF]) << k;
  }
  return gl::mul(o, kRInv);
}

// out[i] = sum_j col[(i - j) mod 16] * s[j] over the integers (< 2^84),
// then one reduction per word.
__device__ __forceinline__ void mds(uint64_t s[kState]) {
  uint32_t lo[kState], hi[kState];
#pragma unroll
  for (int j = 0; j < kState; ++j) {
    lo[j] = static_cast<uint32_t>(s[j]);
    hi[j] = static_cast<uint32_t>(s[j] >> 32);
  }
#pragma unroll
  for (int i = 0; i < kState; ++i) {
    uint64_t acc_lo = 0, acc_hi = 0;
#pragma unroll
    for (int j = 0; j < kState; ++j) {
      const uint64_t c = mds_col(i - j);
      acc_lo += c * lo[j];
      acc_hi += c * hi[j];
    }
    // acc_lo + acc_hi * 2^32 as a 128-bit (lo64, hi64) pair
    const uint64_t mid = (acc_lo >> 32) + (acc_hi & 0xFFFFFFFFull);
    const uint64_t lo64 = (acc_lo & 0xFFFFFFFFull) | (mid << 32);
    const uint64_t hi64 = (acc_hi >> 32) + (mid >> 32);
    s[i] = gl::reduce128(lo64, hi64);
  }
}

__device__ __forceinline__ void permute(uint64_t s[kState], const uint64_t* rc,
                                        const uint8_t* lut) {
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
#pragma unroll
    for (int i = 0; i < kSbox; ++i) s[i] = sbox_lookup(s[i], lut);
#pragma unroll
    for (int i = kSbox; i < kState; ++i) s[i] = gl::pow<7>(s[i]);
    mds(s);
#pragma unroll
    for (int i = 0; i < kState; ++i) s[i] = gl::add(s[i], rc[r * kState + i]);
  }
}

__device__ __forceinline__ void load_tables(uint64_t* rc, uint8_t* lut,
                                            const uint64_t* rc_g,
                                            const uint8_t* lut_g) {
  for (int i = threadIdx.x; i < kRounds * kState; i += blockDim.x) {
    rc[i] = rc_g[i];
  }
  for (int i = threadIdx.x; i < 256; i += blockDim.x) lut[i] = lut_g[i];
}

// K1: (rows, 16) states -> (rows, 16) permuted states, one thread per state.
__global__ void __launch_bounds__(kMaxThreads)
    tip5_permute_kernel(const uint64_t* in, uint64_t* out, int64_t rows,
                        const uint64_t* rc_g, const uint8_t* lut_g) {
  __shared__ uint64_t rc[kRounds * kState];
  __shared__ uint8_t lut[256];
  load_tables(rc, lut, rc_g, lut_g);
  __syncthreads();
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= rows) return;
  uint64_t s[kState];
#pragma unroll
  for (int i = 0; i < kState; ++i) s[i] = in[row * kState + i];
  permute(s, rc, lut);
#pragma unroll
  for (int i = 0; i < kState; ++i) out[row * kState + i] = s[i];
}

// K2: a block of T threads reduces `levels` Merkle levels.
//   leaf mode: T leaf states (rows, 16) -> permute -> T digests -> `levels`
//              pair levels -> T >> levels digests;
//   pair mode: 2T digests (rows, 5) -> `levels` pair levels (the first
//              straight from global memory) -> 2T >> levels digests.
// Parent j = hash_pair(child 2j, child 2j + 1): words 0..9 the two digests,
// capacity words 10..15 set to 1 (the FixedLength domain). Level by level
// the digests go through shared memory and the active threads halve.
__global__ void __launch_bounds__(kMaxThreads)
    merkle_commit_kernel(const uint64_t* in, uint64_t* out, int leaf,
                         int levels, const uint64_t* rc_g,
                         const uint8_t* lut_g) {
  __shared__ uint64_t rc[kRounds * kState];
  __shared__ uint8_t lut[256];
  __shared__ uint64_t dig[kMaxThreads * kDigest];
  load_tables(rc, lut, rc_g, lut_g);
  __syncthreads();
  const int t = threadIdx.x;
  uint64_t s[kState];
  if (leaf) {
    const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + t;
#pragma unroll
    for (int i = 0; i < kState; ++i) s[i] = in[row * kState + i];
  } else {
    const int64_t pair = static_cast<int64_t>(blockIdx.x) * blockDim.x + t;
    const uint64_t* src = in + pair * 2 * kDigest;  // two adjacent digests
#pragma unroll
    for (int i = 0; i < kRate; ++i) s[i] = src[i];
#pragma unroll
    for (int i = kRate; i < kState; ++i) s[i] = 1;
  }
  int cnt = blockDim.x;
  int todo = leaf ? levels : levels - 1;
  bool active = true;
  for (;;) {
    if (active) permute(s, rc, lut);
    if (todo == 0) break;
    --todo;
    __syncthreads();  // the previous level's reads of dig are done
    if (active) {
#pragma unroll
      for (int w = 0; w < kDigest; ++w) dig[t * kDigest + w] = s[w];
    }
    __syncthreads();
    cnt >>= 1;
    active = t < cnt;
    if (active) {
#pragma unroll
      for (int i = 0; i < kRate; ++i) s[i] = dig[2 * t * kDigest + i];
#pragma unroll
      for (int i = kRate; i < kState; ++i) s[i] = 1;
    }
  }
  if (active) {
    const int64_t row = static_cast<int64_t>(blockIdx.x) * cnt + t;
#pragma unroll
    for (int w = 0; w < kDigest; ++w) out[row * kDigest + w] = s[w];
  }
}

}  // namespace

extern "C" int tf_tip5_permute(const void* in, void* out, long long rows,
                               const void* rc, const void* lut,
                               void* stream) {
  constexpr int threads = 128;
  if (rows > 0) {
    const long long blocks = (rows + threads - 1) / threads;
    tip5_permute_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), rows,
        static_cast<const uint64_t*>(rc), static_cast<const uint8_t*>(lut));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tf_merkle_commit(const void* in, void* out, long long blocks,
                                int threads, int leaf, int levels,
                                const void* rc, const void* lut,
                                void* stream) {
  if (threads < 1 || threads > kMaxThreads || (threads & (threads - 1)) ||
      levels < (leaf ? 0 : 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (blocks > 0) {
    merkle_commit_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), leaf,
        levels, static_cast<const uint64_t*>(rc),
        static_cast<const uint8_t*>(lut));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
