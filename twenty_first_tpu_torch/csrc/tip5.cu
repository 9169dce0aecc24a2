// Tip5 on Hopper: the permutation (K1) and the Merkle tree (K2).
//
// Replaces the Pallas kernels of twenty_first_tpu/ops/tip5_pallas.py:
//   * K1 tip5_permute_kernel<kPermute> <- _dense_kernel (:252), launched by
//     permute_packed (:421); it also computes the function of the narrow
//     _permutation_kernel (:102) and of permutation_dense (:383), which
//     ops/tip5_batch.py launches through it. tip5_permute_kernel<kTrace>
//     gives tip5/permutation.py::trace (:204).
//   * K1's absorb mode, tip5_permute_kernel<kPermute> with a row stride
//     and a chunk count (an overload, so K1's plain instantiation keeps its
//     code and registers), and its lane mode (a third overload, the rows an
//     int) <- the absorb loop of
//     twenty_first_tpu/tip5/permutation.py::hash_varlen_padded (:252), the
//     whole sponge in one launch: see "The sponge" below.
//   * K2, the Merkle tree <- permute_packed_multi (:302) /
//     _make_dense_multi_kernel (:262), with the pairing glue of
//     ops/tip5_packed.py (pair_packed :99, _packed_chain :132). Two kernels:
//     tip5_permute_kernel<kPair> (and <kLeaf>) reduces one level at full
//     width, merkle_commit_kernel fuses the levels of the tail.
//
// What bounds them on this card: instruction issue, pipe by pipe. A
// permutation is 5 rounds of 4 byte-lookup S-boxes, 12 x^7 (48 modular
// products) and a 16x16 MDS. One state per thread keeps every word in
// registers and moves nothing between threads; the memory traffic (128
// bytes in and out per state) is small beside the arithmetic. Integer
// multiplies go to the FMA pipe and integer adds, compares and selects to
// the ALU pipe, each at half the issue rate, so the design takes
// instructions off both and gives work to the FP64 pipe beside them:
//   * the MDS is an exact matvec on 32-bit halves in double FMAs, the
//     16-bit entries as constants: every half-sum, with the round constant
//     as its start, stays below 2^52, so a double holds it exactly and the
//     round-constant addition costs nothing;
//   * x^7 works on lazy residues (any u64 congruent to the value): each
//     product is one PTX carry chain of 32-bit multiply-adds and a lazy
//     reduction, with no compare, select or final subtraction; the MDS's
//     32-bit split takes any u64, and the state is made canonical only
//     where it is written;
//   * the S-box's Montgomery conversions are shifts and adds: x * 2^64 =
//     x0 * (2^32 - 1) - x1 for x = x1 * 2^32 + x0, and the way back is one
//     Montgomery reduction of a 64-bit word. The bytes looked up are those
//     of the canonical Montgomery form.
//
// The sponge (K1's absorb mode): one row's state lives in registers from
// the all-zero VariableLength state; words 0..9 are overwritten with each
// of the row's k chunks in turn and permuted, and the row's 5-word digest
// is written at the end: no state goes through device memory and the host
// launches once for all k absorbs. It reads 80 bytes a permutation (the
// chunk, at the row's stride, with 64-bit offsets), too few for bandwidth
// to bind, but a load's latency (about 1 us) would stall each absorb, so
// each design loads ahead. Two designs, one algorithm:
//   * a thread a row: its bound is K1's, one permutation's issue rate. The
//     chunks go through a two-slot ring in shared memory (chunk c + 1 is
//     copied with cp.async while chunk c is permuted, holding no register
//     in flight). Each thread lives for all k permutations, so a launch is
//     as long as its busiest SM's waves of resident blocks: a block is one
//     warp, the finest grain, so the rows spread over the SMs as evenly as
//     their count allows (16 blocks an SM, as many warps as K1 holds). A
//     launch of few rows takes one row's latency: a lone thread's 1,639
//     dependent permutations of a 16,384-word row, 18.3 ms on an H100.
//   * the lane mode, 16 lanes a row (lane i holds word i, two rows a
//     warp): the S-box in every lane (both, each lane keeping its own), the
//     MDS as 15 shuffle steps with the circulant's entries as immediates,
//     the next chunks' words two ahead in registers. It issues about 1.6
//     times the instructions a row but cuts a row's latency about 8 times.
// ops/tip5_cuda.py::lane_mode picks the lane mode for launches of fewer
// rows than a fifth of the threads that the thread-a-row design holds
// resident on the card, where the two times cross on an H100 (PERF.md,
// K1a).
//
// K2's tree: a block that reduces several levels in shared memory halves
// its working threads at every level, so most of its life one warp or less
// works. Each level whose parents fill the card's resident threads runs
// instead as one full-width launch, a thread per parent reading its two
// children (80 contiguous bytes, five 16-byte loads), so every warp works
// at every such level. The levels below that size are bound by the latency
// of one permutation whatever is done: they stay fused, up to 9 levels per
// launch, a block pairing neighbours through shared memory.
// ops/tip5_commit.py plans the launches from the row count and the
// resident thread count.
#include <climits>

#include "tip5_body.cuh"

namespace {

constexpr int kRate = 10;
constexpr int kDigest = 5;
constexpr int kMaxThreads = 256;  // the fused tail's largest block
constexpr int kRowThreads = 128;  // K1 and the level kernel
// K1's absorb mode: a warp a block, 16 blocks an SM (K1's 128 registers)
constexpr int kAbsorbThreads = 32;
constexpr int kAbsorbBlocksPerSm = 16;
// K1's lane mode: kLanes lanes a row, a warp a block (two rows)
constexpr int kLanes = 16;
constexpr int kLaneThreads = 32;

// SHA-256("Tip5") as little-endian 16-bit chunks (tip5/constants.py)
__device__ __forceinline__ double mds_col(int k) {
  constexpr double col[16] = {61402, 1108,  28750, 33823, 7454,  43244,
                              53865, 12034, 56951, 27521, 41351, 40901,
                              12021, 59689, 26798, 17845};
  return col[k & 15];
}

// An exact double below 2^52 as an integer: the low 52 bits of 2^52 + d.
__device__ __forceinline__ uint64_t exact_u64(double d) {
  return static_cast<uint64_t>(__double_as_longlong(d + 4503599627370496.0)) &
         ((1ull << 52) - 1);
}

// s <- MDS(s) + rc for lazy words s: out[i] = rc[i] + sum_j col[(i - j)
// mod 16] * s[j] over the integers, on 32-bit halves. A half-sum is at
// most (2^32 - 1) * 524757 + 2^32 - 1 < 2^52 (524757 the column's sum),
// so the double FMAs are exact. rc holds the round's 16 constants as
// (low half, high half) pairs of doubles.
__device__ __forceinline__ void mds_add_rc(uint64_t s[kState],
                                           const double2* rc) {
  double lo[kState], hi[kState];
#pragma unroll
  for (int j = 0; j < kState; ++j) {
    lo[j] = static_cast<double>(lo32(s[j]));
    hi[j] = static_cast<double>(hi32(s[j]));
  }
#pragma unroll
  for (int i = 0; i < kState; ++i) {
    double acc_lo = rc[i].x;
    double acc_hi = rc[i].y;
#pragma unroll
    for (int j = 0; j < kState; ++j) {
      acc_lo = fma(mds_col(i - j), lo[j], acc_lo);
      acc_hi = fma(mds_col(i - j), hi[j], acc_hi);
    }
    s[i] = combine(exact_u64(acc_lo), exact_u64(acc_hi));
  }
}

// The permutation of one state in registers, canonical out. after_round(r,
// s) sees the lazy state after round r (the trace mode writes it; the
// others pass a no-op, which compiles away).
template <typename AfterRound>
__device__ __forceinline__ void permute(uint64_t s[kState], const double2* rc,
                                        const uint8_t* lut,
                                        AfterRound after_round) {
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
#pragma unroll
    for (int i = 0; i < kSbox; ++i) s[i] = sbox_lookup(s[i], lut);
#pragma unroll
    for (int i = kSbox; i < kState; ++i) s[i] = pow7(s[i]);
    mds_add_rc(s, rc + r * kState);
    after_round(r, s);
  }
  canon_words<kState>(s);
}

__device__ __forceinline__ void permute(uint64_t s[kState], const double2* rc,
                                        const uint8_t* lut) {
  permute(s, rc, lut, [](int, const uint64_t*) {});
}

// The block's tables in shared memory: the round constants as (low half,
// high half) doubles, which the MDS's accumulators start from, and the
// byte table.
__device__ __forceinline__ void load_tables(double2* rc, uint8_t* lut,
                                            const uint64_t* rc_g,
                                            const uint8_t* lut_g) {
  load_tables(rc, lut, rc_g, lut_g, [](uint64_t c) {
    return make_double2(lo32(c), hi32(c));
  });
}

// n words from src to s in 16-byte loads (src 16-byte aligned, n even)
template <int kWords>
__device__ __forceinline__ void load_words(uint64_t* s, const uint64_t* src) {
  const ulonglong2* v = reinterpret_cast<const ulonglong2*>(src);
#pragma unroll
  for (int k = 0; k < kWords / 2; ++k) {
    const ulonglong2 w = v[k];
    s[2 * k] = w.x;
    s[2 * k + 1] = w.y;
  }
}

enum Mode : int {
  kPermute = 0,  // (rows, 16) states -> (rows, 16) permuted (K1)
  kTrace = 1,    // (rows, 16) -> (rows, 6, 16): input and each round's state
  kPair = 2,     // (2 rows, 5) digests -> (rows, 5): one tree level (K2)
  kLeaf = 3,     // (rows, 16) leaf states -> (rows, 5) digests (K2)
};

// The trace mode's writes: a warp stages the 16 words of its 32 rows in
// shared memory (rows padded to 18 words, so each row starts 16-byte
// aligned) and stores them as 16-byte chunks, 8 lanes to a row's 128
// contiguous bytes, into slot `slot` of each row's (6, 16) block.
__device__ __forceinline__ void write_trace_slot(
    uint64_t (*stage)[kState + 2], const uint64_t* s, uint64_t* out,
    int64_t warp_row, int64_t rows, int slot) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kState; ++i) stage[lane][i] = s[i];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kState / 2; ++k) {
    const int chunk = lane + 32 * k;  // row chunk / 8, 16-byte part chunk % 8
    const int64_t row = warp_row + chunk / 8;
    if (row < rows) {
      const ulonglong2 v =
          *reinterpret_cast<const ulonglong2*>(&stage[chunk / 8][2 * (chunk % 8)]);
      reinterpret_cast<ulonglong2*>(
          out + (row * (kRounds + 1) + slot) * kState)[chunk % 8] = v;
    }
  }
  __syncwarp();
}

// One thread per output row. kPair pairs children 2j, 2j + 1 into parent
// j: rate words 0..9 the two digests (80 contiguous bytes), capacity words
// 10..15 set to 1 (the FixedLength domain).
template <int kMode>
__global__ void __launch_bounds__(kRowThreads)
    tip5_permute_kernel(const uint64_t* __restrict__ in,
                        uint64_t* __restrict__ out, int64_t rows,
                        const uint64_t* rc_g, const uint8_t* lut_g) {
  __shared__ double2 rc[kRounds * kState];
  __shared__ uint8_t lut[256];
  load_tables(rc, lut, rc_g, lut_g);
  __syncthreads();
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  uint64_t s[kState];
  if constexpr (kMode == kTrace) {
    // every lane stays to the end for the warp's staged writes; a lane past
    // the last row permutes zeros and writes nothing
    __shared__ __align__(16) uint64_t stage[kRowThreads / 32][32][kState + 2];
    auto* mine = stage[threadIdx.x / 32];
    const int64_t warp_row = row - (threadIdx.x & 31);
    if (row < rows) {
      load_words<kState>(s, in + row * kState);
    } else {
#pragma unroll
      for (int i = 0; i < kState; ++i) s[i] = 0;
    }
    write_trace_slot(mine, s, out, warp_row, rows, 0);
    permute(s, rc, lut, [&](int r, const uint64_t* w) {
      uint64_t c[kState];
#pragma unroll
      for (int i = 0; i < kState; ++i) c[i] = gl::canon(w[i]);
      write_trace_slot(mine, c, out, warp_row, rows, r + 1);
    });
    return;
  }
  if (row >= rows) return;
  if constexpr (kMode == kPair) {
    load_words<kRate>(s, in + row * kRate);
#pragma unroll
    for (int i = kRate; i < kState; ++i) s[i] = 1;
  } else {
    load_words<kState>(s, in + row * kState);
  }
  permute(s, rc, lut);
  if constexpr (kMode == kPermute) {
    ulonglong2* dst = reinterpret_cast<ulonglong2*>(out + row * kState);
#pragma unroll
    for (int k = 0; k < kState / 2; ++k) {
      dst[k] = make_ulonglong2(s[2 * k], s[2 * k + 1]);
    }
  } else {
#pragma unroll
    for (int w = 0; w < kDigest; ++w) out[row * kDigest + w] = s[w];
  }
}

// K1's absorb mode (an overload of the kernel above, instantiated at
// kPermute only): row r's digest of the sponge over its `chunks` chunks of
// kRate words, row r starting at in + r * stride. The chunks go through a
// two-slot ring in shared memory, word-major ([slot][word][thread], so a
// warp's copies and reads fall in distinct banks): the copy of chunk c + 1
// is in flight while chunk c is permuted. A slot is written again only
// after the permutation that read it, which waits on those reads.
template <int kMode>
__global__ void __launch_bounds__(kAbsorbThreads, kAbsorbBlocksPerSm)
    tip5_permute_kernel(const uint64_t* __restrict__ in,
                        uint64_t* __restrict__ out, int64_t rows,
                        int64_t stride, int64_t chunks, const uint64_t* rc_g,
                        const uint8_t* lut_g) {
  static_assert(kMode == kPermute, "the absorb mode is K1's");
  __shared__ double2 rc[kRounds * kState];
  __shared__ uint8_t lut[256];
  __shared__ uint64_t ring[2][kRate][kAbsorbThreads];
  load_tables(rc, lut, rc_g, lut_g);
  __syncthreads();
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= rows) return;
  const int t = threadIdx.x;
  const uint64_t* src = in + row * stride;
  auto fetch = [&](int64_t c) {
#pragma unroll
    for (int i = 0; i < kRate; ++i) {
      gl::cp_async8(&ring[c & 1][i][t], src + c * kRate + i);
    }
  };
  uint64_t s[kState];
#pragma unroll
  for (int i = 0; i < kState; ++i) s[i] = 0;
  if (chunks > 0) fetch(0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#pragma unroll 1
  for (int64_t c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) fetch(c + 1);
    // every group but the newest (chunk c + 1's) has landed
    asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 1;\n" :::
                     "memory");
#pragma unroll
    for (int i = 0; i < kRate; ++i) s[i] = ring[c & 1][i][t];
    permute(s, rc, lut);
  }
#pragma unroll
  for (int w = 0; w < kDigest; ++w) out[row * kDigest + w] = s[w];
}

// s <- MDS(s) + rc across the lanes of a row (the lane mode): lane i's word
// is rc + sum_k col[k] * s[(i - k) mod 16], the word of lane (i - k) mod 16
// of its group read by a shuffle of width kLanes (col[k] is the same for
// every lane: an immediate). Exact on 32-bit halves in 64-bit integer
// sums, two chains a half: a half-sum is below 2^32 + 16 * 2^16 * 2^32 <
// 2^53, which combine takes.
__device__ __forceinline__ uint64_t mds_lanes(uint64_t s, int i, uint64_t rc) {
  uint64_t lo[2] = {lo32(rc), 0}, hi[2] = {hi32(rc), 0};
#pragma unroll
  for (int k = 0; k < kState; ++k) {
    const uint32_t c = static_cast<uint32_t>(mds_col(k));
    const int from = (i - k) & (kLanes - 1);
    const uint32_t l = k ? __shfl_sync(~0u, lo32(s), from, kLanes) : lo32(s);
    const uint32_t h = k ? __shfl_sync(~0u, hi32(s), from, kLanes) : hi32(s);
    lo[k & 1] += static_cast<uint64_t>(c) * l;
    hi[k & 1] += static_cast<uint64_t>(c) * h;
  }
  return combine(lo[0] + lo[1], hi[0] + hi[1]);
}

// K1's lane mode (a third overload, instantiated at kPermute only): the
// absorb mode's sponge with a row's state spread over kLanes lanes, lane i
// holding word i, two rows a warp; row r's digest from in + r * stride.
// Each round every lane runs both S-boxes and keeps its own (the byte
// lookup in lanes 0..3, fed zeros elsewhere so the other lanes' table
// reads are broadcasts; x^7 three products deep), so the two chains
// interleave in one instruction stream; then mds_lanes. Lanes 0..9 take
// the next chunk's word, loaded two chunks ahead into registers. The
// capacity stays lazy from one permutation to the next (every step takes
// any u64 residue); lanes 0..4 write the canonical digest. A group past the
// last row runs on zeros beside its neighbour and writes nothing: the
// shuffles take the whole warp. The rows are an int: the lane mode takes
// fewer rows than the card holds threads (ops/tip5_cuda.py).
template <int kMode>
__global__ void __launch_bounds__(kLaneThreads)
    tip5_permute_kernel(const uint64_t* __restrict__ in,
                        uint64_t* __restrict__ out, int rows, int64_t stride,
                        int64_t chunks, const uint64_t* rc_g,
                        const uint8_t* lut_g) {
  static_assert(kMode == kPermute, "the lane mode is K1's");
  __shared__ uint64_t rc[kRounds * kState];
  __shared__ uint8_t lut[256];
  load_tables(rc, lut, rc_g, lut_g, [](uint64_t c) { return c; });
  __syncthreads();
  const int i = threadIdx.x % kLanes;  // the lane's state word
  const int row = blockIdx.x * (kLaneThreads / kLanes) + threadIdx.x / kLanes;
  const bool reads = row < rows && i < kRate;
  const uint64_t* src = in + static_cast<int64_t>(row) * stride + i;
  auto fetch = [&](int64_t c) {
    return reads && c < chunks ? src[c * kRate] : 0;
  };
  uint64_t s = 0, next = fetch(0), after = fetch(1);
#pragma unroll 1
  for (int64_t c = 0; c < chunks; ++c) {
    if (i < kRate) s = next;
    next = after;
    after = fetch(c + 2);
#pragma unroll 1
    for (int r = 0; r < kRounds; ++r) {
      const uint64_t looked = sbox_lookup(i < kSbox ? s : 0, lut);
      const uint64_t powered = pow7_k9(s);
      s = mds_lanes(i < kSbox ? looked : powered, i, rc[r * kState + i]);
    }
  }
  if (row < rows && i < kDigest) {
    out[static_cast<int64_t>(row) * kDigest + i] = gl::canon(s);
  }
}

// K2's fused tail: a block of T threads reduces `levels` Merkle levels.
//   leaf mode: T leaf states (rows, 16) -> permute -> T digests -> `levels`
//              pair levels -> T >> levels digests;
//   pair mode: 2T digests (rows, 5) -> `levels` pair levels (the first
//              straight from global memory) -> 2T >> levels digests.
// Level by level the digests go through shared memory and the active
// threads halve.
__global__ void __launch_bounds__(kMaxThreads)
    merkle_commit_kernel(const uint64_t* __restrict__ in,
                         uint64_t* __restrict__ out, int leaf, int levels,
                         const uint64_t* rc_g, const uint8_t* lut_g) {
  __shared__ double2 rc[kRounds * kState];
  __shared__ uint8_t lut[256];
  __shared__ uint64_t dig[kMaxThreads * kDigest];
  load_tables(rc, lut, rc_g, lut_g);
  __syncthreads();
  const int t = threadIdx.x;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x + t;
  uint64_t s[kState];
  if (leaf) {
    load_words<kState>(s, in + row * kState);
  } else {
    load_words<kRate>(s, in + row * kRate);  // two adjacent digests
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
    const int64_t o = static_cast<int64_t>(blockIdx.x) * cnt + t;
#pragma unroll
    for (int w = 0; w < kDigest; ++w) out[o * kDigest + w] = s[w];
  }
}

template <int kMode>
int launch_rows(const void* in, void* out, long long rows, const void* rc,
                const void* lut, void* stream) {
  if (rows > 0) {
    const long long blocks = (rows + kRowThreads - 1) / kRowThreads;
    tip5_permute_kernel<kMode><<<static_cast<unsigned>(blocks), kRowThreads,
                                 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), rows,
        static_cast<const uint64_t*>(rc), static_cast<const uint8_t*>(lut));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tf_tip5_permute(const void* in, void* out, long long rows,
                               const void* rc, const void* lut,
                               void* stream) {
  return launch_rows<kPermute>(in, out, rows, rc, lut, stream);
}

// The sponge over `chunks` chunks of each row (K1's absorb mode): out
// (rows, 5) digests, row r of in at r * stride.
extern "C" int tf_tip5_absorb(const void* in, void* out, long long rows,
                              long long stride, long long chunks,
                              const void* rc, const void* lut, void* stream) {
  if (rows > 0) {
    const long long blocks = (rows + kAbsorbThreads - 1) / kAbsorbThreads;
    tip5_permute_kernel<kPermute>
        <<<static_cast<unsigned>(blocks), kAbsorbThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out),
            static_cast<int64_t>(rows), stride, chunks,
            static_cast<const uint64_t*>(rc), static_cast<const uint8_t*>(lut));
  }
  return static_cast<int>(cudaGetLastError());
}

// The same sponge in K1's lane mode (kLanes lanes a row); rows below 2^31.
extern "C" int tf_tip5_absorb_lanes(const void* in, void* out, long long rows,
                                    long long stride, long long chunks,
                                    const void* rc, const void* lut,
                                    void* stream) {
  if (rows > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    constexpr int kRowsPerBlock = kLaneThreads / kLanes;
    const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    tip5_permute_kernel<kPermute>
        <<<static_cast<unsigned>(blocks), kLaneThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out),
            static_cast<int>(rows), stride, chunks,
            static_cast<const uint64_t*>(rc), static_cast<const uint8_t*>(lut));
  }
  return static_cast<int>(cudaGetLastError());
}

// out: (rows, 6, 16), see tip5_permute_kernel's trace mode
extern "C" int tf_tip5_trace(const void* in, void* out, long long rows,
                             const void* rc, const void* lut, void* stream) {
  return launch_rows<kTrace>(in, out, rows, rc, lut, stream);
}

// One tree level at full width: `parents` digests out, from 2 * parents
// digests (pair mode) or from `parents` leaf states (leaf mode).
extern "C" int tf_merkle_level(const void* in, void* out, long long parents,
                               int leaf, const void* rc, const void* lut,
                               void* stream) {
  return leaf ? launch_rows<kLeaf>(in, out, parents, rc, lut, stream)
              : launch_rows<kPair>(in, out, parents, rc, lut, stream);
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

// The block size and resident blocks per SM of a kernel on the current
// device: 0 K1, 1 its trace mode, 2 the level kernel (all at their fixed
// block size), 3 the fused tail at `threads`, 4 K1's absorb mode, 5 its
// lane mode (each at its fixed block size).
extern "C" int tf_tip5_occupancy(int kernel, int threads, int* block,
                                 int* blocks_per_sm) {
  using Rows = void (*)(const uint64_t*, uint64_t*, int64_t, const uint64_t*,
                        const uint8_t*);
  using Absorb = void (*)(const uint64_t*, uint64_t*, int64_t, int64_t,
                          int64_t, const uint64_t*, const uint8_t*);
  using Lanes = void (*)(const uint64_t*, uint64_t*, int, int64_t, int64_t,
                         const uint64_t*, const uint8_t*);
  const void* fn = nullptr;
  int size = kRowThreads;
  switch (kernel) {
    case 0:
      fn = reinterpret_cast<const void*>(
          static_cast<Rows>(tip5_permute_kernel<kPermute>));
      break;
    case 1:
      fn = reinterpret_cast<const void*>(
          static_cast<Rows>(tip5_permute_kernel<kTrace>));
      break;
    case 2:
      fn = reinterpret_cast<const void*>(
          static_cast<Rows>(tip5_permute_kernel<kPair>));
      break;
    case 3:
      fn = reinterpret_cast<const void*>(merkle_commit_kernel);
      size = threads;
      break;
    case 4:
      fn = reinterpret_cast<const void*>(
          static_cast<Absorb>(tip5_permute_kernel<kPermute>));
      size = kAbsorbThreads;
      break;
    case 5:
      fn = reinterpret_cast<const void*>(
          static_cast<Lanes>(tip5_permute_kernel<kPermute>));
      size = kLaneThreads;
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  *block = size;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, size, 0));
}

extern "C" const char* tf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
