// K9: the Tip5 permutation with its MDS layer on the integer tensor cores.
//
// Replaces twenty_first_tpu/ops/tip5_mxu.py: _mds_mxu (:96) inside
// permutation_dense (:143), plain jnp whose matrix products XLA puts on the
// TPU's MXU (no Pallas kernel). The idea is that module's: the 16x16 MDS
// circulant as exact integer matrix products of bytes. Each state word is
// split into its 8 byte planes and each 16-bit circulant entry into a low
// and a high byte (C0, C1). The word sum out[i] = sum_j col[(i - j) mod 16]
// x[j] is then sum_s 2^(8s) S[s] over the shifts s = 0..8, with
// S[s] = plane_s C0 + plane_(s-1) C1: at most 2 * 16 * 255 * 255 < 2^21,
// exact in the s32 accumulators whatever u64 the words hold (lazy
// residues included).
//
// On Hopper each S[s] is one u8 x u8 -> s32 mma.sync.m16n8k32 per 8
// output words: a warp hashes 16 states, the A tile (16 x 32) holds byte
// planes s - 1 and s of their 16 words, and the one constant B (32 x 16)
// is [C1; C0]. That is 9 shifts x 2 n-tiles = 18 mma per 16 states a
// round; B's four fragment registers are the same for every shift and
// round and stay in registers.
//
// What bounds it on this card: instruction issue, as for K1 (csrc/tip5.cu).
// The tensor cores take K1's 512 double FMAs a permutation-round off the
// FP64 pipe; the S-box (byte lookups, x^7 on the IMAD pipe) is K1's.
//
// No data moves between threads. Thread (g, t) of a warp (g = lane / 4,
// t = lane % 4) holds words t, t + 4, t + 8, t + 12 (its slots 0..3) of
// the warp's states g and g + 8. Matching the columns of A and of D to
// those words makes the fragment layouts of the mma (PTX ISA, "matrix
// fragments for mma.m16n8k32") line up with what each thread holds:
//   * A's row g, columns 4t..4t+3 (and 16 + 4t..) are the thread's slots 0..3
//     of state g, so column 4t + j of a plane is word t + 4j;
//   * D's row g, columns 2t and 2t + 1 of n-tile n are the thread's slots
//     2n and 2n + 1, so column c of n-tile n is word (c >> 1) + 4 (2n +
//     (c & 1)).
// B's entries follow from those two maps. Slot 0 is a word below 4 in every
// thread, so every thread does one byte lookup and three x^7 a state, with
// no divergence. A byte plane of four words is one 4x4 byte transpose
// (eight byte permutes). The shift sums regroup as _mds_mxu's do (:112-126):
// byte pairs into 16-bit groups, then two 64-bit words with the round
// constant's halves added, which K1's combine folds into a lazy residue.
#include "tip5_body.cuh"

namespace {

constexpr int kWarpStates = 16;  // states a warp hashes
constexpr int kThreads = 128;    // 4 warps, 64 states a block
constexpr int kShifts = 9;       // byte shifts of a product of 8 x 2 bytes

// SHA-256("Tip5") as little-endian 16-bit chunks (tip5/constants.py)
__constant__ uint16_t kMdsColumn[kState] = {
    61402, 1108,  28750, 33823, 7454,  43244, 53865, 12034,
    56951, 27521, 41351, 40901, 12021, 59689, 26798, 17845};

// B's fragment register for rows 4t..4t+3 of byte block e (0 the low
// bytes, 1 the high) and column g of n-tile n: the entries C_e[in][out] =
// byte e of col[(out - in) mod 16], in = t + 4j the word of row 4t + j,
// out = the word of that column.
__device__ __forceinline__ uint32_t b_fragment(int e, int g, int t, int n) {
  const int out = (g >> 1) + 4 * (2 * n + (g & 1));
  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t c = kMdsColumn[(out - t - 4 * j) & 15];
    r |= ((e ? c >> 8 : c) & 0xFF) << (8 * j);
  }
  return r;
}

// bytes k of w[0..3] for k = 0..3 (a 4x4 byte transpose): p[k] byte j is
// byte k of w[j]
__device__ __forceinline__ void byte_planes(const uint32_t w[4],
                                            uint32_t p[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  p[0] = __byte_perm(t0, t2, 0x5410);
  p[1] = __byte_perm(t0, t2, 0x7632);
  p[2] = __byte_perm(t1, t3, 0x5410);
  p[3] = __byte_perm(t1, t3, 0x7632);
}

// d = A B, A 16 x 32 and B 32 x 8 of u8, d 16 x 8 of s32
__device__ __forceinline__ void mma_u8(uint32_t d[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0));
}

// s[q][j] <- MDS(s)[q][j] + rc, q the state (g, g + 8), j the slot, the
// round's constants as (low, high) halves by word. b[n] are B's fragments
// of n-tile n: rows 0..15 (plane s - 1) C1, rows 16..31 (plane s) C0.
__device__ __forceinline__ void mds_mma(uint64_t s[2][4], const uint2* rc,
                                        const uint32_t b[2][2], int t) {
  uint32_t plane[8][2];  // byte plane k of state q's four words
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    uint32_t lo[4], hi[4], p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo[j] = lo32(s[q][j]);
      hi[j] = hi32(s[q][j]);
    }
    byte_planes(lo, p);
#pragma unroll
    for (int k = 0; k < 4; ++k) plane[k][q] = p[k];
    byte_planes(hi, p);
#pragma unroll
    for (int k = 0; k < 4; ++k) plane[4 + k][q] = p[k];
  }
  // h[u] = S[2u] + 2^8 S[2u + 1] (below 2^30; h[4] = S[8]), by state and
  // slot, as _mds_mxu groups the shifts
  uint32_t h[5][2][4];
#pragma unroll
  for (int sh = 0; sh < kShifts; ++sh) {
    const uint32_t a[4] = {sh > 0 ? plane[sh - 1][0] : 0u,
                           sh > 0 ? plane[sh - 1][1] : 0u,
                           sh < 8 ? plane[sh][0] : 0u,
                           sh < 8 ? plane[sh][1] : 0u};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t d[4];
      mma_u8(d, a, b[n][0], b[n][1]);
      // d[0], d[1]: state g, slots 2n, 2n + 1; d[2], d[3]: state g + 8
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t& dst = h[sh >> 1][i >> 1][2 * n + (i & 1)];
        dst = (sh & 1) ? dst + (d[i] << 8) : d[i];
      }
    }
  }
  // the value plus the round constant is lo + hi 2^32 with lo = h0 +
  // 2^16 h1 + rc_lo < 2^47 and hi = h2 + 2^16 h3 + 2^32 h4 + rc_hi < 2^54
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint2 c = rc[t + 4 * j];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint64_t lo =
          static_cast<uint64_t>(h[1][q][j]) * 65536u + c.x + h[0][q][j];
      const uint64_t hi =
          static_cast<uint64_t>(h[3][q][j]) * 65536u + c.y + h[2][q][j] +
          (static_cast<uint64_t>(h[4][q][j]) << 32);
      s[q][j] = combine(lo, hi);
    }
  }
}

// Each warp permutes 16 consecutive rows of (rows, 16) states; rows past
// the end are zeros that are permuted and not written.
__global__ void __launch_bounds__(kThreads)
    tip5_permute_mma_kernel(const uint64_t* __restrict__ in,
                            uint64_t* __restrict__ out, int64_t rows,
                            const uint64_t* rc_g, const uint8_t* lut_g) {
  __shared__ uint2 rc[kRounds * kState];
  __shared__ uint8_t lut[256];
  load_tables(rc, lut, rc_g, lut_g,
              [](uint64_t c) { return make_uint2(lo32(c), hi32(c)); });
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint32_t b[2][2];
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    b[n][0] = b_fragment(1, g, t, n);
    b[n][1] = b_fragment(0, g, t, n);
  }
  __syncthreads();
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kThreads + (threadIdx.x & ~31)) /
      32 * kWarpStates;
  int64_t row[2];
  uint64_t s[2][4];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    row[q] = base + g + 8 * q;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[q][j] = row[q] < rows ? in[row[q] * kState + t + 4 * j] : 0;
    }
  }
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      s[q][0] = sbox_lookup(s[q][0], lut);  // word t < kSbox
#pragma unroll
      for (int j = 1; j < 4; ++j) s[q][j] = pow7(s[q][j]);
    }
    mds_mma(s, rc + r * kState, b, t);
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    canon_words<4>(s[q]);
    if (row[q] < rows) {
#pragma unroll
      for (int j = 0; j < 4; ++j) out[row[q] * kState + t + 4 * j] = s[q][j];
    }
  }
}

static_assert(kSbox == 4, "slot 0 of every thread is the lookup word");

}  // namespace

extern "C" int tf_tip5_permute_mma(const void* in, void* out, long long rows,
                                   const void* rc, const void* lut,
                                   void* stream) {
  if (rows > 0) {
    const long long warps = (rows + kWarpStates - 1) / kWarpStates;
    const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
    tip5_permute_mma_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(in), static_cast<uint64_t*>(out), rows,
        static_cast<const uint64_t*>(rc), static_cast<const uint8_t*>(lut));
  }
  return static_cast<int>(cudaGetLastError());
}

// K9's block size and resident blocks per SM on the current device
extern "C" int tf_tip5_mma_occupancy(int* block, int* blocks_per_sm) {
  *block = kThreads;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, reinterpret_cast<const void*>(tip5_permute_mma_kernel),
      kThreads, 0));
}
