// K9: the Tip5 permutation with its MDS layer on the integer tensor cores.
//
// Replaces twenty_first_tpu/ops/tip5_mxu.py: _mds_mxu (:96) inside
// permutation_dense (:143), plain jnp whose matrix products XLA puts on the
// TPU's MXU (no Pallas kernel). The idea is that module's: the 16x16 MDS
// circulant as exact integer matrix products of bytes. Each state word is
// split into its 8 byte planes P[k] and each 16-bit circulant entry into a
// low and a high byte (C0, C1). The word sum out[i] = sum_j col[(i - j) mod
// 16] x[j] is then sum_s 2^(8s) S[s] over the shifts s = 0..8, with
// S[s] = P[s] C0 + P[s - 1] C1: at most 2 * 16 * 255 * 255 < 2^21, exact in
// the s32 accumulators whatever u64 the words hold (lazy residues included).
//
// Layout. A warp hashes 32 states as two m tiles of 16 (states 0..15 and
// 16..31) that share B's fragments. Thread (g, t) of a warp (g = lane / 4,
// t = lane % 4) holds words t, t + 4, t + 8, t + 12 (its slots 0..3) of the
// warp's states g + 8q, q = 0..3 (tile q / 2), and no data moves between
// threads: matching the columns of A and of D to those words makes the
// fragment layouts of the mma (PTX ISA, "matrix fragments for
// mma.m16n8k16 / m16n8k32") line up with what each thread holds; in tile
// m, row g is state 16m + g and row g + 8 state 16m + g + 8:
//   * A's row g, columns 4t..4t+3 of a 16-column block are the thread's
//     slots 0..3 of state g, so column 4t + j of a plane is word t + 4j;
//   * D's row g, columns 2t and 2t + 1 of n-tile n are the thread's slots
//     2n and 2n + 1, so column c of n-tile n is word (c >> 1) + 4 (2n +
//     (c & 1)).
// B's entries follow from those two maps (b_fragment). Slot 0 is a word
// below 4 in every thread, so every thread does one byte lookup and three
// x^7 a state, with no divergence; the lookup takes each byte out with one
// byte permute. A byte plane of four words is one 4x4 byte transpose
// (eight byte permutes).
//
// The MDS, 24 mma a round for a tile of 16 states. The planes are taken
// in pairs: A_u = [P[2u]; P[2u + 1]] is one aligned register quad, built
// by the byte permutes where it is used, and its halves are the operands
// of the k16 products. Odd shift 2u + 1 is one m16n8k32 with
// B = [C1; C0]; even shift 2u is two chained m16n8k16, P[2u - 1] C1 then
// P[2u] C0, whose first accumulator holds 16-bit piece u of the round
// constant (shift 8 is one k16); per n-tile 4 k32 and 8 k16. Then
// h_u = S[2u] + 2^8 S[2u + 1] and regroup folds h_0..h_3 and S[8] into a
// lazy residue in 32-bit carry chains.
//
// What bounds it on this card: issue and latency, with no pipe full. The
// first K9 (a sliding A window of nine k32 a n-tile, a 64-bit regroup, x^7
// by four general products) issued 9,910 SASS a permutation (a thread's
// share, K1's unit), 5,030 of them on the IMAD pipe, 1,550 of those moves,
// and ran level with K1. Measured one change at a time against K1
// (PERF.md, "exploration"): the squarings as squarings, x^3 and x^4 side
// by side (x^7 three products deep) and the products as four wide
// multiplies with one fix-up took the most; the paired A quads and the
// 32-bit regroup took the window's moves. The issue rate stayed near 0.6
// warp instructions a clock: more warps (40, 48), a bank-conflict-free
// byte table and unrolled rounds did not raise it, the two half-rate
// integer pipes are each about 60% busy, and a build with 3% fewer
// instructions but longer carry chains ran 4% slower. Issue and the carry
// chains' latency bound it together; the time mostly follows the
// instruction count. Two tiles a warp (B's fragments and the constants'
// loads shared; 106 registers, 16 warps an SM) with the lookup's bytes
// taken out by one byte permute each ran about 1.4% below one tile at
// 2^22 and 2^16; neither change alone did at 2^22. The x^7 changes carry
// over to K1 and K2, which run the same S-box.
#include "tip5_body.cuh"

namespace {

constexpr int kTiles = 2;                 // m tiles of 16 states a warp
constexpr int kWarpStates = 16 * kTiles;  // states a warp hashes
constexpr int kThreads = 128;             // 4 warps, 128 states a block
// the round constants as the even shifts' accumulators: quad (u, n) of
// thread t holds 16-bit piece u of the constants of D's cells (words t + 8n
// and t + 8n + 4, rows g and g + 8), 4 pieces x 2 n-tiles x 4 threads
constexpr int kRcQuads = 4 * 2 * 4;

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
__device__ __forceinline__ void mma_k32(uint32_t d[4], const uint32_t a[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0));
}

// d = A B + c, A 16 x 16 and B 16 x 8 of u8, d and c 16 x 8 of s32
__device__ __forceinline__ void mma_k16(uint32_t d[4], uint32_t a0,
                                        uint32_t a1, uint32_t b,
                                        const uint32_t c[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %8, %9, %10};"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "r"(c[0]), "r"(c[1]), "r"(c[2]),
        "r"(c[3]));
}

// The byte lookup on the canonical Montgomery form of x (tip5_body.cuh's
// sbox_lookup, K1's), each byte taken out by one byte permute instead of a
// shift and a mask.
__device__ __forceinline__ uint64_t sbox_lookup_k9(uint64_t x,
                                                   const uint8_t* lut) {
  const uint64_t m = to_montgomery(x);
  uint32_t o0 = 0, o1 = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // byte k, zero-extended
    o0 |= static_cast<uint32_t>(lut[__byte_perm(lo32(m), 0, 0x4440 + k)])
          << (8 * k);
    o1 |= static_cast<uint32_t>(lut[__byte_perm(hi32(m), 0, 0x4440 + k)])
          << (8 * k);
  }
  return from_montgomery(join(o0, o1));
}

// h0 + 2^16 h1 + 2^32 h2 + 2^48 h3 + 2^64 s8 as a lazy residue, for h_u
// below 2^30 and s8 below 2^21: v = (v2, v1, v0) by two carries (v1 takes
// h2 and h1's top with no carry out, below 2^31; v2 = s8 + h3's top + a
// carry, below 2^21), then (v1, v0) + m with m = v2 2^32 - v2 < 2^53, whose
// one wrap adds 2^32 - 1 and cannot wrap again.
__device__ __forceinline__ uint64_t regroup(uint32_t h0, uint32_t h1,
                                            uint32_t h2, uint32_t h3,
                                            uint32_t s8) {
  uint32_t r0, r1;
  asm("{\n\t.reg .u32 a, b, v0, v1, v2, m0, m1, k;\n\t"
      "shl.b32 a, %3, 16;\n\t"
      "shr.u32 b, %3, 16;\n\t"
      "add.cc.u32 v0, %2, a;\n\t"  // h0 + 2^16 h1
      "addc.u32 v1, %4, b;\n\t"
      "shl.b32 a, %5, 16;\n\t"
      "shr.u32 b, %5, 16;\n\t"
      "add.cc.u32 v1, v1, a;\n\t"  // + 2^48 h3
      "addc.u32 v2, %6, b;\n\t"
      "sub.cc.u32 m0, 0, v2;\n\t"  // m = v2 2^32 - v2
      "subc.u32 m1, v2, 0;\n\t"
      "add.cc.u32 v0, v0, m0;\n\t"
      "addc.cc.u32 v1, v1, m1;\n\t"
      "addc.u32 k, 0, 0;\n\t"
      "neg.s32 k, k;\n\t"  // 2^32 - 1 on a wrap, else 0
      "add.cc.u32 %0, v0, k;\n\t"
      "addc.u32 %1, v1, 0;\n\t}"
      : "=r"(r0), "=r"(r1)
      : "r"(h0), "r"(h1), "r"(h2), "r"(h3), "r"(s8));
  return join(r0, r1);
}

// s[q][j] <- MDS(s)[q][j] + rc, q the tile's state (g, g + 8), j the slot; rcq
// this round's accumulator quads for thread t, b[n] = {C1, C0} fragments of
// n-tile n. Exact for s of any u64: h_u = S[2u] (+ a 16-bit piece) + 2^8
// S[2u + 1] < 2^22 + 2^29 < 2^30, S[8] = P[7] C1 < 2^20.
__device__ __forceinline__ void mds_mma(uint64_t s[2][4], const uint4* rcq,
                                        const uint32_t b[2][2]) {
  // a[u] = {P[2u] row g, P[2u] row g + 8, P[2u + 1] row g, P[2u + 1] row
  // g + 8}: planes 0..3 from the low halves, 4..7 from the high
  uint32_t a[4][4];
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
    for (int k = 0; k < 4; ++k) a[k >> 1][2 * (k & 1) + q] = p[k];
    byte_planes(hi, p);
#pragma unroll
    for (int k = 0; k < 4; ++k) a[2 + (k >> 1)][2 * (k & 1) + q] = p[k];
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const uint32_t c1 = b[n][0], c0 = b[n][1];
    uint32_t h[4][4], e[4], o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint4 piece = rcq[4 * (2 * u + n)];
      const uint32_t acc[4] = {piece.x, piece.y, piece.z, piece.w};
      if (u == 0) {
        mma_k16(e, a[0][0], a[0][1], c0, acc);
      } else {
        mma_k16(e, a[u - 1][2], a[u - 1][3], c1, acc);
        mma_k16(e, a[u][0], a[u][1], c0, e);
      }
      mma_k32(o, a[u], c1, c0);
      // d[0], d[1]: state g, slots 2n, 2n + 1; d[2], d[3]: state g + 8
#pragma unroll
      for (int i = 0; i < 4; ++i) h[u][i] = e[i] + (o[i] << 8);
    }
    const uint32_t zero[4] = {0, 0, 0, 0};
    mma_k16(e, a[3][2], a[3][3], c1, zero);  // S[8]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i >> 1][2 * n + (i & 1)] =
          regroup(h[0][i], h[1][i], h[2][i], h[3][i], e[i]);
    }
  }
}

// Each warp permutes 32 consecutive rows of (rows, 16) states; rows past
// the end are zeros that are permuted and not written.
__global__ void __launch_bounds__(kThreads)
    tip5_permute_mma_kernel(const uint64_t* __restrict__ in,
                            uint64_t* __restrict__ out, int64_t rows,
                            const uint64_t* rc_g, const uint8_t* lut_g) {
  __shared__ uint4 rcq[kRounds * kRcQuads];
  __shared__ uint8_t lut[256];
  for (int i = threadIdx.x; i < kRounds * kRcQuads; i += blockDim.x) {
    // i = 32 r + 8 u + 4 n + t
    const int t = i & 3, n = (i >> 2) & 1, u = (i >> 3) & 3, r = i >> 5;
    const uint64_t* c = rc_g + r * kState + t + 8 * n;
    const uint32_t x = (c[0] >> (16 * u)) & 0xFFFF;
    const uint32_t y = (c[4] >> (16 * u)) & 0xFFFF;
    rcq[i] = make_uint4(x, y, x, y);
  }
  for (int i = threadIdx.x; i < 256; i += blockDim.x) lut[i] = lut_g[i];
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
  int64_t row[2 * kTiles];
  uint64_t s[2 * kTiles][4];
#pragma unroll
  for (int q = 0; q < 2 * kTiles; ++q) {
    row[q] = base + g + 8 * q;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[q][j] = row[q] < rows ? in[row[q] * kState + t + 4 * j] : 0;
    }
  }
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
#pragma unroll
    for (int q = 0; q < 2 * kTiles; ++q) {
      s[q][0] = sbox_lookup_k9(s[q][0], lut);  // word t < kSbox
#pragma unroll
      for (int j = 1; j < 4; ++j) s[q][j] = pow7_k9(s[q][j]);
    }
#pragma unroll
    for (int m = 0; m < kTiles; ++m) {
      mds_mma(s + 2 * m, rcq + r * kRcQuads + t, b);
    }
  }
#pragma unroll
  for (int q = 0; q < 2 * kTiles; ++q) {
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
