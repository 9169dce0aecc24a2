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
//
// Two order modes (ntt_pass.cuh, built in ntt_order.cu) read the column in
// bit-reversed row order or write it so, for the scrambled four-step
// transforms of math/ntt.py; they take no second diagonal.
#include "ntt_pass.cuh"

namespace {

// A launch's shape: elements a thread (2^log_r), columns a tile (2^log_tc,
// narrowed to at most kMaxThreads threads), the row swizzle, threads and
// dynamic shared memory.
struct Plan {
  int log_r, log_tc, swz_shift, swz_mask, threads;
  size_t smem;
  const void* kernel;
};

Plan plan(int log_t, int log_tc, bool diag2, int order) {
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
  pl.kernel = order != kNatural ? k3::order_kernel(pl.log_r, order)
              : diag2           ? kernel_for<true, kNatural>(pl.log_r)
                                : kernel_for<false, kNatural>(pl.log_r);
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
    long long diag2_c, unsigned long long scale, int order, void* stream) {
  if (log_t < 1 || log_t > 12 || log_tc < 0 || nbatch < 1 || nbatch > 65535 ||
      order < kNatural || order > kRevOut ||
      (order != kNatural && diag2 != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan pl = plan(log_t, log_tc, diag2 != nullptr, order);
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
  const Plan pl = plan(log_t, log_tc, false, kNatural);
  const cudaError_t err = prepare(pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  *block = pl.threads;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, pl.kernel, pl.threads, pl.smem));
}
