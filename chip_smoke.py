#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (twenty_first_tpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the hand-written kernels from twenty_first_tpu_torch/csrc with
nvcc, holds each against its plain PyTorch twin on the card (exact
equality: this is integer field arithmetic), reproduces values pinned from
the JAX reference, and drives twelve paths, each with every launch counter
set to 0 just before it and read just after:

* the flagship step (W = 8 trace columns, n = 2^20, expansion 4: a
  2^22-row LDE + Tip5 Merkle commit) and the entry point (K1, K3 and K2's
  two launches: the full-width level and the fused tail);
* the authenticated-structures path (util_types/merkle_tree.py and
  util_types/mmr/): a MerkleTree over the flagship step's 2^22 leaf
  digests (every level a K2 launch written into the node tensor), its
  frugal root, 160 openings verified (and one tampered, refused), the
  authentication structure from the leafs alone, the MMR over 3 * 2^21 - 1
  leafs with a successor proof of 2^16 more (and over 300 leafs, below the
  parallelization cutoff, still on the card), and Tip5.hash_varlen_batch
  (K3 and K1 for the leaf digests, K2's two launches, K1);
* the standalone Tip5 batch path: permutation_batch at 2^16 and 2^22
  states, the T4/T5 entry points, trace, hash_varlen and
  hash_varlen_ragged (K1 and its trace and absorb modes); K1's absorb
  mode at the table commit's (2^17, 16,390), a thread a row, and at the
  opening's (80, 16,390), in its lane mode, each against its plain twin,
  and the absorb mode's two designs timed side by side across row counts;
* the tensor-core Tip5 and the packed commit's entry points
  (ops/tip5_mxu.py, ops/tip5_packed.py): K9, the permutation with its MDS
  as u8 mma on the integer tensor cores, against its twin and K1 at 2^16
  and 2^22 states and at 2^16 + 9; permutation on the 2^22 states' limb
  planes, permutation_dense on their lane-dense planes,
  permutation_values, commit_states_packed over the step's 2^22 leaf
  states (SLICE_ROOT) and reduce_layers_packed over 2^20 digests against
  K2's reduce_layers (K9 and K2's two launches); K1 and K9 timed in turns;
* the polynomial batch path (math/poly_batch.py, the NTT-domain
  convolutions and gf_ext's batch inversion) at full width: the
  out-of-domain extrapolations of bench.py's shape and of the flagship
  trace's width and length, the barycentric evaluation, the coset LDE and
  its inverse, batch products, convolutions at 2^22 and 2^20 (K3, K6, K7
  and K8);
* the polynomial engine (math/polynomial.py) through its object API at
  the shapes of bench.py:584-706 and the flagship step's prover width
  (products at degree 2^14 - 1 and 2^20 - 1, the coset evaluation of
  2^20 coefficients on 2^22 points and back, clean divisions, a zerofier,
  multipoint evaluation and interpolation at 2^14 and 2^15 points, modular
  coset interpolation, the 2^18 -> 2^10 and 8 x 2^20 -> 16 xfe
  extrapolations, reduction, a power-series inverse, the barycentric
  evaluation of 2^22 values) on its default routes, with the native host
  core loaded: K3, K6, K7 and K8 above the host/device crossovers. Every
  result equals the same call on the host alone and passes an independent
  check; PINNED_POLYNOMIAL reproduces with every crossover at 0; a sweep
  times the host against the card for one-shot transforms,
  convolutions, batched row products and batch inversions, beside the
  crossovers chosen;
* the host layers (the native host core must be loaded): Tip5.hash_batch
  of 2^12 objects whose BFieldCodec encodings take every codec type (K1),
  each equal to the scalar Tip5.hash and a sample to its pure-Python
  oracle; MerkleTree.new over host leafs above HOST_MERKLE_MAX_LEAFS (K2)
  and at it (the host route, no K2), roots equal to the native core's;
  verify of 160 openings timed; the lattice KEM's round trip and its
  refusal of a tampered ciphertext; InverseTip5 undoing K1 on a batch;
  the Merkle crossover sweep, host against card at 2^1..2^22 leafs;
* NTT lengths from 2^25, three passes of K3 a transform: ntt and intt at
  2^25 and 2^28 equal to the plain twins on the card element by element,
  device times and peak memory at 2^25, 2^28 and 2^30, then the largest
  length that fits the card beside its output (2^32 the target): a delta's
  transform (X[k + 1] = X[k] w), the round trip, and four outputs of
  random input evaluated directly;
* the distributed layer (parallel/) at world 1 over NCCL in this process:
  the LDE commit of 2^24 coefficients (the distributed NTT in its Z layout,
  each row X[k2::n2] hashed by the sponge, the Merkle root over the mesh)
  and the root of the flagship step's 2^22 leaf digests (K3, K1, K2's two
  launches), each against the single-device path; the distributed NTT at
  2^24 both ways, in both layouts, with one and four all-to-alls, and at
  2^26 (columns and rows in two K3 passes each) against ntt(); the xfe
  NTT at 2^22; the MMR over 3 * 2^21 - 1 leafs with a batch append of
  2^16; dryrun_multichip(1); PINNED_DIST; then four gloo ranks sharing the
  card (spawned, the kernels built first) and, with two cards or more,
  NCCL with a card a rank, each value equal to world 1's;
* the scrambled route of the flagship step (parallel/pipeline.py's
  trace_lde_commit_scrambled at W = 8, n = 2^20, expansion 4: the DIF
  iNTT and the no-reverse NTT on K3's order modes, K1, K2's two launches):
  K3's rev_in and rev_out at every length and at the route's four pass
  shapes against the twin, four_step_ntt_scrambled at 2^24 both ways and
  the (13, 11) split (two K3 passes a factor) against ntt(), the root
  equal to SLICE_ROOT and the leaf digests to the natural step's, both
  routes timed in turns (host medians, device ms, peak memory, profiles);
* the NTT pass probe over 2^24 elements (K3 and K4);
* the ALU probe, chains of lazy field ops (K5) in both forms.

It prints one JSON line per phase. The last lines are the card's name and
power limit (as nvidia-smi reports them), the per-kernel JSON line (for
the Tip5 kernels with their SASS instructions per permutation, registers,
resident warps and issue-bound time; K2's row is the whole 2^22-leaf
tree, launch by launch; K3's with its registers, spills, resident warps at
the step's pass shape and SASS per butterfly), and the device line. K3's
phase also holds in-place passes, inputs full of edge words and
ntt(post=, out=) at the step's two sizes against the twins; the step's
profile splits the glue (every kernel not of csrc/) by kernel name. The
Merkle tree's root equals the step's (SLICE_ROOT), its nodes and the
MMR's peaks equal the plain twins' on the card; the tree is timed whole,
at 2 and 2^10 leaves, and level by level below the resident-thread width
beside K2's fused tail. The polynomial batch path's outputs equal its plain twins' on the card and
PINNED_EXTRAPOLATE reproduces through the kernels; K7 is timed launch by
launch at the path's two shapes. Any failure raises: a
non-zero exit and no device line.
It needs a CUDA device and refuses to run without one.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
P = 0xFFFF_FFFF_0000_0001

# trace_lde_commit roots of the JAX reference for
# np.random.default_rng(0).integers(0, P, size=(8, n), dtype=np.uint64),
# expansion 4 (tests/test_torch_pipeline.py re-derives them).
PINNED_ROOTS = {
    1 << 6: [7212400738294442629, 4786144134398700650, 11416967223783225047,
             9494336110101299495, 13113325513619585193],
    1 << 10: [8422239226348898290, 10027258591245203499, 3115357317289785295,
              7829678549101749663, 13746998341487405660],
}
# the JAX reference's root for __graft_entry__.entry() (tests/test_torch_entry.py)
ENTRY_ROOT = [13477972335611674128, 8311010285982245351, 480628304788764524,
              17490066220839094773, 14904063755748097382]
# Tip5 reference snapshot on raw Montgomery words (tests/test_tip5.py)
RAW_SNAPSHOT_IN = [
    0x0000_000F_FFFF_FFF0, 0x0000_0000_FFFF_FFFF, 0x0000_0000_FFFF_FFFF,
    0x0000_0028_FFFF_FFD7, 0x0000_0006_FFFF_FFF9, 0x0000_0002_FFFF_FFFD,
    0x0000_0000_FFFF_FFFF, 0x0000_0030_FFFF_FFCF, 0x0000_0397_FFFF_FC68,
    0x0000_000F_FFFF_FFF0, 0x316B_FB72_3638_2123, 0x216F_521B_66EF_83F5,
    0x5689_D7B3_63F5_2DF0, 0xEB2F_59E3_AEAE_25FC, 0xB082_99D2_77CB_B4DC,
    0xCBE3_D9FD_C534_9140,
]
RAW_SNAPSHOT_OUT5 = [
    0x15D3_8EA9_29F6_632A, 0xF988_E509_FF73_8BB4, 0x48BC_DFAE_88A2_E9F3,
    0x8733_9E83_2DAA_C02A, 0x511E_4126_8150_FDAC,
]
R = (1 << 64) % P
R_INV = pow(1 << 64, -1, P)
# JAX's Tip5 trace of the state (0, 1, ..., 15): words 0 and 15 of the input
# and of the state after each round (tests/test_torch_tip5_batch.py)
PINNED_TRACE = [
    [0, 15], [13630782508720194763, 15551061978796482092],
    [5525363112442782795, 17108779980408342790],
    [6286105364352512153, 6814426455101604673],
    [7125984701079541885, 11053828540506304354],
    [14273019456630489802, 5428520427373770602]]
# JAX's hash_varlen of varlen_input(length), the lengths of benches/tip5.rs
PINNED_VARLEN = {
    10: [17699434666236764568, 3320238358685627466, 14670388502778114617,
         15124640580562242493, 13459616508061126303],
    16384: [16886452508315667902, 83234472127536013, 9722233246858496946,
            1244537966940540853, 6289475567411222966],
}
# JAX's hash_varlen_ragged of ragged_inputs(), lengths RAGGED_LENGTHS
RAGGED_LENGTHS = (0, 1, 9, 10, 11, 64)
PINNED_RAGGED = [
    [2335476311349343808, 1307299401243390569, 3414029282375928929,
     2141465175172981451, 5966553798353564426],
    [1271158654570114825, 14149102500606193769, 8645048344152756594,
     5729092036765501860, 14171540440692055883],
    [4312793584973550932, 17259037804405352560, 15939896489245361072,
     1015976036173949869, 5341676919131561678],
    [16899413808137251125, 15770539295182800696, 7436705098154965815,
     13581316892468170652, 4404376532229351393],
    [6446733802932522032, 13514753739473363842, 17820163941778736187,
     13809903202627133257, 9939067491374485512],
    [10049464000794506436, 4226005468297386872, 7252665957299743622,
     4543393266712637337, 4346269982479654721],
]

# JAX's batch_coset_extrapolate(_xfe) (use_jit=False) of
# extrapolate_pin_inputs(), offset 7: the first three output words and the
# sha256 of the whole (rows, m) or (rows, m, 3) uint64 output, little-endian
# (tests/test_torch_poly_batch.py re-derives them)
PINNED_EXTRAPOLATE = {
    "base": ([7075090509476388138, 6128495499364521025,
              17596945393161823063],
             "1f9d2267d9d855ec795683f4099344528bea7ce943bcaece2a9f1204dc491853"),
    "xfe_base": ([1988269808576906717, 10830131173574133256,
                  4521848385401232373],
                 "1ecf2e12e835c5dd97eee5b30068ca12d5ee622e45cb8a48b59dbcd99efa7108"),
    "xfe_xfe": ([17098981790229392072, 352494565560432591,
                 8371356374153446334],
                "f39512bc7e41defb5c34e44976950a05ab02253aaaa266aac49a4bd3e3047fe7"),
}

# sha256 of polynomial_pin_results() through the JAX package (tests/
# test_torch_polynomial.py re-derives it there); the polynomial phase
# reproduces it with every crossover forced to 0, all on the card
PINNED_POLYNOMIAL = "230028674833d521f57b6ce01e256d8036ca8239b8fc7d3a28b6f40bdedf853e"

# the flagship step's root over the (W, N) trace of default_rng(2026): the
# value every chip run of the port has reproduced since the first
SLICE_ROOT = [1120500583678470414, 2451579851260808278, 5164740433303553855,
              17133648008207886942, 15214632637220730653]
# the main path's full width: W trace columns of length N, expansion E
W, N, E = 8, 1 << 20, 4
# the Tip5 batch path: permutation_batch at the reference's hash_parallel
# size (benches/tip5.rs) and at the main path's leaf count; the T4/T5 entry
# points at bench.py's smoke shape; trace; a ragged batch of mixed lengths
BATCH_STATES = (1 << 16, N * E)
T45_STATES = 4096
TRACE_STATES = 1 << 16
MIXED_INPUTS, MIXED_MAX_LENGTH = 256, 120
# K1's absorb mode at the table commit's shape (port_bench's
# table_commit.r17_l16384): 2^17 rows of 16,384 words, padded to 16,390
ABSORB_SHAPE = (1 << 17, 16390)
ABSORB_SEED = 20
# its lane mode at the opening's shape (port_bench's
# table_open.r17_l16384_q80 verifies ~80 revealed rows of that width)
LANE_SHAPE = (80, 16390)
LANE_SEED = 22
# the authenticated-structures path: leaf indices opened (the order of a
# STARK's query count), the MMR's leafs (3 * 2^21 - 1: 22 peaks) and the
# leafs its successor proof appends, the small trees timed beside the big one
MERKLE_QUERIES = 160
MMR_LEAFS, MMR_APPEND = 3 * (1 << 21) - 1, 1 << 16
SMALL_TREES = (2, 1 << 10)
SMALL_MMR = 300  # leafs: below the parallelization cutoff (512)
# K9 and the tip5_mxu / tip5_packed entry points: the bench's batch and
# the step's leaf count, batches at the edges of a K9 warp's two tiles of
# 16 states, and the packed reduction over a layer of 2^20 digests to its
# root
MXU_STATES = (1 << 16, N * E)
MXU_RAGGED = (1 << 16) + 9
MXU_EDGES = (1, 15, 16, 17, 31, 32, 33, 1000)
PACKED_DIGESTS = 1 << 20
MXU_SEED = 14

# The bound of a kernel's work: the larger of its bytes (each input read
# once, each output written once) over the memory rate and its multiplies
# over the rates of the pipes that can do them (SMs x lanes x the maximum
# SM clock; the rates in probes/timing.py). Multiplies are counted as the
# fewest 32x32 -> 64-bit products a known algorithm needs, whatever the
# kernel does: four for a product of two 64-bit words, three for a square;
# none for a reduction or a product by 2^32 - 1 or 2^-64 mod p (the S-box's
# Montgomery conversions), which shifts and adds do. A Tip5 round then
# costs 14 per word for x^7 on 12 words (x^2, x^3, x^6, x^7: two squares,
# two products) and, for the MDS, two 16-point cyclic convolutions with
# the fixed column (one per 32-bit half) of MDS_PRODUCTS products each:
# the CRT tower of the Tip5 reference's mds_cyclomul, with Karatsuba and
# three-product complex multiplies at its base
# (tests/test_torch_bounds.py counts them). K1 does 512 for the MDS.
# The x^7 products are of full 64-bit words and take the integer-multiply
# (IMAD) pipe. The MDS's are of 32-bit halves by constants, which the FP64
# pipe beside it does exactly (K1 runs its MDS there as double FMAs), so
# they may go to either: the floor of the products is the larger of the
# IMAD-only ones over the IMAD rate and all of them over both rates.
IMAD_PER_MUL, IMAD_PER_SQUARE = 4, 3
MDS_PRODUCTS = 41
POW7_PRODUCTS_PER_PERM = 5 * 12 * 2 * (IMAD_PER_SQUARE + IMAD_PER_MUL)
MDS_PRODUCTS_PER_PERM = 5 * 2 * MDS_PRODUCTS
PRODUCTS_PER_PERM = POW7_PRODUCTS_PER_PERM + MDS_PRODUCTS_PER_PERM
# K9 (csrc/tip5_mma.cu) runs the MDS on the integer tensor cores instead:
# 8 u8 mma.m16n8k32 and 16 mma.m16n8k16 (2 * 16 * 8 * K operations each)
# for each tile of 16 states a round, two tiles a warp, over the int8
# tensor-core rate; its x^7 products stay on IMAD.
MMA_OPS_PER_WARP_ROUND = 2 * (8 * 32 + 16 * 16) * 2 * 16 * 8
MMA_STATES_PER_WARP = 32
#: canonical edge words K3's checks mix into their inputs
K3_EDGES = (0, 1, P - 1, 1 << 32, (1 << 32) - 1)
#: the device kernels of csrc/ by name; every other kernel of a step is glue
OWN_KERNELS = ("tip5_permute_kernel", "merkle_commit_kernel",
               "tip5_permute_mma_kernel",
               "ntt_local_pass_kernel", "coset_fold_kernel",
               "fold_reduce_kernel", "inv_segment_kernel",
               "inv_zero_rows_kernel", "gf_pointwise_kernel")
NO_LIBRARY = {"library_ms": None,
              "library": "no PyTorch call computes Goldilocks field "
                         "arithmetic, a Goldilocks NTT or Tip5"}


def varlen_input(length: int) -> np.ndarray:
    return np.random.default_rng(length).integers(0, P, size=length,
                                                  dtype=np.uint64)


def ragged_inputs() -> list:
    rng = np.random.default_rng(3)
    return [rng.integers(0, P, size=n, dtype=np.uint64) for n in RAGGED_LENGTHS]


def extrapolate_pin_inputs() -> dict:
    """The inputs of PINNED_EXTRAPOLATE by name: (codewords, points), from
    np.random.default_rng(0): (3, 2^10) base codewords at 64 base points;
    (2, 2^10) base and (2, 2^10, 3) xfe codewords at 4 xfe points."""
    rng = np.random.default_rng(0)
    cw = rng.integers(0, P, size=(3, 1 << 10), dtype=np.uint64)
    pts = rng.integers(0, P, size=64, dtype=np.uint64)
    cwb = rng.integers(0, P, size=(2, 1 << 10), dtype=np.uint64)
    cwx = rng.integers(0, P, size=(2, 1 << 10, 3), dtype=np.uint64)
    xpts = rng.integers(0, P, size=(4, 3), dtype=np.uint64)
    return {"base": (cw, pts), "xfe_base": (cwb, xpts),
            "xfe_xfe": (cwx, xpts)}


def pin_of(values) -> tuple:
    """(first three words, sha256 of the little-endian uint64 array)."""
    arr = np.ascontiguousarray(values, dtype="<u8")
    return (arr.reshape(-1)[:3].tolist(),
            hashlib.sha256(arr.tobytes()).hexdigest())


def bound(nbytes: int, imads: int, either: int = 0,
          int8_mma_ops: int = 0) -> dict:
    """bound_ms and what sets it, for ``nbytes`` moved, ``imads`` products
    that only the IMAD pipe does, ``either`` that the IMAD or the FP64
    pipe may do, and ``int8_mma_ops`` operations of u8 tensor-core
    products (2 M N K an mma) over the int8 tensor-core rate."""
    from twenty_first_tpu_torch.probes import timing

    clock = timing.sm_clock_mhz()[1]
    imad_per_s = timing.lane_rate(timing.IMAD_LANES_PER_SM, clock)
    fp64_per_s = timing.lane_rate(timing.FP64_LANES_PER_SM, clock)
    mem_ms = nbytes / timing.MEMORY_BYTES_PER_S * 1e3
    ops_ms = max(imads / imad_per_s,
                 (imads + either) / (imad_per_s + fp64_per_s),
                 int8_mma_ops / timing.INT8_TENSOR_OPS_PER_S) * 1e3
    return {"bound_ms": max(mem_ms, ops_ms),
            "bound_by": "bytes" if mem_ms >= ops_ms else "operations",
            "bound_bytes": nbytes, "bound_imads": imads,
            "bound_imad_or_fp64_products": either,
            "bound_int8_mma_ops": int8_mma_ops}


def tip5_bound(nbytes: int, perms: int) -> dict:
    """``bound`` of ``perms`` Tip5 permutations moving ``nbytes``."""
    return bound(nbytes, POW7_PRODUCTS_PER_PERM * perms,
                 MDS_PRODUCTS_PER_PERM * perms)


def k9_bound(perms: int) -> dict:
    """``bound`` of K9 on ``perms`` states: their bytes in and out, the x^7
    products on IMAD, and the mma of every warp of 32 states (the last one
    partly masked)."""
    warps = -(-perms // MMA_STATES_PER_WARP)
    return bound(2 * 128 * perms, POW7_PRODUCTS_PER_PERM * perms,
                 int8_mma_ops=5 * MMA_OPS_PER_WARP_ROUND * warps)


def run_path(counters, fn):
    """fn() with every counter at 0 just before; (its result, the counts
    just after, by wrapper name)."""
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    result = fn()
    torch.cuda.synchronize()
    return result, {c.__name__: c.launches for c in counters}


def require_launched(path: str, launches: dict) -> None:
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"{path}: a kernel of the path never ran: "
                             f"{launches}")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median device milliseconds of fn() by CUDA events, after one warm-up
    call, with the host's launch overheads hidden (probes/timing.py)."""
    from twenty_first_tpu_torch.probes import timing

    return timing.cuda_ms(fn, reps)


def wall_ms(fn, reps: int) -> float:
    """Median host milliseconds of fn() up to the device's end, launch
    overheads included (probes/timing.py)."""
    from twenty_first_tpu_torch.probes import timing

    return timing.wall_ms(fn, reps)


def max_abs_err(got, want) -> float:
    """Largest |got - want| over the u64 values (0.0 when equal)."""
    diff = (got != want).nonzero(as_tuple=True)
    if diff[0].numel() == 0:
        return 0.0
    g = got[diff].cpu().numpy().view(np.uint64)
    w = want[diff].cpu().numpy().view(np.uint64)
    return float(max(abs(int(a) - int(b)) for a, b in zip(g, w)))


def require_equal(what: str, got, want) -> float:
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = max_abs_err(got, want)
    if err != 0.0:
        bad = int((got != want).sum())
        raise AssertionError(f"{what}: {bad} of {got.numel()} elements differ "
                             f"(max abs err {err})")
    return err


def random_field(rng, shape, device="cuda"):
    from twenty_first_tpu_torch.math import gf

    return gf.from_u64(rng.integers(0, P, size=shape, dtype=np.uint64)).to(device)


def edge_words(rng, shape) -> np.ndarray:
    """Random field words with every seventh one of K3_EDGES in turn."""
    vals = rng.integers(0, P, size=shape, dtype=np.uint64)
    flat = vals.reshape(-1)
    flat[::7] = np.resize(np.array(K3_EDGES, dtype=np.uint64),
                          flat[::7].shape)
    return vals


def edge_field(rng, shape, device="cuda"):
    """``edge_words`` as a carrier on ``device``."""
    from twenty_first_tpu_torch.math import gf

    return gf.from_u64(edge_words(rng, shape)).to(device)


def check_device() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on a GPU")
    sys.path.insert(0, str(HERE))
    import twenty_first_tpu_torch

    pkg_root = Path(twenty_first_tpu_torch.__file__).resolve().parent.parent
    if pkg_root != HERE:
        raise RuntimeError(f"imported the port from {pkg_root}, not {HERE}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))
    return smi


def phase_build() -> None:
    from twenty_first_tpu_torch import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    seconds = time.perf_counter() - t0
    ptxas = [line.strip() for line in _build.build_log().splitlines()
             if "Used" in line or "spill" in line or "Compiling" in line]
    emit("build", seconds=seconds, library=so.name, ptxas=ptxas)


def phase_k1(rng, tables) -> dict:
    from twenty_first_tpu_torch.math import gf
    from twenty_first_tpu_torch.ops import tip5_cuda

    edges = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, (1 << 32) + 1]
    edge_states = gf.from_u64(np.array(
        [[e] * 16 for e in edges]
        + [[edges[(i + j) % len(edges)] for j in range(16)] for i in range(6)],
        dtype=np.uint64)).cuda()
    states = torch.cat([random_field(rng, (1 << 16, 16)), edge_states])
    got = tip5_cuda.tip5_permute(states, *tables)
    require_equal("K1 random+edge states", got,
                  tip5_cuda.tip5_permute_plain(states, *tables))
    snap = gf.from_u64([[(raw * R_INV) % P for raw in RAW_SNAPSHOT_IN]]).cuda()
    out = gf.to_u64(tip5_cuda.tip5_permute(snap, *tables))[0, :5]
    if [(int(v) * R) % P for v in out] != RAW_SNAPSHOT_OUT5:
        raise AssertionError("K1 misses the Tip5 reference snapshot")
    # at the main path's shape: the leaf hash of 2^22 rows
    big = random_field(rng, (N * E, 16))
    got = tip5_cuda.tip5_permute(big, *tables)
    err = require_equal("K1 at the path's shape", got,
                        tip5_cuda.tip5_permute_plain(big, *tables))
    ms = cuda_ms(lambda: tip5_cuda.tip5_permute(big, *tables), 10)
    host_ms = wall_ms(lambda: tip5_cuda.tip5_permute(big, *tables), 10)
    plain_ms = cuda_ms(lambda: tip5_cuda.tip5_permute_plain(big, *tables), 3)
    emit("k1_tip5_permute", states=states.shape[0], snapshot=True,
         shape=[N * E, 16], ms=ms, plain_ms=plain_ms,
         perms_per_s=N * E / (ms * 1e-3))
    return {"max_abs_err": err, "ms": ms, "wall_ms": host_ms,
            "plain_ms": plain_ms,
            **tip5_bound(2 * 128 * N * E, N * E)}


def phase_k2(rng, tables) -> dict:
    """K2, the tree: uneven and forced-branch cases against the plain twins,
    then the tree over the main path's 2^22 leaf digests, timed whole and
    launch by launch."""
    from twenty_first_tpu_torch.ops import tip5_commit, tip5_cuda
    from twenty_first_tpu_torch.probes import tip5_probe

    states = random_field(rng, (1 << 16, 16))
    require_equal("K2 commit of 2^16 leaf states",
                  tip5_commit.commit_states(states, 16, tables=tables),
                  tip5_commit.commit_states(states, 16, tables=tables,
                                            plain=True))
    cases = [(2, 1), (4, 2), (8, 3), (6, 1), (96, 5), (384, 7), (512, 9),
             (1024, 10), (1536, 9), (3 << 11, 11), (1 << 13, 13)]
    # resident thread counts that put the switch from full-width levels to
    # the fused tail at every level of these small trees (0: all full width)
    forced = (0, 1, 7, 48, 200, 1 << 30)
    checked = 0
    for rows, layers in cases:
        dig = random_field(rng, (rows, 5))
        want = tip5_commit.reduce_layers(dig, layers, tables=tables,
                                         plain=True)
        for resident in (None, *forced):
            require_equal(f"K2 reduce ({rows}, {layers}) resident={resident}",
                          tip5_commit.reduce_layers(
                              dig, layers, tables=tables,
                              resident_threads=resident), want)
            checked += 1
    for rows, layers in [(48, 4), (1024, 0), (40, 3), (256, 8), (1536, 9)]:
        st = random_field(rng, (rows, 16))
        want = tip5_commit.commit_states(st, layers, tables=tables,
                                         plain=True)
        for resident in (None, *forced):
            require_equal(f"K2 commit ({rows}, {layers}) resident={resident}",
                          tip5_commit.commit_states(
                              st, layers, tables=tables,
                              resident_threads=resident), want)
            checked += 1
    # at the main path's shape: the tree over 2^22 leaf digests
    leafs = random_field(rng, (N * E, 5))
    log_rows = (N * E).bit_length() - 1
    tree = lambda: tip5_commit.reduce_layers(leafs, log_rows, tables=tables)  # noqa: E731
    tree_plain = lambda: tip5_commit.reduce_layers(  # noqa: E731
        leafs, log_rows, tables=tables, plain=True)
    err = require_equal("K2 tree over the path's leafs", tree(), tree_plain())
    resident = tip5_cuda.resident_threads(leafs.device)
    plan = tip5_commit.plan(N * E, log_rows, resident)
    ms = cuda_ms(tree, 10)
    host_ms = wall_ms(tree, 10)
    plain_ms = cuda_ms(tree_plain, 3)
    launches = tip5_probe.tree_launch_ms(leafs, tables)
    summary = tip5_probe.tree_summary(launches)
    # the level kernel alone: the first level, 2^22 -> 2^21 digests
    level = lambda: tip5_cuda.merkle_level(leafs, False, *tables)  # noqa: E731
    level_plain = lambda: tip5_cuda.merkle_level_plain(  # noqa: E731
        leafs, False, *tables)
    level_err = require_equal("K2 level at the path's shape", level(),
                              level_plain())
    level_row = {"max_abs_err": level_err, "ms": cuda_ms(level, 10),
                 "wall_ms": wall_ms(level, 10),
                 "plain_ms": cuda_ms(level_plain, 3),
                 **tip5_bound(40 * (N * E + N * E // 2), N * E // 2)}
    emit("k2_merkle_tree", cases=checked + 2, resident_threads=resident,
         plan=plan, ms=ms, wall_ms=host_ms, plain_ms=plain_ms,
         launch_ms=launches, **summary, level_ms=level_row["ms"])
    fused_perms = sum(t["rows_in"] - (t["rows_in"] >> t["levels"])
                      for t in launches if t["launch"] == "fused")
    return {"max_abs_err": err, "ms": ms, "wall_ms": host_ms,
            "plain_ms": plain_ms, "tree_leafs": N * E,
            "perms": {"merkle_level": N * E - 1 - fused_perms,
                      "merkle_commit": fused_perms},
            # the plan's launch count as plan_launches: "launches" is the
            # path's count, which the kernels line sets
            **{("plan_launches" if k == "launches" else k): v
               for k, v in summary.items()},
            "plan": plan, "resident_threads": resident,
            "level_kernel": level_row,
            **tip5_bound(40 * (N * E + 1), N * E - 1)}


def phase_k3(rng) -> dict:
    from twenty_first_tpu_torch.math import gf, ntt
    from twenty_first_tpu_torch.ops import ntt_cuda

    checked = 0
    for log_t in range(1, 13):
        t = 1 << log_t
        tw = gf.from_u64(ntt.stage_twiddles(log_t, log_t % 2 == 1)).cuda()
        diag = edge_field(rng, (t, 37))
        n_inv = pow(t, P - 2, P)
        for layout in ("cols_fast", "elems_fast"):
            if layout == "cols_fast":
                x = edge_field(rng, (2, t, 37))
            else:
                x = edge_field(rng, (2, 37, t)).transpose(1, 2)
            for d, scale in ((None, 1), (diag, 1), (None, n_inv),
                             (diag, n_inv)):
                require_equal(
                    f"K3 log_t={log_t} {layout} diag={d is not None} "
                    f"scale={scale != 1}",
                    ntt_cuda.ntt_local_pass(x, tw, diag=d, scale=scale),
                    ntt_cuda.ntt_local_pass_plain(x, tw, diag=d, scale=scale))
                checked += 1
            # in place: out is x's very view
            want = ntt_cuda.ntt_local_pass_plain(x, tw, diag=diag, scale=n_inv)
            ntt_cuda.ntt_local_pass(x, tw, diag=diag, scale=n_inv, out=x)
            require_equal(f"K3 in place log_t={log_t} {layout}", x, want)
            checked += 1
    for log_n in (10, 17, 22):
        n = 1 << log_n
        x = random_field(rng, (2, n))
        fwd = ntt.ntt_tables(n, False, "cuda")
        inv = ntt.ntt_tables(n, True, "cuda")
        y = ntt.ntt(x, tables=fwd)
        require_equal(f"ntt 2^{log_n}", y, ntt.ntt(x, tables=fwd, plain=True))
        require_equal(f"intt 2^{log_n}", ntt.intt(y, tables=inv),
                      ntt.intt(y, tables=inv, plain=True))
        require_equal(f"intt(ntt(x)) 2^{log_n}", ntt.intt(y, tables=inv), x)
    # ntt(post=, out=) at the main path's two sizes (the iNTT of n = N
    # written into the head of zero planes of E * N, the NTT of N * E)
    # against the transform followed by the product, on the plain twins
    for n, inverse in ((N, True), (N * E, False)):
        tabs = ntt.ntt_tables(n, inverse, "cuda")
        x = random_field(rng, (W, n))
        post = random_field(rng, (n,))
        planes = torch.zeros((W, E * n), dtype=torch.int64, device="cuda")
        ntt.ntt(x, inverse, tables=tabs, post=post, out=planes[:, :n])
        want = gf.mul(ntt.ntt(x, inverse, tables=tabs, plain=True), post)
        require_equal(f"ntt(post=, out=) 2^{n.bit_length() - 1} "
                      f"inverse={inverse}", planes[:, :n], want)
        if bool(planes[:, n:].any()):
            raise AssertionError("ntt(out=) wrote past the head of its planes")
        del planes, want
    golden = ntt.ntt(gf.from_u64([1, 4, 0, 0]).cuda())
    if gf.to_u64(golden).tolist() != [5, 1125899906842625,
                                      18446744069414584318,
                                      18445618169507741698]:
        raise AssertionError("ntt misses the [1, 4, 0, 0] golden vector")
    # at the main path's shape: pass 1 of the forward transform of N * E
    fwd = ntt.ntt_tables(N * E, False, "cuda")
    log_n1, log_n2 = ntt.four_step_split((N * E).bit_length() - 1)
    x = random_field(rng, (W, 1 << log_n2, 1 << log_n1))
    err = require_equal(
        f"K3 at {tuple(x.shape)}",
        ntt_cuda.ntt_local_pass(x, fwd.tw1, diag=fwd.diag),
        ntt_cuda.ntt_local_pass_plain(x, fwd.tw1, diag=fwd.diag))
    ms = cuda_ms(lambda: ntt_cuda.ntt_local_pass(x, fwd.tw1, diag=fwd.diag), 10)
    host_ms = wall_ms(lambda: ntt_cuda.ntt_local_pass(x, fwd.tw1,
                                                      diag=fwd.diag), 10)
    plain_ms = cuda_ms(lambda: ntt_cuda.ntt_local_pass_plain(
        x, fwd.tw1, diag=fwd.diag), 3)
    flat = x.reshape(W, N * E)
    ntt_ms = cuda_ms(lambda: ntt.ntt(flat, tables=fwd), 10)
    ntt_plain_ms = cuda_ms(lambda: ntt.ntt(flat, tables=fwd, plain=True), 3)
    emit("k3_ntt_local_pass", passes_checked=checked, ntt_sizes=[10, 17, 22],
         shape=list(x.shape), ms=ms, plain_ms=plain_ms,
         ntt_path_ms=ntt_ms, ntt_path_plain_ms=ntt_plain_ms)
    b, t, c = x.shape
    products = b * c * (t // 2) * log_n2 + b * t * c  # butterflies + diagonal
    return {"max_abs_err": err, "ms": ms, "wall_ms": host_ms,
            "plain_ms": plain_ms,
            **bound(16 * x.numel() + 8 * fwd.diag.numel(),
                    IMAD_PER_MUL * products)}


def phase_pinned_roots() -> None:
    from twenty_first_tpu_torch.math import gf
    from twenty_first_tpu_torch.parallel import pipeline

    for n, want in PINNED_ROOTS.items():
        trace = gf.from_u64(np.random.default_rng(0).integers(
            0, P, size=(W, n), dtype=np.uint64)).cuda()
        for plain in (False, True):
            got = gf.to_u64(pipeline.trace_lde_commit(trace, plain=plain))
            if got.tolist() != [want]:
                raise AssertionError(f"n={n} plain={plain}: root {got.tolist()}"
                                     f" != pinned JAX root {want}")
    emit("pinned_jax_roots", sizes=sorted(PINNED_ROOTS), ok=True)


def device_breakdown(fn) -> dict:
    """Device time by kernel over one fn() under torch.profiler, and the
    device's busy share of that call's CUDA-event time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    span_ms = start.elapsed_time(end)
    # the glue: every device kernel that is not one of the port's own
    glue = [e for e in kernels if not any(k in e.key for k in OWN_KERNELS)]
    return {"span_ms": span_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / span_ms if busy_ms else "not measured",
            "glue_device_ms": sum(e.self_device_time_total for e in glue) / 1e3,
            "glue_launches": sum(e.count for e in glue),
            "kernels": [{"name": e.key[:90], "calls": e.count,
                         "device_ms": e.self_device_time_total / 1e3}
                        for e in kernels[:24]]}


def phase_slice(counters) -> dict:
    from twenty_first_tpu_torch.math import gf
    from twenty_first_tpu_torch.parallel import pipeline

    step = pipeline.TraceLdeCommit(W, N, E)
    trace = random_field(np.random.default_rng(2026), (W, N))
    # the main path, once, with every launch counter at 0
    root, launches = run_path(counters, lambda: step(trace))
    require_launched("slice", launches)
    vals = gf.to_u64(root)
    if root.shape != (1, 5) or not (vals < np.uint64(P)).all():
        raise AssertionError(f"bad root {vals.tolist()}")
    require_equal("slice root: kernels vs plain on the card", root,
                  step(trace, plain=True))
    from twenty_first_tpu_torch.probes import timing

    torch.cuda.reset_peak_memory_stats()
    times = sorted(timing.wall_times(lambda: step(trace), 21))
    wall = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    device_ms = cuda_ms(lambda: step(trace), 21)
    torch.cuda.reset_peak_memory_stats()
    plain_ms = wall_ms(lambda: step(trace, plain=True), 3)
    plain_peak = torch.cuda.max_memory_allocated()
    emit("slice_lde_commit", w=W, n=N, expansion=E, rows=N * E,
         root=vals[0].tolist(), launches=launches, wall_ms=wall,
         runs=len(times), wall_ms_min=times[0], wall_ms_max=times[-1],
         ms=device_ms, plain_wall_ms=plain_ms, max_memory_allocated=peak,
         plain_max_memory_allocated=plain_peak)
    emit("slice_profile", **device_breakdown(lambda: step(trace)))
    return launches, vals[0].tolist()


def phase_merkle_objects(counters, slice_root, fused_tail_ms) -> dict:
    """The authenticated-structures path at a prover's sizes: the Merkle
    tree over the flagship step's 2^22 leaf digests with 160 openings, the
    MMR over 3 * 2^21 - 1 leafs and a successor proof of 2^16 more, and a
    ragged batch through the Tip5 object API (K1, K2's two launches, K3
    through the step's leaf digests)."""
    from twenty_first_tpu_torch.ops import tip5_commit, tip5_cuda
    from twenty_first_tpu_torch.parallel import pipeline
    from twenty_first_tpu_torch.probes import timing
    from twenty_first_tpu_torch.tip5 import Digest, Tip5
    from twenty_first_tpu_torch.util_types.merkle_tree import (
        MerkleTree, MerkleTreeInclusionProof)
    from twenty_first_tpu_torch.util_types.mmr import (MmrAccumulator,
                                                       MmrSuccessorProof)

    step = pipeline.TraceLdeCommit(W, N, E)
    trace = random_field(np.random.default_rng(2026), (W, N))
    rng = np.random.default_rng(9)
    indices = [int(i) for i in rng.integers(0, N * E, MERKLE_QUERIES)]
    mmr_leafs = random_field(rng, (MMR_LEAFS, 5))
    appended = random_field(rng, (MMR_APPEND, 5))
    ragged = [rng.integers(0, P, size=int(n), dtype=np.uint64)
              for n in rng.integers(0, 50, size=64)]

    def path():
        leafs = step.leaf_digests(trace)
        tree = MerkleTree.new(leafs)
        acc = MmrAccumulator.new_from_leafs(mmr_leafs)
        return {"leafs": leafs, "tree": tree,
                "frugal_root": MerkleTree.frugal_root(leafs),
                "proof": tree.inclusion_proof_for_leaf_indices(indices),
                "from_leafs": MerkleTree.authentication_structure_from_leafs(
                    leafs, indices),
                "acc": acc,
                "successor": MmrSuccessorProof.new_from_batch_append(
                    acc, appended),
                "ragged": Tip5.hash_varlen_batch(ragged)}

    got, launches = run_path(counters, path)
    require_launched("merkle_objects", launches)
    leafs, tree, proof = got["leafs"], got["tree"], got["proof"]
    root = tree.root()
    root_vals = [v.value() for v in root.values()]
    if root_vals != slice_root or root_vals != SLICE_ROOT:
        raise AssertionError(f"tree root {root_vals}, the step's root "
                             f"{slice_root}, pinned {SLICE_ROOT}")
    if got["frugal_root"] != root:
        raise AssertionError("frugal_root != the tree's root")
    if tree != MerkleTree.new(leafs, plain=True):
        raise AssertionError("tree nodes: kernels != plain on the card")
    # openings
    auth = tree.authentication_structure(indices)
    if auth != got["from_leafs"] or auth != proof.authentication_structure:
        raise AssertionError("authentication_structure != "
                             "authentication_structure_from_leafs")
    t0 = time.perf_counter()
    verified = proof.verify(root)
    verify_ms = (time.perf_counter() - t0) * 1e3
    flipped = list(auth)
    flipped[len(flipped) // 2] = Digest(
        [flipped[len(flipped) // 2].values()[0] + 1]
        + list(flipped[len(flipped) // 2].values()[1:]))
    tampered = MerkleTreeInclusionProof(proof.tree_height,
                                        proof.indexed_leafs, flipped)
    tampered_verified = tampered.verify(root)
    if not verified or tampered_verified:
        raise AssertionError(f"verify: honest {verified}, tampered "
                             f"{tampered_verified}")
    # the MMR
    acc = got["acc"]
    acc_plain = MmrAccumulator.new_from_leafs(mmr_leafs, plain=True)
    if (acc != acc_plain or acc.bag_peaks() != acc_plain.bag_peaks()
            or len(acc.peaks()) != bin(MMR_LEAFS).count("1")):
        raise AssertionError("MMR peaks: kernels != plain on the card")
    successor = got["successor"]
    new_acc = MmrAccumulator.new_from_leafs(torch.cat([mmr_leafs, appended]))
    if successor != MmrSuccessorProof.new_from_batch_append(
            acc, appended, plain=True) or not successor.verify(acc, new_acc):
        raise AssertionError("successor proof fails from the old MMR to the "
                             "new")
    if got["ragged"] != [Tip5.hash_varlen([int(v) for v in seq])
                         for seq in ragged]:
        raise AssertionError("hash_varlen_batch != scalar hash_varlen")
    # times: the tree, whole and at the small sizes
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    MerkleTree.new(leafs)
    torch.cuda.synchronize()
    tree_peak = torch.cuda.max_memory_allocated() - base
    tree_launches = run_path(counters, lambda: MerkleTree.new(leafs))[1]
    trees = {}
    for size in SMALL_TREES + (N * E,):
        small = leafs[:size].contiguous()
        counts = run_path(counters, lambda: MerkleTree.new(small))[1]
        if counts["merkle_level"] != size.bit_length() - 1:
            raise AssertionError(f"MerkleTree.new({size}) made "
                                 f"{counts['merkle_level']} K2 launches")
        trees[size] = {"ms": cuda_ms(lambda: MerkleTree.new(small), 10),
                       "wall_ms": wall_ms(lambda: MerkleTree.new(small), 10),
                       "merkle_level_launches": counts["merkle_level"]}
    # an MMR below the cutoff: its peaks are still reduced on the card
    small_mmr = mmr_leafs[:SMALL_MMR].contiguous()
    small_acc, counts = run_path(
        counters, lambda: MmrAccumulator.new_from_leafs(small_mmr))
    small_mmr_k2 = counts["merkle_level"] + counts["merkle_commit"]
    if small_mmr_k2 == 0 or small_acc != MmrAccumulator.new_from_leafs(
            small_mmr, plain=True):
        raise AssertionError(f"MMR of {SMALL_MMR} leafs: {small_mmr_k2} K2 "
                             "launches, or peaks != plain on the card")
    small_mmr_ms = cuda_ms(lambda: MmrAccumulator.peaks_from_leafs(small_mmr),
                           10)
    small_mmr_wall_ms = wall_ms(
        lambda: MmrAccumulator.peaks_from_leafs(small_mmr), 10)
    # the levels below the resident-thread width, one launch a level, beside
    # the commit's fused tail over the same levels (k2_merkle_tree)
    tables = step.round_constants, step.lookup_table
    full_width = sum(1 for t in tip5_commit.plan(
        N * E, (N * E).bit_length() - 1,
        tip5_cuda.resident_threads(leafs.device)) if t[0] == "level")
    tail_leafs = tip5_commit.reduce_layers(leafs, full_width, tables=tables)
    tail_tree_ms = cuda_ms(lambda: MerkleTree.new(tail_leafs), 10)
    tail_level_ms, x = [], tail_leafs
    while x.shape[0] > 1:
        tail_level_ms.append(cuda_ms(
            lambda x=x: tip5_cuda.merkle_level(x, False, *tables), 10))
        x = tip5_cuda.merkle_level(x, False, *tables)
    # the openings and the MMR
    gather_ms = wall_ms(lambda: tree.authentication_structure(indices), 10)
    from_leafs_ms = wall_ms(lambda: MerkleTree.authentication_structure_from_leafs(
        leafs, indices), 5)
    peaks_ms = cuda_ms(lambda: MmrAccumulator.peaks_from_leafs(mmr_leafs), 5)
    peaks_wall_ms = wall_ms(lambda: MmrAccumulator.peaks_from_leafs(
        mmr_leafs), 5)
    peaks_plain_ms = timing.wall_ms(lambda: MmrAccumulator.peaks_from_leafs(
        mmr_leafs, plain=True), 1, warmup=0)
    successor_ms = wall_ms(lambda: MmrSuccessorProof.new_from_batch_append(
        acc, appended), 3)
    big = trees[N * E]
    emit("merkle_objects", launches=launches, leafs=N * E,
         root=[v.value() for v in root.values()], tree_ms=big["ms"],
         tree_wall_ms=big["wall_ms"],
         tree_wall_ms_runs=timing.wall_times(lambda: MerkleTree.new(leafs), 5),
         tree_launches=tree_launches, tree_peak_bytes=tree_peak,
         node_bytes=2 * N * E * 40,
         small_trees={str(k): v for k, v in trees.items()},
         tail_rows=tail_leafs.shape[0], tail_level_ms=tail_level_ms,
         tail_levels_ms=sum(tail_level_ms), tail_tree_ms=tail_tree_ms,
         fused_tail_ms=fused_tail_ms,
         tail_excess_ms=sum(tail_level_ms) - fused_tail_ms,
         queries=MERKLE_QUERIES, auth_nodes=len(auth),
         auth_gather_copy_wall_ms=gather_ms,
         auth_from_leafs_wall_ms=from_leafs_ms, verify_host_ms=verify_ms,
         verified=verified, tampered_verified=tampered_verified,
         mmr_leafs=MMR_LEAFS, mmr_peaks=len(acc.peaks()),
         peaks_from_leafs_ms=peaks_ms, peaks_from_leafs_wall_ms=peaks_wall_ms,
         peaks_from_leafs_plain_wall_ms=peaks_plain_ms,
         small_mmr_leafs=SMALL_MMR, small_mmr_k2_launches=small_mmr_k2,
         small_mmr_peaks_ms=small_mmr_ms,
         small_mmr_peaks_wall_ms=small_mmr_wall_ms,
         successor_appended=MMR_APPEND, successor_paths=len(successor.paths),
         successor_wall_ms=successor_ms, ragged_inputs=len(ragged))
    return launches


def phase_entry() -> None:
    from twenty_first_tpu_torch.entry import entry
    from twenty_first_tpu_torch.math import gf

    fn, args = entry()  # on the card by default
    if args[0].device.type != "cuda":
        raise AssertionError(f"entry() put its trace on {args[0].device}")
    root = fn(*args)
    require_equal("entry root vs plain", root, fn(*args, plain=True))
    if gf.to_u64(root).tolist() != [ENTRY_ROOT]:
        raise AssertionError(f"entry root {gf.to_u64(root).tolist()} != "
                             f"JAX reference {ENTRY_ROOT}")
    emit("entry", shape=list(args[0].shape), root=ENTRY_ROOT, ok=True)


def snapshot_state():
    """The Tip5 reference snapshot's input as a canonical (1, 16) state."""
    return np.array([[(raw * R_INV) % P for raw in RAW_SNAPSHOT_IN]],
                    dtype=np.uint64)


def require_snapshot(what: str, states_out) -> None:
    """Row 0 of ``states_out`` must be the reference snapshot's output."""
    from twenty_first_tpu_torch.math import gf

    out = np.asarray(states_out if isinstance(states_out, np.ndarray)
                     else gf.to_u64(states_out[:1]))[0, :5]
    if [(int(v) * R) % P for v in out] != RAW_SNAPSHOT_OUT5:
        raise AssertionError(f"{what} misses the Tip5 reference snapshot")


def phase_tip5_batch(rng, tables) -> dict:
    """The standalone Tip5 batch path: K1 and its trace mode."""
    from twenty_first_tpu_torch.math import gf
    from twenty_first_tpu_torch.ops import tip5_batch, tip5_cuda
    from twenty_first_tpu_torch.tip5 import permutation as tperm

    def batch(n):  # row 0: the snapshot state
        x = rng.integers(0, P, size=(n, 16), dtype=np.uint64)
        x[0] = snapshot_state()[0]
        return x

    small, big = (batch(n) for n in BATCH_STATES)
    t45 = batch(T45_STATES)
    small_d, big_d, t45_d = (gf.from_u64(v).cuda() for v in (small, big, t45))
    trace_in = rng.integers(0, P, size=(TRACE_STATES, 16), dtype=np.uint64)
    trace_in[0] = np.arange(16)
    trace_d = gf.from_u64(trace_in).cuda()
    mixed = [rng.integers(0, P, size=int(n), dtype=np.uint64)
             for n in rng.integers(0, MIXED_MAX_LENGTH + 1,
                                   size=MIXED_INPUTS)]
    t4t5 = {"permutation": lambda: tip5_batch.permutation(t45_d),
            "permutation_values": lambda: tip5_batch.permutation_values(t45),
            "permutation_dense": lambda: tip5_batch.permutation_dense(t45_d),
            "permutation_dense_nogrid":
                lambda: tip5_batch.permutation_dense_nogrid(t45_d),
            "permutation_dense_values":
                lambda: tip5_batch.permutation_dense_values(t45)}

    def path():
        return {"batch_small": tperm.permutation_batch(small_d),
                "batch_big": tperm.permutation_batch(big_d),
                **{name: fn() for name, fn in t4t5.items()},
                "trace": tperm.trace(trace_d),
                **{f"varlen_{n}": tperm.hash_varlen(varlen_input(n))
                   for n in PINNED_VARLEN},
                "ragged_pinned": tperm.hash_varlen_ragged(ragged_inputs()),
                "ragged_mixed": tperm.hash_varlen_ragged(mixed)}

    got, launches = run_path((tip5_cuda.tip5_permute, tip5_cuda.tip5_trace),
                             path)
    require_launched("tip5_batch", launches)
    # against the plain twins on the card, at reduced sizes where plain
    # sponges would be long
    err = require_equal("permutation_batch (small)", got["batch_small"],
                        tperm.permutation_batch(small_d, plain=True))
    for name in ("batch_small", "batch_big"):
        require_snapshot(name, got[name])
    plain45 = tip5_cuda.tip5_permute_plain(t45_d, *tables)
    for name in t4t5:
        out = got[name]
        out = gf.from_u64(out).cuda() if isinstance(out, np.ndarray) else out
        require_equal(f"T4/T5 {name}", out, plain45)
        require_snapshot(name, out)
    require_equal("trace", got["trace"], tperm.trace(trace_d, plain=True))
    rows = gf.to_u64(got["trace"][0])
    if [[int(r[0]), int(r[15])] for r in rows] != PINNED_TRACE:
        raise AssertionError("trace misses the JAX-pinned trace")
    for n, want in PINNED_VARLEN.items():
        if got[f"varlen_{n}"].tolist() != want:
            raise AssertionError(f"hash_varlen({n}) misses the JAX pin")
    short = varlen_input(1000)
    if not np.array_equal(tperm.hash_varlen(short),
                          tperm.hash_varlen(short, plain=True)):
        raise AssertionError("hash_varlen(1000) kernel != plain")
    if got["ragged_pinned"].tolist() != PINNED_RAGGED:
        raise AssertionError("hash_varlen_ragged misses the JAX pins")
    if not np.array_equal(got["ragged_mixed"],
                          tperm.hash_varlen_ragged(mixed, plain=True)):
        raise AssertionError("hash_varlen_ragged (mixed) kernel != plain")
    # timings, on the kernel path only
    ms = {"batch_small": cuda_ms(lambda: tperm.permutation_batch(small_d), 10),
          "batch_big": cuda_ms(lambda: tperm.permutation_batch(big_d), 10),
          "t4_permutation": cuda_ms(t4t5["permutation"], 10),
          "trace": cuda_ms(lambda: tperm.trace(trace_d), 10)}
    trace_wall_ms = wall_ms(lambda: tperm.trace(trace_d), 10)
    trace_plain_ms = cuda_ms(lambda: tperm.trace(trace_d, plain=True), 3)
    ms["t4_permutation_plain"] = cuda_ms(
        lambda: tip5_cuda.tip5_permute_plain(t45_d, *tables), 3)
    host_ms = {
        "varlen_10": wall_ms(lambda: tperm.hash_varlen(varlen_input(10)), 5),
        "varlen_16384": wall_ms(lambda: tperm.hash_varlen(
            varlen_input(16384)), 5),
        "ragged_mixed": wall_ms(lambda: tperm.hash_varlen_ragged(mixed), 5)}
    before = tip5_cuda.tip5_permute.launches
    tperm.hash_varlen(varlen_input(16384))
    varlen_launches = tip5_cuda.tip5_permute.launches - before
    emit("tip5_batch", launches=launches, states=list(BATCH_STATES),
         t45_states=T45_STATES, trace_states=TRACE_STATES,
         t45_bound=tip5_bound(2 * 128 * T45_STATES, T45_STATES),
         mixed_inputs=MIXED_INPUTS, ms=ms, host_ms=host_ms,
         hash_varlen_16384_launches=varlen_launches,
         perms_per_s={n: n / (ms[k] * 1e-3) for n, k in
                      zip(BATCH_STATES, ("batch_small", "batch_big"))},
         pinned=["snapshot", "trace", "varlen_10", "varlen_16384", "ragged"])
    return {"launches": launches, "max_abs_err": err,
            "trace": {"launches": launches["tip5_trace"],
                      "ms": ms["trace"], "wall_ms": trace_wall_ms,
                      "plain_ms": trace_plain_ms,
                      **tip5_bound(8 * (16 + 96) * TRACE_STATES,
                                   TRACE_STATES)}}


def absorb_table(shape, seed):
    """A random int64 table of ``shape`` on the card with edge words first
    in every row."""
    from twenty_first_tpu_torch.math import gf

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    table = torch.randint(0, (1 << 63) - 1, shape, generator=g,
                          device="cuda", dtype=torch.int64)
    edges = gf.from_u64(np.array([0, 1, P - 1, (1 << 32) - 1, 1 << 32,
                                  (1 << 32) + 1], dtype=np.uint64)).cuda()
    table[:, :edges.shape[0]] = edges
    return table


def absorb_counted(table, tables) -> tuple:
    """``tip5_absorb`` over ``table`` and how far it moved K1's launches
    and the lane mode's."""
    from twenty_first_tpu_torch.ops import tip5_cuda

    before = (tip5_cuda.tip5_permute.launches,
              tip5_cuda.tip5_absorb.lane_launches)
    got = tip5_cuda.tip5_absorb(table, *tables)
    torch.cuda.synchronize()
    return got, (tip5_cuda.tip5_permute.launches - before[0],
                 tip5_cuda.tip5_absorb.lane_launches - before[1])


def phase_k1_absorb(tables) -> dict:
    """K1's absorb mode at the table commit's shape: one launch for every
    chunk of every row of a (2^17, 16,390) table (rows past 2^31 bytes,
    edge words first in every row), a thread a row, equal to the plain
    twin ``tip5_absorb_plain`` on the same table."""
    from twenty_first_tpu_torch.ops import tip5_cuda

    rows, width = ABSORB_SHAPE
    table = absorb_table(ABSORB_SHAPE, ABSORB_SEED)
    got, moved = absorb_counted(table, tables)
    if moved != (1, 0):
        raise AssertionError(f"K1's absorb mode at the table's shape moved "
                             f"(launches, lane launches) by {moved}")
    err = require_equal("K1 absorb at the table's shape", got,
                        tip5_cuda.tip5_absorb_plain(table, *tables))
    ms = cuda_ms(lambda: tip5_cuda.tip5_absorb(table, *tables), 3)
    perms = rows * (width // 10)
    del table, got
    torch.cuda.empty_cache()  # 17 GB, before the phases that fill the card
    emit("k1_absorb", shape=[rows, width], twin_equal=True, ms=ms,
         ns_per_perm=ms * 1e6 / perms)
    return {"max_abs_err": err, "ms": ms, "shape": [rows, width],
            "perms": perms, "launches": 1, "lane_launches": 0}


def phase_k1_absorb_lanes(tables) -> dict:
    """K1's absorb mode at the opening's shape, which takes its lane mode:
    one launch over a (80, 16,390) table (edge words first in every row),
    counted as K1's and as a lane-mode launch, equal to the plain twin on
    the same table; timed beside the thread-a-row design on the same
    table, and both designs across ``tip5_probe.ABSORB_SWEEP`` (equal
    digests) beside the design ``lane_mode`` picks."""
    from twenty_first_tpu_torch.ops import tip5_cuda
    from twenty_first_tpu_torch.probes import tip5_probe

    rows, width = LANE_SHAPE
    table = absorb_table(LANE_SHAPE, LANE_SEED)
    got, moved = absorb_counted(table, tables)
    if moved != (1, 1):
        raise AssertionError(f"K1's absorb mode at the opening's shape moved "
                             f"(launches, lane launches) by {moved}")
    err = require_equal("K1 lane mode at the opening's shape", got,
                        tip5_cuda.tip5_absorb_plain(table, *tables))
    ms = cuda_ms(lambda: tip5_cuda.tip5_absorb(table, *tables), 5)
    threads_ms = cuda_ms(tip5_probe.absorb_design(table, tables, "threads"),
                         5)
    perms = rows * (width // 10)
    del table, got
    sweep = tip5_probe.absorb_sweep(tables)
    emit("k1_absorb_lanes", shape=[rows, width], twin_equal=True, ms=ms,
         threads_ms=threads_ms, ns_per_perm=ms * 1e6 / perms, sweep=sweep)
    return {"max_abs_err": err, "ms": ms, "threads_ms": threads_ms,
            "shape": [rows, width], "perms": perms, "launches": 1,
            "lane_launches": 1, "sweep": sweep}


def slice_leaf_states():
    """The flagship step's (N * E, 16) leaf states of SLICE_ROOT's trace:
    the rows ``pipeline.hash_rows`` permutes (the W evaluations, zeros to
    the rate, the capacity ones), made as ``TraceLdeCommit.leaf_digests``
    makes them."""
    from twenty_first_tpu_torch.math import ntt
    from twenty_first_tpu_torch.parallel import pipeline
    from twenty_first_tpu_torch.tip5.constants import RATE

    step = pipeline.TraceLdeCommit(W, N, E)
    trace = random_field(np.random.default_rng(2026), (W, N))
    padded = torch.zeros((W, N * E), dtype=torch.int64, device="cuda")
    ntt.ntt(trace, inverse=True, tables=step._ntt_tables("inv", N, True),
            post=step.offset_powers, out=padded[:, :N])
    evals = ntt.ntt(padded, tables=step._ntt_tables("fwd", N * E, False))
    states = torch.zeros((N * E, 16), dtype=torch.int64, device="cuda")
    states[:, :W] = evals.t()
    states[:, RATE:] = 1
    return states


def k1_k9_in_turns(x, tables) -> dict:
    """K1 and K9 on the same states, timed in turns (K1, K9, K9, K1): each
    one's device ms (CUDA events, median of 10) and wall_ms, both
    readings."""
    from twenty_first_tpu_torch.ops import tip5_cuda, tip5_mxu

    fns = {"k1": lambda: tip5_cuda.tip5_permute(x, *tables),
           "k9": lambda: tip5_mxu.tip5_permute_mma(x, *tables)}
    out = {k: {"ms": [], "wall_ms": []} for k in fns}
    for name in ("k1", "k9", "k9", "k1"):
        out[name]["ms"].append(cuda_ms(fns[name], 10))
        out[name]["wall_ms"].append(wall_ms(fns[name], 10))
    return out


def phase_tip5_mxu(tables, stats) -> dict:
    """K9 and the entry points of ops/tip5_mxu.py and ops/tip5_packed.py.

    K9 against its plain twin on the card and against K1, at 2^16 and
    2^22 states, at a batch that is not a multiple of 32 and at the warp
    tile's edges, inputs with edge words; its SASS a permutation by class
    beside K1's (``stats``, ``tip5_probe.kernel_stats``); then the path,
    once, with the counters at 0:
    ``permutation`` on the 2^22 states' limb planes, ``permutation_dense``
    on their lane-dense planes, ``permutation_values`` on 2^16 host states,
    ``commit_states_packed`` over the step's 2^22 leaf states (SLICE_ROOT)
    and ``reduce_layers_packed`` over 2^20 digests to their root (K9 and
    K2's two launches); then K1 and K9 in turns at 2^16 and 2^22."""
    from twenty_first_tpu_torch.math import gf
    from twenty_first_tpu_torch.ops import (tip5_commit, tip5_cuda, tip5_mxu,
                                            tip5_packed)
    from twenty_first_tpu_torch.probes import tip5_probe

    rng = np.random.default_rng(MXU_SEED)
    small_n, big_n = MXU_STATES
    inputs = {n: edge_field(rng, (n, 16))
              for n in (*MXU_STATES, MXU_RAGGED, *MXU_EDGES)}
    inputs[small_n][0] = gf.from_u64(snapshot_state())[0].cuda()
    k1_out, err = {}, 0.0
    for n, x in inputs.items():
        got = tip5_mxu.tip5_permute_mma(x, *tables)
        err = max(err, require_equal(
            f"K9 at {n} states vs its twin", got,
            tip5_mxu.tip5_permute_mma_plain(x, *tables)))
        k1_out[n] = tip5_cuda.tip5_permute(x, *tables)
        require_equal(f"K9 at {n} states vs K1", got, k1_out[n])
    require_snapshot("K9", k1_out[small_n])
    big, small = inputs[big_n], inputs[small_n]
    blo, bhi = gf.limbs_of(big)
    dense_in = (tip5_mxu._interleave(blo), tip5_mxu._interleave(bhi))
    host = gf.to_u64(small)
    leaf_states = slice_leaf_states()
    slo, shi = gf.limbs_of(leaf_states)
    digests = random_field(rng, (PACKED_DIGESTS, 5))
    layers = PACKED_DIGESTS.bit_length() - 1

    def path():
        return {"permutation": tip5_mxu.permutation(blo, bhi),
                "dense": tip5_mxu.permutation_dense(dense_in),
                "values": tip5_mxu.permutation_values(host),
                "commit": tip5_packed.commit_states_packed(
                    slo, shi, (N * E).bit_length() - 1),
                "reduce": tip5_packed.reduce_layers_packed(
                    gf.limbs_of(digests), layers)}

    got, launches = run_path((tip5_mxu.tip5_permute_mma,
                              tip5_cuda.merkle_level,
                              tip5_cuda.merkle_commit), path)
    require_launched("tip5_mxu", launches)
    require_equal("tip5_mxu.permutation vs K1",
                  gf.carrier_of(got["permutation"]), k1_out[big_n])
    for plane, want in zip(got["dense"], dense_in):
        if plane.shape != want.shape or plane.dtype != torch.uint32:
            raise AssertionError(f"permutation_dense gave {plane.shape} "
                                 f"{plane.dtype}")
    require_equal("permutation_dense vs K1, de-interleaved",
                  tip5_mxu._deinterleave(gf.carrier_of(got["dense"])),
                  k1_out[big_n])
    require_equal("the lane interleave round trip",
                  tip5_mxu._deinterleave(gf.carrier_of(dense_in)), big)
    if not np.array_equal(got["values"], gf.to_u64(k1_out[small_n])):
        raise AssertionError("permutation_values != K1 on the host states")
    root = gf.from_limbs(got["commit"])
    if root.shape != (1, 5) or root[0].tolist() != SLICE_ROOT:
        raise AssertionError(f"commit_states_packed root {root.tolist()} "
                             f"!= SLICE_ROOT")
    require_equal("reduce_layers_packed vs K2's reduce_layers",
                  gf.carrier_of(got["reduce"]),
                  tip5_commit.reduce_layers(digests, layers))
    turns = {n: k1_k9_in_turns(inputs[n], tables) for n in MXU_STATES}
    plain_ms = cuda_ms(lambda: tip5_mxu.tip5_permute_mma_plain(big, *tables),
                       3)
    block, blocks = tip5_mxu.occupancy()
    by_size = {n: {"ms": statistics.mean(t["k9"]["ms"]),
                   "wall_ms": statistics.mean(t["k9"]["wall_ms"]),
                   "k1_ms": statistics.mean(t["k1"]["ms"]),
                   "k1_wall_ms": statistics.mean(t["k1"]["wall_ms"]),
                   "turns": t, "bound": k9_bound(n),
                   "k1_bound": tip5_bound(2 * 128 * n, n)}
               for n, t in turns.items()}
    sass = {name: {k: stats.get(kernel, {}).get(k, "not measured")
                   for k in tip5_probe.CLASSES}
            for name, kernel in (("k9", "tip5_permute_mma"),
                                 ("k1", "tip5_permute"))}
    emit("tip5_mxu", launches=launches, states=list(MXU_STATES),
         ragged=MXU_RAGGED, edges=list(MXU_EDGES), sass_by_class=sass,
         packed_digests=PACKED_DIGESTS,
         commit_root=SLICE_ROOT, k9_over_k1={
             n: v["ms"] / v["k1_ms"] for n, v in by_size.items()},
         by_size=by_size, plain_ms=plain_ms,
         resident_warps_per_sm=blocks * block // 32)
    return {"launches": launches, "max_abs_err": err,
            "ms": by_size[big_n]["ms"], "wall_ms": by_size[big_n]["wall_ms"],
            "plain_ms": plain_ms, **k9_bound(big_n),
            "by_size": {n: {k: v[k] for k in ("ms", "wall_ms", "k1_ms",
                                               "k1_wall_ms")}
                        for n, v in by_size.items()},
            "resident_warps_per_sm": blocks * block // 32,
            "sass_by_class": sass}


#: the polynomial phase's inputs: np.random.default_rng(POLY_SEED)
POLY_SEED = 10
#: the polynomial batch path's widths: the flagship trace (W x N), bench.py's
#: out-of-domain shape (one 2^18 codeword to 2^10 points), 16 xfe points,
#: the convolutions' lengths
POLY_BENCH_N, POLY_BENCH_POINTS = 1 << 18, 1 << 10
POLY_XFE_POINTS = 16
CONV_N, CONV_XFE_N = 1 << 22, 1 << 20
# least 32x32 -> 64-bit products a known algorithm needs for one K6 term
# (coefficient x point power): Horner's product with a base point; with an
# xfe point and base coefficients, the division of the coefficients by the
# point's cubic minimal polynomial (three a coefficient); with xfe
# coefficients, Horner with Karatsuba's six-product xfe product
FOLD_PRODUCTS = {(False, False): 1, (True, False): 3, (True, True): 6}
# the fixed addition chain for x^(p-2): 63 squarings and 9 products
INVERSE_SQUARES, INVERSE_PRODUCTS = 63, 9
# device ms of K6 (one reduction a term), K8's inverse (the chain on
# canonical products), K7 (three launches reading x twice, one inversion a
# row) and K5 (mul_lazy k = 112 at 2^22 in the C forms) before their
# redesign, at the shapes timed below, on an H100 80GB HBM3 at 700 W
# (PERF.md section 6 names the runs); printed beside this run's times in
# the kernels' phase lines, and in no other line
BEFORE_MS = {"k6": 0.50674, "k6_base_coeffs": 2.0735,
             "k6_xfe_coeffs": 0.67040, "k8_inv": 0.48976, "k7": 0.032368,
             "k7_rows_8": 0.14938, "k5": 0.66418}


def fold_bound(rows: int, n: int, m: int, xpts: bool, xcoef: bool) -> dict:
    comps = 3 if xpts else 1
    nbytes = 8 * (rows * n * (3 if xcoef else 1) + m * comps
                  + rows * m * comps)
    return bound(nbytes, IMAD_PER_MUL * FOLD_PRODUCTS[xpts, xcoef]
                 * rows * n * m)


def kernel_row(fn, plain, reps: int = 10, plain_reps: int = 3) -> dict:
    """A kernel call against its twin on the card: max_abs_err, device ms,
    host-inclusive wall_ms, the twin's device ms."""
    err = require_equal("kernel vs plain", fn(), plain())
    return {"max_abs_err": err, "ms": cuda_ms(fn, reps),
            "wall_ms": wall_ms(fn, reps), "plain_ms": cuda_ms(plain,
                                                               plain_reps)}


def phase_poly_batch(rng, counters) -> dict:
    """The polynomial batch path at full width, once with the launch
    counters at 0, against its plain twins; the pins; then K6-K8 alone at
    the path's shapes, and the path's end-to-end times."""
    from twenty_first_tpu_torch.math import gf, gf_ext, ntt, poly_batch
    from twenty_first_tpu_torch.math import gf_numpy as gfn
    from twenty_first_tpu_torch.ops import poly_cuda
    from twenty_first_tpu_torch.probes import inv_probe, timing

    codeword = edge_words(rng, (1, POLY_BENCH_N))
    points = np.unique(rng.integers(1, P, size=2 * POLY_BENCH_POINTS,
                                    dtype=np.uint64))[:POLY_BENCH_POINTS]
    trace = edge_words(rng, (W, N))
    trace_x = edge_words(rng, (2, N, 3))
    xpts = edge_words(rng, (POLY_XFE_POINTS, 3))
    z = int(rng.integers(1, P, dtype=np.uint64))
    mul_a = edge_words(rng, (W, N // 2))
    mul_b = edge_words(rng, (W, N // 2))
    conv_a, conv_b = edge_words(rng, CONV_N), edge_words(rng, CONV_N)
    conv_xa = edge_words(rng, (CONV_XFE_N, 3))
    conv_xb = edge_words(rng, (CONV_XFE_N, 3))
    table_values = edge_words(rng, CONV_N)
    inv_x = edge_words(rng, (W, N, 3))
    inv_x[inv_x == 0] = 1
    inv_x[3, N // 2] = 0  # a zero element: row 3's determinants hold a 0
    inv_dev = gf_ext.from_u64(inv_x).cuda()
    table = ntt.conv_table_prepare(table_values)
    # a base table under xfield=True, table_xfield=True: the table's own
    # field decides, as on the JAX package's host route
    base_table_x = ntt.conv_table_prepare(table_values[:CONV_XFE_N])

    def path(plain=False):
        ev = poly_batch.batch_coset_evaluate(trace, N * E, plain=plain)
        chunk = {"point_chunk": 4} if plain else {}
        return {
            "extrapolate": poly_batch.batch_coset_extrapolate(
                codeword, 7, points, plain=plain),
            "extrapolate_xfe": poly_batch.batch_coset_extrapolate_xfe(
                trace, 7, xpts, plain=plain, **chunk),
            "extrapolate_xfe_x": poly_batch.batch_coset_extrapolate_xfe(
                trace_x, 7, xpts, plain=plain, **chunk),
            "barycentric": poly_batch.batch_evaluate_barycentric(
                trace, z, plain=plain),
            "evaluate": ev,
            "interpolate": poly_batch.batch_coset_interpolate(ev,
                                                              plain=plain),
            "multiply": poly_batch.batch_multiply(mul_a, mul_b, plain=plain),
            **{f"conv_divide={d}": ntt.conv_values(conv_a, conv_b, divide=d,
                                                   plain=plain)
               for d in (False, True)},
            **{f"conv_xfe_divide={d}": ntt.conv_values(
                conv_xa, conv_xb, xfield=True, divide=d, plain=plain)
               for d in (False, True)},
            "conv_table": ntt.conv_table_values(conv_a, table, plain=plain),
            "conv_table_base_on_xfe": ntt.conv_table_values(
                conv_xa, base_table_x, xfield=True, table_xfield=True,
                plain=plain),
            "xfe_batch_inversion": gf_ext.to_u64(gf_ext.batch_inversion(
                inv_dev, plain=plain)),
        }

    got, launches = run_path(counters, path)
    require_launched("poly_batch", launches)
    want = path(plain=True)
    for name in got:
        if not np.array_equal(got[name], want[name]) or \
                got[name].shape != want[name].shape:
            raise AssertionError(f"poly_batch {name}: kernels != plain twins")
    if (not np.array_equal(got["interpolate"][:, :N], trace)
            or got["interpolate"][:, N:].any()):
        raise AssertionError("interpolate(evaluate(x)) is not x")
    if got["xfe_batch_inversion"][3].any():
        raise AssertionError("a row holding a 0 did not invert to zeros")
    # the pins, through the kernels
    for name, (cw, pts) in extrapolate_pin_inputs().items():
        fn = (poly_batch.batch_coset_extrapolate if name == "base"
              else poly_batch.batch_coset_extrapolate_xfe)
        if pin_of(fn(cw, 7, pts)) != tuple(PINNED_EXTRAPOLATE[name]):
            raise AssertionError(f"extrapolation misses the JAX pin {name}")

    # K6 at forced segment lengths (one segment a lane up to one a row,
    # segments shorter than a block) and at lengths below a block; K7 at
    # n = 1 and around a segment, with more rows than a grid's y, and with
    # zeros in one segment, in a row's last part segment only, and in two
    # segments;
    # K8's broadcasts and its inverse at odd lengths and at length 1, each
    # against its twin
    checked = 0
    for rows, n, m, xp, xc in ((3, 1 << 10, 64, False, False),
                               (2, 1 << 10, 5, True, False),
                               (2, 1 << 8, 33, True, True),
                               (2, 8, 33, False, False), (1, 1, 3, True, False),
                               (2, 4, 7, True, True)):
        b = edge_field(rng, (rows, 3, n) if xc else (rows, n))
        w = edge_field(rng, (m, 3) if xp else (m,))
        want_fold = poly_cuda.coset_extrapolate_fold_plain(b, w)
        for seg in (None, 0, 3, 10):
            require_equal(f"K6 {(rows, n, m, xp, xc)} seg_log2={seg}",
                          poly_cuda.coset_extrapolate_fold(b, w,
                                                           seg_log2=seg),
                          want_fold)
            checked += 1
    seg = poly_cuda.INV_SEGMENT
    for rows, n, zeros in ((2, 1, ((1, 0),)), (1, 2049, ((0, 1024),)),
                           (70000, 3, ((69999, 1),)),
                           (3, 5000, ((2, 2500),)),
                           (2, 2047, ((1, 2046),)), (2, 2048, ((0, 0),)),
                           (2, seg - 1, ((1, 5),)), (2, seg, ((1, seg - 1),)),
                           (3, seg + 1, ((1, seg),)),
                           (3, 2 * seg + 5, ((1, 2 * seg + 4),)),
                           (3, 3 * seg, ((0, 7), (0, 2 * seg + 9))),
                           (4, 2049, ())):
        x = edge_field(rng, (rows, n))
        x[x == 0] = 1
        for r, j in zeros:
            x[r, j] = 0
        require_equal(f"K7 ({rows}, {n}) zeros at {zeros}",
                      poly_cuda.batch_inversion(x),
                      poly_cuda.batch_inversion_plain(x))
        checked += 1
    for op, sa, sb in (("mul", (3, 5, 100), (5, 100)), ("mul", (7, 1), (1,)),
                       ("xmul", (2, 3, 100), (3, 100)),
                       ("xmul_base", (4, 3, 77), (77,)),
                       ("inv", (3, 100), None), ("inv", (3, 513), None),
                       ("inv", (1,), None), ("inv", (len(K3_EDGES),), None)):
        a = edge_field(rng, sa)
        if sa == (len(K3_EDGES),):
            a = gf.from_u64(np.array(K3_EDGES, dtype=np.uint64)).cuda()
        b = None if sb is None else edge_field(rng, sb)
        require_equal(f"K8 {op} {sa} x {sb}", poly_cuda.gf_pointwise(a, b, op),
                      poly_cuda.gf_pointwise_plain(a, b, op))
        checked += 1

    # K6-K8 alone at the path's shapes, on device tensors
    cw_dev = gf.from_u64(codeword).cuda()
    bench_b = ntt.intt(cw_dev)
    bench_w = gf.from_u64(gfn.mul(points, np.uint64(pow(7, P - 2, P)))).cuda()
    k6 = {**kernel_row(lambda: poly_cuda.coset_extrapolate_fold(bench_b,
                                                                bench_w),
                       lambda: poly_cuda.coset_extrapolate_fold_plain(
                           bench_b, bench_w)),
          **fold_bound(1, POLY_BENCH_N, POLY_BENCH_POINTS, False, False),
          "shape": [1, POLY_BENCH_N, POLY_BENCH_POINTS],
          "plan": poly_cuda.fold_plan(1, POLY_BENCH_N, POLY_BENCH_POINTS)}
    k6_before = {"ms": BEFORE_MS["k6"]}
    xw = gf.from_u64(xpts).cuda()
    stark = {}
    for label, x in (("base_coeffs", gf.from_u64(trace).cuda()),
                     ("xfe_coeffs", gf_ext.from_u64(trace_x).cuda())):
        b = ntt.intt(x)
        xcoef = b.dim() == 3
        stark[label] = {
            **kernel_row(lambda: poly_cuda.coset_extrapolate_fold(b, xw),
                         lambda: poly_cuda.coset_extrapolate_fold_plain(
                             b, xw, point_chunk=4), reps=5, plain_reps=1),
            **fold_bound(b.shape[0], N, POLY_XFE_POINTS, True, xcoef),
            "shape": list(b.shape) + [POLY_XFE_POINTS],
            "plan": poly_cuda.fold_plan(b.shape[0], N, POLY_XFE_POINTS,
                                        xpts=True, xcoef=xcoef)}
        k6_before[label] = BEFORE_MS[f"k6_{label}"]
    k6["stark_shapes"] = stark
    dets = edge_field(rng, (W, N))
    dets[dets == 0] = 1
    dets[3, 7] = 0
    k7 = {**kernel_row(lambda: poly_cuda.batch_inversion(dets[:1]),
                       lambda: poly_cuda.batch_inversion_plain(dets[:1])),
          **bound(16 * N, IMAD_PER_MUL * 3 * N), "shape": [1, N],
          "by_launch": inv_probe.launch_profile(
              lambda: poly_cuda.batch_inversion(dets[:1]))}
    k7["rows_8"] = {**kernel_row(lambda: poly_cuda.batch_inversion(dets),
                                 lambda: poly_cuda.batch_inversion_plain(dets)),
                    **bound(16 * W * N, IMAD_PER_MUL * 3 * W * N),
                    "shape": [W, N],
                    "by_launch": inv_probe.launch_profile(
                        lambda: poly_cuda.batch_inversion(dets))}
    a8 = edge_field(rng, (W, N * E))
    b8 = edge_field(rng, (W, N * E))
    pw = poly_cuda.gf_pointwise
    k8 = {**kernel_row(lambda: pw(a8, b8, "mul"),
                       lambda: poly_cuda.gf_pointwise_plain(a8, b8, "mul")),
          **bound(24 * W * N * E, IMAD_PER_MUL * W * N * E),
          "op": "mul", "shape": [W, N * E]}
    inv_in = a8[0]
    k8["inv"] = {**kernel_row(lambda: pw(inv_in, None, "inv"),
                              lambda: poly_cuda.gf_pointwise_plain(
                                  inv_in, None, "inv"), plain_reps=1),
                 **bound(16 * N * E, (IMAD_PER_SQUARE * INVERSE_SQUARES
                                      + IMAD_PER_MUL * INVERSE_PRODUCTS)
                         * N * E),
                 "shape": [N * E]}
    xa, xb = a8[:6].reshape(2, 3, -1), b8[:6].reshape(2, 3, -1)
    k8["xmul"] = {**kernel_row(lambda: pw(xa, xb, "xmul"),
                               lambda: poly_cuda.gf_pointwise_plain(
                                   xa, xb, "xmul")),
                  **bound(8 * 3 * xa.numel(),
                          IMAD_PER_MUL * 6 * xa.numel() // 3),
                  "shape": list(xa.shape)}
    del a8, b8, xa, xb

    # the path's end to end: bench.py's extrapolation and the 2^22
    # convolution, numpy in and out (host median), their device cores
    # (device ms) and the core's profile
    def extrapolate():
        return poly_batch.batch_coset_extrapolate(codeword, 7, points)

    def extrapolate_core():
        return poly_cuda.coset_extrapolate_fold(ntt.intt(cw_dev), bench_w)

    ca, cb = gf.from_u64(conv_a).cuda(), gf.from_u64(conv_b).cuda()

    def conv_core():
        return ntt.intt(pw(ntt.ntt(ca), ntt.ntt(cb), "mul"))

    ext_times = sorted(timing.wall_times(extrapolate, 11))
    conv_times = sorted(timing.wall_times(
        lambda: ntt.conv_values(conv_a, conv_b), 11))
    ends = {"extrapolate_2^18_to_2^10": {
                "host_ms": statistics.median(ext_times),
                "host_ms_min": ext_times[0], "host_ms_max": ext_times[-1],
                "device_ms": cuda_ms(extrapolate_core, 11),
                "plain_host_ms": wall_ms(lambda: poly_batch
                                         .batch_coset_extrapolate(
                                             codeword, 7, points, plain=True),
                                         3)},
            "conv_2^22": {
                "host_ms": statistics.median(conv_times),
                "host_ms_min": conv_times[0], "host_ms_max": conv_times[-1],
                "device_ms": cuda_ms(conv_core, 11),
                "plain_host_ms": wall_ms(lambda: ntt.conv_values(
                    conv_a, conv_b, plain=True), 3)}}
    emit("poly_batch", launches=launches, outputs=sorted(got),
         pinned=sorted(PINNED_EXTRAPOLATE), kernel_cases=checked,
         end_to_end=ends,
         k6_ms=k6["ms"], k7_ms=k7["ms"], k8_ms=k8["ms"],
         profile_conv=device_breakdown(conv_core),
         profile_extrapolate=device_breakdown(extrapolate_core))
    for name, wrapper, row, before in (
            ("k6_coset_extrapolate_fold", "coset_extrapolate_fold", k6,
             k6_before),
            ("k7_batch_inversion", "batch_inversion", k7,
             {"ms": BEFORE_MS["k7"], "rows_8_ms": BEFORE_MS["k7_rows_8"]}),
            ("k8_gf_pointwise", "gf_pointwise", k8,
             {"inv_ms": BEFORE_MS["k8_inv"]})):
        emit(name, launches_on_path=launches[wrapper], **row,
             before_redesign=before)
    return {"launches": launches, "k6": k6, "k7": k7, "k8": k8}


# ---------------------------------------------------------------------------
# the polynomial engine (math/polynomial.py) through its object API
# ---------------------------------------------------------------------------

EXTRAPOLATE_KNOB = "TWENTY_FIRST_TPU_EXTRAPOLATE_DEVICE"
#: the crossover sweep: one-shot transforms, convolutions and batch
#: inversions of 2^8 .. 2^22 elements; batched row products of rows of
#: 2^(k+1) + 1 coefficients (the product tree's levels over leafs of 2^k
#: points), 2^(k+2) elements a padded row, at 2^9 .. 2^22 elements a level
SWEEP_LOG2 = range(8, 23)
ROWS_SWEEP = ((4, (9, 10, 11, 12, 14, 18, 22)), (7, (10, 11, 12, 14, 18, 22)),
              (10, (12, 13, 14, 18, 22)))


@contextlib.contextmanager
def polynomial_routes(limit: int, knob: str, device=None):
    """The polynomial engine with every crossover (``ntt.HOST_NTT_MAX_ELEMS``,
    ``HOST_CONV_MAX_ELEMS``, ``polynomial.HOST_INVERSE_MAX_ELEMS``) at
    ``limit``, the extrapolation knob at ``knob`` and ``ntt.DEVICE`` at
    ``device`` (unchanged if None): 0 and "1" send all of its work to the
    device, ``sys.maxsize`` and "0" keep it on the host."""
    from twenty_first_tpu_torch.math import ntt, polynomial

    saved = (ntt.DEVICE, ntt.HOST_NTT_MAX_ELEMS, ntt.HOST_CONV_MAX_ELEMS,
             polynomial.HOST_INVERSE_MAX_ELEMS)
    old_knob = os.environ.get(EXTRAPOLATE_KNOB)
    ntt.DEVICE = device or ntt.DEVICE
    ntt.HOST_NTT_MAX_ELEMS = ntt.HOST_CONV_MAX_ELEMS = limit
    polynomial.HOST_INVERSE_MAX_ELEMS = limit
    os.environ[EXTRAPOLATE_KNOB] = knob
    try:
        yield
    finally:
        (ntt.DEVICE, ntt.HOST_NTT_MAX_ELEMS, ntt.HOST_CONV_MAX_ELEMS,
         polynomial.HOST_INVERSE_MAX_ELEMS) = saved
        os.environ.pop(EXTRAPOLATE_KNOB, None)
        if old_knob is not None:
            os.environ[EXTRAPOLATE_KNOB] = old_knob


def card_routes(device=None):
    """All of the polynomial engine's work on ``device`` (ntt.DEVICE, the
    card, if None)."""
    return polynomial_routes(0, "1", device)


def host_routes():
    """All of the polynomial engine's work on the host."""
    return polynomial_routes(sys.maxsize, "0")


def polynomial_pin_results(k) -> list:
    """Results of the polynomial engine at about 2^12 through package
    ``k``'s object API (a namespace with ``Polynomial``, ``mod``, the
    polynomial module, ``bfe`` and ``xfe``), inputs from
    np.random.default_rng(12): products, clean division, a zerofier,
    multipoint evaluation, interpolation, the coset transforms, modular
    coset interpolation, three extrapolations, reduction, a power-series
    inverse, barycentric evaluation."""
    rng = np.random.default_rng(12)

    def r(shape):
        return rng.integers(0, P, size=shape, dtype=np.uint64)

    poly = k.Polynomial
    a, b = poly.from_array(r(1 << 12)), poly.from_array(r(1 << 12))
    ax = poly.from_array(r((1 << 10, 3)), True)
    pts = np.unique(r(1 << 10))[:1 << 9]
    z = poly.zerofier(pts[:64])
    cw = r(1 << 12)
    xpt = k.xfe(tuple(int(v) for v in r(3)))
    dom = np.unique(r(1 << 11))[:1 << 10]
    return [a.fast_multiply(b), ax * b, (a * z).clean_divide(z),
            poly.zerofier(pts), a.batch_evaluate(pts),
            poly.batch_fast_interpolate(dom, [r(1 << 10)])[0],
            a.fast_coset_evaluate(k.bfe(7), 1 << 13),
            poly.fast_coset_interpolate(k.bfe(7), cw),
            poly.fast_modular_coset_interpolate(cw, k.bfe(7), z),
            poly.coset_extrapolate(k.bfe(7), cw, pts[:64]),
            poly.coset_extrapolate(k.bfe(7), cw, [xpt]),
            poly.batch_coset_extrapolate(k.bfe(7), 1 << 10, cw, pts[:16]),
            a.reduce(z), a.formal_power_series_inverse_newton(1 << 10),
            k.mod.barycentric_evaluate(cw, xpt)]


def words(v) -> np.ndarray:
    """A result of either package's polynomial engine as uint64 words:
    a Polynomial's or FieldElements' array, an element's coefficients, a
    list's elements in turn."""
    if hasattr(v, "to_array"):
        return np.asarray(v.to_array(), dtype=np.uint64).reshape(-1)
    if hasattr(v, "coefficients"):
        return np.array([c.value() for c in v.coefficients], dtype=np.uint64)
    if hasattr(v, "value"):
        return np.array([v.value()], dtype=np.uint64)
    return np.array([w for e in v for w in words(e).tolist()],
                    dtype=np.uint64)


def polynomial_pin(k) -> str:
    """sha256 over polynomial_pin_results(k), each result's word count
    and words, little-endian."""
    h = hashlib.sha256()
    for v in polynomial_pin_results(k):
        w = np.ascontiguousarray(words(v), dtype="<u8")
        h.update(len(w).to_bytes(8, "little"))
        h.update(w.tobytes())
    return h.hexdigest()


def port_namespace():
    """The port's side of polynomial_pin_results."""
    from types import SimpleNamespace

    from twenty_first_tpu_torch.math import polynomial
    from twenty_first_tpu_torch.math.b_field_element import bfe
    from twenty_first_tpu_torch.math.x_field_element import xfe

    return SimpleNamespace(Polynomial=polynomial.Polynomial, mod=polynomial,
                           bfe=bfe, xfe=xfe)


def require_words(what: str, got, want) -> None:
    g, w = words(got), words(want)
    if g.shape != w.shape or not np.array_equal(g, w):
        raise AssertionError(f"polynomial {what}: the card's routes and the "
                             f"host's differ")


def phase_polynomial_sweep(rng) -> dict:
    """Host wall time against the card's, numpy in and out, of one-shot
    transforms, convolutions, batched row products and batch inversions;
    the measured cuts beside the chosen ones."""
    from twenty_first_tpu_torch import native
    from twenty_first_tpu_torch.math import ntt, polynomial
    from twenty_first_tpu_torch.probes import timing

    rows = {"ntt": ({}, {}), "conv": ({}, {}), "inverse": ({}, {})}
    for log_n in SWEEP_LOG2:
        n = 1 << log_n
        x, y = (rng.integers(0, P, size=n, dtype=np.uint64) for _ in "xy")
        inv = np.where(x == 0, np.uint64(1), x)
        for name, host, card in (
                ("ntt", lambda: ntt.ntt_host(x),
                 lambda: ntt.ntt_values(x, device=ntt.DEVICE)),
                ("conv", lambda: ntt._conv_host(x, y, False, False),
                 lambda: ntt.conv_values(x, y, device=ntt.DEVICE)),
                ("inverse", lambda: native.batch_inverse(inv),
                 lambda: polynomial._finv_device(inv, False))):
            rows[name][0][n] = statistics.median(timing.wall_times(host, 5))
            rows[name][1][n] = statistics.median(timing.wall_times(card, 5))
    for k, logs in ROWS_SWEEP:
        size = 1 << (k + 2)
        row_host, row_card = {}, {}
        for log_total in logs:
            m = (1 << log_total) // size
            a = rng.integers(0, P, size=(m, (1 << (k + 1)) + 1),
                             dtype=np.uint64)
            b = rng.integers(0, P, size=a.shape, dtype=np.uint64)

            def mul_rows():
                return polynomial.Polynomial._mul_rows(a, b, False)

            with host_routes():
                host = statistics.median(timing.wall_times(mul_rows, 3))
                want = mul_rows()
            with card_routes():
                card = statistics.median(timing.wall_times(mul_rows, 3))
                if not np.array_equal(mul_rows(), want):
                    raise AssertionError(f"_mul_rows ({m}, {a.shape[1]}): "
                                         "the card's and the host's differ")
            row_host[m * size], row_card[m * size] = host, card
        rows[f"rows_of_{(1 << (k + 1)) + 1}"] = (row_host, row_card)
    return {"ms": {name: {"host_ms": {f"2^{n.bit_length() - 1}": v
                                      for n, v in h.items()},
                          "card_ms": {f"2^{n.bit_length() - 1}": v
                                      for n, v in c.items()},
                          "host_up_to": timing.crossover(h, c)}
                   for name, (h, c) in rows.items()},
            "chosen": {"HOST_NTT_MAX_ELEMS": ntt.HOST_NTT_MAX_ELEMS,
                       "HOST_CONV_MAX_ELEMS": ntt.HOST_CONV_MAX_ELEMS,
                       "HOST_INVERSE_MAX_ELEMS":
                           polynomial.HOST_INVERSE_MAX_ELEMS,
                       "_mul_rows": "the card above HOST_CONV_MAX_ELEMS "
                                    "elements a level (m rows x the padded "
                                    "product length)"}}


def phase_polynomial(counters) -> dict:
    """The polynomial engine's object API at the shapes of bench.py:584-706
    (benches/*.rs) and the flagship step's prover width, once with the
    launch counters at 0 on its default routes; every result against the
    same call on the host alone and by an independent check; the pin; each
    operation's host median and device time; the crossover sweep."""
    from twenty_first_tpu_torch import native
    from twenty_first_tpu_torch.math import ntt, poly_batch, polynomial
    from twenty_first_tpu_torch.math.b_field_element import bfe
    from twenty_first_tpu_torch.probes import timing

    if not native.available():
        raise AssertionError("polynomial: the native host core did not load")
    poly = polynomial.Polynomial
    rng = np.random.default_rng(POLY_SEED)

    def r(shape):
        return rng.integers(0, P, size=shape, dtype=np.uint64)

    def distinct(n):
        return np.unique(rng.integers(1, P, size=2 * n, dtype=np.uint64))[:n]

    def from_array(arr):
        return poly.from_array(arr, arr.ndim == 2)

    m14 = [from_array(r(1 << 14)) for _ in "ab"]
    m20 = [from_array(r(N)) for _ in "ab"]
    c20 = from_array(r(N))
    z9, z10 = poly.zerofier(distinct(1 << 9)), poly.zerofier(distinct(1 << 10))
    q12, q20 = from_array(r(1 << 12)), from_array(r(N))
    with host_routes():
        d9, d10 = q12 * z9, q20 * z10
    pts14, pts14e = distinct(1 << 14), distinct(1 << 14)
    e14 = from_array(r(1 << 14))
    pts15, vals15 = distinct(1 << 15), r(1 << 15)
    cw16, mod9 = r(1 << 16), from_array(r((1 << 9) + 1))
    cw18, pts10 = r(POLY_BENCH_N), distinct(POLY_BENCH_POINTS)
    # xfe points as elements: the host route's zerofier tree keeps slices
    # of the points as they are given
    cw8 = r(8 * N)
    xpts16 = [port_namespace().xfe(tuple(int(v) for v in row))
              for row in r((POLY_XFE_POINTS, 3))]
    r14, f10 = from_array(r(1 << 14)), from_array(r(1 << 10))
    cw22 = r(N * E)
    xz = port_namespace().xfe(tuple(int(v) for v in r(3)))
    seven = bfe(7)
    ops = {
        "fast_multiply_deg_2^14-1": lambda: m14[0].fast_multiply(m14[1]),
        "fast_multiply_deg_2^20-1": lambda: m20[0].fast_multiply(m20[1]),
        "fast_coset_evaluate_2^20_on_2^22": lambda: c20.fast_coset_evaluate(
            seven, N * E),
        "clean_divide_2^12_by_zerofier_2^9": lambda: d9.clean_divide(z9),
        "clean_divide_2^20_by_zerofier_2^10": lambda: d10.clean_divide(z10),
        "zerofier_2^14": lambda: poly.zerofier(pts14),
        "batch_evaluate_2^14_on_2^14": lambda: e14.batch_evaluate(pts14e),
        "fast_interpolate_2^15": lambda: poly.fast_interpolate(pts15, vals15),
        "fast_modular_coset_interpolate_2^16_mod_2^9":
            lambda: poly.fast_modular_coset_interpolate(cw16, seven, mod9),
        "coset_extrapolate_2^18_to_2^10": lambda: poly.coset_extrapolate(
            seven, cw18, pts10),
        "batch_coset_extrapolate_8x2^20_to_16_xfe":
            lambda: poly.batch_coset_extrapolate(seven, N, cw8, xpts16),
        "reduce_2^14_by_2^9": lambda: r14.reduce(mod9),
        "formal_power_series_inverse_newton_2^10":
            lambda: f10.formal_power_series_inverse_newton(1 << 10),
        "barycentric_evaluate_2^22_at_xfe":
            lambda: polynomial.barycentric_evaluate(cw22, xz),
    }
    evals = None

    def path():
        nonlocal evals
        out = {name: fn() for name, fn in ops.items()}
        evals = out["fast_coset_evaluate_2^20_on_2^22"]
        out["fast_coset_interpolate_2^22"] = poly.fast_coset_interpolate(
            seven, evals)
        return out

    got, launches = run_path(counters, path)
    require_launched("polynomial", launches)
    ops["fast_coset_interpolate_2^22"] = (
        lambda: poly.fast_coset_interpolate(seven, evals))

    # every result against the host alone (numpy and the native core); the
    # 8 codewords' extrapolation at 2^16 a codeword (on the host, each
    # codeword's reduction loops over 2^20 / 2^8 chunks in numpy: minutes),
    # its full width against poly_batch on the card below
    width = min(1 << 16, N)
    narrow = {"batch_coset_extrapolate_8x2^20_to_16_xfe":
              lambda: poly.batch_coset_extrapolate(seven, width,
                                                   cw8[:8 * width], xpts16)}
    host_only_ms = {}
    for name, fn in narrow.items():
        got[name + "_at_2^16"] = fn()
    with host_routes():
        for name, fn in ops.items():
            if name in narrow:
                name, fn = name + "_at_2^16", narrow[name]
            t0 = time.perf_counter()
            want = fn()
            host_only_ms[name] = (time.perf_counter() - t0) * 1e3
            require_words(name, got[name], want)
    xcw = poly_batch.batch_coset_extrapolate_xfe(
        cw8.reshape(8, N), 7, np.array([words(x) for x in xpts16]),
        device=ntt.DEVICE)
    if not np.array_equal(
            words(got["batch_coset_extrapolate_8x2^20_to_16_xfe"]),
            xcw.reshape(-1)):
        raise AssertionError("batch_coset_extrapolate != "
                             "batch_coset_extrapolate_xfe")
    # and by an independent check
    horner = native.horner_points
    z = int(r(()))
    for a, b, name in ((*m14, "fast_multiply_deg_2^14-1"),
                       (*m20, "fast_multiply_deg_2^20-1")):
        want = a.evaluate(bfe(z)) * b.evaluate(bfe(z))
        if got[name].evaluate(bfe(z)) != want:
            raise AssertionError(f"{name}: f(z) g(z) != (f g)(z)")
    if got["fast_coset_interpolate_2^22"] != c20:
        raise AssertionError("fast_coset_interpolate(fast_coset_evaluate(p)) "
                             "!= p")
    lde = poly_batch.batch_coset_evaluate(c20.to_array()[None], N * E,
                                          device=ntt.DEVICE)[0]
    if not np.array_equal(words(got["fast_coset_evaluate_2^20_on_2^22"]), lde):
        raise AssertionError("fast_coset_evaluate != batch_coset_evaluate")
    if got["clean_divide_2^12_by_zerofier_2^9"] != q12 or \
            got["clean_divide_2^20_by_zerofier_2^10"] != q20:
        raise AssertionError("clean_divide(q z, z) != q")
    zero = got["zerofier_2^14"]
    if zero.degree() != 1 << 14 or not zero.leading_coefficient().is_one() \
            or horner(zero.to_array(), pts14).any():
        raise AssertionError("the zerofier does not vanish on its points")
    if not np.array_equal(words(got["batch_evaluate_2^14_on_2^14"]),
                          horner(e14.to_array(), pts14e)):
        raise AssertionError("batch_evaluate != Horner")
    if not np.array_equal(horner(got["fast_interpolate_2^15"].to_array(),
                                 pts15), vals15):
        raise AssertionError("the interpolant misses its values")
    with host_routes():
        want_fmci = poly.fast_coset_interpolate(seven, cw16).reduce(mod9)
        want_ext = poly._naive_coset_extrapolate(seven, cw18, pts10)
    require_words("fast_modular_coset_interpolate", want_fmci,
                  got["fast_modular_coset_interpolate_2^16_mod_2^9"])
    require_words("coset_extrapolate vs _naive_coset_extrapolate", want_ext,
                  got["coset_extrapolate_2^18_to_2^10"])
    if not np.array_equal(words(got["coset_extrapolate_2^18_to_2^10"]),
                          poly_batch.batch_coset_extrapolate(
                              cw18[None], 7, pts10, device=ntt.DEVICE)[0]):
        raise AssertionError("coset_extrapolate != batch_coset_extrapolate")
    inv = got["formal_power_series_inverse_newton_2^10"]
    if not (f10 * inv).mod_x_to_the_n(1 << 10).is_one():
        raise AssertionError("f * f^-1 != 1 mod x^(2^10)")
    with card_routes():
        pin = polynomial_pin(port_namespace())
    if pin != PINNED_POLYNOMIAL:
        raise AssertionError(f"polynomial pin {pin} != {PINNED_POLYNOMIAL}")

    # device busy ms: the largest of three profiles. torch.profiler drops
    # device records of some of these calls (a dropped record only lowers
    # the sum), so each profile also counts its records of the port's
    # kernels against the wrappers' launches in one call: fewer records
    # than launches mark the time incomplete
    timed = {}
    for name, fn in ops.items():
        runs = timing.wall_times(fn, 3, warmup=0)
        for c in counters:
            c.launches = 0
        busy = [device_breakdown(fn) for _ in range(3)]
        launched = sum(c.launches for c in counters) // 6  # 2 calls each
        records = max(sum(k["calls"] for k in b["kernels"]
                          if any(o in k["name"] for o in OWN_KERNELS))
                      for b in busy)
        timed[name] = {"host_ms": statistics.median(runs),
                       "host_ms_runs": runs,
                       "device_ms": max(b["device_busy_ms"] for b in busy),
                       "device_ms_profiles": [b["device_busy_ms"]
                                              for b in busy],
                       "device_ms_complete": records >= launched,
                       "kernel_launches": launched,
                       "kernel_records": records,
                       "host_only_ms": host_only_ms.get(name)}
    sweep = phase_polynomial_sweep(rng)
    emit("polynomial", native_core=native.available(),
         native_library=native.library_path().name, launches=launches,
         pinned=PINNED_POLYNOMIAL, ops=timed,
         host_only_narrow_ms={n + "_at_2^16": host_only_ms[n + "_at_2^16"]
                              for n in narrow},
         sweep=sweep)
    return {"launches": launches, "ops": timed, "sweep": sweep}


# the host layers' path: hash_batch's objects and the sample held against
# the Python rounds, the batch of states InverseTip5 takes back through K1
HASH_BATCH_OBJECTS = 1 << 12
ORACLE_SAMPLE = 16
#: verify of MERKLE_QUERIES openings when the scalar Tip5 ran only its
#: pure-Python rounds (NVIDIA H100 80GB HBM3 host, 700.00 W card), the
#: yardstick of the native dispatch
VERIFY_MS_PYTHON_ROUNDS = 1037.5
INVERSE_STATES = 64


def codec_objects(rng, count: int, package: str = "twenty_first_tpu_torch"
                  ) -> list:
    """``count`` objects whose encodings take every codec type of
    ``math/bfield_codec.py`` in turn, from ``rng``: base and extension
    field elements, digests, u64 ints, bools, vectors of field elements
    and of digests, base and extension polynomials, a @bfield_codec struct
    (u32, i64, u128, i8, Option, tuple and array fields) and enum.
    ``package`` names the package whose types make them (the cuda-marked
    tests hash the same objects through the JAX package's)."""
    import importlib

    codec = importlib.import_module(f"{package}.math.bfield_codec")
    bfe = importlib.import_module(f"{package}.math.b_field_element").bfe
    xfe = importlib.import_module(f"{package}.math.x_field_element").xfe
    poly = importlib.import_module(f"{package}.math.polynomial").Polynomial
    digest = importlib.import_module(f"{package}.tip5.digest").Digest

    @codec.bfield_codec(fields=[
        ("a", codec.U32), ("b", codec.I64), ("c", codec.Opt(codec.XFE)),
        ("d", codec.Tup(codec.U8, codec.Vec_(codec.DIGEST))),
        ("e", codec.Arr(codec.BFE, 3)), ("f", codec.U128), ("g", codec.I8)])
    class Record:
        def __init__(self, **fields):
            self.__dict__.update(fields)

    @codec.bfield_codec(variants=[("Empty", []), ("Value", [("v", codec.U16)]),
                                  ("Flags", [("f", codec.Vec_(codec.BOOL))])])
    class Kind:
        def __init__(self, variant, **fields):
            self.variant = variant
            self.__dict__.update(fields)

    makers = [  # each from 12 random words w and a size k < 12
        lambda w, k: bfe(w[0]),
        lambda w, k: xfe(tuple(w[:3])),
        lambda w, k: digest(w[:5]),
        lambda w, k: w[1],
        lambda w, k: bool(w[2] & 1),
        lambda w, k: [bfe(v) for v in w[:1 + k]],
        lambda w, k: [digest(w[:5]), digest(w[5:10])][:1 + k % 2],
        lambda w, k: poly([bfe(v) for v in w[:k]]),
        lambda w, k: poly([xfe(tuple(w[j:j + 3])) for j in range(k % 4)]),
        lambda w, k: Record(a=w[0] & 0xFFFFFFFF, b=(w[1] >> 1) - (1 << 62),
                            c=None if k % 2 else xfe(w[2]),
                            d=(w[3] & 0xFF, [digest(w[4:9])][:k % 2]),
                            e=[bfe(v) for v in w[9:12]],
                            f=(w[0] << 64) | w[1], g=(w[2] & 0xFF) - 128),
        lambda w, k: [Kind("Empty"), Kind("Value", v=w[0] & 0xFFFF),
                      Kind("Flags", f=[bool(v & 1) for v in w[:k]])][k % 3],
    ]
    words = rng.integers(0, P, size=(count, 12), dtype=np.uint64)
    sizes = rng.integers(0, 12, size=count)
    return [makers[i % len(makers)]([int(v) for v in words[i]], int(sizes[i]))
            for i in range(count)]


@contextlib.contextmanager
def python_rounds():
    """The scalar Tip5's pure-Python rounds (its oracle) inside the block:
    the native core reported as unavailable."""
    from twenty_first_tpu_torch import native

    saved = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = saved


def phase_host_layers(counters) -> dict:
    """The host layers a prover and a verifier call: Tip5.hash and
    hash_batch of encodings of every codec type (K1), verify of 160
    openings on the native core, MerkleTree.new on both sides of
    HOST_MERKLE_MAX_LEAFS (K2 above it) with the crossover sweep
    (probes/merkle_probe.py), the lattice KEM, and InverseTip5 undoing K1
    on a batch."""
    from twenty_first_tpu_torch import native
    from twenty_first_tpu_torch.math import gf, lattice
    from twenty_first_tpu_torch.probes import merkle_probe
    from twenty_first_tpu_torch.tip5 import InverseTip5, Tip5, permutation
    from twenty_first_tpu_torch.util_types import merkle_tree
    from twenty_first_tpu_torch.util_types.merkle_tree import MerkleTree

    if not native.available():
        raise RuntimeError("the native host core did not load")
    rng = np.random.default_rng(11)
    objects = codec_objects(rng, HASH_BATCH_OBJECTS)
    cut = merkle_tree.HOST_MERKLE_MAX_LEAFS
    above = rng.integers(0, P, size=(2 * cut, 5), dtype=np.uint64)
    at_cut = above[:cut].copy()
    big = random_field(rng, (N * E, 5))
    states = random_field(rng, (INVERSE_STATES, 16))
    key_rand, enc_rand = (bytes(rng.integers(0, 256, 32, dtype=np.uint8))
                          for _ in "ke")
    indices = [int(i) for i in rng.integers(0, N * E, MERKLE_QUERIES)]

    def path():
        return {"hashes": Tip5.hash_batch(objects),
                "above": MerkleTree.new(above),
                "big": MerkleTree.new(big),
                "permuted": permutation.permutation(states)}

    got, launches = run_path(counters, path)
    require_launched("host_layers", launches)
    # hash_batch: each result the scalar hash's, a sample the oracle's
    scalar = [Tip5.hash(v) for v in objects]
    if got["hashes"] != scalar:
        bad = sum(a != b for a, b in zip(got["hashes"], scalar))
        raise AssertionError(f"hash_batch != scalar hash in {bad} of "
                             f"{len(objects)}")
    with python_rounds():
        oracle = [Tip5.hash(v) for v in objects[:ORACLE_SAMPLE]]
    if oracle != scalar[:ORACLE_SAMPLE]:
        raise AssertionError("the native scalar hash != the Python rounds")
    hash_batch_ms = wall_ms(lambda: Tip5.hash_batch(objects), 3)
    t0 = time.perf_counter()
    for v in objects:
        Tip5.hash(v)
    hash_host_ms = (time.perf_counter() - t0) * 1e3
    # the Merkle tree on both sides of the cut: the host route's root is
    # the native core's, K2's above the cut too
    below, counts = run_path(counters, lambda: MerkleTree.new(at_cut))
    if counts["merkle_level"] or below._nodes.device.type != "cuda":
        raise AssertionError(f"{cut} host leafs: {counts}, nodes on "
                             f"{below._nodes.device}")
    for tree, leafs in ((below, at_cut), (got["above"], above)):
        if tree.root() != MerkleTree.frugal_root(leafs) or \
                tree.root().to_array().tolist() != \
                native.tip5_merkle_root(leafs).tolist():
            raise AssertionError(f"Merkle root of {len(leafs)} leafs != the "
                                 "native core's")
    # verify of MERKLE_QUERIES openings: the partial tree on the card
    tree = got["big"]
    proof = tree.inclusion_proof_for_leaf_indices(indices)
    t0 = time.perf_counter()
    verified = proof.verify(tree.root())
    verify_ms = (time.perf_counter() - t0) * 1e3
    if not verified:
        raise AssertionError("verify refused an honest proof")
    # the lattice KEM
    t0 = time.perf_counter()
    sk, pk = lattice.keygen(key_rand)
    shared, ct = lattice.enc(pk, enc_rand)
    opened = lattice.dec(sk, ct)
    kem_ms = (time.perf_counter() - t0) * 1e3
    bad = ct.bg.elements.copy()
    bad[0, 0] ^= np.uint64(1)
    if opened != shared or lattice.dec(sk, lattice.Ciphertext(
            bg=lattice.ModuleElement(bad), bga_m=ct.bga_m)) is not None:
        raise AssertionError("the KEM's round trip or its refusal failed")
    # InverseTip5 takes K1's permutation back, state by state
    for row, out in zip(gf.to_u64(states).tolist(),
                        gf.to_u64(got["permuted"]).tolist()):
        inv = InverseTip5(out)
        inv.inv_permutation()
        if [e.value() for e in inv.state] != row:
            raise AssertionError("InverseTip5 does not undo K1")
    sweep = merkle_probe.sweep(rng)
    emit("host_layers", launches=launches, objects=len(objects),
         hash_batch_wall_ms=hash_batch_ms,
         hash_scalar_host_ms=hash_host_ms, oracle_sample=ORACLE_SAMPLE,
         verify_openings=MERKLE_QUERIES, verify_host_ms=verify_ms,
         verify_host_ms_python_rounds=VERIFY_MS_PYTHON_ROUNDS,
         merkle_cut=cut,
         merkle_below_k2_launches=counts["merkle_level"], kem_host_ms=kem_ms,
         inverse_states=INVERSE_STATES, merkle_sweep=sweep)
    return {"launches": launches, "sweep": sweep}


# the large NTT: full-output checks against the plain twin, three-pass
# times, and the largest length that fits the card beside its output
NTT_LARGE_CHECKED = (25, 28)
NTT_LARGE_TIMED = (25, 28, 30)
NTT_LARGE_TARGET = 32
RANDOM_CHUNK = 1 << 26


def random_chunks(n: int, seed: int):
    """(offset, chunk) pairs of n random canonical field words on the card
    from ``seed``, RANDOM_CHUNK at a time: the same words for the same n
    and seed, so a check can make them again instead of keeping a copy.
    The high word stays below 2^32 - 1, so every value is below p."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    for s in range(0, n, RANDOM_CHUNK):
        m = min(RANDOM_CHUNK, n - s)
        hi = torch.randint(0, (1 << 32) - 1, (m,), generator=g,
                           device="cuda", dtype=torch.int64)
        lo = torch.randint(0, 1 << 32, (m,), generator=g, device="cuda",
                           dtype=torch.int64)
        yield s, (hi << 32) | lo


def random_on_card(n: int, seed: int, out=None):
    x = torch.empty(n, dtype=torch.int64, device="cuda") if out is None \
        else out
    for s, chunk in random_chunks(n, seed):
        x[s:s + chunk.numel()] = chunk
    return x


def field_sum(v):
    """The field sum of a power-of-two number of carrier words, as a
    python int (plain torch, by halves)."""
    from twenty_first_tpu_torch.math import gf

    while v.numel() > 1:
        h = v.numel() // 2
        v = gf.add(v[:h], v[h:])
    return int(v[0]) & ((1 << 64) - 1)


def direct_ntt(x, ks, chunk: int = 1 << 24) -> list:
    """X[k] = sum_j x[j] w^(jk) of the (n,) carrier x for each k in ks,
    evaluated directly by chunks of x on the card."""
    from twenty_first_tpu_torch.math import gf, gf_numpy
    from twenty_first_tpu_torch.math.b_field_element import PRIMITIVE_ROOTS

    n = x.numel()
    chunk = min(chunk, n)
    out = []
    for k in ks:
        z = pow(PRIMITIVE_ROOTS[n], k, P)
        powers = gf.from_u64(gf_numpy.powers(z, chunk)).to(x.device)
        step, scale, acc = pow(z, chunk, P), 1, 0
        for s in range(0, n, chunk):
            acc = (acc + field_sum(gf.mul(x[s:s + chunk], powers)) * scale) % P
            scale = scale * step % P
        out.append(acc)
    return out


def ntt_bound(n: int) -> dict:
    """bound of the three-pass transform of n elements: three passes, each
    reading and writing n words; n/2 log n butterfly products and 3n
    twiddle products."""
    log_n = n.bit_length() - 1
    return bound(3 * 16 * n, IMAD_PER_MUL * (n // 2 * log_n + 3 * n))


def phase_ntt_large(counters) -> dict:
    """NTT lengths from 2^25 (three passes of K3): full outputs against the
    plain twin on the card at 2^25 and 2^28, device time and peak memory at
    2^25, 2^28 and 2^30, then the largest length that fits the card beside
    its output, 2^32 the target: a delta's transform (X[k] = w^k), a round
    trip, and a few outputs of random input evaluated directly."""
    from twenty_first_tpu_torch.math import gf, ntt
    from twenty_first_tpu_torch.math.b_field_element import PRIMITIVE_ROOTS

    n0 = 1 << NTT_LARGE_CHECKED[0]
    x0 = random_on_card(n0, 25)
    (y0, z0), launches = run_path(
        counters, lambda: (ntt.ntt(x0), ntt.intt(ntt.ntt(x0))))
    require_launched("ntt_large", launches)
    if launches["ntt_local_pass"] != 9:
        raise AssertionError(f"three transforms of 2^25 made {launches}")
    require_equal("intt(ntt(x)) 2^25", z0, x0)
    del x0, y0, z0
    checked = {}
    for log_n in NTT_LARGE_CHECKED:
        n = 1 << log_n
        x = random_on_card(n, log_n).view(1, n)
        y = ntt.ntt(x)
        checked[f"2^{log_n}"] = {
            "ntt": require_equal(f"ntt 2^{log_n}", y, ntt.ntt(x, plain=True)),
            "intt": require_equal(f"intt 2^{log_n}", ntt.intt(y),
                                  ntt.intt(y, plain=True))}
        del x, y
    timed = {}
    for log_n in NTT_LARGE_TIMED:
        n = 1 << log_n
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        x = random_on_card(n, log_n)
        y = torch.empty_like(x)
        ms = cuda_ms(lambda: ntt.ntt(x, out=y), 5)
        inv_ms = cuda_ms(lambda: ntt.intt(x, out=y), 5)
        timed[f"2^{log_n}"] = {
            "ms": ms, "intt_ms": inv_ms,
            "peak_bytes": torch.cuda.max_memory_allocated() - base,
            **ntt_bound(n)}
        del x, y
    # the largest length that fits: input, output and a check's chunks
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    fits = [k for k in range(NTT_LARGE_TARGET, NTT_LARGE_TIMED[-1], -1)
            if 2 * 8 * (1 << k) + (4 << 30) <= free]
    if not fits:
        raise AssertionError(f"no length above 2^{NTT_LARGE_TIMED[-1]} fits "
                             f"{free} free bytes")
    log_n = fits[0]
    n = 1 << log_n
    w = PRIMITIVE_ROOTS[n]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y = torch.empty(n, dtype=torch.int64, device="cuda")
    x = torch.zeros(n, dtype=torch.int64, device="cuda")
    x[1] = 1
    counts = run_path(counters, lambda: ntt.ntt(x, out=y))[1]
    del x
    if int(y[0]) != 1 or (int(y[-1]) & ((1 << 64) - 1)) * w % P != 1:
        raise AssertionError(f"ntt of a delta at 2^{log_n}: X[0] or X[n-1]")
    for s in range(0, n - 1, RANDOM_CHUNK):
        m = min(RANDOM_CHUNK, n - 1 - s)
        require_equal(f"delta 2^{log_n} X[k+1] = X[k] w from {s}",
                      y[s + 1:s + 1 + m], gf.mul_const(y[s:s + m], w))
    x = random_on_card(n, log_n)
    ms = cuda_ms(lambda: ntt.ntt(x, out=y), 3)
    ks = [0, 1, n // 2 + 12345, n - 1]
    direct = direct_ntt(x, ks)
    if direct != [int(y[k]) & ((1 << 64) - 1) for k in ks]:
        raise AssertionError(f"ntt 2^{log_n}: outputs {ks} != direct sums")
    ntt.intt(y, out=x)
    for s, chunk in random_chunks(n, log_n):
        require_equal(f"intt(ntt(x)) 2^{log_n} from {s}",
                      x[s:s + chunk.numel()], chunk)
    peak = torch.cuda.max_memory_allocated() - base
    del x, y
    torch.cuda.empty_cache()
    largest = {"log_n": log_n, "ms": ms, "peak_bytes": peak,
               "k3_launches_a_call": counts["ntt_local_pass"],
               "direct_indices": ks, **ntt_bound(n)}
    emit("ntt_large", launches=launches, checked=checked, timed=timed,
         largest=largest,
         left_out=[f"2^{k}" for k in range(NTT_LARGE_TARGET, log_n, -1)],
         free_bytes=free)
    return {"launches": launches,
            "three_pass": {k: timed[k] for k in ("2^25", "2^30")},
            "largest": largest}


# the distributed phase (parallel/): the NTT and the LDE commit at world 1
# over NCCL, the two-pass transform of columns and rows longer than one K3
# pass, the xfe planes; then DIST_GLOO_RANKS gloo ranks sharing the card
DIST_LOG_N, DIST_TWO_PASS_LOG_N, DIST_XFE_LOG_N = 24, 26, 22
DIST_GLOO_RANKS, DIST_GLOO_NTT_LOG_N, DIST_GLOO_LDE_LOG_N = 4, 22, 20
DIST_SEED = 12
# distributed_ntt_values of dist_pin_input(12) and dist_lde_commit_values
# of dist_pin_input(4) of the JAX reference (tests/test_torch_dist.py
# re-derives them)
PINNED_DIST = {
    "ntt_2^12": ([11680897939243291889, 10688625778695833481,
                  17465821650599573678],
                 "74e7f65a6c22cac439984cfb994eee203746f7a10903d745bd03ead257f5d6c9"),
    "lde_commit_2^4": [14066517630845631259, 2517194801082197725,
                       3002827495855957701, 16222024021622636485,
                       12980898472508654990],
}


def dist_pin_input(log_n: int) -> np.ndarray:
    return np.random.default_rng(1000 + log_n).integers(
        0, P, size=1 << log_n, dtype=np.uint64)


def dist_input(log_n: int) -> np.ndarray:
    return np.random.default_rng(DIST_SEED + log_n).integers(
        0, P, size=1 << log_n, dtype=np.uint64)


def dist_pins(mesh) -> dict:
    """PINNED_DIST's values on ``mesh``."""
    from twenty_first_tpu_torch.parallel import dist_ntt, pipeline

    return {"ntt_2^12": pin_of(dist_ntt.distributed_ntt_values(
                dist_pin_input(12), mesh)),
            "lde_commit_2^4": [int(v) for v in pipeline.dist_lde_commit_values(
                dist_pin_input(4), mesh).to_array()]}


def slice_leaf_digests():
    """The flagship step's (N * E, 5) leaf digests of SLICE_ROOT's trace."""
    from twenty_first_tpu_torch.parallel import pipeline

    step = pipeline.TraceLdeCommit(W, N, E)
    return step.leaf_digests(random_field(np.random.default_rng(2026), (W, N)))


def lde_commit_oracle(x) -> list:
    """The root of the distributed LDE commit of the carrier vector x (on
    the card) by the single-device composition: ``ntt``, the rows
    X[k2::n2], ``hash_varlen``, ``MerkleTree``."""
    from twenty_first_tpu_torch.math import gf, ntt
    from twenty_first_tpu_torch.parallel import dist_ntt
    from twenty_first_tpu_torch.tip5 import permutation as tip5
    from twenty_first_tpu_torch.util_types.merkle_tree import MerkleTree

    n1, n2 = dist_ntt._split_sizes(x.shape[0].bit_length() - 1)
    rows = gf.to_u64(ntt.ntt(x).view(n1, n2).t())
    return [int(v) for v in MerkleTree.new(tip5.hash_varlen(rows)).root()
            .to_array()]


def dist_rank(mesh) -> dict:
    """One rank of a multi-rank mesh: the distributed NTT of
    dist_input(DIST_GLOO_NTT_LOG_N), the Merkle root of the step's leaf
    digests, the LDE commit of dist_input(DIST_GLOO_LDE_LOG_N) and
    PINNED_DIST, with the host ms of each (medians of 5)."""
    from twenty_first_tpu_torch.math import gf
    from twenty_first_tpu_torch.parallel import (dist_merkle, dist_ntt,
                                                 mesh as mesh_mod, pipeline)
    from twenty_first_tpu_torch.probes import timing

    foreign = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "twenty_first_tpu")]
    if foreign:
        raise AssertionError(f"rank {mesh.rank} imported {foreign[:5]}")
    log_n, lde_log_n = DIST_GLOO_NTT_LOG_N, DIST_GLOO_LDE_LOG_N
    n1, n2 = dist_ntt._split_sizes(log_n)
    x = dist_input(log_n)
    ntt_pin = pin_of(dist_ntt.distributed_ntt_values(x, mesh))
    block = mesh_mod.shard_host_array(mesh, (None, mesh_mod.AXIS),
                                      x.reshape(n2, n1))
    leafs = slice_leaf_digests()
    root = dist_merkle.distributed_merkle_root(gf.to_u64(leafs), mesh)
    leaf_block = leafs.view(mesh.size, -1, 5)[mesh.rank]
    lde = pipeline.dist_lde_commit_values(dist_input(lde_log_n), mesh)
    l1, l2 = dist_ntt._split_sizes(lde_log_n)
    lde_block = mesh_mod.shard_host_array(
        mesh, (None, mesh_mod.AXIS), dist_input(lde_log_n).reshape(l2, l1))
    commit = pipeline.make_dist_lde_commit(mesh, lde_log_n)
    log_leafs = leafs.shape[0].bit_length() - 1
    return {
        "rank": mesh.rank, "backend": mesh.backend, "device": str(mesh.device),
        "ntt_pin": ntt_pin, "root": [int(v) for v in root.to_array()],
        "lde_commit": [int(v) for v in lde.to_array()],
        "pins": dist_pins(mesh),
        "ntt_wall_ms": timing.wall_ms(
            lambda: dist_ntt.distributed_ntt(block, mesh), 5),
        "merkle_root_wall_ms": timing.wall_ms(
            lambda: dist_merkle._root(leaf_block, mesh, log_leafs), 5),
        "lde_commit_wall_ms": timing.wall_ms(lambda: commit(lde_block), 5)}


def phase_distributed(counters) -> dict:
    """The distributed layer (parallel/): at world 1 over NCCL in this
    process at full width, each result against the single-device path on
    the card; then DIST_GLOO_RANKS gloo ranks sharing the card, each result
    equal to world 1's; then NCCL with a card a rank where there are two
    cards or more."""
    import torch.distributed as dist

    from twenty_first_tpu_torch.entry import dryrun_multichip
    from twenty_first_tpu_torch.math import gf, ntt
    from twenty_first_tpu_torch.ops import tip5_commit
    from twenty_first_tpu_torch.parallel import (dist_merkle, dist_mmr,
                                                 dist_ntt, mesh as mesh_mod,
                                                 pipeline)
    from twenty_first_tpu_torch.util_types.mmr import MmrAccumulator

    t0 = time.perf_counter()
    mesh = mesh_mod.make_mesh(1)
    if (mesh.backend, mesh.device.type) != ("nccl", "cuda"):
        raise AssertionError(f"world 1 on {mesh.backend}, {mesh.device}")
    log_n = DIST_LOG_N
    n1, n2 = dist_ntt._split_sizes(log_n)
    x = gf.from_u64(dist_input(log_n)).cuda()
    block = x.view(n2, n1)  # world 1: every column
    commit = pipeline.make_dist_lde_commit(mesh, log_n)
    leafs = slice_leaf_digests()
    leafs_host = gf.to_u64(leafs)
    log_leafs = leafs.shape[0].bit_length() - 1
    # the main path, once, with every launch counter at 0: the LDE commit of
    # 2^24 coefficients and the Merkle root of the step's 2^22 leafs
    (root, slice_root), launches = run_path(counters, lambda: (
        commit(block), dist_merkle.distributed_merkle_root(leafs_host, mesh)))
    require_launched("distributed", launches)
    if [int(v) for v in slice_root.to_array()] != SLICE_ROOT:
        raise AssertionError(f"distributed root {slice_root} != SLICE_ROOT")
    # the LDE commit against the single-device composition and against
    # its plain twins on the same block (the sponge's rows of n1 words, the
    # distributed passes' K3 views)
    want_root = lde_commit_oracle(x)
    if gf.to_u64(root).tolist() != [want_root]:
        raise AssertionError(f"LDE commit 2^{log_n}: {gf.to_u64(root)} != "
                             f"{want_root}")
    checked = {"lde_commit_plain": require_equal(
        f"LDE commit 2^{log_n} vs plain", root, commit(block, plain=True))}
    # the NTT both ways, both layouts, one and four all-to-alls, against
    # ntt(); with four, also against the plain passes on the same block
    want, want_inv = ntt.ntt(x), ntt.intt(x)
    for inverse, ref in ((False, want), (True, want_inv)):
        for natural in (False, True):
            expect = ref.view(n1, n2) if natural else ref.view(n1, n2).t()
            for chunks in (1, 4):
                name = (f"{'intt' if inverse else 'ntt'}_"
                        f"{'natural' if natural else 'z'}_chunks{chunks}")
                got = dist_ntt.distributed_ntt(block, mesh, inverse, natural,
                                               chunks)
                checked[name] = require_equal(
                    f"distributed {name} 2^{log_n}", got, expect)
                if chunks == 4:
                    checked[f"{name}_plain"] = require_equal(
                        f"distributed {name} 2^{log_n} vs plain", got,
                        dist_ntt.distributed_ntt(block, mesh, inverse,
                                                 natural, chunks, plain=True))
                del got
    timed = {"distributed_ntt_ms": cuda_ms(
                 lambda: dist_ntt.distributed_ntt(block, mesh), 10),
             "distributed_ntt_wall_ms": wall_ms(
                 lambda: dist_ntt.distributed_ntt(block, mesh), 10),
             "distributed_ntt_chunks1_ms": cuda_ms(
                 lambda: dist_ntt.distributed_ntt(block, mesh,
                                                  a2a_chunks=1), 10),
             "ntt_ms": cuda_ms(lambda: ntt.ntt(x), 10),
             "ntt_wall_ms": wall_ms(lambda: ntt.ntt(x), 10),
             "lde_commit_ms": cuda_ms(lambda: commit(block), 5),
             "lde_commit_wall_ms": wall_ms(lambda: commit(block), 5),
             "merkle_root_ms": cuda_ms(
                 lambda: dist_merkle._root(leafs, mesh, log_leafs), 10),
             "single_device_tree_ms": cuda_ms(
                 lambda: tip5_commit.reduce_layers(leafs, log_leafs), 10)}
    del want, want_inv, x, block
    # columns and rows longer than one pass of K3: two passes each
    big = 1 << DIST_TWO_PASS_LOG_N
    b1, b2 = dist_ntt._split_sizes(DIST_TWO_PASS_LOG_N)
    xb = random_on_card(big, DIST_TWO_PASS_LOG_N)
    for inverse in (False, True):
        name = f"{'intt' if inverse else 'ntt'}_2^{DIST_TWO_PASS_LOG_N}"
        got = dist_ntt.distributed_ntt(xb.view(b2, b1), mesh, inverse,
                                       natural_output=True)
        checked[name] = require_equal(f"distributed {name}", got,
                                      ntt.ntt(xb, inverse).view(b1, b2))
        checked[f"{name}_plain"] = require_equal(
            f"distributed {name} vs plain", got, dist_ntt.distributed_ntt(
                xb.view(b2, b1), mesh, inverse, natural_output=True,
                plain=True))
        del got
    timed["two_pass_ms"] = cuda_ms(
        lambda: dist_ntt.distributed_ntt(xb.view(b2, b1), mesh), 5)
    timed["two_pass_single_device_ms"] = cuda_ms(lambda: ntt.ntt(xb), 5)
    del xb
    vals = np.random.default_rng(DIST_SEED).integers(
        0, P, size=(1 << DIST_XFE_LOG_N, 3), dtype=np.uint64)
    got = dist_ntt.distributed_ntt_xfe_values(vals, mesh)
    if not np.array_equal(got, ntt.ntt_values(vals.T).T):
        raise AssertionError(f"distributed xfe NTT 2^{DIST_XFE_LOG_N}")
    # the MMR over MMR_LEAFS leafs and a batch append of MMR_APPEND
    rng = np.random.default_rng(DIST_SEED)
    mmr_leafs = rng.integers(0, P, size=(MMR_LEAFS, 5), dtype=np.uint64)
    appended = rng.integers(0, P, size=(MMR_APPEND, 5), dtype=np.uint64)
    peaks = dist_mmr.distributed_peaks_from_leafs(mmr_leafs, mesh)
    if peaks != MmrAccumulator.peaks_from_leafs(mmr_leafs):
        raise AssertionError("distributed MMR peaks != MmrAccumulator's")
    new_peaks, count = dist_mmr.distributed_batch_append(
        peaks, MMR_LEAFS, appended, mesh)
    if count != MMR_LEAFS + MMR_APPEND or new_peaks != \
            MmrAccumulator.peaks_from_leafs(np.concatenate([mmr_leafs,
                                                            appended])):
        raise AssertionError("distributed batch append != MmrAccumulator's")
    del mmr_leafs, appended
    dryrun_multichip(1)
    pins = dist_pins(mesh)
    if pins != PINNED_DIST:
        raise AssertionError(f"PINNED_DIST: {pins} != {PINNED_DIST}")
    # the values the multi-rank meshes must reproduce: the single-device
    # path's, which world 1 reproduces too
    world1 = {"ntt_pin": pin_of(ntt.ntt_values(
                  dist_input(DIST_GLOO_NTT_LOG_N))),
              "root": SLICE_ROOT,
              "lde_commit": lde_commit_oracle(gf.from_u64(
                  dist_input(DIST_GLOO_LDE_LOG_N)).cuda()),
              "pins": PINNED_DIST}
    for key, got in (
            ("ntt_pin", pin_of(dist_ntt.distributed_ntt_values(
                dist_input(DIST_GLOO_NTT_LOG_N), mesh))),
            ("lde_commit", [int(v) for v in pipeline.dist_lde_commit_values(
                dist_input(DIST_GLOO_LDE_LOG_N), mesh).to_array()])):
        if got != world1[key]:
            raise AssertionError(f"world 1 {key} {got} != the single-device "
                                 f"path's {world1[key]}")
    del leafs
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    multi = {f"gloo_{DIST_GLOO_RANKS}_ranks_one_card": mesh_mod.launch(
        dist_rank, DIST_GLOO_RANKS, backend="gloo", device="cuda:0",
        timeout=600)}
    for world in (2, 4):
        if world <= cards:
            multi[f"nccl_{world}_cards"] = mesh_mod.launch(
                dist_rank, world, backend="nccl", device="cuda", timeout=600)
    for name, ranks in multi.items():
        for r in ranks:
            for key, value in world1.items():
                if r[key] != value:
                    raise AssertionError(f"{name} rank {r['rank']}: {key} "
                                         f"{r[key]} != world 1's {value}")
    dist.destroy_process_group()
    emit("distributed", seconds=time.perf_counter() - t0,
         world1_backend=mesh.backend, log_n=log_n,
         launches=launches, k1_launches_lde_commit=launches["tip5_permute"],
         checked=checked, timed=timed, two_pass_log_n=DIST_TWO_PASS_LOG_N,
         xfe_log_n=DIST_XFE_LOG_N, mmr_leafs=MMR_LEAFS,
         mmr_append=MMR_APPEND, pinned_dist=True, dryrun_multichip_1=True,
         multi_rank={name: [
             {k: r[k] for k in ("rank", "backend", "device", "ntt_wall_ms",
                                "merkle_root_wall_ms", "lde_commit_wall_ms")}
             for r in ranks] for name, ranks in multi.items()},
         nccl_multi_card=(sorted(k for k in multi if k.startswith("nccl"))
                          if cards >= 2 else "not run: 1 card"),
         multi_rank_note="gloo ranks share one card and stage each "
                         "collective through host memory: their times are "
                         "host-staged wall ms")
    return {"launches": launches}


# the scrambled route's check of K3's order modes in two passes: a 2^24
# transform at a split whose first factor takes two passes of K3
SCRAMBLED_LOG_N = 24
SCRAMBLED_TWO_PASS_SPLIT = (13, 11)


def scrambled_pass_shapes() -> dict:
    """The four K3 passes of the full-width scrambled commit (W, N, E) by
    name: (x view, out view, diagonal, stage twiddles' log2 and direction,
    order mode), on the card; the scrambled route's own views."""
    from twenty_first_tpu_torch.math import ntt
    from twenty_first_tpu_torch.parallel import pipeline

    log_n = N.bit_length() - 1
    log_e = E.bit_length() - 1
    l1, l2 = ntt.four_step_split(log_n)
    n1, n2, n1e = 1 << l1, 1 << l2, 1 << (l1 + log_e)
    d1, pw_scr, d4 = pipeline.lde_scrambled_tables(N, E)
    trace = torch.empty((W, N), dtype=torch.int64, device="cuda")
    y = torch.empty((W, n2, n1), dtype=torch.int64, device="cuda")
    padded = torch.zeros((W, n1, E, n2), dtype=torch.int64, device="cuda")
    z = torch.empty((W, n1e, n2), dtype=torch.int64, device="cuda")
    evals = torch.empty((W, n2, n1e), dtype=torch.int64, device="cuda")
    return {
        "dif_pass1": (trace.view(W, n2, n1), y, d1, l2, True, "rev_out"),
        "dif_pass2": (y.transpose(1, 2), padded[:, :, 0], pw_scr, l1, True,
                      "rev_out"),
        "norev_pass1": (padded.view(W, n1e, n2), z, d4, l1 + log_e, False,
                        "rev_in"),
        "norev_pass2": (z.transpose(1, 2), evals, None, l2, False, "rev_in")}


def scrambled_k3_checks(rng) -> dict:
    """K3's order modes against the twin on the card: every length 2^1..2^12
    in both layouts and modes, with and without a diagonal and a scale, in
    place too; then each of the scrambled commit's four pass shapes, timed
    beside the twin with its bound."""
    from twenty_first_tpu_torch.math import gf, ntt
    from twenty_first_tpu_torch.ops import ntt_cuda

    checked = 0
    for log_t in range(1, 13):
        t = 1 << log_t
        tw = gf.from_u64(ntt.stage_twiddles(log_t, log_t % 2 == 0)).cuda()
        diag = edge_field(rng, (t, 37))
        n_inv = pow(t, P - 2, P)
        for layout in ("cols_fast", "elems_fast"):
            if layout == "cols_fast":
                x = edge_field(rng, (2, t, 37))
            else:
                x = edge_field(rng, (2, 37, t)).transpose(1, 2)
            for mode in ("rev_in", "rev_out"):
                for d, scale in ((None, 1), (diag, 1), (None, n_inv),
                                 (diag, n_inv)):
                    require_equal(
                        f"K3 {mode} log_t={log_t} {layout} "
                        f"diag={d is not None} scale={scale != 1}",
                        ntt_cuda.ntt_local_pass(x, tw, diag=d, scale=scale,
                                                **{mode: True}),
                        ntt_cuda.ntt_local_pass_plain(x, tw, diag=d,
                                                      scale=scale,
                                                      **{mode: True}))
                    checked += 1
                want = ntt_cuda.ntt_local_pass_plain(x, tw, diag=diag,
                                                     **{mode: True})
                inplace = x.clone()
                ntt_cuda.ntt_local_pass(inplace, tw, diag=diag, out=inplace,
                                        **{mode: True})
                require_equal(f"K3 {mode} in place log_t={log_t} {layout}",
                              inplace, want)
                checked += 1
    shapes = {}
    for name, (x, out, d, log_t, inverse, mode) in \
            scrambled_pass_shapes().items():
        x.copy_(random_field(rng, tuple(x.shape)))
        tw = gf.from_u64(ntt.stage_twiddles(log_t, inverse)).cuda()
        kw = {"diag": d, mode: True}
        err = require_equal(f"K3 {mode} at {name} {tuple(x.shape)}",
                            ntt_cuda.ntt_local_pass(x, tw, out=out, **kw),
                            ntt_cuda.ntt_local_pass_plain(x, tw, **kw))
        checked += 1
        b, t, c = x.shape
        products = b * c * (t // 2) * log_t + (x.numel() if d is not None
                                               else 0)
        shapes[name] = {
            "shape": list(x.shape), "strides_in": list(x.stride()),
            "strides_out": list(out.stride()), "mode": mode,
            "max_abs_err": err,
            "ms": cuda_ms(lambda: ntt_cuda.ntt_local_pass(x, tw, out=out,
                                                          **kw), 10),
            "wall_ms": wall_ms(lambda: ntt_cuda.ntt_local_pass(
                x, tw, out=out, **kw), 10),
            "plain_ms": cuda_ms(lambda: ntt_cuda.ntt_local_pass_plain(
                x, tw, **kw), 3),
            **bound(16 * x.numel() + (8 * d.numel() if d is not None else 0),
                    IMAD_PER_MUL * products)}
    return {"checked": checked, "passes": shapes}


def natural_transforms(step, trace):
    """The natural step's two transforms alone (K3's four passes): the
    iNTT with its coset scaling into the padded planes' head, the NTT."""
    from twenty_first_tpu_torch.math import ntt

    padded = torch.zeros((W, N * E), dtype=torch.int64, device="cuda")
    inv, fwd = step._ntt_tables("inv", N, True), step._ntt_tables(
        "fwd", N * E, False)

    def run():
        ntt.ntt(trace, inverse=True, tables=inv, post=step.offset_powers,
                out=padded[:, :N])
        return ntt.ntt(padded, tables=fwd)

    return run


def scrambled_transforms(trace, tables):
    """The scrambled route's two transforms alone (K3's four passes): the
    DIF iNTT into the padded layout, the no-reverse NTT."""
    from twenty_first_tpu_torch.math import ntt

    l1, l2 = ntt.four_step_split(N.bit_length() - 1)
    log_e = E.bit_length() - 1
    d1, pw_scr, d4 = tables
    padded = torch.zeros((W, 1 << l1, E, 1 << l2), dtype=torch.int64,
                         device="cuda")

    def run():
        ntt._four_step(trace, (l1, l2), True, d1, order="dif",
                       post_diag=pw_scr, out=padded[:, :, 0])
        return ntt._four_step(padded.view(W, N * E), (l1 + log_e, l2), False,
                              d4, order="norev")

    return run


def phase_scrambled(counters) -> dict:
    """The JAX package's other route of the flagship step, the scrambled
    LDE commit (K3 under its order modes, K1, K2), at full width: K3's
    modes against the twin, ``four_step_ntt_scrambled`` at 2^24 both ways
    and the two-pass modes at a (13, 11) split against ``ntt()`` through
    the scrambled index, the commit's root equal to SLICE_ROOT and its leaf
    digests to the natural step's, then both routes timed in turns."""
    from twenty_first_tpu_torch.math import gf, ntt
    from twenty_first_tpu_torch.parallel import pipeline
    from twenty_first_tpu_torch.probes import timing

    t0 = time.perf_counter()
    rng = np.random.default_rng(13)
    k3 = scrambled_k3_checks(rng)
    checked = {}
    # the 2^24 scrambled four-step both ways, one K3 pass a factor
    log_n = SCRAMBLED_LOG_N
    x = random_field(rng, (1 << log_n,))
    idx = torch.from_numpy(ntt.scrambled_index(log_n).astype(np.int64)).cuda()
    want = ntt.ntt(x)
    got = gf.carrier_of(ntt.four_step_ntt_scrambled(
        gf.limbs_of(x), log_n, False, ntt._scrambled_diag_device(log_n,
                                                                 False)))
    checked["scrambled_forward_2^24"] = require_equal(
        "four_step_ntt_scrambled 2^24", got[idx], want)
    got = gf.carrier_of(ntt.four_step_ntt_scrambled(
        gf.limbs_of(x[idx]), log_n, True,
        ntt._scrambled_diag_device(log_n, True)))
    checked["scrambled_inverse_2^24"] = require_equal(
        "four_step_ntt_scrambled^-1 2^24", got, ntt.intt(x))
    # K3's order modes in two passes: a first factor of 2^13
    split = SCRAMBLED_TWO_PASS_SPLIT
    r1 = ntt.bit_reverse_permutation(split[0])
    r2 = ntt.bit_reverse_permutation(split[1])
    sidx = torch.from_numpy(
        (r2[None, :] + (r1[:, None] << split[1])).reshape(-1)).cuda()
    scr = gf.carrier_of(ntt.four_step_dif_general(
        gf.limbs_of(x), log_n, False,
        ntt._diag_device_general(log_n, False, True, split), split=split))
    checked["dif_general_2^24_split_13_11"] = require_equal(
        f"four_step_dif_general 2^24 split {split}", scr, want[sidx])
    back = gf.carrier_of(ntt.four_step_norev_general(
        gf.limbs_of(scr), log_n, True,
        ntt._norev_diag_device(log_n, True, split), split=split,
        post_const=pow(1 << log_n, P - 2, P)))
    checked["norev_general_2^24_split_13_11"] = require_equal(
        f"four_step_norev_general 2^24 split {split}", back, x)
    del x, want, got, scr, back, idx, sidx
    # the scrambled commit at full width: the path, once, counters at 0
    step = pipeline.TraceLdeCommit(W, N, E)
    tables = pipeline.lde_scrambled_tables(N, E)
    trace = random_field(np.random.default_rng(2026), (W, N))

    def scrambled():
        return pipeline.trace_lde_commit_scrambled(trace, E, tables)

    root, launches = run_path(counters, scrambled)
    require_launched("scrambled", launches)
    if launches["ntt_local_pass"] != 4:
        raise AssertionError(f"scrambled commit: {launches}, not 4 K3 passes")
    _, natural_launches = run_path(counters, lambda: step(trace))
    if launches != natural_launches:
        raise AssertionError(f"scrambled commit launches {launches} != the "
                             f"natural step's {natural_launches}")
    if gf.to_u64(root).tolist() != [SLICE_ROOT]:
        raise AssertionError(f"scrambled root {gf.to_u64(root)} != "
                             f"SLICE_ROOT")
    checked["leaf_digests"] = require_equal(
        "scrambled leaf digests vs TraceLdeCommit.leaf_digests",
        pipeline.scrambled_leaf_digests(trace, E, tables),
        step.leaf_digests(trace))
    checked["root_plain"] = require_equal(
        "scrambled root vs plain on the card", root,
        pipeline.trace_lde_commit_scrambled(trace, E, tables, plain=True))
    # both routes timed in turns: host medians of 21 calls interleaved,
    # device ms natural, scrambled, scrambled, natural, each route's two
    # transforms (K3's four passes, nothing else) the same way; the peak
    # memory a call adds to what is allocated before it
    routes = {"natural": lambda: step(trace), "scrambled": scrambled}
    transforms = {"natural": natural_transforms(step, trace),
                  "scrambled": scrambled_transforms(trace, tables)}
    walls = {k: [] for k in routes}
    for fn in routes.values():
        fn()
    for _ in range(21):
        for k, fn in routes.items():
            walls[k] += timing.wall_times(fn, 1, warmup=0)
    timed = {k: {"wall_ms": statistics.median(v), "wall_ms_min": min(v),
                 "wall_ms_max": max(v), "runs": len(v)}
             for k, v in walls.items()}
    for k in ("natural", "scrambled", "scrambled", "natural"):
        timed[k].setdefault("ms", []).append(cuda_ms(routes[k], 21))
        timed[k].setdefault("k3_passes_ms", []).append(
            cuda_ms(transforms[k], 21))
    for k, fn in routes.items():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        timed[k]["peak_bytes_added"] = torch.cuda.max_memory_allocated() - before
        timed[k]["profile"] = device_breakdown(fn)
    emit("scrambled", seconds=time.perf_counter() - t0, w=W, n=N,
         expansion=E, root=gf.to_u64(root)[0].tolist(), launches=launches,
         k3_checked=k3["checked"], k3_passes=k3["passes"], checked=checked,
         two_pass_split=list(split), timed=timed)
    return {"launches": launches, "passes": k3["passes"]}


def phase_probe_pass(rng) -> dict:
    """K4 against its twin, then the pass probe's path (K3 and K4)."""
    from twenty_first_tpu_torch.math import gf, ntt
    from twenty_first_tpu_torch.ops import ntt_cuda, probe_cuda
    from twenty_first_tpu_torch.probes import pass_probe

    checked = 0
    for log_t in range(1, 13):
        t = 1 << log_t
        tw = gf.from_u64(ntt.stage_twiddles(log_t, log_t % 2 == 1)).cuda()
        for layout in ("cols_fast", "elems_fast"):
            if layout == "cols_fast":
                x = random_field(rng, (t, 37))
            else:
                x = random_field(rng, (37, t)).t()
            for stage in range(log_t):
                for rev in ((True, False) if stage == 0 else (False,)):
                    require_equal(
                        f"K4 log_t={log_t} {layout} stage={stage} rev={rev}",
                        probe_cuda.ntt_stage(x, tw, stage, bit_reverse=rev),
                        probe_cuda.ntt_stage_plain(x, tw, stage,
                                                   bit_reverse=rev))
                    checked += 1
            inplace = x.clone()
            probe_cuda.ntt_stage(inplace, tw, log_t - 1, out=inplace)
            require_equal(f"K4 in place log_t={log_t} {layout}", inplace,
                          probe_cuda.ntt_stage_plain(x, tw, log_t - 1))
            require_equal(f"K4 chain == pass log_t={log_t} {layout}",
                          pass_probe.run_pass(x, tw, "rt", 0),
                          pass_probe.plain_pass(x, tw))
    # the probe's path: every spec over 2^24 elements
    results, launches = run_path(
        (ntt_cuda.ntt_local_pass, probe_cuda.ntt_stage),
        lambda: pass_probe.run(pass_probe.DEFAULT_SPECS))
    require_launched("probe_pass", launches)
    # K4 alone at the probe's shape: one middle stage of t = 2^12
    x = pass_probe.make_input(12)
    tw = gf.from_u64(ntt.stage_twiddles(12, False)).cuda()
    err = require_equal("K4 at (2^12, 2^12)", probe_cuda.ntt_stage(x, tw, 6),
                        probe_cuda.ntt_stage_plain(x, tw, 6))
    ms = cuda_ms(lambda: probe_cuda.ntt_stage(x, tw, 6), 10)
    host_ms = wall_ms(lambda: probe_cuda.ntt_stage(x, tw, 6), 10)
    plain_ms = cuda_ms(lambda: probe_cuda.ntt_stage_plain(x, tw, 6), 3)
    ng = {r["spec"]: r["launches_per_pass"] for r in results
          if r["variant"] == "ng"}
    emit("probe_pass", stages_checked=checked, launches=launches,
         k4_stage_ms=ms, k4_stage_plain_ms=plain_ms,
         specs={r["spec"]: {k: r[k] for k in ("ms", "wall_ms", "gelems_per_s",
                                              "tb_per_s", "launches_per_pass")}
                for r in results})
    return {"launches": launches, "k3_per_tile_launches": ng,
            "k4": {"max_abs_err": err, "ms": ms, "wall_ms": host_ms,
                   "plain_ms": plain_ms,
                   **bound(16 * x.numel(), IMAD_PER_MUL * x.numel() // 2)}}


def phase_probe_alu(rng) -> dict:
    """K5 in each form against its twin, then the ALU probe's path."""
    from twenty_first_tpu_torch.math import gf
    from twenty_first_tpu_torch.ops import probe_cuda
    from twenty_first_tpu_torch.probes import alu_probe

    edges = np.array([0, 1, P - 1, P, (1 << 32) - 1, 1 << 32, (1 << 64) - 1],
                     dtype=np.uint64)
    a = rng.integers(0, 1 << 64, size=(512, 128), dtype=np.uint64,
                     endpoint=False)
    b = rng.integers(0, 1 << 64, size=(512, 128), dtype=np.uint64,
                     endpoint=False)
    a[0, :49], b[0, :49] = np.repeat(edges, 7), np.tile(edges, 7)
    a, b = gf.from_u64(a).cuda(), gf.from_u64(b).cuda()
    for op in probe_cuda.CHAIN_OPS:
        for k in (1, 2, 16, alu_probe.K_HI):
            want = probe_cuda.gf_chain_plain(a, b, op, k)
            for form in probe_cuda.CHAIN_FORMS:
                require_equal(f"K5 {op} {form} k={k}",
                              probe_cuda.gf_chain(a, b, op, k, form), want)
    results, launches = run_path((probe_cuda.gf_chain,), alu_probe.run)
    require_launched("probe_alu", launches)
    # K5 alone at the full shape: one mul_lazy chain of K_HI steps, in the
    # carry-chain form and beside it in the C form
    fa, fb = alu_probe.operands(alu_probe.FULL_SHAPE)
    k = alu_probe.K_HI
    want = probe_cuda.gf_chain_plain(fa, fb, "mul_lazy", k)
    forms_ms = {}
    for form in probe_cuda.CHAIN_FORMS:
        err = require_equal(f"K5 mul_lazy {form} k={k} at 2^22",
                            probe_cuda.gf_chain(fa, fb, "mul_lazy", k, form),
                            want)
        forms_ms[form] = cuda_ms(
            lambda: probe_cuda.gf_chain(fa, fb, "mul_lazy", k, form), 10)
    ms = forms_ms["cc"]
    host_ms = wall_ms(lambda: probe_cuda.gf_chain(fa, fb, "mul_lazy", k), 10)
    plain_ms = cuda_ms(lambda: probe_cuda.gf_chain_plain(fa, fb, "mul_lazy",
                                                        k), 3)
    sass = {f"{r['op']} {r['form']}": r["sass"] for r in results}
    emit("probe_alu", launches=launches, k5_ms=ms, k5_forms_ms=forms_ms,
         k5_plain_ms=plain_ms, before_redesign={"ms": BEFORE_MS["k5"]},
         sass=sass, per_step={f"{r['op']} {r['form']} {r['shape']}": {
             key: r.get(key) for key in (
                 "ms_per_step", "sm_cycles_per_warp_step", "gops_per_s",
                 "g_instructions_per_s", "share_of_dispatch_rate",
                 "g_imad_per_s", "share_of_imad_rate", "plain_over_kernel")}
             for r in results})
    n = fa.numel()
    # the C form's issue rate, which the Tip5 issue bounds have always used
    rates = [r.get("g_instructions_per_s") for r in results
             if r["op"] == "mul_lazy" and r["form"] == "c"
             and r["shape"] == list(alu_probe.FULL_SHAPE)]
    return {"launches": launches,
            "instructions_per_s": rates[0] * 1e9 if rates and isinstance(
                rates[0], float) else None,
            "k5": {"max_abs_err": err, "ms": ms, "wall_ms": host_ms,
                   "plain_ms": plain_ms, "form": "cc",
                   "forms_ms": forms_ms,
                   **bound(24 * n, IMAD_PER_MUL * k * n)}}


def phase_tip5_counts(instructions_per_s, stats) -> None:
    """Registers, spills, resident warps and SASS per permutation of the
    Tip5 kernels (``stats``: probes/tip5_probe.py), by kernel."""
    emit("tip5_sass", instructions_per_s=instructions_per_s, **{
        name: {k: v for k, v in st.items() if k != "round_opcodes"}
        for name, st in stats.items()})


def main() -> None:
    smi = check_device()
    phase_build()
    from twenty_first_tpu_torch.ops import ntt_cuda, tip5_cuda
    from twenty_first_tpu_torch.math import ntt
    from twenty_first_tpu_torch.probes import pass_probe, tip5_probe
    from twenty_first_tpu_torch.tip5.permutation import tip5_tables

    rng = np.random.default_rng(0)
    tables = tip5_tables()
    k1 = phase_k1(rng, tables)
    k2 = phase_k2(rng, tables)
    k3 = phase_k3(rng)
    phase_pinned_roots()
    counters = (tip5_cuda.tip5_permute, tip5_cuda.merkle_level,
                tip5_cuda.merkle_commit, ntt_cuda.ntt_local_pass)
    launches, slice_root = phase_slice(counters)
    phase_entry()
    merkle = phase_merkle_objects(counters, slice_root, k2["tail_ms"])
    batch = phase_tip5_batch(rng, tables)
    batch["absorb_mode"] = phase_k1_absorb(tables)
    batch["absorb_lane_mode"] = phase_k1_absorb_lanes(tables)
    stats = tip5_probe.kernel_stats()
    mxu = phase_tip5_mxu(tables, stats)
    from twenty_first_tpu_torch.ops import poly_cuda

    poly_counters = (ntt_cuda.ntt_local_pass, poly_cuda.coset_extrapolate_fold,
                     poly_cuda.batch_inversion, poly_cuda.gf_pointwise)
    poly = phase_poly_batch(rng, poly_counters)
    engine = phase_polynomial(poly_counters)["launches"]
    host = phase_host_layers((tip5_cuda.tip5_permute, tip5_cuda.merkle_level))
    large = phase_ntt_large((ntt_cuda.ntt_local_pass,))
    dist = phase_distributed(counters)["launches"]
    scrambled = phase_scrambled(counters)
    scr = scrambled["launches"]
    probe_pass = phase_probe_pass(rng)
    probe_alu = phase_probe_alu(rng)
    rate = probe_alu["instructions_per_s"]
    phase_tip5_counts(rate, stats)
    k1.update(tip5_probe.counts(stats, "tip5_permute", N * E, rate))
    for mode, name in (("absorb_mode", "tip5_absorb"),
                       ("absorb_lane_mode", "tip5_absorb_lanes")):
        batch[mode].update(tip5_probe.counts(stats, name,
                                             batch[mode]["perms"], rate))
    mxu.update(tip5_probe.counts(stats, "tip5_permute_mma", N * E, rate))
    log_n1, log_n2 = ntt.four_step_split((N * E).bit_length() - 1)
    k3_stats = pass_probe.kernel_stats(log_n2, 1 << log_n1)
    emit("k3_sass", **k3_stats)
    k3.update({k: k3_stats.get(k, "not measured") for k in (
        "elements_per_thread", "registers", "spill_bytes", "threads",
        "resident_warps_per_sm", "sass_per_butterfly")})
    batch["trace"].update(tip5_probe.counts(stats, "tip5_trace", TRACE_STATES,
                                            rate))
    # the counts of the full-width level kernel, which does all but the
    # tail's permutations; the fused tail's beside them
    perms = k2["perms"]
    k2.update(tip5_probe.counts(stats, "merkle_level", perms["merkle_level"],
                                rate),
              counts_of="merkle_level",
              fused_kernel=tip5_probe.counts(stats, "merkle_commit",
                                             perms["merkle_commit"], rate),
              issue_bound_ms=tip5_probe.issue_bound_ms(stats, perms, rate))
    pallas = "twenty_first_tpu/ops/tip5_pallas.py"
    kernels = [
        {"name": "tip5_permute", "route": "cuda",
         "source": "twenty_first_tpu_torch/csrc/tip5.cu",
         "replaces": f"{pallas}:252 (T1); {pallas}:102 (T4); "
                     f"{pallas}:383 (T5)",
         "launches": launches["tip5_permute"]
                     + merkle["tip5_permute"]
                     + batch["launches"]["tip5_permute"]
                     + host["launches"]["tip5_permute"]
                     + dist["tip5_permute"] + scr["tip5_permute"],
         "launches_by_path": {"slice": launches["tip5_permute"],
                              "merkle_objects": merkle["tip5_permute"],
                              "tip5_batch": batch["launches"]["tip5_permute"],
                              "host_layers": host["launches"]["tip5_permute"],
                              "distributed": dist["tip5_permute"],
                              "scrambled": scr["tip5_permute"]},
         **k1, **NO_LIBRARY, "trace_mode": batch["trace"],
         "absorb_mode": batch["absorb_mode"],
         "absorb_lane_mode": batch["absorb_lane_mode"]},
        {"name": "merkle_commit", "route": "cuda",
         "source": "twenty_first_tpu_torch/csrc/tip5.cu",
         "replaces": f"{pallas}:262 (T2)",
         "launches": sum(path[k] for path in (launches, merkle, dist, scr,
                                              mxu["launches"])
                         for k in ("merkle_level", "merkle_commit"))
                     + host["launches"]["merkle_level"],
         "launches_by_path": {
             **{path: {k: counts[k] for k in ("merkle_level", "merkle_commit")}
                for path, counts in (("slice", launches),
                                     ("merkle_objects", merkle),
                                     ("distributed", dist),
                                     ("scrambled", scr),
                                     ("tip5_mxu", mxu["launches"]))},
             "host_layers": {"merkle_level": host["launches"]["merkle_level"]}},
         "merkle_sweep_host_up_to": host["sweep"]["host_up_to"],
         **k2, **NO_LIBRARY},
        {"name": "tip5_permute_mma", "route": "cuda",
         "source": "twenty_first_tpu_torch/csrc/tip5_mma.cu",
         "replaces": "twenty_first_tpu/ops/tip5_mxu.py:96 (_mds_mxu), :143 "
                     "(permutation_dense); plain jnp on the MXU, no Pallas "
                     "kernel",
         "launches": mxu["launches"]["tip5_permute_mma"],
         "launches_by_path": {
             "tip5_mxu": mxu["launches"]["tip5_permute_mma"]},
         **{k: v for k, v in mxu.items() if k != "launches"}, **NO_LIBRARY},
        {"name": "ntt_local_pass", "route": "cuda",
         "source": "twenty_first_tpu_torch/csrc/ntt.cu",
         "replaces": "twenty_first_tpu/ops/ntt_pallas.py:47 (T3); "
                     "scripts/prof_pallas_pass.py:53 (T6); "
                     "scripts/prof_pallas_pass.py:110 (T7)",
         "launches": launches["ntt_local_pass"]
                     + merkle["ntt_local_pass"]
                     + poly["launches"]["ntt_local_pass"]
                     + engine["ntt_local_pass"]
                     + large["launches"]["ntt_local_pass"]
                     + dist["ntt_local_pass"]
                     + scr["ntt_local_pass"]
                     + probe_pass["launches"]["ntt_local_pass"],
         "launches_by_path": {
             "slice": launches["ntt_local_pass"],
             "merkle_objects": merkle["ntt_local_pass"],
             "poly_batch": poly["launches"]["ntt_local_pass"],
             "polynomial": engine["ntt_local_pass"],
             "ntt_large": large["launches"]["ntt_local_pass"],
             "distributed": dist["ntt_local_pass"],
             "scrambled": scr["ntt_local_pass"],
             "probe_pass": probe_pass["launches"]["ntt_local_pass"]},
         "order_modes": {
             "replaces": "twenty_first_tpu/math/ntt.py:941 (_local_pass "
                         "with dif=True / norev=True: :1147, :1153); plain "
                         "jnp, no Pallas kernel",
             "passes": scrambled["passes"]},
         "t7_launches_per_pass": probe_pass["k3_per_tile_launches"],
         "three_pass": large["three_pass"],
         "largest_ntt": large["largest"],
         **k3, **NO_LIBRARY},
        {"name": "ntt_stage", "route": "cuda",
         "source": "twenty_first_tpu_torch/csrc/probes.cu",
         "replaces": "scripts/prof_pallas_pass.py:53 (T6 roundtrip)",
         "launches": probe_pass["launches"]["ntt_stage"],
         **probe_pass["k4"], **NO_LIBRARY},
        {"name": "gf_chain", "route": "cuda",
         "source": "twenty_first_tpu_torch/csrc/probes.cu",
         "replaces": "scripts/pallas_alu_probe.py:38 (T8)",
         "launches": probe_alu["launches"]["gf_chain"],
         **probe_alu["k5"], **NO_LIBRARY},
        {"name": "coset_extrapolate_fold", "route": "cuda",
         "source": "twenty_first_tpu_torch/csrc/poly.cu",
         "replaces": "twenty_first_tpu/math/poly_batch.py:152 "
                     "(_coset_extrapolate_pow_core); :226 "
                     "(_coset_extrapolate_xfe_pow_core); plain jnp, no "
                     "Pallas kernel",
         "launches": (poly["launches"]["coset_extrapolate_fold"]
                      + engine["coset_extrapolate_fold"]),
         "launches_by_path": {
             "poly_batch": poly["launches"]["coset_extrapolate_fold"],
             "polynomial": engine["coset_extrapolate_fold"]},
         **poly["k6"], **NO_LIBRARY},
        {"name": "batch_inversion", "route": "cuda",
         "source": "twenty_first_tpu_torch/csrc/poly.cu",
         "replaces": "twenty_first_tpu/math/gf.py:503 (batch_inversion); "
                     "plain jnp, no Pallas kernel",
         "launches": (poly["launches"]["batch_inversion"]
                      + engine["batch_inversion"]),
         "launches_by_path": {
             "poly_batch": poly["launches"]["batch_inversion"],
             "polynomial": engine["batch_inversion"]},
         **poly["k7"], **NO_LIBRARY},
        {"name": "gf_pointwise", "route": "cuda",
         "source": "twenty_first_tpu_torch/csrc/poly.cu",
         "replaces": "twenty_first_tpu/math/gf_ext.py:71 (mul); :84 "
                     "(mul_base); twenty_first_tpu/math/gf.py:444 "
                     "(inverse_or_zero) and gf.mul; plain jnp, no Pallas "
                     "kernel",
         "launches": (poly["launches"]["gf_pointwise"]
                      + engine["gf_pointwise"]),
         "launches_by_path": {
             "poly_batch": poly["launches"]["gf_pointwise"],
             "polynomial": engine["gf_pointwise"]},
         **poly["k8"], **NO_LIBRARY},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
