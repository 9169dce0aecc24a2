#!/usr/bin/env python3
"""Check the PyTorch/CUDA port (twenty_first_tpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the hand-written kernels from twenty_first_tpu_torch/csrc with
nvcc, holds each against its plain PyTorch twin on the card (exact
equality: this is integer field arithmetic), reproduces values pinned from
the JAX reference, and drives twelve paths, each with every launch counter
set to 0 just before it and read just after (a path fails if one of its
kernels never launched):

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
  (K3 and K1 for the leaf digests, K2's two launches, K1); K2's launches
  counted at 2, 2^10 and 2^22 leafs;
* the standalone Tip5 batch path: permutation_batch at 2^16 and 2^22
  states, the T4/T5 entry points, trace, hash_varlen and
  hash_varlen_ragged (K1 and its trace and absorb modes); K1's absorb
  mode at the table commit's (2^17, 16,390), a thread a row, and at the
  opening's (80, 16,390), in its lane mode, each against its plain twin;
* the tensor-core Tip5 and the packed commit's entry points
  (ops/tip5_mxu.py, ops/tip5_packed.py): K9, the permutation with its MDS
  as u8 mma on the integer tensor cores, against its twin and K1 at 2^16
  and 2^22 states, at 2^16 + 9 and at a warp tile's edges; permutation on
  the 2^22 states' limb planes, permutation_dense on their lane-dense
  planes, permutation_values, commit_states_packed over the step's 2^22
  leaf states (SLICE_ROOT) and reduce_layers_packed over 2^20 digests
  against K2's reduce_layers (K9 and K2's two launches);
* the polynomial batch path (math/poly_batch.py, the NTT-domain
  convolutions and gf_ext's batch inversion) at full width: the
  out-of-domain extrapolations of bench.py's shape and of the flagship
  trace's width and length, the barycentric evaluation, the coset LDE and
  its inverse, batch products, convolutions at 2^22 and 2^20 (K3, K6, K7
  and K8), every output equal to the plain twins'; PINNED_EXTRAPOLATE
  through the kernels; K6, K7 and K8 alone at edge cases and at the path's
  shapes against their twins;
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
  check; PINNED_POLYNOMIAL reproduces with every crossover at 0;
* the host layers (the native host core must be loaded): Tip5.hash_batch
  of 2^12 objects whose BFieldCodec encodings take every codec type (K1),
  each equal to the scalar Tip5.hash and a sample to its pure-Python
  oracle; MerkleTree.new over host leafs above HOST_MERKLE_MAX_LEAFS (K2)
  and at it (the host route, no K2), roots equal to the native core's;
  verify of 160 openings; the lattice KEM's round trip and its refusal of
  a tampered ciphertext; InverseTip5 undoing K1 on a batch;
* NTT lengths from 2^25, three passes of K3 a transform: ntt and intt at
  2^25 and 2^28 equal to the plain twins on the card element by element,
  then the largest length that fits the card beside its output (2^32 the
  target): a delta's transform (X[k + 1] = X[k] w), the round trip, and
  four outputs of random input evaluated directly;
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
  equal to SLICE_ROOT and the leaf digests to the natural step's;
* the NTT pass probe's variants over 2^24 elements (K3 and K4);
* the ALU probe's chains of lazy field ops (K5) in both forms.

K3's phase also holds in-place passes, inputs full of edge words and
ntt(post=, out=) at the step's two sizes against the twins. It prints one
JSON line per phase, with what the phase checked, and {"ok": true,
"device": {...}} last. Any failure raises: a non-zero exit and no ok line.
It times nothing: per-kernel times come from the probes
(python -m twenty_first_tpu_torch.probes.<name>), per-layer times from
port_bench/. It needs a CUDA device and refuses to run without one.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import subprocess
import sys
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
# leafs its successor proof appends, the small trees whose K2 launches are
# counted beside the big one's
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

#: canonical edge words K3's checks mix into their inputs
K3_EDGES = (0, 1, P - 1, 1 << 32, (1 << 32) - 1)


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


def check_device() -> None:
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


def phase_build() -> None:
    from twenty_first_tpu_torch import _build

    so = _build.build()
    _build.load()
    ptxas = [line.strip() for line in _build.build_log().splitlines()
             if "Used" in line or "spill" in line or "Compiling" in line]
    emit("build", library=so.name, ptxas=ptxas)


def phase_k1(rng, tables) -> None:
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
    require_equal("K1 at the path's shape",
                  tip5_cuda.tip5_permute(big, *tables),
                  tip5_cuda.tip5_permute_plain(big, *tables))
    emit("k1_tip5_permute", states=states.shape[0], snapshot=True,
         shape=[N * E, 16], twin_equal=True)


def phase_k2(rng, tables) -> None:
    """K2, the tree: uneven and forced-branch cases against the plain twins,
    then the tree over the main path's 2^22 leaf digests and its first
    level alone."""
    from twenty_first_tpu_torch.ops import tip5_commit, tip5_cuda

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
    require_equal("K2 tree over the path's leafs",
                  tip5_commit.reduce_layers(leafs, log_rows, tables=tables),
                  tip5_commit.reduce_layers(leafs, log_rows, tables=tables,
                                            plain=True))
    resident = tip5_cuda.resident_threads(leafs.device)
    # the level kernel alone: the first level, 2^22 -> 2^21 digests
    require_equal("K2 level at the path's shape",
                  tip5_cuda.merkle_level(leafs, False, *tables),
                  tip5_cuda.merkle_level_plain(leafs, False, *tables))
    emit("k2_merkle_tree", cases=checked + 2, tree_leafs=N * E,
         resident_threads=resident,
         plan=tip5_commit.plan(N * E, log_rows, resident))


def phase_k3(rng) -> None:
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
    require_equal(f"K3 at {tuple(x.shape)}",
                  ntt_cuda.ntt_local_pass(x, fwd.tw1, diag=fwd.diag),
                  ntt_cuda.ntt_local_pass_plain(x, fwd.tw1, diag=fwd.diag))
    emit("k3_ntt_local_pass", passes_checked=checked, ntt_sizes=[10, 17, 22],
         shape=list(x.shape), twin_equal=True)


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


def phase_slice(counters) -> list:
    """The flagship step once with the launch counters at 0, its root
    against the plain twins' on the card; returns the root."""
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
    emit("slice_lde_commit", w=W, n=N, expansion=E, rows=N * E,
         root=vals[0].tolist(), launches=launches, plain_equal=True)
    return vals[0].tolist()


def phase_merkle_objects(counters, slice_root) -> None:
    """The authenticated-structures path at a prover's sizes: the Merkle
    tree over the flagship step's 2^22 leaf digests with 160 openings, the
    MMR over 3 * 2^21 - 1 leafs and a successor proof of 2^16 more, and a
    ragged batch through the Tip5 object API (K1, K2's two launches, K3
    through the step's leaf digests); K2's launches counted at 2, 2^10 and
    2^22 leafs and below the MMR's cutoff."""
    from twenty_first_tpu_torch.parallel import pipeline
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
    verified = proof.verify(root)
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
    # K2's launches: one a level, at the small sizes and the whole tree
    trees = {}
    for size in SMALL_TREES + (N * E,):
        small = leafs[:size].contiguous()
        counts = run_path(counters, lambda: MerkleTree.new(small))[1]
        if counts["merkle_level"] != size.bit_length() - 1:
            raise AssertionError(f"MerkleTree.new({size}) made "
                                 f"{counts['merkle_level']} K2 launches")
        trees[str(size)] = counts["merkle_level"]
    # an MMR below the cutoff: its peaks are still reduced on the card
    small_mmr = mmr_leafs[:SMALL_MMR].contiguous()
    small_acc, counts = run_path(
        counters, lambda: MmrAccumulator.new_from_leafs(small_mmr))
    small_mmr_k2 = counts["merkle_level"] + counts["merkle_commit"]
    if small_mmr_k2 == 0 or small_acc != MmrAccumulator.new_from_leafs(
            small_mmr, plain=True):
        raise AssertionError(f"MMR of {SMALL_MMR} leafs: {small_mmr_k2} K2 "
                             "launches, or peaks != plain on the card")
    emit("merkle_objects", launches=launches, leafs=N * E,
         root=root_vals, tree_plain_equal=True,
         merkle_level_launches=trees, queries=MERKLE_QUERIES,
         auth_nodes=len(auth), verified=verified,
         tampered_verified=tampered_verified, mmr_leafs=MMR_LEAFS,
         mmr_peaks=len(acc.peaks()), small_mmr_leafs=SMALL_MMR,
         small_mmr_k2_launches=small_mmr_k2, successor_appended=MMR_APPEND,
         successor_paths=len(successor.paths), ragged_inputs=len(ragged))


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


def phase_tip5_batch(rng, tables) -> None:
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
    require_equal("permutation_batch (small)", got["batch_small"],
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
    before = tip5_cuda.tip5_permute.launches
    tperm.hash_varlen(varlen_input(16384))
    varlen_launches = tip5_cuda.tip5_permute.launches - before
    emit("tip5_batch", launches=launches, states=list(BATCH_STATES),
         t45_states=T45_STATES, trace_states=TRACE_STATES,
         mixed_inputs=MIXED_INPUTS,
         hash_varlen_16384_launches=varlen_launches,
         pinned=["snapshot", "trace", "varlen_10", "varlen_16384", "ragged"])


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


def phase_k1_absorb(tables) -> None:
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
    require_equal("K1 absorb at the table's shape", got,
                  tip5_cuda.tip5_absorb_plain(table, *tables))
    del table, got
    torch.cuda.empty_cache()  # 17 GB, before the phases that fill the card
    emit("k1_absorb", shape=[rows, width], twin_equal=True,
         launches=1, lane_launches=0)


def phase_k1_absorb_lanes(tables) -> None:
    """K1's absorb mode at the opening's shape, which takes its lane mode:
    one launch over a (80, 16,390) table (edge words first in every row),
    counted as K1's and as a lane-mode launch, equal to the plain twin on
    the same table."""
    from twenty_first_tpu_torch.ops import tip5_cuda

    rows, width = LANE_SHAPE
    table = absorb_table(LANE_SHAPE, LANE_SEED)
    got, moved = absorb_counted(table, tables)
    if moved != (1, 1):
        raise AssertionError(f"K1's absorb mode at the opening's shape moved "
                             f"(launches, lane launches) by {moved}")
    require_equal("K1 lane mode at the opening's shape", got,
                  tip5_cuda.tip5_absorb_plain(table, *tables))
    emit("k1_absorb_lanes", shape=[rows, width], twin_equal=True,
         launches=1, lane_launches=1)


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


def phase_tip5_mxu(tables) -> None:
    """K9 and the entry points of ops/tip5_mxu.py and ops/tip5_packed.py.

    K9 against its plain twin on the card and against K1, at 2^16 and
    2^22 states, at a batch that is not a multiple of 32 and at the warp
    tile's edges, inputs with edge words; then the path, once, with the
    counters at 0:
    ``permutation`` on the 2^22 states' limb planes, ``permutation_dense``
    on their lane-dense planes, ``permutation_values`` on 2^16 host states,
    ``commit_states_packed`` over the step's 2^22 leaf states (SLICE_ROOT)
    and ``reduce_layers_packed`` over 2^20 digests to their root (K9 and
    K2's two launches)."""
    from twenty_first_tpu_torch.math import gf
    from twenty_first_tpu_torch.ops import (tip5_commit, tip5_cuda, tip5_mxu,
                                            tip5_packed)

    rng = np.random.default_rng(MXU_SEED)
    small_n, big_n = MXU_STATES
    inputs = {n: edge_field(rng, (n, 16))
              for n in (*MXU_STATES, MXU_RAGGED, *MXU_EDGES)}
    inputs[small_n][0] = gf.from_u64(snapshot_state())[0].cuda()
    k1_out = {}
    for n, x in inputs.items():
        got = tip5_mxu.tip5_permute_mma(x, *tables)
        require_equal(f"K9 at {n} states vs its twin", got,
                      tip5_mxu.tip5_permute_mma_plain(x, *tables))
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
    emit("tip5_mxu", launches=launches, states=list(MXU_STATES),
         ragged=MXU_RAGGED, edges=list(MXU_EDGES),
         packed_digests=PACKED_DIGESTS, commit_root=SLICE_ROOT)


#: the polynomial phase's inputs: np.random.default_rng(POLY_SEED)
POLY_SEED = 10
#: the polynomial batch path's widths: the flagship trace (W x N), bench.py's
#: out-of-domain shape (one 2^18 codeword to 2^10 points), 16 xfe points,
#: the convolutions' lengths
POLY_BENCH_N, POLY_BENCH_POINTS = 1 << 18, 1 << 10
POLY_XFE_POINTS = 16
CONV_N, CONV_XFE_N = 1 << 22, 1 << 20


def phase_poly_batch(rng, counters) -> None:
    """The polynomial batch path at full width, once with the launch
    counters at 0, against its plain twins; the pins; then K6-K8 alone at
    edge cases and at the path's shapes against their twins."""
    from twenty_first_tpu_torch.math import gf, gf_ext, ntt, poly_batch
    from twenty_first_tpu_torch.math import gf_numpy as gfn
    from twenty_first_tpu_torch.ops import poly_cuda

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
    require_equal("K6 at bench.py's shape",
                  poly_cuda.coset_extrapolate_fold(bench_b, bench_w),
                  poly_cuda.coset_extrapolate_fold_plain(bench_b, bench_w))
    shapes = {"k6": [[1, POLY_BENCH_N, POLY_BENCH_POINTS]]}
    xw = gf.from_u64(xpts).cuda()
    for x in (gf.from_u64(trace).cuda(), gf_ext.from_u64(trace_x).cuda()):
        b = ntt.intt(x)
        require_equal(f"K6 at {tuple(b.shape)} to {POLY_XFE_POINTS} points",
                      poly_cuda.coset_extrapolate_fold(b, xw),
                      poly_cuda.coset_extrapolate_fold_plain(b, xw,
                                                             point_chunk=4))
        shapes["k6"].append(list(b.shape) + [POLY_XFE_POINTS])
    dets = edge_field(rng, (W, N))
    dets[dets == 0] = 1
    dets[3, 7] = 0
    for x in (dets[:1], dets):
        require_equal(f"K7 at {tuple(x.shape)}", poly_cuda.batch_inversion(x),
                      poly_cuda.batch_inversion_plain(x))
    shapes["k7"] = [[1, N], [W, N]]
    a8 = edge_field(rng, (W, N * E))
    b8 = edge_field(rng, (W, N * E))
    xa, xb = a8[:6].reshape(2, 3, -1), b8[:6].reshape(2, 3, -1)
    for op, a, b in (("mul", a8, b8), ("inv", a8[0], None),
                     ("xmul", xa, xb)):
        require_equal(f"K8 {op} at {tuple(a.shape)}",
                      poly_cuda.gf_pointwise(a, b, op),
                      poly_cuda.gf_pointwise_plain(a, b, op))
    shapes["k8"] = {"mul": [W, N * E], "inv": [N * E],
                    "xmul": list(xa.shape)}
    del a8, b8, xa, xb
    emit("poly_batch", launches=launches, outputs=sorted(got),
         pinned=sorted(PINNED_EXTRAPOLATE), kernel_cases=checked,
         twin_equal_at_path_shapes=shapes)


# ---------------------------------------------------------------------------
# the polynomial engine (math/polynomial.py) through its object API
# ---------------------------------------------------------------------------

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


def phase_polynomial(counters) -> None:
    """The polynomial engine's object API at the shapes of bench.py:584-706
    (benches/*.rs) and the flagship step's prover width, once with the
    launch counters at 0 on its default routes; every result against the
    same call on the host alone and by an independent check; the pin with
    every crossover at 0."""
    from twenty_first_tpu_torch import native
    from twenty_first_tpu_torch.math import ntt, poly_batch, polynomial
    from twenty_first_tpu_torch.math.b_field_element import bfe
    from twenty_first_tpu_torch.probes.polynomial_probe import (card_routes,
                                                                host_routes)

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
    for name, fn in narrow.items():
        got[name + "_at_2^16"] = fn()
    with host_routes():
        for name, fn in ops.items():
            if name in narrow:
                name, fn = name + "_at_2^16", narrow[name]
            require_words(name, got[name], fn())
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
    emit("polynomial", native_core=native.available(),
         native_library=native.library_path().name, launches=launches,
         host_equal=sorted(got), pinned=PINNED_POLYNOMIAL)


# the host layers' path: hash_batch's objects and the sample held against
# the Python rounds, the batch of states InverseTip5 takes back through K1
HASH_BATCH_OBJECTS = 1 << 12
ORACLE_SAMPLE = 16
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


def phase_host_layers(counters) -> None:
    """The host layers a prover and a verifier call: Tip5.hash and
    hash_batch of encodings of every codec type (K1), verify of 160
    openings on the native core, MerkleTree.new on both sides of
    HOST_MERKLE_MAX_LEAFS (K2 above it), the lattice KEM, and InverseTip5
    undoing K1 on a batch."""
    from twenty_first_tpu_torch import native
    from twenty_first_tpu_torch.math import gf, lattice
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
    if not proof.verify(tree.root()):
        raise AssertionError("verify refused an honest proof")
    # the lattice KEM
    sk, pk = lattice.keygen(key_rand)
    shared, ct = lattice.enc(pk, enc_rand)
    opened = lattice.dec(sk, ct)
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
    emit("host_layers", launches=launches, objects=len(objects),
         oracle_sample=ORACLE_SAMPLE, verify_openings=MERKLE_QUERIES,
         merkle_cut=cut, merkle_below_k2_launches=counts["merkle_level"],
         kem=True, inverse_states=INVERSE_STATES)


# the large NTT: full-output checks against the plain twin, and the largest
# length from NTT_LARGE_TARGET down to NTT_LARGE_LEAST that fits the card
# beside its output
NTT_LARGE_CHECKED = (25, 28)
NTT_LARGE_TARGET, NTT_LARGE_LEAST = 32, 31
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


def phase_ntt_large(counters) -> None:
    """NTT lengths from 2^25 (three passes of K3): full outputs against the
    plain twin on the card at 2^25 and 2^28, then the largest length that
    fits the card beside its output, 2^32 the target: a delta's transform
    (X[k] = w^k), a round trip, and a few outputs of random input
    evaluated directly."""
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
    for log_n in NTT_LARGE_CHECKED:
        n = 1 << log_n
        x = random_on_card(n, log_n).view(1, n)
        y = ntt.ntt(x)
        require_equal(f"ntt 2^{log_n}", y, ntt.ntt(x, plain=True))
        require_equal(f"intt 2^{log_n}", ntt.intt(y), ntt.intt(y, plain=True))
        del x, y
    # the largest length that fits: input, output and a check's chunks
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    fits = [k for k in range(NTT_LARGE_TARGET, NTT_LARGE_LEAST - 1, -1)
            if 2 * 8 * (1 << k) + (4 << 30) <= free]
    if not fits:
        raise AssertionError(f"no length from 2^{NTT_LARGE_LEAST} fits "
                             f"{free} free bytes")
    log_n = fits[0]
    n = 1 << log_n
    w = PRIMITIVE_ROOTS[n]
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
    ntt.ntt(x, out=y)
    ks = [0, 1, n // 2 + 12345, n - 1]
    direct = direct_ntt(x, ks)
    if direct != [int(y[k]) & ((1 << 64) - 1) for k in ks]:
        raise AssertionError(f"ntt 2^{log_n}: outputs {ks} != direct sums")
    ntt.intt(y, out=x)
    for s, chunk in random_chunks(n, log_n):
        require_equal(f"intt(ntt(x)) 2^{log_n} from {s}",
                      x[s:s + chunk.numel()], chunk)
    del x, y
    torch.cuda.empty_cache()
    emit("ntt_large", launches=launches,
         twin_equal=[f"2^{k}" for k in NTT_LARGE_CHECKED],
         largest={"log_n": log_n,
                  "k3_launches_a_call": counts["ntt_local_pass"],
                  "direct_indices": ks},
         left_out=[f"2^{k}" for k in range(NTT_LARGE_TARGET, log_n, -1)],
         free_bytes=free)


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
    PINNED_DIST."""
    from twenty_first_tpu_torch.math import gf
    from twenty_first_tpu_torch.parallel import dist_merkle, dist_ntt, pipeline

    foreign = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "twenty_first_tpu")]
    if foreign:
        raise AssertionError(f"rank {mesh.rank} imported {foreign[:5]}")
    ntt_pin = pin_of(dist_ntt.distributed_ntt_values(
        dist_input(DIST_GLOO_NTT_LOG_N), mesh))
    root = dist_merkle.distributed_merkle_root(
        gf.to_u64(slice_leaf_digests()), mesh)
    lde = pipeline.dist_lde_commit_values(dist_input(DIST_GLOO_LDE_LOG_N),
                                          mesh)
    return {
        "rank": mesh.rank, "backend": mesh.backend, "device": str(mesh.device),
        "ntt_pin": ntt_pin, "root": [int(v) for v in root.to_array()],
        "lde_commit": [int(v) for v in lde.to_array()],
        "pins": dist_pins(mesh)}


def phase_distributed(counters) -> None:
    """The distributed layer (parallel/): at world 1 over NCCL in this
    process at full width, each result against the single-device path on
    the card; then DIST_GLOO_RANKS gloo ranks sharing the card, each result
    equal to world 1's; then NCCL with a card a rank where there are two
    cards or more."""
    import torch.distributed as dist

    from twenty_first_tpu_torch.entry import dryrun_multichip
    from twenty_first_tpu_torch.math import gf, ntt
    from twenty_first_tpu_torch.parallel import (dist_merkle, dist_mmr,
                                                 dist_ntt, mesh as mesh_mod,
                                                 pipeline)
    from twenty_first_tpu_torch.util_types.mmr import MmrAccumulator

    mesh = mesh_mod.make_mesh(1)
    if (mesh.backend, mesh.device.type) != ("nccl", "cuda"):
        raise AssertionError(f"world 1 on {mesh.backend}, {mesh.device}")
    log_n = DIST_LOG_N
    n1, n2 = dist_ntt._split_sizes(log_n)
    x = gf.from_u64(dist_input(log_n)).cuda()
    block = x.view(n2, n1)  # world 1: every column
    commit = pipeline.make_dist_lde_commit(mesh, log_n)
    leafs_host = gf.to_u64(slice_leaf_digests())
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
    emit("distributed", world1_backend=mesh.backend, log_n=log_n,
         launches=launches, k1_launches_lde_commit=launches["tip5_permute"],
         checked=checked, two_pass_log_n=DIST_TWO_PASS_LOG_N,
         xfe_log_n=DIST_XFE_LOG_N, mmr_leafs=MMR_LEAFS,
         mmr_append=MMR_APPEND, pinned_dist=True, dryrun_multichip_1=True,
         multi_rank={name: [{k: r[k] for k in ("rank", "backend", "device")}
                            for r in ranks]
                     for name, ranks in multi.items()},
         nccl_multi_card=(sorted(k for k in multi if k.startswith("nccl"))
                          if cards >= 2 else "not run: 1 card"))


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
    place too; then each of the scrambled commit's four pass shapes."""
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
        require_equal(f"K3 {mode} at {name} {tuple(x.shape)}",
                      ntt_cuda.ntt_local_pass(x, tw, out=out, **kw),
                      ntt_cuda.ntt_local_pass_plain(x, tw, **kw))
        checked += 1
        shapes[name] = {"shape": list(x.shape), "strides_in": list(x.stride()),
                        "strides_out": list(out.stride()), "mode": mode}
    return {"checked": checked, "passes": shapes}


def phase_scrambled(counters) -> None:
    """The JAX package's other route of the flagship step, the scrambled
    LDE commit (K3 under its order modes, K1, K2), at full width: K3's
    modes against the twin, ``four_step_ntt_scrambled`` at 2^24 both ways
    and the two-pass modes at a (13, 11) split against ``ntt()`` through
    the scrambled index, the commit's root equal to SLICE_ROOT and its leaf
    digests to the natural step's."""
    from twenty_first_tpu_torch.math import gf, ntt
    from twenty_first_tpu_torch.parallel import pipeline

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
    emit("scrambled", w=W, n=N, expansion=E,
         root=gf.to_u64(root)[0].tolist(), launches=launches,
         k3_checked=k3["checked"], k3_passes=k3["passes"], checked=checked,
         two_pass_split=list(split))


def phase_probe_pass(rng) -> None:
    """K4 against its twin, then the pass probe's variants (K3 and K4)."""
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
    # the probe's path: every spec's variant over 2^24 elements against
    # the plain pass
    inputs = {}

    def variants():
        for spec in pass_probe.DEFAULT_SPECS:
            log_t, tc, variant = pass_probe.parse_spec(spec)
            if log_t not in inputs:
                inputs[log_t] = pass_probe.make_input(log_t)
            x = inputs[log_t]
            tw = gf.from_u64(ntt.stage_twiddles(log_t, False)).cuda()
            require_equal(f"pass probe {spec}",
                          pass_probe.run_pass(x, tw, variant, tc),
                          pass_probe.plain_pass(x, tw))

    launches = run_path((ntt_cuda.ntt_local_pass, probe_cuda.ntt_stage),
                        variants)[1]
    require_launched("probe_pass", launches)
    # K4 alone at the probe's shape: one middle stage of t = 2^12
    x = inputs[12]
    tw = gf.from_u64(ntt.stage_twiddles(12, False)).cuda()
    require_equal("K4 at (2^12, 2^12)", probe_cuda.ntt_stage(x, tw, 6),
                  probe_cuda.ntt_stage_plain(x, tw, 6))
    emit("probe_pass", stages_checked=checked, launches=launches,
         specs=list(pass_probe.DEFAULT_SPECS))


def phase_probe_alu(rng) -> None:
    """K5 in each form against its twin: at the ALU probe's shape at four
    chain lengths, and at its full shape at the longest."""
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
    fa, fb = alu_probe.operands(alu_probe.FULL_SHAPE)
    k_hi = alu_probe.K_HI

    def chains():
        for op in probe_cuda.CHAIN_OPS:
            for k in (1, 2, 16, k_hi):
                want = probe_cuda.gf_chain_plain(a, b, op, k)
                for form in probe_cuda.CHAIN_FORMS:
                    require_equal(f"K5 {op} {form} k={k}",
                                  probe_cuda.gf_chain(a, b, op, k, form),
                                  want)
        # at the full shape: one mul_lazy chain of K_HI steps in each form
        want = probe_cuda.gf_chain_plain(fa, fb, "mul_lazy", k_hi)
        for form in probe_cuda.CHAIN_FORMS:
            require_equal(f"K5 mul_lazy {form} k={k_hi} at 2^22",
                          probe_cuda.gf_chain(fa, fb, "mul_lazy", k_hi, form),
                          want)

    launches = run_path((probe_cuda.gf_chain,), chains)[1]
    require_launched("probe_alu", launches)
    emit("probe_alu", launches=launches, ops=list(probe_cuda.CHAIN_OPS),
         forms=list(probe_cuda.CHAIN_FORMS), k=[1, 2, 16, k_hi],
         full_shape=list(alu_probe.FULL_SHAPE))


def main() -> None:
    check_device()
    phase_build()
    from twenty_first_tpu_torch.ops import ntt_cuda, poly_cuda, tip5_cuda
    from twenty_first_tpu_torch.tip5.permutation import tip5_tables

    rng = np.random.default_rng(0)
    tables = tip5_tables()
    phase_k1(rng, tables)
    phase_k2(rng, tables)
    phase_k3(rng)
    phase_pinned_roots()
    counters = (tip5_cuda.tip5_permute, tip5_cuda.merkle_level,
                tip5_cuda.merkle_commit, ntt_cuda.ntt_local_pass)
    slice_root = phase_slice(counters)
    phase_entry()
    phase_merkle_objects(counters, slice_root)
    phase_tip5_batch(rng, tables)
    phase_k1_absorb(tables)
    phase_k1_absorb_lanes(tables)
    phase_tip5_mxu(tables)
    poly_counters = (ntt_cuda.ntt_local_pass, poly_cuda.coset_extrapolate_fold,
                     poly_cuda.batch_inversion, poly_cuda.gf_pointwise)
    phase_poly_batch(rng, poly_counters)
    phase_polynomial(poly_counters)
    phase_host_layers((tip5_cuda.tip5_permute, tip5_cuda.merkle_level))
    phase_ntt_large((ntt_cuda.ntt_local_pass,))
    phase_distributed(counters)
    phase_scrambled(counters)
    phase_probe_pass(rng)
    phase_probe_alu(rng)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
