#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (twenty_first_tpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the hand-written kernels from twenty_first_tpu_torch/csrc with
nvcc, holds each against its plain PyTorch twin on the card (exact
equality: this is integer field arithmetic), reproduces values pinned from
the JAX reference, and drives five paths, each with every launch counter
set to 0 just before it and read just after:

* the flagship step (W = 8 trace columns, n = 2^20, expansion 4: a
  2^22-row LDE + Tip5 Merkle commit) and the entry point (K1, K3 and K2's
  two launches: the full-width level and the fused tail);
* the standalone Tip5 batch path: permutation_batch at 2^16 and 2^22
  states, the T4/T5 entry points, trace, hash_varlen and
  hash_varlen_ragged (K1 and its trace mode);
* the polynomial batch path (math/poly_batch.py, the NTT-domain
  convolutions and gf_ext's batch inversion) at full width: the
  out-of-domain extrapolations of bench.py's shape and of the flagship
  trace's width and length, the barycentric evaluation, the coset LDE and
  its inverse, batch products, convolutions at 2^22 and 2^20 (K3, K6, K7
  and K8);
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
polynomial batch path's outputs equal its plain twins' on the card and
PINNED_EXTRAPOLATE reproduces through the kernels; K7 is timed launch by
launch at the path's two shapes. Any failure raises: a
non-zero exit and no device line.
It needs a CUDA device and refuses to run without one.
"""

from __future__ import annotations

import hashlib
import json
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

# the main path's full width: W trace columns of length N, expansion E
W, N, E = 8, 1 << 20, 4
# the Tip5 batch path: permutation_batch at the reference's hash_parallel
# size (benches/tip5.rs) and at the main path's leaf count; the T4/T5 entry
# points at bench.py's smoke shape; trace; a ragged batch of mixed lengths
BATCH_STATES = (1 << 16, N * E)
T45_STATES = 4096
TRACE_STATES = 1 << 16
MIXED_INPUTS, MIXED_MAX_LENGTH = 256, 120

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
#: canonical edge words K3's checks mix into their inputs
K3_EDGES = (0, 1, P - 1, 1 << 32, (1 << 32) - 1)
#: the device kernels of csrc/ by name; every other kernel of a step is glue
OWN_KERNELS = ("tip5_permute_kernel", "merkle_commit_kernel",
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


def bound(nbytes: int, imads: int, either: int = 0) -> dict:
    """bound_ms and what sets it, for ``nbytes`` moved, ``imads`` products
    that only the IMAD pipe does and ``either`` that the IMAD or the FP64
    pipe may do."""
    from twenty_first_tpu_torch.probes import timing

    clock = timing.sm_clock_mhz()[1]
    imad_per_s = timing.lane_rate(timing.IMAD_LANES_PER_SM, clock)
    fp64_per_s = timing.lane_rate(timing.FP64_LANES_PER_SM, clock)
    mem_ms = nbytes / timing.MEMORY_BYTES_PER_S * 1e3
    ops_ms = max(imads / imad_per_s,
                 (imads + either) / (imad_per_s + fp64_per_s)) * 1e3
    return {"bound_ms": max(mem_ms, ops_ms),
            "bound_by": "bytes" if mem_ms >= ops_ms else "operations",
            "bound_bytes": nbytes, "bound_imads": imads,
            "bound_imad_or_fp64_products": either}


def tip5_bound(nbytes: int, perms: int) -> dict:
    """``bound`` of ``perms`` Tip5 permutations moving ``nbytes``."""
    return bound(nbytes, POW7_PRODUCTS_PER_PERM * perms,
                 MDS_PRODUCTS_PER_PERM * perms)


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
            **summary, "plan": plan, "resident_threads": resident,
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


def phase_tip5_counts(instructions_per_s) -> dict:
    """Registers, spills, resident warps and SASS per permutation of the
    Tip5 kernels (probes/tip5_probe.py), by kernel."""
    from twenty_first_tpu_torch.probes import tip5_probe

    stats = tip5_probe.kernel_stats()
    emit("tip5_sass", instructions_per_s=instructions_per_s, **{
        name: {k: v for k, v in st.items() if k != "round_opcodes"}
        for name, st in stats.items()})
    return stats


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
    launches = phase_slice(counters)
    phase_entry()
    batch = phase_tip5_batch(rng, tables)
    from twenty_first_tpu_torch.ops import poly_cuda

    poly = phase_poly_batch(rng, (
        ntt_cuda.ntt_local_pass, poly_cuda.coset_extrapolate_fold,
        poly_cuda.batch_inversion, poly_cuda.gf_pointwise))
    probe_pass = phase_probe_pass(rng)
    probe_alu = phase_probe_alu(rng)
    rate = probe_alu["instructions_per_s"]
    stats = phase_tip5_counts(rate)
    k1.update(tip5_probe.counts(stats, "tip5_permute", N * E, rate))
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
                     + batch["launches"]["tip5_permute"],
         "launches_by_path": {"slice": launches["tip5_permute"],
                              "tip5_batch": batch["launches"]["tip5_permute"]},
         **k1, **NO_LIBRARY, "trace_mode": batch["trace"]},
        {"name": "merkle_commit", "route": "cuda",
         "source": "twenty_first_tpu_torch/csrc/tip5.cu",
         "replaces": f"{pallas}:262 (T2)",
         "launches": launches["merkle_commit"] + launches["merkle_level"],
         "launches_by_wrapper": {"merkle_level": launches["merkle_level"],
                                 "merkle_commit": launches["merkle_commit"]},
         **k2, **NO_LIBRARY},
        {"name": "ntt_local_pass", "route": "cuda",
         "source": "twenty_first_tpu_torch/csrc/ntt.cu",
         "replaces": "twenty_first_tpu/ops/ntt_pallas.py:47 (T3); "
                     "scripts/prof_pallas_pass.py:53 (T6); "
                     "scripts/prof_pallas_pass.py:110 (T7)",
         "launches": launches["ntt_local_pass"]
                     + poly["launches"]["ntt_local_pass"]
                     + probe_pass["launches"]["ntt_local_pass"],
         "launches_by_path": {
             "slice": launches["ntt_local_pass"],
             "poly_batch": poly["launches"]["ntt_local_pass"],
             "probe_pass": probe_pass["launches"]["ntt_local_pass"]},
         "t7_launches_per_pass": probe_pass["k3_per_tile_launches"],
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
         "launches": poly["launches"]["coset_extrapolate_fold"],
         **poly["k6"], **NO_LIBRARY},
        {"name": "batch_inversion", "route": "cuda",
         "source": "twenty_first_tpu_torch/csrc/poly.cu",
         "replaces": "twenty_first_tpu/math/gf.py:503 (batch_inversion); "
                     "plain jnp, no Pallas kernel",
         "launches": poly["launches"]["batch_inversion"],
         **poly["k7"], **NO_LIBRARY},
        {"name": "gf_pointwise", "route": "cuda",
         "source": "twenty_first_tpu_torch/csrc/poly.cu",
         "replaces": "twenty_first_tpu/math/gf_ext.py:71 (mul); :84 "
                     "(mul_base); twenty_first_tpu/math/gf.py:444 "
                     "(inverse_or_zero) and gf.mul; plain jnp, no Pallas "
                     "kernel",
         "launches": poly["launches"]["gf_pointwise"],
         **poly["k8"], **NO_LIBRARY},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
