"""Wrappers of the Tip5 kernels in ``csrc/tip5.cu``, beside their plain twins.

The counterpart of ``twenty_first_tpu/ops/tip5_pallas.py``:

* K1 ``tip5_permute`` (replaces ``permute_packed`` / ``_dense_kernel``):
  (rows, 16) states -> permuted states, one thread per state; its trace
  mode ``tip5_trace`` (a compile-time variant of the same kernel) writes
  the (rows, 6, 16) round states of ``tip5/permutation.py::trace``; its
  absorb mode ``tip5_absorb`` (an overload of the kernel) is the whole
  sponge of ``hash_varlen_padded`` in one launch, a thread per row, or, in
  its lane mode (a third overload), 16 lanes a row for launches of too few
  rows to fill the card (``lane_mode``);
* K2, the Merkle tree (replaces ``permute_packed_multi`` /
  ``_make_dense_multi_kernel`` and the ``tip5_packed`` pairing glue), two
  launches: ``merkle_level`` reduces one level at full width, a thread per
  parent; ``merkle_commit`` fuses several levels in one launch, a block at
  a time, for the levels too small to fill the card.
  ``ops/tip5_commit.py`` plans them from ``resident_threads``.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
twin. Each wrapper counts its launches in ``<wrapper>.launches``; the
absorb mode's launches are K1's, counted in ``tip5_permute.launches``, and
those in the lane mode also in ``tip5_absorb.lane_launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..tip5.constants import DIGEST_LENGTH, NUM_ROUNDS, RATE, STATE_SIZE
from ..tip5.permutation import (fixed_length_state, permutation_plain,
                                trace_plain)

#: Largest block of K2's fused launch; it bounds the levels one launch can
#: fuse.
MAX_THREADS = 256
#: ``tf_tip5_occupancy``'s kernel numbers (csrc/tip5.cu)
OCCUPANCY_KERNEL = {"tip5_permute": 0, "tip5_trace": 1, "merkle_level": 2,
                    "merkle_commit": 3, "tip5_absorb": 4,
                    "tip5_absorb_lanes": 5}
#: K1's absorb mode takes its lane mode below the card's resident threads
#: over this many rows (``lane_mode``): on an H100 the two modes' times at
#: 16,390 words a row cross near 14,100 rows, 67,584 / 4.8 (PERF.md, K1a)
LANE_ROWS_DIVISOR = 5


def _check_tables(rc, lut, device):
    if rc.dtype != torch.int64 or rc.shape != (80,) or rc.device != device:
        raise ValueError("rc must be the (80,) int64 round constants on the "
                         "states' device")
    if lut.dtype != torch.uint8 or lut.shape != (256,) or lut.device != device:
        raise ValueError("lut must be the (256,) uint8 lookup table on the "
                         "states' device")
    if not (rc.is_contiguous() and lut.is_contiguous()):
        raise ValueError("rc and lut must be contiguous")


def _check_rows(x, width: int, what: str):
    if x.dtype != torch.int64 or x.dim() != 2 or x.shape[1] != width:
        raise ValueError(f"{what} must be a (rows, {width}) int64 tensor, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _require_cuda(x):
    if not x.is_cuda:
        raise ValueError(f"no kernel for device {x.device}")


def _aligned(x):
    """x itself where it starts on a 16-byte boundary, else an aligned copy:
    the kernels read rows with 16-byte loads."""
    return x.clone() if x.data_ptr() % 16 else x


def occupancy(kernel: str, device=None, threads: int = MAX_THREADS):
    """(threads per block, resident blocks per SM) of one Tip5 kernel on a
    CUDA device, from the CUDA runtime; ``threads`` sets the fused launch's
    block only."""
    lib = _build.load()
    block, blocks = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        _build.check(lib.tf_tip5_occupancy(OCCUPANCY_KERNEL[kernel], threads,
                                           ctypes.byref(block),
                                           ctypes.byref(blocks)),
                     "tip5_occupancy")
    return block.value, blocks.value


@functools.lru_cache(maxsize=None)
def _resident_threads(device: torch.device, kernel: str) -> int:
    block, blocks = occupancy(kernel, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * blocks * block


def resident_threads(device, kernel: str = "merkle_level") -> int:
    """Threads of one Tip5 kernel (K2's level kernel unless ``kernel``
    names another) that the card holds at once: its SMs (the device's
    properties) times the kernel's resident blocks per SM times its block
    size. 0 for a CPU device, where the plain twins run."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    return _resident_threads(device, kernel)


# ---------------------------------------------------------------------------
# K1: the permutation
# ---------------------------------------------------------------------------

tip5_permute_plain = permutation_plain


def tip5_permute(states, rc, lut):
    """(rows, 16) int64 states -> permuted states (a new tensor)."""
    _check_rows(states, STATE_SIZE, "states")
    _check_tables(rc, lut, states.device)
    if states.device.type == "cpu":
        return tip5_permute_plain(states, rc, lut)
    _require_cuda(states)
    states = _aligned(states)
    out = torch.empty_like(states)
    if states.shape[0] == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(states.device):
        err = lib.tf_tip5_permute(
            states.data_ptr(), out.data_ptr(), states.shape[0],
            rc.data_ptr(), lut.data_ptr(), _build.stream_of(states))
        _build.check(err, "tip5_permute")
    tip5_permute.launches += 1
    return out


tip5_permute.launches = 0

tip5_trace_plain = trace_plain


def tip5_trace(states, rc, lut):
    """(rows, 16) int64 states -> (rows, 6, 16): the input and the canonical
    state after each round (K1's trace mode)."""
    _check_rows(states, STATE_SIZE, "states")
    _check_tables(rc, lut, states.device)
    if states.device.type == "cpu":
        return tip5_trace_plain(states, rc, lut)
    _require_cuda(states)
    states = _aligned(states)
    out = torch.empty((states.shape[0], NUM_ROUNDS + 1, STATE_SIZE),
                      dtype=states.dtype, device=states.device)
    if states.shape[0] == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(states.device):
        err = lib.tf_tip5_trace(
            states.data_ptr(), out.data_ptr(), states.shape[0],
            rc.data_ptr(), lut.data_ptr(), _build.stream_of(states))
        _build.check(err, "tip5_trace")
    tip5_trace.launches += 1
    return out


tip5_trace.launches = 0


def tip5_absorb_plain(padded, rc, lut):
    """Plain twin of ``tip5_absorb``: absorb chunk by chunk (overwrite the
    rate, permute), starting from the all-zero VariableLength state."""
    state = torch.zeros(padded.shape[:-1] + (STATE_SIZE,),
                        dtype=padded.dtype, device=padded.device)
    for start in range(0, padded.shape[-1], RATE):
        state = torch.cat([padded[..., start:start + RATE],
                           state[..., RATE:]], dim=-1)
        state = permutation_plain(state, rc, lut)
    return state[..., :DIGEST_LENGTH]


def lane_mode(rows: int, resident: int) -> bool:
    """Whether ``tip5_absorb`` runs ``rows`` rows in K1's lane mode (16
    lanes a row) rather than a thread a row, on a card that holds
    ``resident`` threads of the thread-a-row mode
    (``resident_threads(device, "tip5_absorb")``; 0 without a card).

    A thread a row issues the fewest instructions a row, but until its
    warps fill the card's schedulers a launch takes one row's latency
    whatever the count of rows (18.3 ms for a row of 16,384 words on an
    H100); the lane mode takes an eighth of that latency and issues about
    1.6 times the instructions a row, so its time grows with the rows from
    about a thousand rows on. The times cross at about a fifth of the
    resident threads (PERF.md, K1a)."""
    return 0 < rows < resident // LANE_ROWS_DIVISOR


def tip5_absorb(padded, rc, lut):
    """(rows, k * 10) int64 padded inputs -> (rows, 5) digests: each row's
    k chunks absorbed in turn from the all-zero VariableLength state (K1's
    absorb mode: one launch, a row's state in registers, a thread's or, in
    the lane mode, 16 lanes' (``lane_mode``)). Rows may lie at any stride;
    the words of a row must be contiguous."""
    if (padded.dtype != torch.int64 or padded.dim() != 2
            or padded.shape[1] % RATE):
        raise ValueError(f"padded inputs must be a (rows, k * {RATE}) int64 "
                         f"tensor, got {tuple(padded.shape)} {padded.dtype}")
    if padded.numel() and padded.stride(1) != 1:
        raise ValueError("the words of a padded row must be contiguous")
    _check_tables(rc, lut, padded.device)
    if padded.device.type == "cpu":
        return tip5_absorb_plain(padded, rc, lut)
    _require_cuda(padded)
    rows = padded.shape[0]
    out = torch.empty((rows, DIGEST_LENGTH), dtype=padded.dtype,
                      device=padded.device)
    if rows == 0:
        return out
    lib = _build.load()
    lanes = lane_mode(rows, resident_threads(padded.device, "tip5_absorb"))
    launch = lib.tf_tip5_absorb_lanes if lanes else lib.tf_tip5_absorb
    with torch.cuda.device(padded.device):
        err = launch(
            padded.data_ptr(), out.data_ptr(), rows, padded.stride(0),
            padded.shape[1] // RATE, rc.data_ptr(), lut.data_ptr(),
            _build.stream_of(padded))
        _build.check(err, "tip5_absorb")
    tip5_permute.launches += 1
    if lanes:
        tip5_absorb.lane_launches += 1
    return out


tip5_absorb.lane_launches = 0


# ---------------------------------------------------------------------------
# K2: the Merkle tree, one full-width level or several fused levels a launch
# ---------------------------------------------------------------------------


def _pair_level(digests, rc, lut):
    """One Merkle level: (2b, 5) -> (b, 5), parent j = hash_pair(2j, 2j+1)."""
    states = fixed_length_state(digests.reshape(-1, 2 * DIGEST_LENGTH))
    return permutation_plain(states, rc, lut)[:, :DIGEST_LENGTH].contiguous()


def merkle_level_plain(x, leaf: bool, rc, lut, out=None):
    """Plain twin of ``merkle_level``."""
    if leaf:
        parents = permutation_plain(x, rc, lut)[:, :DIGEST_LENGTH].contiguous()
    else:
        parents = _pair_level(x, rc, lut)
    return parents if out is None else out.copy_(parents)


def _check_out(out, parents: int, x):
    if (out.dtype != torch.int64 or out.shape != (parents, DIGEST_LENGTH)
            or out.device != x.device):
        raise ValueError(f"out must be a ({parents}, {DIGEST_LENGTH}) int64 "
                         f"tensor on {x.device}, got {tuple(out.shape)} "
                         f"{out.dtype} on {out.device}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")


def merkle_level(x, leaf: bool, rc, lut, out=None):
    """One K2 level at full width, a thread per parent.

    leaf mode: x is (rows, 16) leaf states -> (rows, 5) digests;
    pair mode: x is (rows, 5) digests, rows even -> (rows / 2, 5).

    ``out``, if given, is a contiguous (parents, 5) int64 tensor that
    receives the parents and is returned: say the rows of a tree's node
    tensor that hold the level. Only the input must start on a 16-byte
    boundary (the kernel loads rows in 16-byte chunks; ``_aligned``); it
    stores each digest a word at a time, so ``out`` may start at any row,
    the root's row 1 included.
    """
    _check_rows(x, STATE_SIZE if leaf else DIGEST_LENGTH,
                "leaf states" if leaf else "digests")
    if not leaf and x.shape[0] % 2:
        raise ValueError(f"{x.shape[0]} digests do not pair up")
    _check_tables(rc, lut, x.device)
    parents = x.shape[0] if leaf else x.shape[0] // 2
    if out is not None:
        _check_out(out, parents, x)
    if x.device.type == "cpu":
        return merkle_level_plain(x, leaf, rc, lut, out=out)
    _require_cuda(x)
    x = _aligned(x)
    dst = out if out is not None else torch.empty(
        (parents, DIGEST_LENGTH), dtype=x.dtype, device=x.device)
    if parents > 0:
        lib = _build.load()
        with torch.cuda.device(x.device):
            err = lib.tf_merkle_level(x.data_ptr(), dst.data_ptr(), parents,
                                      int(leaf), rc.data_ptr(),
                                      lut.data_ptr(), _build.stream_of(x))
            _build.check(err, "merkle_level")
        merkle_level.launches += 1
    return dst


merkle_level.launches = 0


def merkle_commit_plain(x, leaf: bool, levels: int, threads: int, rc, lut):
    """Plain twin of one K2 launch (``threads`` only shapes the launch)."""
    del threads
    if leaf:
        x = permutation_plain(x, rc, lut)[:, :DIGEST_LENGTH].contiguous()
    for _ in range(levels):
        x = _pair_level(x, rc, lut)
    return x


def merkle_commit(x, leaf: bool, levels: int, threads: int, rc, lut):
    """One fused K2 launch.

    leaf mode: x is (rows, 16) leaf states; each block of ``threads`` rows
    hashes them and reduces ``levels`` levels: rows >> levels digests out.
    pair mode: x is (rows, 5) digests; each block takes 2 * ``threads`` of
    them through ``levels`` >= 1 levels: rows >> levels digests out.
    """
    if threads < 1 or threads > MAX_THREADS or threads & (threads - 1):
        raise ValueError(f"threads must be a power of two <= {MAX_THREADS}")
    span = threads if leaf else 2 * threads  # input rows per block
    if levels < (0 if leaf else 1) or (1 << levels) > span:
        raise ValueError(f"levels={levels} does not fit a block of {span} rows")
    _check_rows(x, STATE_SIZE if leaf else DIGEST_LENGTH,
                "leaf states" if leaf else "digests")
    if x.shape[0] % span:
        raise ValueError(f"{x.shape[0]} rows is not a multiple of {span}")
    _check_tables(rc, lut, x.device)
    if x.device.type == "cpu":
        return merkle_commit_plain(x, leaf, levels, threads, rc, lut)
    _require_cuda(x)
    x = _aligned(x)
    out = torch.empty((x.shape[0] >> levels, DIGEST_LENGTH), dtype=x.dtype,
                      device=x.device)
    if x.shape[0] == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.tf_merkle_commit(
            x.data_ptr(), out.data_ptr(), x.shape[0] // span, threads,
            int(leaf), levels, rc.data_ptr(), lut.data_ptr(),
            _build.stream_of(x))
        _build.check(err, "merkle_commit")
    merkle_commit.launches += 1
    return out


merkle_commit.launches = 0
