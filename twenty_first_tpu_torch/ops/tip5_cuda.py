"""Wrappers of the Tip5 kernels in ``csrc/tip5.cu``, beside their plain twins.

The counterpart of ``twenty_first_tpu/ops/tip5_pallas.py``:

* K1 ``tip5_permute`` (replaces ``permute_packed`` / ``_dense_kernel``):
  (rows, 16) states -> permuted states, one thread per state; its trace
  mode ``tip5_trace`` (a compile-time variant of the same kernel) writes
  the (rows, 6, 16) round states of ``tip5/permutation.py::trace``;
* K2 ``merkle_commit`` (replaces ``permute_packed_multi`` /
  ``_make_dense_multi_kernel`` and the ``tip5_packed`` pairing glue): one
  launch reduces several Merkle levels, a block at a time.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
twin. Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from .. import _build
from ..tip5.constants import DIGEST_LENGTH, NUM_ROUNDS, STATE_SIZE
from ..tip5.permutation import (fixed_length_state, permutation_plain,
                                trace_plain)

#: Largest K2 block (threads); it bounds the levels one launch can fuse.
MAX_THREADS = 256


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


# ---------------------------------------------------------------------------
# K2: the multi-level Merkle commit
# ---------------------------------------------------------------------------


def _pair_level(digests, rc, lut):
    """One Merkle level: (2b, 5) -> (b, 5), parent j = hash_pair(2j, 2j+1)."""
    states = fixed_length_state(digests.reshape(-1, 2 * DIGEST_LENGTH))
    return permutation_plain(states, rc, lut)[:, :DIGEST_LENGTH].contiguous()


def merkle_commit_plain(x, leaf: bool, levels: int, threads: int, rc, lut):
    """Plain twin of one K2 launch (``threads`` only shapes the launch)."""
    del threads
    if leaf:
        x = permutation_plain(x, rc, lut)[:, :DIGEST_LENGTH].contiguous()
    for _ in range(levels):
        x = _pair_level(x, rc, lut)
    return x


def merkle_commit(x, leaf: bool, levels: int, threads: int, rc, lut):
    """One K2 launch.

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
