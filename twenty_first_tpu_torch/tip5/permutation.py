"""Batched Tip5 permutation and hashing on the int64 carrier.

The counterpart of ``twenty_first_tpu/tip5/permutation.py``. States are
(..., 16) carrier tensors. One round is

* the S-box: words 0..3 go through the byte lookup table applied to the
  bytes of their *Montgomery* representative x * 2^64 mod p (the table is
  specified on those bytes); words 4..15 are raised to the 7th power;
* the MDS layer: the 16x16 circulant with 16-bit entries as an exact
  integer matvec (its sum is below 2^84, so it takes a full 128-bit
  reduction, not a 64-bit one);
* the addition of the round's constants, which are canonical values (not
  Montgomery forms).

``permutation_plain`` is that arithmetic in plain torch, on any device: the
plain twin of the CUDA kernel (``ops/tip5_cuda.py``). ``permutation`` sends
a CUDA tensor to the kernel and a CPU tensor to the twin; so do
``permutation_batch``, ``trace`` (the kernel's trace mode) and the sponge
entry points, which launch the kernel once per absorbed chunk. The
``*_values``, ``hash_varlen`` and ``hash_varlen_ragged`` entry points take
and return host uint64 arrays and run on ``device``, the card by default.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..math import gf
from .constants import (
    CAPACITY,
    DIGEST_LENGTH,
    LOOKUP_TABLE,
    MDS_MATRIX_FIRST_COLUMN,
    NUM_ROUNDS,
    NUM_SPLIT_AND_LOOKUP,
    RATE,
    ROUND_CONSTANTS,
    STATE_SIZE,
)

_M32 = 0xFFFF_FFFF
_MDS_COL = [int(c) for c in MDS_MATRIX_FIRST_COLUMN]


def tip5_tables(device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """The permutation's tables on ``device``: round constants (80,) int64
    carrier and the byte lookup table (256,) uint8. Made once per device
    and shared (callers must not write to them), so an entry point called
    without tables does not copy them to the card, which would block the
    host, on every call."""
    return _tables_on(torch.device(device))


@functools.lru_cache(maxsize=None)
def _tables_on(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    rc = torch.from_numpy(ROUND_CONSTANTS.view(np.int64).copy())
    lut = torch.from_numpy(LOOKUP_TABLE.astype(np.uint8))
    return rc.to(device), lut.to(device)


# ---------------------------------------------------------------------------
# Plain arithmetic (the kernel's twin)
# ---------------------------------------------------------------------------


def _split_and_lookup(x, lut):
    """Byte-wise table lookup on the Montgomery representative of x."""
    m = gf.to_montgomery(x)
    shifts = torch.arange(0, 64, 8, device=x.device)
    b = (m.unsqueeze(-1) >> shifts) & 0xFF  # arithmetic >> is fine: masked
    out = (lut.to(torch.int64)[b] << shifts).sum(-1)  # disjoint bytes
    return gf.from_montgomery(out)  # `out` may be >= p


def _pow7(x):
    x3 = gf.mul(gf.square(x), x)
    return gf.mul(gf.square(x3), x)


def _mds(state):
    """Exact circulant matvec, then one 128-bit Goldilocks reduction.

    out[i] = sum_k col[k] * x[(i - k) mod 16]. Each word splits into 32-bit
    halves; a half times a 16-bit entry summed over 16 taps stays below
    2^52, so both accumulators are exact in int64.
    """
    lo, hi = state & _M32, gf._shr(state, 32)
    acc_lo = torch.zeros_like(state)
    acc_hi = torch.zeros_like(state)
    for k, c in enumerate(_MDS_COL):
        acc_lo += c * torch.roll(lo, k, -1)
        acc_hi += c * torch.roll(hi, k, -1)
    # value = acc_lo + acc_hi * 2^32 as a 128-bit (lo64, hi64) pair
    mid = (acc_lo >> 32) + (acc_hi & _M32)
    lo64 = (acc_lo & _M32) | (mid << 32)
    hi64 = (acc_hi >> 32) + (mid >> 32)
    return gf.reduce128(lo64, hi64)


def _round(state, rc, lut):
    first = _split_and_lookup(state[..., :NUM_SPLIT_AND_LOOKUP], lut)
    rest = _pow7(state[..., NUM_SPLIT_AND_LOOKUP:])
    state = _mds(torch.cat([first, rest], dim=-1))
    return gf.add(state, rc)


def permutation_plain(state, rc, lut):
    """The 5-round Tip5 permutation of (..., 16) states in plain torch.

    ``rc`` and ``lut`` come from ``tip5_tables``. Canonical output."""
    rc = rc.reshape(NUM_ROUNDS, STATE_SIZE)
    for r in range(NUM_ROUNDS):
        state = _round(state, rc[r], lut)
    return state


def trace_plain(state, rc, lut):
    """(..., 16) states -> (..., 6, 16): the input, then the canonical state
    after each round, in plain torch (the twin of K1's trace mode)."""
    rc = rc.reshape(NUM_ROUNDS, STATE_SIZE)
    states = [state]
    for r in range(NUM_ROUNDS):
        states.append(_round(states[-1], rc[r], lut))
    return torch.stack(states, dim=-2)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def permutation(state, *, tables=None, plain: bool = False):
    """Apply Tip5 to (..., 16) states: the CUDA kernel for a CUDA tensor,
    the plain twin for a CPU tensor or when ``plain`` asks for it."""
    rc, lut = tables if tables is not None else tip5_tables(state.device)
    if plain:
        return permutation_plain(state, rc, lut)
    from ..ops import tip5_cuda

    flat = state.reshape(-1, STATE_SIZE).contiguous()
    return tip5_cuda.tip5_permute(flat, rc, lut).reshape(state.shape)


# The standalone batch permutation of (B, 16) states. The JAX package sends
# aligned batches (B a multiple of 2^12) to its lane-dense Pallas kernel on
# a TPU (``TWENTY_FIRST_TPU_DENSE_PERM``); that dispatch answers TPU lanes
# only. Here every B goes to K1 on a CUDA tensor, to the twin on a CPU one.
permutation_batch = permutation


def trace(state, *, tables=None, plain: bool = False):
    """Permutation trace: (..., 16) -> (..., 6, 16), trace[0] the input and
    trace[1 + i] the canonical state after round i (Tip5::trace). K1's trace
    mode for a CUDA tensor, the plain twin for a CPU tensor or on request."""
    rc, lut = tables if tables is not None else tip5_tables(state.device)
    if plain:
        return trace_plain(state, rc, lut)
    from ..ops import tip5_cuda

    flat = state.reshape(-1, STATE_SIZE).contiguous()
    out = tip5_cuda.tip5_trace(flat, rc, lut)
    return out.reshape(state.shape[:-1] + (NUM_ROUNDS + 1, STATE_SIZE))


def fixed_length_state(rate_input):
    """FixedLength-domain state: rate words from the input, capacity = 1s."""
    cap = torch.ones(rate_input.shape[:-1] + (CAPACITY,),
                     dtype=rate_input.dtype, device=rate_input.device)
    return torch.cat([rate_input, cap], dim=-1)


def hash_10(rate_input, *, tables=None, plain: bool = False):
    """Batched hash_10: (..., 10) -> (..., 5)."""
    state = permutation(fixed_length_state(rate_input), tables=tables,
                        plain=plain)
    return state[..., :DIGEST_LENGTH]


def hash_pair(left, right, *, tables=None, plain: bool = False):
    """Batched hash_pair: two (..., 5) digests -> (..., 5)."""
    return hash_10(torch.cat([left, right], dim=-1), tables=tables,
                   plain=plain)


def padded_length(length: int) -> int:
    """The length of an L-word input after the sponge padding."""
    return (length + 1 + RATE - 1) // RATE * RATE


def pad_for_varlen(x):
    """Append the 1, 0, ..., 0 sponge padding to (..., L) up to a multiple
    of RATE: a carrier tensor on its device, or a host uint64 array on the
    host."""
    length = x.shape[-1]
    shape = tuple(x.shape[:-1]) + (padded_length(length) - length,)
    if isinstance(x, np.ndarray):
        pad = np.zeros(shape, dtype=x.dtype)
        pad[..., 0] = 1
        return np.concatenate([x, pad], axis=-1)
    pad = torch.zeros(shape, dtype=x.dtype, device=x.device)
    pad[..., 0] = 1
    return torch.cat([x, pad], dim=-1)


def hash_varlen_padded(padded, *, tables=None, plain: bool = False):
    """Variable-length hash of already padded equal-length inputs
    (..., k * RATE) -> (..., 5): absorb chunk by chunk (overwrite the rate,
    permute), starting from the all-zero VariableLength state."""
    tables = tables if tables is not None else tip5_tables(padded.device)
    state = torch.zeros(padded.shape[:-1] + (STATE_SIZE,), dtype=padded.dtype,
                        device=padded.device)
    for start in range(0, padded.shape[-1], RATE):
        state = torch.cat([padded[..., start:start + RATE],
                           state[..., RATE:]], dim=-1)
        state = permutation(state, tables=tables, plain=plain)
    return state[..., :DIGEST_LENGTH]


# ---------------------------------------------------------------------------
# Host-array entry points (uint64 numpy in and out), on ``device``
# ---------------------------------------------------------------------------


def _to_device(values, device):
    return gf.from_u64(np.asarray(values, dtype=np.uint64)).to(device)


def permutation_values(states, device="cuda", plain: bool = False):
    """uint64 (..., 16) -> permuted uint64 (..., 16)."""
    return gf.to_u64(permutation(_to_device(states, device), plain=plain))


def permutation_batch_values(states, device="cuda", plain: bool = False):
    """uint64 (B, 16) -> permuted, through ``permutation_batch``."""
    return gf.to_u64(permutation_batch(_to_device(states, device),
                                       plain=plain))


def trace_values(states, device="cuda", plain: bool = False):
    """uint64 (..., 16) -> uint64 (..., 6, 16) permutation traces."""
    return gf.to_u64(trace(_to_device(states, device), plain=plain))


def hash_varlen(values, device="cuda", plain: bool = False) -> np.ndarray:
    """Hash a batch of equal-length inputs: uint64 (..., L) -> (..., 5).

    One K1 launch per absorbed chunk of RATE words (L = 16384 is 1639
    launches of one state each)."""
    padded = pad_for_varlen(_to_device(values, device))
    return gf.to_u64(hash_varlen_padded(padded, plain=plain))


def hash_varlen_ragged(inputs, device="cuda", plain: bool = False):
    """Hash inputs of any lengths (0 included) in one call: a sequence of
    uint64 arrays -> (N, 5) uint64 digests, equal to ``hash_varlen`` of each.

    The inputs are sorted by chunk count, longest first, so the inputs
    still absorbing at step i are a prefix of the batch: step i permutes
    that prefix only (one K1 launch) and updates the state in place. Their
    padded chunks go to the device once, step-major, so no input is padded
    beyond its own length. (The JAX package buckets by powers of two only
    to bound its XLA compiles.)"""
    arrs = [np.asarray(v, dtype=np.uint64).ravel() for v in inputs]
    out = np.empty((len(arrs), DIGEST_LENGTH), dtype=np.uint64)
    if not arrs:
        return out
    counts = np.array([padded_length(a.size) // RATE for a in arrs])
    order = np.argsort(-counts, kind="stable")
    # active[i]: inputs with more than i chunks, a prefix of `order`
    active = np.array([int((counts > i).sum())
                       for i in range(int(counts.max()))])
    offsets = np.concatenate([[0], np.cumsum(active)])
    chunks = np.zeros((int(offsets[-1]), RATE), dtype=np.uint64)
    for row, idx in enumerate(order):
        # on the host: torch calls per input tripled the host time of a
        # 256-input batch
        chunks[offsets[:int(counts[idx])] + row] = pad_for_varlen(
            arrs[idx]).reshape(-1, RATE)
    x = _to_device(chunks, device)
    tables = tip5_tables(x.device)
    state = torch.zeros((len(arrs), STATE_SIZE), dtype=x.dtype,
                        device=x.device)
    for i, rows in enumerate(active.tolist()):
        absorbed = torch.cat([x[offsets[i]:offsets[i] + rows],
                              state[:rows, RATE:]], dim=-1)
        state[:rows] = permutation(absorbed, tables=tables, plain=plain)
    out[order] = gf.to_u64(state[:, :DIGEST_LENGTH])
    return out
