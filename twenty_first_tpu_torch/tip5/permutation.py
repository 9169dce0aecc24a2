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
a CUDA tensor to the kernel and a CPU tensor to the twin.
"""

from __future__ import annotations

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


def tip5_tables(device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The permutation's tables on ``device``: round constants (80,) int64
    carrier and the byte lookup table (256,) uint8."""
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


def pad_for_varlen(x):
    """Append the 1, 0, ..., 0 sponge padding to (..., L) up to a multiple
    of RATE."""
    length = x.shape[-1]
    pad_to = (length + 1 + RATE - 1) // RATE * RATE
    pad = torch.zeros(x.shape[:-1] + (pad_to - length,), dtype=x.dtype,
                      device=x.device)
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
