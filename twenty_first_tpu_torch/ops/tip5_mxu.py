"""Tip5 with its MDS layer as exact byte matrix products: the counterpart of
``twenty_first_tpu/ops/tip5_mxu.py``, on Hopper's integer tensor cores.

The JAX module puts the 16x16 MDS circulant on the TPU's matrix unit: each
state word splits into 8 byte planes, each 16-bit circulant entry into a
low and a high byte, and every byte x byte product summed over 16 taps is
exact; the partial sums regroup by byte shift into one 128-bit reduction.
Here that is K9 (``tip5_permute_mma``, ``csrc/tip5_mma.cu``): u8 x u8 ->
s32 ``mma.sync`` on the integer tensor cores, 24 a round for each tile of
16 states, two tiles a warp (the odd byte shifts one k32 product each, the
even ones two chained k16 with the round constant in the accumulator),
with the S-box on the CUDA cores (x^7 three products deep on lazy
residues). ``MDS_BYTE_BLOCKS`` are
the circulant's byte blocks (the de-interleaved ``_M_LO``/``_M_HI`` of the
JAX module).

The entry points keep the JAX layouts: ``permutation`` takes and returns
(B, 16) uint32 limb planes (``gf.to_limbs``' form), ``permutation_dense``
the lane-dense (rows, 128) planes, lane = word * 8 + substate (the same
values at the same positions; index moves around the kernel), and
``permutation_values`` host uint64 arrays. A CUDA tensor launches K9, or
raises; a CPU tensor, or ``plain=True``, takes the plain twin
``tip5_permute_mma_plain``, whose MDS is ``_mds_mxu``'s byte-plane
arithmetic with its exact products in float64 (TF32 settings cannot reach
them). Unlike the JAX ``permutation``, any B is taken, not only multiples
of 8. K9 is not on the step's path: K1 (``ops/tip5_cuda.py``) is.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..math import gf
from ..tip5.constants import MDS_MATRIX_FIRST_COLUMN, NUM_ROUNDS, STATE_SIZE
from ..tip5.permutation import _pow7, _split_and_lookup, tip5_tables
from .tip5_cuda import _check_rows, _check_tables, _require_cuda

_M32 = 0xFFFF_FFFF
_SBOX = 4  # words through the byte lookup


def _byte_blocks() -> np.ndarray:
    """(2, 16, 16) int64: block e holds byte e (0 low, 1 high) of the
    circulant entry that takes input word j to output word i, at [e, j, i]:
    byte e of col[(i - j) mod 16]."""
    col = MDS_MATRIX_FIRST_COLUMN.astype(np.int64)
    words = np.arange(STATE_SIZE)
    c = col[(words[None, :] - words[:, None]) % STATE_SIZE]
    return np.stack([c & 0xFF, c >> 8])


#: the MDS circulant's low and high byte blocks, [e, input word, output word]
MDS_BYTE_BLOCKS = _byte_blocks()


@functools.lru_cache(maxsize=None)
def _blocks_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(MDS_BYTE_BLOCKS.astype(np.float64)).to(device)


def mds_bytes(state):
    """The MDS of (..., 16) words of any u64 (int64 carrier), canonical out,
    as ``_mds_mxu`` computes it: byte planes x byte blocks, exact (each
    product sum below 2^20, in float64), grouped by byte shift s = k + e
    into S[s] < 2^21, byte pairs folded into 16-bit groups
    h_u = S[2u] + 2^8 S[2u + 1], and the 128-bit value sum_u h_u 2^(16u)
    reduced mod p."""
    shifts = torch.arange(0, 64, 8, device=state.device)
    planes = ((state.unsqueeze(-2) >> shifts[:, None]) & 0xFF).to(
        torch.float64)  # (..., 8, 16): byte k of each word
    blocks = _blocks_on(state.device)
    low, high = planes @ blocks[0], planes @ blocks[1]
    zero = torch.zeros_like(low[..., :1, :])
    s = (torch.cat([low, zero], -2) + torch.cat([zero, high], -2)).to(
        torch.int64)  # (..., 9, 16): S[s] = plane_s C0 + plane_(s-1) C1
    h0, h1, h2, h3 = (s[..., 0:8:2, :] + (s[..., 1:8:2, :] << 8)).unbind(-2)
    x0 = h0 + ((h1 & 0xFFFF) << 16)
    x1 = h2 + (h1 >> 16) + (x0 >> 32) + ((h3 & 0xFFFF) << 16)
    x2 = s[..., 8, :] + (h3 >> 16) + (x1 >> 32)
    return gf.reduce128((x0 & _M32) | (x1 << 32), x2)


def _round(state, rc, lut):
    first = _split_and_lookup(state[..., :_SBOX], lut)
    rest = _pow7(state[..., _SBOX:])
    return gf.add(mds_bytes(torch.cat([first, rest], dim=-1)), rc)


def tip5_permute_mma_plain(states, rc, lut):
    """K9's plain twin: the permutation of (..., 16) states with the
    byte-plane MDS, canonical out, on any device."""
    rc = rc.reshape(NUM_ROUNDS, STATE_SIZE)
    for r in range(NUM_ROUNDS):
        states = _round(states, rc[r], lut)
    return states


def tip5_permute_mma(states, rc, lut):
    """K9: (rows, 16) int64 states -> permuted states (a new tensor), the
    MDS on the integer tensor cores. Counts its launches in ``.launches``."""
    _check_rows(states, STATE_SIZE, "states")
    _check_tables(rc, lut, states.device)
    if states.device.type == "cpu":
        return tip5_permute_mma_plain(states, rc, lut)
    _require_cuda(states)
    out = torch.empty_like(states)
    if states.shape[0] == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(states.device):
        err = lib.tf_tip5_permute_mma(
            states.data_ptr(), out.data_ptr(), states.shape[0],
            rc.data_ptr(), lut.data_ptr(), _build.stream_of(states))
        _build.check(err, "tip5_permute_mma")
    tip5_permute_mma.launches += 1
    return out


tip5_permute_mma.launches = 0


def occupancy(device=None) -> tuple[int, int]:
    """(threads per block, resident blocks per SM) of K9 on a CUDA device,
    from the CUDA runtime."""
    lib = _build.load()
    block, blocks = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        _build.check(lib.tf_tip5_mma_occupancy(ctypes.byref(block),
                                               ctypes.byref(blocks)),
                     "tip5_mma_occupancy")
    return block.value, blocks.value


def _permute(states, plain: bool):
    rc, lut = tip5_tables(states.device)
    states = states.contiguous()
    if plain:
        return tip5_permute_mma_plain(states, rc, lut)
    return tip5_permute_mma(states, rc, lut)


def _interleave(x):
    """(b, 16) -> (b / 8, 128), lane = word * 8 + substate."""
    b = x.shape[0]
    return x.reshape(b // 8, 8, STATE_SIZE).transpose(1, 2).reshape(
        b // 8, 8 * STATE_SIZE)


def _deinterleave(x):
    """(rows, 128) -> (rows * 8, 16): the inverse of ``_interleave``."""
    rows = x.shape[0]
    return x.reshape(rows, STATE_SIZE, 8).transpose(1, 2).reshape(
        rows * 8, STATE_SIZE)


def permutation_dense(state, *, plain: bool = False):
    """The permutation on lane-dense (rows, 128) uint32 limb planes
    (lo, hi), 8 states a row, lane = word * 8 + substate: (lo, hi) out in
    the same layout."""
    lo, hi = state
    out = _interleave(_permute(_deinterleave(gf.carrier_of((lo, hi))),
                               plain))
    return gf.limbs_of(out)


def permutation(lo, hi, *, plain: bool = False):
    """The permutation of (B, 16) uint32 limb planes: (lo, hi) out."""
    return gf.limbs_of(_permute(gf.carrier_of((lo, hi)), plain))


def permutation_values(states, device="cuda", plain: bool = False):
    """uint64 (B, 16) -> permuted uint64 (B, 16), on ``device``."""
    states = np.asarray(states, dtype=np.uint64)
    lo, hi = gf.to_limbs(states, device)
    return gf.from_limbs(permutation(lo, hi, plain=plain))
