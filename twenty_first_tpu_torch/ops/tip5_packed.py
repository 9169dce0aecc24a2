"""The packed Tip5 commit's entry points, over K1/K2: the counterpart of
``twenty_first_tpu/ops/tip5_packed.py``.

The JAX module keeps a whole Merkle commit in the TPU's lane packing
(8 states a 128-lane row, strided: state c at row c mod R, lane
word * 8 + c // R) so that no layer pays a transpose at its kernel's
boundary. The packing answers TPU lanes only. Here:

* ``pack_states``, ``unpack_states``, ``unpack_digests`` and
  ``pair_packed`` are the same index moves on (lo, hi) uint32 planes (any
  dtype: they move elements), ``pair_packed`` writing the capacity words
  as 1 (lo) and 0 (hi);
* ``reduce_layers_packed`` and ``commit_states_packed`` take and return
  the natural-layout planes, (b, 5) digests or (B, 16) states and their
  digests, and run K2's plan (``ops/tip5_commit.py``: the leaf hash, the
  full-width levels, the fused tail) on the int64 carrier between. Their
  ``tile`` and ``interpret`` keep the JAX signatures and are ignored, so
  every size takes the one route, eligible or not.

A CUDA tensor launches the kernels (or raises); a CPU tensor takes their
plain twins.
"""

from __future__ import annotations

import torch

from ..math import gf
from ..tip5.constants import DIGEST_LENGTH, RATE, STATE_SIZE
from . import tip5_commit

#: the JAX module's block height for its packed kernels; kept for
#: ``packed_eligible``, no launch here reads it
TILE = 512

#: the JAX module's Merkle levels fused per kernel call; K2's plan fuses
#: its own (``tip5_commit.plan``)
MULTI_LEVELS = 1


def pack_states(lo, hi):
    """Natural (B, 16) limb planes -> strided-packed (B/8, 128) planes."""
    r = lo.shape[0] // 8

    def f(x):
        return x.reshape(8, r, STATE_SIZE).permute(1, 2, 0).reshape(r, 128)

    return f(lo), f(hi)


def unpack_states(ilo, ihi):
    """Inverse of pack_states: (R, 128) -> (8R, 16)."""
    r = ilo.shape[0]

    def f(x):
        return x.reshape(r, STATE_SIZE, 8).permute(2, 0, 1).reshape(
            8 * r, STATE_SIZE)

    return f(ilo), f(ihi)


def unpack_digests(ilo, ihi):
    """Packed post-permutation planes (R, 128) -> natural (8R, 5) digests.

    Digest word w of state c = q*R + r sits at [r, w*8 + q] (w < 5); lanes
    >= 40 hold the discarded sponge tail.
    """
    r = ilo.shape[0]

    def f(x):
        return x.reshape(r, STATE_SIZE, 8)[:, :DIGEST_LENGTH, :].permute(
            2, 0, 1).reshape(8 * r, DIGEST_LENGTH)

    return f(ilo), f(ihi)


def pair_packed(ilo, ihi):
    """Merkle pairing in packed layout: (R, 128) child digest planes ->
    (R/2, 128) parent hash-pair states (capacity = FixedLength domain)."""
    rate = 8 * DIGEST_LENGTH  # one digest: 40 lanes
    cap = 8 * (STATE_SIZE - RATE)  # 6 capacity words: 48 lanes

    def f(x, fill):
        even, odd = x[0::2], x[1::2]
        cap_words = torch.full((even.shape[0], cap), fill, dtype=x.dtype,
                               device=x.device)
        return torch.cat([even[:, :rate], odd[:, :rate], cap_words], 1)

    return f(ilo, 1), f(ihi, 0)


def packed_eligible(num_states: int, tile: int = TILE) -> bool:
    """True iff a (num_states, 16) hash layer can enter the JAX package's
    packed path (its predicate; the port's commit takes every size)."""
    r = num_states // 8
    return num_states % 8 == 0 and r >= tile and r % tile == 0


def reduce_layers_packed(state, num_layers: int, tile: int = TILE,
                         interpret: bool = False):
    """(b, 5) digest planes (lo, hi) -> (b / 2^num_layers, 5): repeated
    hash_pair through K2's plan. ``tile`` and ``interpret`` are ignored."""
    del tile, interpret
    out = tip5_commit.reduce_layers(gf.carrier_of(state), num_layers)
    return gf.limbs_of(out)


def commit_states_packed(slo, shi, num_layers: int, tile: int = TILE,
                         interpret: bool = False):
    """Leaf-hash states (B, 16) as planes -> (B / 2^num_layers, 5) digest
    planes: every leaf state permuted once, then ``num_layers`` Merkle
    levels, through K2's plan. ``tile`` and ``interpret`` are ignored."""
    del tile, interpret
    out = tip5_commit.commit_states(gf.carrier_of((slo, shi)), num_layers)
    return gf.limbs_of(out)


def use_packed_commit() -> bool:
    """Whether the commit takes the packed path: False. In the JAX package
    it is True on a TPU backend only (unless
    TWENTY_FIRST_TPU_PACKED_COMMIT=0); the port's backend is never a TPU,
    and its commit has no packed route: every commit runs K2's plan on the
    natural layout."""
    return False
