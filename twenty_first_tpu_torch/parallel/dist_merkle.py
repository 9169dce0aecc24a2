"""Distributed Merkle commitment: subtrees on the ranks, the top on each.

The counterpart of ``twenty_first_tpu/parallel/dist_merkle.py``, with the
same roots: the leafs are cut over the mesh in contiguous blocks; each rank
reduces its block to its subtree root by K2's launch plan
(``ops/tip5_commit.py::reduce_layers``); the d subtree roots are
all-gathered (d * 5 words); and every rank reduces the top log d levels by
the same plan, so every rank holds the root.
"""

from __future__ import annotations

import numpy as np

from ..math import gf
from ..ops import tip5_commit
from ..tip5.digest import Digest
from ..tip5.permutation import tip5_tables
from .mesh import AXIS, Mesh, shard_host_array


def _log_d(mesh: Mesh, log_n: int) -> int:
    d = mesh.size
    log_d = d.bit_length() - 1
    if (1 << log_d) != d:
        raise ValueError("mesh size must be a power of two")
    if log_n < log_d:
        raise ValueError("tree smaller than mesh")
    return log_d


def _root(block, mesh: Mesh, log_n: int, plain: bool = False):
    """This rank's (2^log_n / d, 5) leaf block -> the (1, 5) root of the
    whole tree, on every rank."""
    log_d = _log_d(mesh, log_n)
    tables = tip5_tables(block.device)
    sub = tip5_commit.reduce_layers(block, log_n - log_d, tables=tables,
                                    plain=plain)
    top = mesh.all_gather(sub).view(mesh.size, 5)
    return tip5_commit.reduce_layers(top, log_d, tables=tables, plain=plain)


def distributed_merkle_root(leafs, mesh: Mesh, *, plain: bool = False) -> Digest:
    """Merkle root of (n, 5) uint64 leafs over the mesh: every rank passes
    the whole array and gets the root. Bit-exact with
    ``MerkleTree.new(leafs).root()`` for any mesh size."""
    leafs = np.asarray(leafs, dtype=np.uint64)
    n = leafs.shape[0]
    log_n = n.bit_length() - 1
    if (1 << log_n) != n:
        raise ValueError("number of leafs must be a power of two")
    _log_d(mesh, log_n)
    block = shard_host_array(mesh, (AXIS, None), leafs)
    return Digest.from_array(gf.to_u64(_root(block, mesh, log_n, plain))[0])


def distributed_merkle_root_limbs(state, mesh: Mesh, log_n: int, *,
                                  plain: bool = False):
    """The limb-plane variant: this rank's (2^log_n / d, 5) block as uint32
    planes (lo, hi) (``gf.to_limbs``) -> the (1, 5) root's planes on every
    rank."""
    return gf.limbs_of(_root(gf.carrier_of(state), mesh, log_n, plain))
