"""Distributed MMR: peaks from leafs and batch append over a mesh.

The counterpart of ``twenty_first_tpu/parallel/dist_mmr.py``. The leaf
count's binary decomposition splits the leafs into contiguous perfect
trees, so each peak is a Merkle root of its own: one that spans the mesh
is reduced by ``dist_merkle`` (subtrees on the ranks, one all-gather, the
top on each); smaller ones, and every one on a mesh whose size does not
divide it (a mesh of 3), by ``MerkleTree.frugal_root`` on the rank's
device. A batch append reduces each maximal aligned perfect subtree of the
appended range the same way and merges the carries with the scalar
``Tip5.hash_pair`` on the host. Every rank passes the whole leaf array and
gets every peak.
"""

from __future__ import annotations

import numpy as np

from ..math import gf
from ..tip5.digest import Digest
from ..tip5.tip5 import Tip5
from ..util_types.merkle_tree import MerkleTree
from ..util_types.mmr import shared_advanced
from . import dist_merkle
from .mesh import AXIS, Mesh, shard_host_array


def _chunk_root(arr: np.ndarray, mesh: Mesh | None,
                plain: bool = False) -> Digest:
    """Merkle root of a (2^h, 5) uint64 chunk: over the mesh when the chunk
    divides over it, by the frugal root on the rank's device otherwise (on
    the card without a mesh)."""
    n = arr.shape[0]
    if n == 1:
        return Digest.from_array(arr[0])
    d = mesh.size if mesh is not None else 1
    if mesh is not None and n >= max(d, 2) and n % d == 0:
        log_n = n.bit_length() - 1
        block = shard_host_array(mesh, (AXIS, None), arr)
        root = dist_merkle._root(block, mesh, log_n, plain)
        return Digest.from_array(gf.to_u64(root)[0])
    device = mesh.device if mesh is not None else "cuda"
    return MerkleTree.frugal_root(arr, device=device, plain=plain)


def distributed_peaks_from_leafs(leafs, mesh: Mesh, *,
                                 plain: bool = False) -> list[Digest]:
    """MMR peaks of (n, 5) uint64 leafs, each peak reduced over the mesh
    where it divides over it. Bit-exact with
    ``MmrAccumulator.peaks_from_leafs`` for any n >= 0."""
    arr = np.asarray(leafs, dtype=np.uint64)
    peaks: list[Digest] = []
    offset = 0
    for height in shared_advanced.get_peak_heights(arr.shape[0]):
        size = 1 << height
        peaks.append(_chunk_root(arr[offset: offset + size], mesh, plain))
        offset += size
    return peaks


def distributed_batch_append(peaks: list[Digest], leaf_count: int,
                             new_leafs, mesh: Mesh, *,
                             plain: bool = False) -> tuple[list[Digest], int]:
    """Append (m, 5) uint64 leafs to an accumulator's (peaks, count).

    Returns (new_peaks, new_leaf_count), bit-exact with m sequential
    ``MmrAccumulator.append`` calls: one reduction per maximal aligned
    perfect subtree of the appended range, then the scalar carry merges."""
    arr = np.asarray(new_leafs, dtype=np.uint64)
    m = arr.shape[0]
    peaks = list(peaks)
    count = leaf_count
    offset = 0
    while offset < m:
        rem = m - offset
        align = (count & -count) if count else 1 << 63
        size = min(align, 1 << (rem.bit_length() - 1))
        node = _chunk_root(arr[offset: offset + size], mesh, plain)
        # the carry chain of count + size: each set bit of count at or above
        # log2(size) that propagates is a trailing peak of that size
        bit = size
        while count & bit:
            node = Tip5.hash_pair(peaks.pop(), node)
            bit <<= 1
        peaks.append(node)
        count += size
        offset += size
    return peaks, count
