"""The query phase of a committed Merkle tree, in plain torch: Fiat-Shamir
sampling of the leafs to open, the authentication structure of an
opening, and a verifier that rebuilds the partial tree.

Written from the upstream crate twenty-first: ``Tip5::sample_indices``
(tip5/mod.rs:636-656), ``MerkleTree::authentication_structure_node_indices``
(merkle_tree.rs:449-504) and ``PartialMerkleTree``'s ``try_from``,
``fill`` and ``root`` behind ``MerkleTreeInclusionProof::verify``
(merkle_tree.rs:779-931). Nodes are numbered as there: the root 1, node
i's children 2i and 2i + 1, leaf j the node n + j of a tree of n leafs.
The hashing is reference/tip5.py's.
"""

from __future__ import annotations

import torch

from . import goldilocks as gl
from .tip5 import DIGEST_LENGTH, RATE, STATE_SIZE

#: the largest tree a proof may claim (merkle_tree.rs, MAX_TREE_HEIGHT)
MAX_TREE_HEIGHT = 62


def sample_indices(tip5, root: torch.Tensor, upper_bound: int,
                   count: int) -> list[int]:
    """``count`` indices below the power of two ``upper_bound`` from a
    fresh variable-length sponge that absorbed ``root`` (5 words, padded
    with 1 and then 0s to the rate): squeeze 10 words at a time, skip a
    word equal to p - 1, and keep the low 32 bits of the others modulo
    ``upper_bound``, in order."""
    state = torch.zeros((1, STATE_SIZE), dtype=torch.int64, device=tip5.device)
    state[0, :DIGEST_LENGTH] = root.to(tip5.device)
    state[0, DIGEST_LENGTH] = 1
    state = tip5.permutation(state)
    indices: list[int] = []
    while len(indices) < count:
        words = gl.to_u64(state[0, :RATE]).tolist()
        state = tip5.permutation(state)
        for w in words:
            if len(indices) < count and w != gl.P - 1:
                indices.append((w & 0xFFFFFFFF) % upper_bound)
    return indices


def structure_indices(num_leafs: int, leaf_indices) -> list[int]:
    """The nodes an opening of ``leaf_indices`` reveals, largest first:
    each level's siblings of the nodes on the leafs' paths that are not on
    a path themselves, from the leafs up to the root's children."""
    level = {num_leafs + i for i in leaf_indices}
    found = []
    while level and min(level) > 1:
        found += [i ^ 1 for i in level if i ^ 1 not in level]
        level = {i // 2 for i in level}
    return sorted(found, reverse=True)


def verify(tip5, height: int, indexed_leafs: list, structure: torch.Tensor,
           root: torch.Tensor) -> bool:
    """Whether an opening (``indexed_leafs``: (leaf index, (5,) digest)
    pairs, at least one; ``structure``: (s, 5) digests in the order of
    ``structure_indices``) rebuilds the tree of ``root``. Refused: a
    height over MAX_TREE_HEIGHT, a leaf index out of range, a structure of
    the wrong length, one index given two digests, and a root that
    differs."""
    if height > MAX_TREE_HEIGHT:
        return False
    n = 1 << height
    indices = [i for i, _ in indexed_leafs]
    if any(not 0 <= i < n for i in indices):
        return False
    wanted = structure_indices(n, indices)
    if structure.shape[0] != len(wanted):
        return False
    nodes = dict(zip(wanted, structure))
    for i, digest in indexed_leafs:
        node = nodes.setdefault(n + i, digest)
        if not torch.equal(node, digest):
            return False
    level = sorted({n + i for i in indices})
    for _ in range(height):
        parents = sorted({i // 2 for i in level})
        children = torch.stack([nodes[c] for p in parents
                                for c in (2 * p, 2 * p + 1)])
        for p, digest in zip(parents, tip5.hash_pairs(children)):
            nodes[p] = digest
        level = parents
    return bool(torch.equal(nodes[1], root))
