"""Merkle tree over Tip5, its authentication structures and inclusion proofs.

The counterpart of ``twenty_first_tpu/util_types/merkle_tree.py``, held
against it by ``tests/test_torch_merkle_tree.py``; mirrors
twenty-first/src/util_types/merkle_tree.rs in API and values. Node indexing
is the reference's 1-based heap (root at 1, leafs at n..2n-1, row 0 unused;
merkle_tree.rs:25-88).

The nodes are one (2n, 5) int64 carrier tensor on a device. Host leafs
(numpy or a list of Digests) of at most ``HOST_MERKLE_MAX_LEAFS`` rows are
hashed on the host by the native core (``native.tip5_hash_pairs`` a level,
``native.tip5_merkle_root``), as in the JAX package, whatever ``plain``
says; the nodes then go to the named device. Size and the native core
decide, never whether a card is present: without the core
(``TWENTY_FIRST_TPU_NO_NATIVE``, or no g++) host leafs go to the named
device and take the device route below. Leafs given as a tensor stay on
its device at every size. Everything else runs on the
device: ``new`` reduces level by level with K2's full-width
``merkle_level``, each level written straight into the node tensor;
``frugal_root`` is the commit's own launch plan
(``ops/tip5_commit.py::reduce_layers``: full-width levels, then the fused
tail); ``authentication_structure_from_leafs`` keeps one level at a time
and gathers the nodes it needs from each before the next. A CPU tensor
takes the plain twins, as does ``plain=True`` on any device.

The de-duplicated authentication structure's index math
(merkle_tree.rs:449-504) is host code, as in the JAX package. An inclusion
proof gathers its leafs and its structure in one gather and one copy to
the host. Its verification (merkle_tree.rs:779-931) fills the partial tree
level by level on the verifier's device (``device="cuda"``, ``plain``, as
above): the known nodes are one (k, 5) tensor, and each level's children
are gathered from it and hashed by one K2 ``merkle_level`` launch (the
JAX package hashes a node at a time on the host). Every error it raises,
and when, is decided on the host from the node indices alone.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import native
from ..errors import MerkleTreeError
from ..math import gf
from ..ops import tip5_commit, tip5_cuda
from ..spans import span
from ..tip5.digest import Digest
from ..tip5.permutation import tip5_tables

ROOT_INDEX = 1

# In-struct size limit, as in the reference (merkle_tree.rs:76-79).
MAX_TREE_HEIGHT = 24

# Host leafs of up to this many rows are hashed on the host (the native
# core), above on the device: the JAX package's name and environment
# variable, with the default from the sweep of host against card wall time
# that probes/merkle_probe.py runs on an H100's host, numpy in and out, the
# node tensor's copy included (its reading is in PERF.md section 6, with
# the port's bring-up). The JAX package's 2^21 was tuned to a TPU's
# transfer link.
HOST_MERKLE_MAX_LEAFS = int(os.environ.get(
    "TWENTY_FIRST_TPU_HOST_MERKLE_MAX_LEAFS", str(1 << 7)))


def _leaf_array(leafs) -> np.ndarray:
    """Host leafs (numpy uint64 (n, 5) or a list of Digests) as (n, 5)
    uint64."""
    if isinstance(leafs, np.ndarray):
        arr = np.asarray(leafs, dtype=np.uint64)
        if arr.ndim != 2 or arr.shape[1] != Digest.LEN:
            raise MerkleTreeError(f"leaf array must be (n, 5), got {arr.shape}")
        return arr
    return np.array([d.to_array() for d in leafs],
                    dtype=np.uint64).reshape(-1, Digest.LEN)


def _routed_leafs(leafs, device):
    """Host leafs of at most HOST_MERKLE_MAX_LEAFS rows as (n, 5) uint64
    when the native core is loaded (the host route); other leafs as
    ``_as_leaf_tensor`` gives them."""
    if not isinstance(leafs, torch.Tensor):
        arr = _leaf_array(leafs)
        if arr.shape[0] <= HOST_MERKLE_MAX_LEAFS and native.available():
            return arr
        leafs = arr
    return _as_leaf_tensor(leafs, device)


def _host_nodes(leafs: np.ndarray) -> np.ndarray:
    """The (2n, 5) uint64 node array over host leafs, a level at a time by
    the native core."""
    n = leafs.shape[0]
    nodes = np.zeros((2 * n, Digest.LEN), dtype=np.uint64)
    nodes[n:] = leafs
    layer, lo = leafs, n
    while lo > 1:
        layer = native.tip5_hash_pairs(layer)
        lo //= 2
        nodes[lo: 2 * lo] = layer
    return nodes


def _as_leaf_tensor(leafs, device) -> torch.Tensor:
    """Leafs as an (n, 5) int64 carrier: a tensor stays on its device;
    numpy uint64 (n, 5) or a list of Digests goes to ``device``."""
    if isinstance(leafs, torch.Tensor):
        if (leafs.dtype != torch.int64 or leafs.dim() != 2
                or leafs.shape[1] != Digest.LEN):
            raise MerkleTreeError(f"leaf tensor must be (n, 5) int64, got "
                                  f"{tuple(leafs.shape)} {leafs.dtype}")
        return leafs.contiguous()
    return gf.from_u64(_leaf_array(leafs)).to(device)


def _check_num_leafs(num_leafs: int) -> int:
    if num_leafs == 0 or num_leafs & (num_leafs - 1):
        raise MerkleTreeError("number of leafs must be a power of two")
    return int(num_leafs).bit_length() - 1


def _level(children, tables, plain: bool, out=None):
    """One level, (2b, 5) -> (b, 5), into ``out`` if given: K2's
    full-width launch, or its plain twin."""
    fn = tip5_cuda.merkle_level_plain if plain else tip5_cuda.merkle_level
    return fn(children, False, *tables, out=out)


def _digests(rows: torch.Tensor) -> list[Digest]:
    """(k, 5) carrier rows -> k Digests, in one copy to the host."""
    return [Digest._of_canonical(row) for row in gf.to_u64(rows).tolist()]


class MerkleTree:
    """A full Merkle tree holding all 2n nodes (row 0 unused)."""

    def __init__(self, nodes, device="cuda"):
        """``nodes``: a (2n, 5) int64 tensor, which stays on its device, or
        numpy uint64, such as the JAX package's ``node_array()``, which
        goes to ``device``."""
        if isinstance(nodes, np.ndarray):
            nodes = gf.from_u64(nodes).to(device)
        if (nodes.dtype != torch.int64 or nodes.dim() != 2
                or nodes.shape[1] != Digest.LEN or nodes.shape[0] % 2):
            raise MerkleTreeError(f"nodes must be (2n, 5) int64, got "
                                  f"{tuple(nodes.shape)} {nodes.dtype}")
        _check_num_leafs(nodes.shape[0] // 2)
        self._nodes = nodes

    # -- construction -------------------------------------------------------

    @classmethod
    def new(cls, leafs, device="cuda", plain: bool = False) -> "MerkleTree":
        """The tree over ``leafs``: (n, 5) numpy uint64, a list of Digests
        (hashed on the host up to HOST_MERKLE_MAX_LEAFS rows, and the nodes
        sent to ``device``) or an int64 tensor (its own device)."""
        with span("tree"):
            leafs = _routed_leafs(leafs, device)
            n = leafs.shape[0]
            height = _check_num_leafs(n)
            if height > MAX_TREE_HEIGHT:
                raise MerkleTreeError(
                    f"tree height {height} exceeds {MAX_TREE_HEIGHT}")
            if isinstance(leafs, np.ndarray):
                return cls(_host_nodes(leafs), device)
            nodes = torch.empty((2 * n, Digest.LEN), dtype=leafs.dtype,
                                device=leafs.device)
            nodes[0] = 0
            nodes[n:] = leafs
            tables = tip5_tables(leafs.device)
            lo = n
            while lo > 1:
                _level(nodes[lo: 2 * lo], tables, plain,
                       out=nodes[lo // 2: lo])
                lo //= 2
            return cls(nodes)

    # The reference's par_new/sequential_new distinction is a host-threading
    # artifact; here both are the same batched level reduction.
    par_new = new
    sequential_new = new

    @classmethod
    def frugal_root(cls, leafs, device="cuda", plain: bool = False) -> Digest:
        """Root with O(layer) memory: never materializes the node array
        (reference: sequential/par_frugal_root, merkle_tree.rs:299-364),
        by the commit's launch plan."""
        layer = _routed_leafs(leafs, device)
        height = _check_num_leafs(layer.shape[0])
        if isinstance(layer, np.ndarray):
            return Digest.from_array(native.tip5_merkle_root(layer))
        return _digests(tip5_commit.reduce_layers(layer, height,
                                                  plain=plain))[0]

    par_frugal_root = frugal_root
    sequential_frugal_root = frugal_root

    # -- accessors ----------------------------------------------------------

    def num_leafs(self) -> int:
        return self._nodes.shape[0] // 2

    def height(self) -> int:
        return self.num_leafs().bit_length() - 1

    def root(self) -> Digest:
        return _digests(self._nodes[ROOT_INDEX: ROOT_INDEX + 1])[0]

    def node(self, index: int) -> Digest | None:
        if index < 1 or index >= self._nodes.shape[0]:
            return None
        return _digests(self._nodes[index: index + 1])[0]

    def node_array(self) -> np.ndarray:
        """The (2n, 5) nodes as numpy uint64, as the JAX package's."""
        return gf.to_u64(self._nodes)

    def leaf(self, index: int) -> Digest | None:
        if index < 0 or index >= self.num_leafs():
            return None
        return self.node(self.num_leafs() + index)

    def leafs(self):
        return _digests(self._nodes[self.num_leafs():])

    def _gather(self, node_indices) -> list[Digest]:
        """The nodes at ``node_indices``, in one gather and one copy."""
        if not node_indices:
            return []
        index = torch.tensor(node_indices, dtype=torch.int64,
                             device=self._nodes.device)
        return _digests(self._nodes.index_select(0, index))

    def _check_leaf_indices(self, indices) -> list[int]:
        indices = list(indices)
        for i in indices:
            if i < 0 or i >= self.num_leafs():
                raise MerkleTreeError(f"invalid leaf index {i}")
        return indices

    def indexed_leafs(self, indices) -> list[tuple[int, Digest]]:
        indices = self._check_leaf_indices(indices)
        leafs = self._gather([self.num_leafs() + i for i in indices])
        return list(zip(indices, leafs))

    # -- authentication structure -------------------------------------------

    @staticmethod
    def authentication_structure_node_indices(
        num_leafs: int, leaf_indices
    ) -> list[int]:
        """De-duplicated node indices, sorted descending
        (merkle_tree.rs:449-504)."""
        if num_leafs == 0 or num_leafs & (num_leafs - 1):
            raise MerkleTreeError("number of leafs must be a power of two")
        needed: set[int] = set()
        computable: set[int] = set()
        for leaf_index in leaf_indices:
            if leaf_index >= num_leafs or leaf_index < 0:
                raise MerkleTreeError(f"invalid leaf index {leaf_index}")
            node_index = leaf_index + num_leafs
            while node_index > ROOT_INDEX:
                computable.add(node_index)
                needed.add(node_index ^ 1)
                node_index //= 2
        return sorted(needed - computable, reverse=True)

    def authentication_structure(self, leaf_indices) -> list[Digest]:
        return self._gather(self.authentication_structure_node_indices(
            self.num_leafs(), leaf_indices))

    @classmethod
    def authentication_structure_from_leafs(
        cls, leafs, leaf_indices, device="cuda", plain: bool = False
    ) -> list[Digest]:
        """Auth structure without a full tree (merkle_tree.rs:514-575).

        Node index i lies in the level of 2^k nodes with 2^k <= i < 2^(k+1).
        The indices are sorted descending, so they come level by level from
        the leafs up: reduce one level at a time, keeping only the current
        one, and gather each level's nodes before reducing it. The JAX
        package takes one frugal root per node instead, the same values."""
        layer = _routed_leafs(leafs, device)
        indices = cls.authentication_structure_node_indices(
            layer.shape[0], leaf_indices)
        if isinstance(layer, np.ndarray):
            nodes = _host_nodes(layer)
            return [Digest.from_array(nodes[i]) for i in indices]
        tables = tip5_tables(layer.device)
        parts, size, pos = [], layer.shape[0], 0
        while pos < len(indices):
            end = pos
            while end < len(indices) and indices[end] >= size:
                end += 1
            if end > pos:
                offsets = torch.tensor(indices[pos:end], dtype=torch.int64,
                                       device=layer.device) - size
                parts.append(layer.index_select(0, offsets))
                pos = end
            if pos < len(indices):
                layer = _level(layer, tables, plain)
                size //= 2
        return _digests(torch.cat(parts)) if parts else []

    sequential_authentication_structure_from_leafs = authentication_structure_from_leafs
    par_authentication_structure_from_leafs = authentication_structure_from_leafs

    def inclusion_proof_for_leaf_indices(
        self, indices
    ) -> "MerkleTreeInclusionProof":
        """The leafs at ``indices`` and their authentication structure,
        gathered together in one gather and one copy to the host."""
        with span("open"):
            indices = self._check_leaf_indices(indices)
            n = self.num_leafs()
            structure = self.authentication_structure_node_indices(n, indices)
            found = self._gather([n + i for i in indices] + structure)
            return MerkleTreeInclusionProof(
                tree_height=self.height(),
                indexed_leafs=list(zip(indices, found[:len(indices)])),
                authentication_structure=found[len(indices):],
            )

    def __eq__(self, other):
        return (isinstance(other, MerkleTree)
                and self._nodes.shape == other._nodes.shape
                and torch.equal(self._nodes,
                                other._nodes.to(self._nodes.device)))


@dataclass
class MerkleTreeInclusionProof:
    """Inclusion proof relative to a (possibly unknown) Merkle tree
    (merkle_tree.rs:94-113)."""

    tree_height: int
    indexed_leafs: list[tuple[int, Digest]] = field(default_factory=list)
    authentication_structure: list[Digest] = field(default_factory=list)

    def leaf_indices(self) -> list[int]:
        return [i for i, _ in self.indexed_leafs]

    def is_trivial(self) -> bool:
        return not self.indexed_leafs and not self.authentication_structure

    def verify(self, expected_root: Digest, device="cuda",
               plain: bool = False) -> bool:
        """Whether the proof's leafs are in the tree of ``expected_root``:
        the partial tree filled on ``device``."""
        if self.is_trivial():
            return True
        try:
            tree = PartialMerkleTree.from_proof(self, device, plain)
            return tree.root() == expected_root
        except MerkleTreeError:
            return False

    def try_verify(self, expected_root: Digest, device="cuda",
                   plain: bool = False) -> None:
        """Like verify, but raising a typed error with the failure cause
        (merkle_tree.rs:736-745)."""
        if self.is_trivial():
            return
        # raises MerkleTreeError
        tree = PartialMerkleTree.from_proof(self, device, plain)
        if tree.root() != expected_root:
            raise MerkleTreeError("root mismatch")

    def into_authentication_paths(self, device="cuda",
                                  plain: bool = False) -> list[list[Digest]]:
        """Decompress into one authentication path per indicated leaf
        (merkle_tree.rs:773-776, :861-887)."""
        tree = PartialMerkleTree.from_proof(self, device, plain)
        return [
            tree.authentication_path_for_index(i) for i in tree.leaf_indices
        ]


class PartialMerkleTree:
    """Helper for verifying inclusion proofs (merkle_tree.rs:779-931).

    ``nodes`` maps node indices to the known Digests. ``fill`` works out
    the parents on ``device`` (K2, or its plain twin on a CPU device or
    with ``plain=True``) into one (k, 5) tensor; ``root`` reads one row of
    it, and ``nodes`` brings all of it to the host on first use."""

    def __init__(self, tree_height: int, leaf_indices: list[int],
                 nodes: dict[int, Digest], device="cuda", plain: bool = False):
        self.tree_height = tree_height
        self.leaf_indices = leaf_indices
        self.device, self.plain = device, plain
        self._nodes = nodes
        self._filled = None  # after fill: (node tensor, node index -> row)

    @classmethod
    def from_proof(cls, proof: MerkleTreeInclusionProof, device="cuda",
                   plain: bool = False) -> "PartialMerkleTree":
        leaf_indices = proof.leaf_indices()
        if proof.tree_height > 62:
            raise MerkleTreeError("tree too high")
        num_leafs = 1 << proof.tree_height
        if any(i >= num_leafs or i < 0 for i in leaf_indices):
            raise MerkleTreeError("invalid leaf index")
        node_indices = MerkleTree.authentication_structure_node_indices(
            num_leafs, leaf_indices
        )
        if len(proof.authentication_structure) != len(node_indices):
            raise MerkleTreeError("authentication structure length mismatch")
        nodes = dict(zip(node_indices, proof.authentication_structure))
        for leaf_index, leaf_digest in proof.indexed_leafs:
            node_index = leaf_index + num_leafs
            if node_index not in nodes:
                nodes[node_index] = leaf_digest
            elif nodes[node_index] != leaf_digest:
                raise MerkleTreeError("repeated leaf digest mismatch")
        tree = cls(proof.tree_height, leaf_indices, nodes, device, plain)
        tree.fill()
        return tree

    @property
    def nodes(self) -> dict[int, Digest]:
        """Every known node, the filled ones brought to the host in one
        copy on first use."""
        if self._filled is not None:
            tensor, rows = self._filled
            self._filled = None
            host = gf.to_u64(tensor).tolist()
            for i, r in rows.items():
                if i not in self._nodes:
                    self._nodes[i] = Digest._of_canonical(host[r])
        return self._nodes

    def num_leafs(self) -> int:
        return 1 << self.tree_height

    def root(self) -> Digest:
        if ROOT_INDEX in self._nodes:
            return self._nodes[ROOT_INDEX]
        if self._filled is not None and ROOT_INDEX in self._filled[1]:
            tensor, rows = self._filled
            row = rows[ROOT_INDEX]
            return _digests(tensor[row: row + 1])[0]
        raise MerkleTreeError("root not found")

    def node(self, index: int) -> Digest:
        nodes = self.nodes
        if index not in nodes:
            raise MerkleTreeError(f"missing node index {index}")
        return nodes[index]

    def fill(self) -> None:
        """Work out every parent on the leafs' paths, a level at a time
        from the leafs up: the level's (left, right) children gathered from
        the node tensor into one (2m, 5) tensor, reduced by one K2 launch
        into the tensor's next m rows. The plan, with every missing or
        spurious node it meets, is made on the host first, in the order of
        the reference's node-at-a-time loop, so the same error is raised.
        Counts the levels hashed in ``PartialMerkleTree.fill.levels``."""
        with span("verify"):
            num_leafs = self.num_leafs()
            nodes = self.nodes
            rows = {i: r for r, i in enumerate(nodes)}
            known = len(rows)
            parents = sorted({(i + num_leafs) // 2 for i in self.leaf_indices})
            children, widths, row_of = [], [], rows.get
            for _ in range(self.tree_height):
                for parent in parents:
                    left, right = row_of(2 * parent), row_of(2 * parent + 1)
                    if left is None or right is None:
                        child = 2 * parent + (left is not None)
                        raise MerkleTreeError(f"missing node index {child}")
                    if parent in rows:
                        raise MerkleTreeError(f"spurious node index {parent}")
                    rows[parent] = len(rows)
                    children += (left, right)
                if parents:
                    widths.append(len(parents))
                parents = sorted({p // 2 for p in parents})
            if not widths:
                return
            # the known nodes, room for the parents and the gathers' row
            # numbers, in one copy to the device
            words = np.zeros(5 * len(rows) + len(children), dtype=np.uint64)
            words[:5 * known] = [w for d in nodes.values()
                                 for w in d._words]
            words[5 * len(rows):] = children
            flat = gf.from_u64(words).to(self.device)
            tensor = flat[:5 * len(rows)].view(len(rows), Digest.LEN)
            gathers = flat[5 * len(rows):]
            tables = tip5_tables(tensor.device)
            at, out = 0, known
            for m in widths:
                level = tensor.index_select(0, gathers[at: at + 2 * m])
                _level(level, tables, self.plain, out=tensor[out: out + m])
                at, out = at + 2 * m, out + m
            _fill.levels += len(widths)
            self._filled = (tensor, rows)

    def authentication_path_for_index(self, leaf_index: int) -> list[Digest]:
        num_leafs = self.num_leafs()
        path = []
        node_index = leaf_index + num_leafs
        while node_index > ROOT_INDEX:
            path.append(self.node(node_index ^ 1))
            node_index //= 2
        return path


PartialMerkleTree.fill.levels = 0
# the counter's function by a name of its own: a caller that rebinds
# ``fill`` to a wrapper of it still counts here
_fill = PartialMerkleTree.fill
