"""The query phase of a table prover, and a verifier checking it.

A prover holds the Merkle tree of a wide table already on the card (each
row hashed with the variable-length Tip5 sponge, as ``table_commit``
commits it). One operation: the root is absorbed by a fresh sponge and
``queries`` row indices are sampled from it (Fiat-Shamir); the prover
reveals the distinct rows at those indices, and the verifier, starting
from those host arrays as from the wire, hashes each of them
(``tip5/permutation.py::pad_for_varlen`` and ``hash_varlen_padded``, as
``hash_varlen`` runs them: one launch of K1's absorb mode) while the
prover gathers the inclusion proof (``MerkleTree.
inclusion_proof_for_leaf_indices``: the de-duplicated authentication
structure) on a stream of its own, as two parties would; then the
verifier verifies the proof built from its own digests against the root
(``MerkleTreeInclusionProof.verify``: the partial tree filled on the
card), and the same proof with one word forged, which it must refuse.

The first operation on an input commits to it (``pad_for_varlen``,
``hash_varlen_padded``, ``MerkleTree.new``) and keeps its tree, as a
prover keeps it between commitment and queries: that is set-up, since the
warm-up takes each input of the pool once. The answer is one uint64
array (``answer``). The reference works the same answer out with
reference/tip5.py and reference/opening.py.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from reference import goldilocks as gl
from reference import opening
from reference.tip5 import RATE


def answer(verdicts, indices, leafs, structure) -> np.ndarray:
    """The verdicts on the honest and the forged opening (1 accepted, 0
    refused), the sampled indices in order, the digests of the distinct
    revealed rows in increasing index order, and the structure's digests,
    as one flat uint64 array."""
    return np.concatenate([np.asarray(verdicts, dtype=np.uint64),
                           np.asarray(indices, dtype=np.uint64),
                           np.asarray(leafs, dtype=np.uint64).reshape(-1),
                           np.asarray(structure, dtype=np.uint64).reshape(-1)])


def parents_of(num_leafs: int, indices) -> int:
    """The parents a verifier hashes to fill the partial tree of an
    opening: the distinct nodes above the leafs on their paths."""
    level, count = {num_leafs + i for i in indices}, 0
    while level and min(level) > 1:
        level = {i // 2 for i in level}
        count += len(level)
    return count


class Operation:
    keeps_nodes = False

    def __init__(self, config: dict, mix: dict, device):
        from twenty_first_tpu_torch.tip5 import permutation
        from twenty_first_tpu_torch.tip5.digest import Digest
        from twenty_first_tpu_torch.tip5.tip5 import Tip5
        from twenty_first_tpu_torch.util_types import merkle_tree

        self.columns, self.height = config["columns"], config["log_rows"]
        self.n, self.queries = 1 << self.height, config["queries"]
        self.shape = (self.n, self.columns)
        self.device = device
        self._perm, self._digest, self._tip5 = permutation, Digest, Tip5
        self._mt = merkle_tree
        self._commits = {}  # id(input) -> (its weak reference, tree, root)
        self._sizes = {}  # id(input) -> (distinct rows, parents) an opening
        self._pinned = None
        on_card = torch.device(device).type == "cuda"
        self._prover = torch.cuda.stream(
            torch.cuda.Stream(device) if on_card else None)

    def _commitment(self, table):
        entry = self._commits.get(id(table))
        if entry is None or entry[0]() is not table:
            for key in [k for k, e in self._commits.items() if e[0]() is None]:
                del self._commits[key]
                self._sizes.pop(key, None)
            digests = self._perm.hash_varlen_padded(
                self._perm.pad_for_varlen(table))
            tree = self._mt.MerkleTree.new(digests)
            entry = (weakref.ref(table), tree, tree.root())
            self._commits[id(table)] = entry
        return entry[1], entry[2]

    def run(self, table):
        """One opening and its two verifications: (the answer, no nodes)."""
        tree, root = self._commitment(table)
        sponge = self._tip5.init()
        sponge.pad_and_absorb_all(root.values())
        indices = sponge.sample_indices(self.n, self.queries)
        # the prover reveals the rows ...
        distinct = sorted(set(indices))
        rows = self._to_host(table.index_select(0, torch.tensor(
            distinct, dtype=torch.int64, device=table.device)))
        # ... which the verifier hashes as they arrive, from the host
        # arrays (K1's absorb mode, one launch), while the prover gathers
        # their authentication structure on a stream of its own
        hashing = self._perm.hash_varlen_padded(self._perm.pad_for_varlen(
            torch.from_numpy(rows).to(self.device)))
        with self._prover:
            proof = tree.inclusion_proof_for_leaf_indices(indices)
        structure = [d.to_array() for d in proof.authentication_structure]
        digests = gl.to_u64(hashing)
        # the verifier, from its own digests and the prover's structure
        mine = dict(zip(distinct, map(self._digest, digests.tolist())))
        leafs = [(i, mine[i]) for i in indices]
        honest = self._mt.MerkleTreeInclusionProof(
            self.height, leafs, proof.authentication_structure)
        forged = self._mt.MerkleTreeInclusionProof(
            self.height, *self._forge(leafs, proof.authentication_structure))
        verdicts = [honest.verify(root, device=self.device),
                    forged.verify(root, device=self.device)]
        if id(table) not in self._sizes:  # an input's openings are alike
            self._sizes[id(table)] = (len(distinct),
                                      2 * parents_of(self.n, distinct))
        return answer(verdicts, indices, digests, structure), None

    def _to_host(self, revealed):
        """The revealed rows as int64 words on the host: on a card, through
        a pinned buffer the prover keeps for its openings."""
        if revealed.device.type != "cuda":
            return revealed.numpy()
        if self._pinned is None:
            self._pinned = torch.empty((self.queries, self.columns),
                                       dtype=torch.int64, pin_memory=True)
        host = self._pinned[:revealed.shape[0]]
        host.copy_(revealed)
        return host.numpy()

    def _forge(self, leafs, structure):
        """The opening with word 0 of the first structure digest (of the
        first leaf's, where the structure is empty) raised by 1 mod p."""
        def raised(d):
            words = list(d.values())
            return self._digest([words[0] + 1] + words[1:])
        if structure:
            return leafs, [raised(structure[0])] + structure[1:]
        return [(leafs[0][0], raised(leafs[0][1]))] + leafs[1:], structure

    def release(self):
        self._commits.clear()
        self._pinned = None
        del self._perm, self._digest, self._tip5, self._mt

    def work(self) -> dict:
        """One operation's counts, averaged over the inputs opened: a
        sponge over each distinct revealed row, and the parents of both
        verifications' partial trees."""
        sizes = list(self._sizes.values())
        rows = sum(r for r, _ in sizes) / len(sizes)
        parents = sum(p for _, p in sizes) / len(sizes)
        return {"hash_perms": rows * (self.columns // RATE + 1),
                "tree_leafs": parents + 1, "tree_nodes_out": parents,
                "ntt": [], "ntt_scaled": 0}


def reference(config: dict, tables: list, tip5) -> list:
    """[(answer, None)] of each (n, L) table: its tree from the rows
    hashed side by side, the indices sampled from its root, the revealed
    rows' digests and the structure read from the tree, and the verdicts
    of reference/opening.py's verifier on the opening and its forgery."""
    n, queries = tables[0].shape[0], config["queries"]
    height = n.bit_length() - 1
    digests = tip5.hash_varlen(*tables)
    out = []
    for k in range(len(tables)):
        nodes = tip5.merkle_nodes(digests[k * n:(k + 1) * n])
        root = nodes[1]
        indices = opening.sample_indices(tip5, root, n, queries)
        distinct = sorted(set(indices))
        leafs = nodes[[n + i for i in distinct]]
        structure = nodes[opening.structure_indices(n, indices)]
        mine = dict(zip(distinct, leafs))
        indexed = [(i, mine[i]) for i in indices]
        if structure.shape[0]:
            forged = (indexed, torch.cat([_raised(structure[0])[None],
                                          structure[1:]]))
        else:
            forged = ([(indices[0], _raised(indexed[0][1]))] + indexed[1:],
                      structure)
        verdicts = [opening.verify(tip5, height, indexed, structure, root),
                    opening.verify(tip5, height, *forged, root)]
        out.append((answer(verdicts, indices, gl.to_u64(leafs),
                           gl.to_u64(structure)), None))
    return out


def _raised(digest: torch.Tensor) -> torch.Tensor:
    """A (5,) digest with word 0 raised by 1 mod p."""
    out = digest.clone()
    out[0] = gl.add(digest[0], gl.scalar(1, digest))
    return out
