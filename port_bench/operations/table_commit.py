"""A prover's commitment to a wide table already on the card: each row is
hashed with the variable-length Tip5 sponge, and the digests become the
leafs of a Merkle tree that keeps every node (a prover opens rows from it),
whose root is read back to the host.

The program's entries are ``tip5/permutation.py::pad_for_varlen`` and
``hash_varlen_padded`` (one permutation launch per absorbed chunk) and
``util_types/merkle_tree.py::MerkleTree.new``. The reference works the
same node array out of the same table with reference/tip5.py.
"""

from __future__ import annotations

import numpy as np

from reference import goldilocks as gl
from reference.tip5 import RATE


class Operation:
    keeps_nodes = True

    def __init__(self, config: dict, mix: dict, device):
        from twenty_first_tpu_torch.tip5 import permutation
        from twenty_first_tpu_torch.util_types.merkle_tree import MerkleTree

        self.columns, self.n = config["columns"], 1 << config["log_rows"]
        self.shape = (self.n, self.columns)
        self._perm, self._tree = permutation, MerkleTree

    def run(self, table):
        """One commitment: (root as (5,) uint64 on the host, the node
        tensor of the tree, on the device)."""
        digests = self._perm.hash_varlen_padded(self._perm.pad_for_varlen(table))
        tree = self._tree.new(digests)
        return np.asarray(tree.root().to_array(), dtype=np.uint64), tree

    @staticmethod
    def host_nodes(tree) -> np.ndarray:
        return tree.node_array()

    def release(self):
        del self._perm, self._tree

    def work(self) -> dict:
        absorbs = self.columns // RATE + 1
        return {"hash_perms": self.n * absorbs, "tree_leafs": self.n,
                "tree_nodes_out": self.n - 1, "ntt": [], "ntt_scaled": 0}


def reference(config: dict, tables: list, tip5) -> list:
    """[(root, (2n, 5) node array)] of each (n, L) table, the tables'
    rows hashed side by side."""
    n = tables[0].shape[0]
    digests = tip5.hash_varlen(*tables)
    out = []
    for i in range(len(tables)):
        nodes = np.asarray(gl.to_u64(tip5.merkle_nodes(digests[i * n:(i + 1) * n])))
        out.append((nodes[1].copy(), nodes))
    return out
