"""Archival MMR: stores every node (mirrors archival_mmr.rs). In the
reference this is test-only (mmr.rs:8-10); here it ships as the ground-truth
oracle for MmrAccumulator and the membership-proof maintenance algorithms.

A copy of ``twenty_first_tpu/util_types/mmr/archival_mmr.py``
(importing that package would import JAX), held against it by
``tests/test_torch_mmr.py``.
"""

from __future__ import annotations

from ...tip5.digest import Digest
from ...tip5.tip5 import Tip5
from . import shared_advanced
from .mmr_accumulator import MmrAccumulator, bag_peaks
from .mmr_membership_proof import MmrMembershipProof
from .mmr_trait import LeafMutation, Mmr


class ArchivalMmr(Mmr):
    """Node storage is 1-indexed: digests[0] is a dummy."""

    def __init__(self, leafs=()):
        self._digests: list[Digest] = [Digest.all_zero()]
        for leaf in leafs:
            self.append(leaf)

    @classmethod
    def new_from_leafs(cls, leafs) -> "ArchivalMmr":
        return cls(leafs)

    def num_nodes(self) -> int:
        return len(self._digests) - 1

    def get_digest(self, node_index: int) -> Digest:
        return self._digests[node_index]

    def get_leaf(self, leaf_index: int) -> Digest:
        return self._digests[shared_advanced.leaf_index_to_node_index(leaf_index)]

    # -- Mmr interface -------------------------------------------------------

    def num_leafs(self) -> int:
        count = 0
        nodes_left = self.num_nodes()
        while nodes_left:
            height = (nodes_left + 1).bit_length() - 1
            # largest perfect subtree has 2^(h+1)-1 nodes
            while (1 << (height + 1)) - 1 > nodes_left:
                height -= 1
            count += 1 << height
            nodes_left -= (1 << (height + 1)) - 1
        return count

    def is_empty(self) -> bool:
        return self.num_nodes() == 0

    def peaks(self) -> list[Digest]:
        _, indices = shared_advanced.get_peak_heights_and_peak_node_indices(
            self.num_leafs()
        )
        return [self._digests[i] for i in indices]

    def get_peaks_with_heights(self) -> list[tuple[Digest, int]]:
        """Peaks paired with their heights (archival_mmr.rs:260-290)."""
        heights, indices = \
            shared_advanced.get_peak_heights_and_peak_node_indices(
                self.num_leafs())
        return [(self._digests[i], h) for i, h in zip(indices, heights)]

    def bag_peaks(self) -> Digest:
        return bag_peaks(self.peaks(), self.num_leafs())

    def append(self, new_leaf: Digest) -> MmrMembershipProof:
        self._digests.append(new_leaf)
        node_index = len(self._digests) - 1
        right_count, height = \
            shared_advanced.right_lineage_length_and_own_height(node_index)
        while right_count != 0:
            left_sibling = self._digests[
                shared_advanced.left_sibling(node_index, height)
            ]
            parent = Tip5.hash_pair(left_sibling, self._digests[node_index])
            self._digests.append(parent)
            node_index = len(self._digests) - 1
            right_count -= 1
            height += 1
        leaf_index = self.num_leafs() - 1
        return self.prove_membership(leaf_index)

    def prove_membership(self, leaf_index: int) -> MmrMembershipProof:
        """Walk siblings upward to the peak (archival_mmr.rs:212-257)."""
        indices = shared_advanced.auth_path_node_indices(
            self.num_leafs(), leaf_index
        )
        return MmrMembershipProof([self._digests[i] for i in indices])

    def mutate_leaf(self, leaf_mutation: LeafMutation) -> None:
        self.mutate_leaf_unchecked(leaf_mutation.leaf_index,
                                   leaf_mutation.new_leaf)

    def mutate_leaf_unchecked(self, leaf_index: int, new_leaf: Digest) -> None:
        """Ripple the change up to the peak (archival_mmr.rs:181-209)."""
        node_index = shared_advanced.leaf_index_to_node_index(leaf_index)
        self._digests[node_index] = new_leaf
        num_nodes = self.num_nodes()
        while node_index < num_nodes:
            right_count, height = \
                shared_advanced.right_lineage_length_and_own_height(node_index)
            if right_count != 0:
                sibling = shared_advanced.left_sibling(node_index, height)
                parent_idx = node_index + 1
                if parent_idx > num_nodes:
                    break
                self._digests[parent_idx] = Tip5.hash_pair(
                    self._digests[sibling], self._digests[node_index]
                )
            else:
                sibling = shared_advanced.right_sibling(node_index, height)
                parent_idx = node_index + (1 << (height + 1))
                if sibling > num_nodes or parent_idx > num_nodes:
                    break
                self._digests[parent_idx] = Tip5.hash_pair(
                    self._digests[node_index], self._digests[sibling]
                )
            node_index = parent_idx

    def batch_mutate_leaf_and_update_mps(self, membership_proofs,
                                         membership_proof_leaf_indices,
                                         mutation_data) -> list[int]:
        for mutation in mutation_data:
            self.mutate_leaf_unchecked(mutation.leaf_index, mutation.new_leaf)
        modified = []
        for i, (mp, leaf_index) in enumerate(
                zip(membership_proofs, membership_proof_leaf_indices)):
            new_mp = self.prove_membership(leaf_index)
            if new_mp != mp:
                mp.authentication_path = new_mp.authentication_path
                modified.append(i)
        return modified

    def verify_batch_update(self, new_peaks, appended_leafs,
                            leaf_mutations) -> bool:
        return self.to_accumulator().verify_batch_update(
            new_peaks, appended_leafs, leaf_mutations
        )

    def to_accumulator(self) -> MmrAccumulator:
        return MmrAccumulator(self.peaks(), self.num_leafs())
