"""Mmr interface + LeafMutation (mirrors mmr_trait.rs).

A copy of ``twenty_first_tpu/util_types/mmr/mmr_trait.py``
(importing that package would import JAX), held against it by
``tests/test_torch_mmr.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...tip5.digest import Digest


@dataclass
class LeafMutation:
    """A prospective leaf mutation: which leaf, the new value, and a (still-
    valid) membership proof for it (mmr_trait.rs:9-40)."""

    leaf_index: int
    new_leaf: Digest
    membership_proof: "MmrMembershipProof"

    @classmethod
    def new(cls, leaf_index: int, new_leaf: Digest, membership_proof):
        return cls(leaf_index, new_leaf, membership_proof)

    def affected_node_indices(self) -> list[int]:
        """All node indices whose digest changes under this mutation."""
        return self.membership_proof.get_direct_path_indices(self.leaf_index)


class Mmr:
    """Abstract MMR interface (mmr_trait.rs:127-171)."""

    def bag_peaks(self) -> Digest:
        raise NotImplementedError

    def peaks(self) -> list[Digest]:
        raise NotImplementedError

    def is_empty(self) -> bool:
        raise NotImplementedError

    def num_leafs(self) -> int:
        raise NotImplementedError

    def append(self, new_leaf: Digest):
        raise NotImplementedError

    def mutate_leaf(self, leaf_mutation: LeafMutation) -> None:
        raise NotImplementedError

    def batch_mutate_leaf_and_update_mps(self, membership_proofs,
                                         membership_proof_leaf_indices,
                                         mutation_data):
        raise NotImplementedError

    def verify_batch_update(self, new_peaks, appended_leafs,
                            leaf_mutations) -> bool:
        raise NotImplementedError

    def to_accumulator(self):
        raise NotImplementedError
