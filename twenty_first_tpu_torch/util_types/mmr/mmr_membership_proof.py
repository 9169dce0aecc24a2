"""MMR membership proofs + proof-maintenance algorithms (mirrors
mmr_membership_proof.rs). Verification climbs the local Merkle tree by
left/right parity; the update algorithms harvest recomputable node digests
into hash maps keyed by MMR node index.

A copy of ``twenty_first_tpu/util_types/mmr/mmr_membership_proof.py``
(importing that package would import JAX), held against it by
``tests/test_torch_mmr.py``.
"""

from __future__ import annotations

from ...tip5.digest import Digest
from ...tip5.tip5 import Tip5
from . import shared_advanced
from . import shared_basic


class MmrMembershipProof:
    __slots__ = ("authentication_path",)

    def __init__(self, authentication_path: list[Digest]):
        self.authentication_path = list(authentication_path)

    @classmethod
    def new(cls, authentication_path):
        return cls(authentication_path)

    def __eq__(self, other):
        return isinstance(other, MmrMembershipProof) and \
            self.authentication_path == other.authentication_path

    def __repr__(self):
        return f"MmrMembershipProof({len(self.authentication_path)} nodes)"

    def clone(self) -> "MmrMembershipProof":
        return MmrMembershipProof(list(self.authentication_path))

    # -- verification -------------------------------------------------------

    def verify(self, leaf_index: int, leaf_hash: Digest, peaks: list[Digest],
               num_leafs: int) -> bool:
        """Climb to the indicated peak (mmr_membership_proof.rs:36-77)."""
        if leaf_index >= num_leafs:
            return False
        mt_index, peak_index = shared_basic.leaf_index_to_mt_index_and_peak_index(
            leaf_index, num_leafs
        )
        if bin(num_leafs).count("1") != len(peaks):
            return False
        merkle_tree_height = mt_index.bit_length() - 1
        if merkle_tree_height != len(self.authentication_path):
            return False
        current = leaf_hash
        for sibling in self.authentication_path:
            if mt_index % 2 == 0:
                current = Tip5.hash_pair(current, sibling)
            else:
                current = Tip5.hash_pair(sibling, current)
            mt_index //= 2
        return peaks[peak_index] == current

    # -- index helpers ------------------------------------------------------

    def get_node_indices(self, leaf_index: int) -> list[int]:
        """MMR node indices of the authentication path elements."""
        node_index = shared_advanced.leaf_index_to_node_index(leaf_index)
        out = []
        for _ in range(len(self.authentication_path)):
            right_count, height = \
                shared_advanced.right_lineage_length_and_own_height(node_index)
            if right_count != 0:
                out.append(shared_advanced.left_sibling(node_index, height))
                node_index += 1
            else:
                out.append(shared_advanced.right_sibling(node_index, height))
                node_index += 1 << (height + 1)
        return out

    def get_direct_path_indices(self, leaf_index: int) -> list[int]:
        """Node indices derivable from this proof, leaf included."""
        node_index = shared_advanced.leaf_index_to_node_index(leaf_index)
        out = [node_index]
        for _ in range(len(self.authentication_path)):
            node_index = shared_advanced.parent(node_index)
            out.append(node_index)
        return out

    def get_peak_index_and_height(self, leaf_index: int) -> tuple[int, int]:
        return (
            self.get_direct_path_indices(leaf_index)[-1],
            len(self.authentication_path),
        )

    # -- maintenance under appends ------------------------------------------

    def update_from_append(self, own_leaf_index: int, old_leaf_count: int,
                           new_leaf: Digest, old_peaks: list[Digest]) -> bool:
        """Extend this proof when an append merges its peak
        (mmr_membership_proof.rs:127-217)."""
        own_old_peak_index, own_old_peak_height = \
            self.get_peak_index_and_height(own_leaf_index)
        added = shared_advanced.node_indices_added_by_append(old_leaf_count)
        peak_parent_index = own_old_peak_index + (1 << (own_old_peak_height + 1))
        if peak_parent_index not in added:
            return False
        new_peak_index = added[-1]
        new_node_count = shared_advanced.num_leafs_to_num_nodes(
            old_leaf_count + 1
        )
        missing = shared_advanced.get_authentication_path_node_indices(
            own_old_peak_index, new_peak_index, new_node_count
        )
        known: dict[int, Digest] = {}
        _, old_peak_indices = \
            shared_advanced.get_peak_heights_and_peak_node_indices(old_leaf_count)
        for idx, digest in zip(old_peak_indices, old_peaks):
            known[idx] = digest
        acc_hash = new_leaf
        for node_index, old_peak_digest in zip(added, reversed(old_peaks)):
            known[node_index] = acc_hash
            acc_hash = Tip5.hash_pair(old_peak_digest, acc_hash)
            if node_index in missing:
                break
        for idx in missing:
            self.authentication_path.append(known[idx])
        return True

    @staticmethod
    def batch_update_from_append(membership_proofs, leaf_indices,
                                 old_leaf_count: int, new_leaf: Digest,
                                 old_peaks: list[Digest]) -> list[int]:
        """Extend many proofs after one append (rs:224-330). Returns indices
        of modified proofs."""
        assert len(membership_proofs) == len(leaf_indices)
        assert all(i < old_leaf_count for i in leaf_indices)
        added = shared_advanced.node_indices_added_by_append(old_leaf_count)
        known: dict[int, Digest] = {}
        _, old_peak_indices = \
            shared_advanced.get_peak_heights_and_peak_node_indices(old_leaf_count)
        for idx, digest in zip(old_peak_indices, old_peaks):
            known[idx] = digest
        acc_hash = new_leaf
        for count, (node_index, old_peak_digest) in enumerate(
                zip(added, reversed(old_peaks))):
            known[node_index] = acc_hash
            if count == len(added) - 2:
                break
            acc_hash = Tip5.hash_pair(old_peak_digest, acc_hash)
        modified = []
        new_peak_index = added[-1]
        new_node_count = shared_advanced.num_leafs_to_num_nodes(
            old_leaf_count + 1
        )
        for i, (mp, leaf_index) in enumerate(zip(membership_proofs,
                                                 leaf_indices)):
            old_peak_index, old_peak_height = \
                mp.get_peak_index_and_height(leaf_index)
            peak_parent_index = old_peak_index + (1 << (old_peak_height + 1))
            if peak_parent_index not in added:
                continue
            modified.append(i)
            missing = shared_advanced.get_authentication_path_node_indices(
                old_peak_index, new_peak_index, new_node_count
            )
            for idx in missing:
                mp.authentication_path.append(known[idx])
        return modified

    # -- maintenance under leaf mutations -----------------------------------

    def update_from_leaf_mutation(self, own_leaf_index: int,
                                  leaf_mutation) -> bool:
        """Patch this proof after another leaf changed (rs:337-418)."""
        affected = set(leaf_mutation.affected_node_indices())
        own_indices = self.get_node_indices(own_leaf_index)
        intersection = set(own_indices) & affected
        if not intersection:
            return False
        assert len(intersection) == 1
        intersection_index = next(iter(intersection))
        deducible: dict[int, Digest] = {}
        node_index = shared_advanced.leaf_index_to_node_index(
            leaf_mutation.leaf_index
        )
        deducible[node_index] = leaf_mutation.new_leaf
        acc_hash = leaf_mutation.new_leaf
        for digest in leaf_mutation.membership_proof.authentication_path:
            if intersection_index == node_index:
                break
            right_count, height = \
                shared_advanced.right_lineage_length_and_own_height(node_index)
            if right_count != 0:
                acc_hash = Tip5.hash_pair(digest, acc_hash)
                node_index += 1
            else:
                acc_hash = Tip5.hash_pair(acc_hash, digest)
                node_index += 1 << (height + 1)
            deducible[node_index] = acc_hash
        for pos, own_index in enumerate(own_indices):
            if own_index in deducible:
                self.authentication_path[pos] = deducible[own_index]
        return True

    @staticmethod
    def _deducible_from_mutation(leaf_mutation) -> dict[int, Digest]:
        """Digests recomputable from one mutation, peak excluded."""
        deducible: dict[int, Digest] = {}
        node_index = shared_advanced.leaf_index_to_node_index(
            leaf_mutation.leaf_index
        )
        deducible[node_index] = leaf_mutation.new_leaf
        acc_hash = leaf_mutation.new_leaf
        path = leaf_mutation.membership_proof.authentication_path
        for count, digest in enumerate(path):
            if count == len(path) - 1:
                break
            right_count, height = \
                shared_advanced.right_lineage_length_and_own_height(node_index)
            if right_count != 0:
                acc_hash = Tip5.hash_pair(digest, acc_hash)
                node_index += 1
            else:
                acc_hash = Tip5.hash_pair(acc_hash, digest)
                node_index += 1 << (height + 1)
            deducible[node_index] = acc_hash
        return deducible

    @staticmethod
    def batch_update_from_leaf_mutation(membership_proofs, leaf_indices,
                                        leaf_mutation) -> list[int]:
        """Patch many proofs after one mutation (rs:421-520)."""
        assert len(membership_proofs) == len(leaf_indices)
        deducible = MmrMembershipProof._deducible_from_mutation(leaf_mutation)
        modified = []
        for i, (mp, leaf_index) in enumerate(zip(membership_proofs,
                                                 leaf_indices)):
            for pos, ap_index in enumerate(mp.get_node_indices(leaf_index)):
                if ap_index in deducible and \
                        mp.authentication_path[pos] != deducible[ap_index]:
                    mp.authentication_path[pos] = deducible[ap_index]
                    modified.append(i)
                    break
        return modified

    @staticmethod
    def batch_update_from_batch_leaf_mutation(membership_proofs, leaf_indices,
                                              leaf_mutations) -> list[int]:
        """Patch many proofs after many mutations (rs:523-640)."""
        assert len(membership_proofs) == len(leaf_indices)
        new_ap_digests: dict[int, Digest] = {}
        mutations = list(leaf_mutations)
        while mutations:
            mutation = mutations.pop()
            node_index = shared_advanced.leaf_index_to_node_index(
                mutation.leaf_index
            )
            assert node_index not in new_ap_digests, \
                "Duplicated leafs are not allowed in membership proof updater"
            new_ap_digests[node_index] = mutation.new_leaf
            acc_hash = mutation.new_leaf
            path = mutation.membership_proof.authentication_path
            for count, digest in enumerate(path):
                if count == len(path) - 1:
                    break
                right_count, height = \
                    shared_advanced.right_lineage_length_and_own_height(
                        node_index)
                sibling = (
                    shared_advanced.left_sibling(node_index, height)
                    if right_count != 0
                    else shared_advanced.right_sibling(node_index, height)
                )
                sibling_hash = new_ap_digests.get(sibling, digest)
                if right_count != 0:
                    acc_hash = Tip5.hash_pair(sibling_hash, acc_hash)
                    node_index += 1
                else:
                    acc_hash = Tip5.hash_pair(acc_hash, sibling_hash)
                    node_index += 1 << (height + 1)
                new_ap_digests[node_index] = acc_hash
        modified = []
        for i, (mp, leaf_index) in enumerate(zip(membership_proofs,
                                                 leaf_indices)):
            changed = False
            for pos, ap_index in enumerate(mp.get_node_indices(leaf_index)):
                if ap_index in new_ap_digests and \
                        mp.authentication_path[pos] != new_ap_digests[ap_index]:
                    mp.authentication_path[pos] = new_ap_digests[ap_index]
                    changed = True
            if changed:
                modified.append(i)
        return modified
