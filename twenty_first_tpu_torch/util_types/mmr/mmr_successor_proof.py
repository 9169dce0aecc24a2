"""MMR successor proofs: B == A + batch-append (mirrors
mmr_successor_proof.rs).

The counterpart of ``twenty_first_tpu/util_types/mmr/mmr_successor_proof.py``,
held against it by ``tests/test_torch_mmr.py``. The proof is an
authentication path connecting the old peaks into the first unshared new
peak; the Merkle trees over appended leafs are built with ``MerkleTree.new``
on a device (K2 on the card)."""

from __future__ import annotations

from ...tip5.digest import Digest
from ...tip5.tip5 import Tip5
from ..merkle_tree import MerkleTree
from .mmr_accumulator import MmrAccumulator
from .shared_basic import leaf_index_to_mt_index_and_peak_index


class MmrSuccessorProof:
    __slots__ = ("paths",)

    def __init__(self, paths: list[Digest]):
        self.paths = list(paths)

    def __eq__(self, other):
        return isinstance(other, MmrSuccessorProof) and \
            self.paths == other.paths

    @classmethod
    def new_from_batch_append(cls, mmra: MmrAccumulator, new_leafs,
                              device="cuda",
                              plain: bool = False) -> "MmrSuccessorProof":
        """(mmr_successor_proof.rs:34-91). ``new_leafs``: a list of Digests,
        (n, 5) numpy uint64 or an int64 tensor; the trees over them are
        built on ``device`` (a tensor's own device)."""
        if mmra.num_leafs() == 0:
            return cls([])
        height_of_lowest_peak = _trailing_zeros(mmra.num_leafs())
        num_leafs_in_lowest_peak = 1 << height_of_lowest_peak
        if len(new_leafs) < num_leafs_in_lowest_peak:
            return cls([])
        initial_right_tree = MerkleTree.new(
            new_leafs[:num_leafs_in_lowest_peak], device, plain
        )
        num_total_leafs = mmra.num_leafs() + len(new_leafs)
        first_new_leaf_index = mmra.num_leafs()
        merkle_tree_index, _ = leaf_index_to_mt_index_and_peak_index(
            first_new_leaf_index, num_total_leafs
        )
        height_of_new_peak = merkle_tree_index.bit_length() - 1
        merkle_tree_index >>= height_of_lowest_peak

        current_node = initial_right_tree.root()
        paths = [current_node]
        old_peaks = list(mmra.peaks())
        first_unused = num_leafs_in_lowest_peak
        while merkle_tree_index > 1:
            if merkle_tree_index % 2 == 0:
                current_height = height_of_new_peak - \
                    (merkle_tree_index.bit_length() - 1)
                num_right = 1 << current_height
                right_tree = MerkleTree.new(
                    new_leafs[first_unused: first_unused + num_right],
                    device, plain
                )
                first_unused += num_right
                paths.append(right_tree.root())
                current_node = Tip5.hash_pair(current_node, right_tree.root())
            else:
                left_sibling = old_peaks.pop()
                current_node = Tip5.hash_pair(left_sibling, current_node)
            merkle_tree_index //= 2
        return cls(paths)

    def verify(self, old: MmrAccumulator, new: MmrAccumulator) -> bool:
        """(mmr_successor_proof.rs:142-223)"""
        if not old.is_consistent() or not new.is_consistent():
            return False
        if old.num_leafs() == 0:
            return not self.paths
        if old.num_leafs() == new.num_leafs():
            return old.peaks() == new.peaks() and not self.paths
        if old.num_leafs() > new.num_leafs():
            return False

        first_unverified = old.num_leafs()
        merkle_tree_index, num_unchanged_peaks = \
            leaf_index_to_mt_index_and_peak_index(first_unverified,
                                                  new.num_leafs())
        old_peaks = list(old.peaks())
        new_peaks = list(new.peaks())
        if len(old_peaks) < num_unchanged_peaks or \
                len(new_peaks) < num_unchanged_peaks:
            return False
        for i in range(num_unchanged_peaks):
            if old_peaks[i] != new_peaks[i]:
                return False
        old_peaks_rest = old_peaks[num_unchanged_peaks:]
        new_peaks_rest = new_peaks[num_unchanged_peaks:]

        height_of_lowest_old_peak = _trailing_zeros(old.num_leafs())
        num_leafs_in_lowest_old_peak = 1 << height_of_lowest_old_peak
        num_new_leafs = new.num_leafs() - old.num_leafs()
        if num_new_leafs < num_leafs_in_lowest_old_peak:
            return not self.paths

        path = iter(self.paths)
        try:
            current_node = next(path)
        except StopIteration:
            return False
        merkle_tree_index >>= height_of_lowest_old_peak
        while merkle_tree_index > 1:
            if merkle_tree_index % 2 == 0:
                try:
                    right_sibling = next(path)
                except StopIteration:
                    return False
                current_node = Tip5.hash_pair(current_node, right_sibling)
            else:
                if not old_peaks_rest:
                    return False
                left_sibling = old_peaks_rest.pop()
                current_node = Tip5.hash_pair(left_sibling, current_node)
            merkle_tree_index //= 2
        if list(path):
            return False
        if not new_peaks_rest:
            return False
        return current_node == new_peaks_rest[0]


def _trailing_zeros(n: int) -> int:
    return (n & -n).bit_length() - 1
