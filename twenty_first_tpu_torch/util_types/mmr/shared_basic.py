"""MMR basic index math and peak calculations (mirrors
twenty-first/src/util_types/mmr/shared_basic.rs). MMR node numbering is
post-order 1-based; all functions are pure host-side integer math.

A copy of ``twenty_first_tpu/util_types/mmr/shared_basic.py``
(importing that package would import JAX), held against it by
``tests/test_torch_mmr.py``.
"""

from __future__ import annotations

from ...tip5.digest import Digest
from ...tip5.tip5 import Tip5


def left_child(node_index: int, height: int) -> int:
    return node_index - (1 << height)


def right_child(node_index: int) -> int:
    return node_index - 1


def leaf_index_to_mt_index_and_peak_index(leaf_index: int, num_leafs: int
                                          ) -> tuple[int, int]:
    """Merkle-tree index within the local tree and the peak index
    (shared_basic.rs:24-61, XOR-discrepancy bit trick)."""
    assert leaf_index < num_leafs, \
        "Leaf index must be strictly smaller than the number of leafs"
    discrepancies = leaf_index ^ num_leafs
    local_mt_height = discrepancies.bit_length() - 1
    local_mt_num_leafs = 1 << local_mt_height
    remainder_bitmask = local_mt_num_leafs - 1
    local_leaf_index = remainder_bitmask & leaf_index
    mt_node_index = local_leaf_index + local_mt_num_leafs
    num_peaks = bin(num_leafs).count("1")
    num_peaks_le = bin(num_leafs & remainder_bitmask).count("1")
    peak_index = num_peaks - num_peaks_le - 1
    return mt_node_index, peak_index


def right_lineage_length_from_leaf_index(leaf_index: int) -> int:
    """Number of parents a fresh append merges == trailing ones."""
    count = 0
    while leaf_index & 1:
        count += 1
        leaf_index >>= 1
    return count


def calculate_new_peaks_from_append(old_num_leafs: int, old_peaks: list,
                                    new_leaf: Digest):
    """New peak list + membership proof for the appended leaf
    (shared_basic.rs:75-96)."""
    from .mmr_membership_proof import MmrMembershipProof

    assert len(old_peaks) == bin(old_num_leafs).count("1"), \
        "old peaks and old num leafs must be consistent"
    peaks = list(old_peaks)
    peaks.append(new_leaf)
    authentication_path = []
    for _ in range(right_lineage_length_from_leaf_index(old_num_leafs)):
        in_progress_peak = peaks.pop()
        previous_peak = peaks.pop()
        authentication_path.append(previous_peak)
        peaks.append(Tip5.hash_pair(previous_peak, in_progress_peak))
    return peaks, MmrMembershipProof(authentication_path)


def calculate_new_peaks_from_leaf_mutation(old_peaks: list, num_leafs: int,
                                           new_leaf: Digest, leaf_index: int,
                                           membership_proof) -> list:
    """Recompute the (single) affected peak after a leaf mutation
    (shared_basic.rs:107-138)."""
    acc_mt_index, peak_index = leaf_index_to_mt_index_and_peak_index(
        leaf_index, num_leafs
    )
    acc_hash = new_leaf
    path = iter(membership_proof.authentication_path)
    while acc_mt_index > 1:
        ap_element = next(path)
        if acc_mt_index % 2 == 0:
            acc_hash = Tip5.hash_pair(acc_hash, ap_element)
        else:
            acc_hash = Tip5.hash_pair(ap_element, acc_hash)
        acc_mt_index //= 2
    peaks = list(old_peaks)
    peaks[peak_index] = acc_hash
    return peaks
