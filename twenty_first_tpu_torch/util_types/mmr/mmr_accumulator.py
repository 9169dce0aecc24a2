"""Succinct MMR accumulator: leaf count + peaks only (mirrors
mmr_accumulator.rs).

The counterpart of ``twenty_first_tpu/util_types/mmr/mmr_accumulator.py``,
held against it by ``tests/test_torch_mmr.py``. Peaks from leafs are
reduced on the device the caller names (each peak by the commit's launch
plan, K2 on the card); only host leafs on ``device="cpu"`` below the
reference's parallelization cutoff take the reference's O(log n)-memory
diagonal sweep instead. Everything else is scalar host code over
``Tip5.hash_pair``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import merkle_tree_parallelization_cutoff
from ...ops import tip5_commit
from ...tip5.digest import Digest
from ...tip5.tip5 import Tip5
from ..merkle_tree import _as_leaf_tensor, _digests
from . import shared_advanced
from . import shared_basic
from .mmr_membership_proof import MmrMembershipProof
from .mmr_trait import LeafMutation, Mmr

# Consistent with the reference's cap (mmr.rs:12-13).
MAX_NUM_LEAFS = 1 << 63


class MmrAccumulator(Mmr):
    def __init__(self, peaks: list[Digest], leaf_count: int):
        self._leaf_count = leaf_count
        self._peaks = list(peaks)

    @classmethod
    def init(cls, peaks: list[Digest], leaf_count: int) -> "MmrAccumulator":
        return cls(peaks, leaf_count)

    @classmethod
    def new_from_leafs(cls, leafs, device="cuda",
                       plain: bool = False) -> "MmrAccumulator":
        """The accumulator over ``leafs``: a list of Digests, (n, 5) numpy
        uint64 or an int64 tensor (see ``peaks_from_leafs``)."""
        return cls(cls.peaks_from_leafs(leafs, device, plain), len(leafs))

    # -- peaks from leafs ----------------------------------------------------

    @staticmethod
    def peaks_from_leafs(leafs, device="cuda",
                         plain: bool = False) -> list[Digest]:
        """Peaks of the MMR over the given leafs.

        The leaf count's binary decomposition splits the leafs into
        contiguous perfect trees, and each peak is that tree's frugal root
        on ``device`` (a tensor's own device; K2 on the card, the plain
        twins on the CPU or with ``plain``), all copied to the host at
        once. That is the batched form of the reference's diagonal sweep
        (mmr_accumulator.rs:96-115), which is sequential: host leafs (a
        list or numpy) on ``device="cpu"`` below the parallelization
        cutoff take the sweep, as the reference's sequential branch."""
        n = len(leafs)
        if n == 0:
            return []
        if (isinstance(leafs, torch.Tensor)
                or torch.device(device).type != "cpu"
                or n >= merkle_tree_parallelization_cutoff()):
            arr = _as_leaf_tensor(leafs, device)
            roots, offset = [], 0
            for height in shared_advanced.get_peak_heights(n):
                size = 1 << height
                roots.append(tip5_commit.reduce_layers(
                    arr[offset: offset + size], height, plain=plain))
                offset += size
            return _digests(torch.cat(roots))
        if isinstance(leafs, np.ndarray):
            leafs = [Digest.from_array(row) for row in leafs]
        peaks: list[Digest] = []
        for diagonal_idx in range(1, n // 2 + 1):
            left = leafs[2 * (diagonal_idx - 1)]
            right_leaf = leafs[2 * diagonal_idx - 1]
            right = Tip5.hash_pair(left, right_leaf)
            tz = diagonal_idx
            while tz % 2 == 0:
                right = Tip5.hash_pair(peaks.pop(), right)
                tz //= 2
            peaks.append(right)
        if n % 2 == 1:
            peaks.append(leafs[-1])
        return peaks

    def is_consistent(self) -> bool:
        return len(self._peaks) == bin(self._leaf_count).count("1")

    # -- Mmr interface -------------------------------------------------------

    def bag_peaks(self) -> Digest:
        return bag_peaks(self._peaks, self._leaf_count)

    def peaks(self) -> list[Digest]:
        return list(self._peaks)

    def is_empty(self) -> bool:
        return self._leaf_count == 0

    def num_leafs(self) -> int:
        return self._leaf_count

    def append(self, new_leaf: Digest) -> MmrMembershipProof:
        new_peaks, membership_proof = \
            shared_basic.calculate_new_peaks_from_append(
                self._leaf_count, self._peaks, new_leaf
            )
        self._peaks = new_peaks
        self._leaf_count += 1
        return membership_proof

    def mutate_leaf(self, leaf_mutation: LeafMutation) -> None:
        self._peaks = shared_basic.calculate_new_peaks_from_leaf_mutation(
            self._peaks,
            self._leaf_count,
            leaf_mutation.new_leaf,
            leaf_mutation.leaf_index,
            leaf_mutation.membership_proof,
        )

    def batch_mutate_leaf_and_update_mps(self, membership_proofs,
                                         membership_proof_leaf_indices,
                                         mutation_data) -> list[int]:
        """Apply many mutations, then patch the tracked membership proofs
        (mmr_accumulator.rs:180-302)."""
        assert len(membership_proofs) == len(membership_proof_leaf_indices)
        assert all(i < self._leaf_count
                   for i in membership_proof_leaf_indices)
        new_ap_digests: dict[int, Digest] = {}
        mutations = list(mutation_data)
        while mutations:
            mutation = mutations.pop()
            node_index = shared_advanced.leaf_index_to_node_index(
                mutation.leaf_index
            )
            assert node_index not in new_ap_digests, \
                "Duplicated leaf indices are not allowed in membership proof updater"
            new_ap_digests[node_index] = mutation.new_leaf
            acc_hash = mutation.new_leaf
            path = mutation.membership_proof.authentication_path
            for count, digest in enumerate(path):
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
                if count < len(path) - 1:
                    new_ap_digests[node_index] = acc_hash
            _, peak_index = shared_basic.leaf_index_to_mt_index_and_peak_index(
                mutation.leaf_index, self._leaf_count
            )
            self._peaks[peak_index] = acc_hash
        modified = []
        for i, (mp, leaf_index) in enumerate(
                zip(membership_proofs, membership_proof_leaf_indices)):
            for pos, ap_index in enumerate(mp.get_node_indices(leaf_index)):
                if ap_index in new_ap_digests and \
                        mp.authentication_path[pos] != new_ap_digests[ap_index]:
                    mp.authentication_path[pos] = new_ap_digests[ap_index]
                    if not modified or modified[-1] != i:
                        modified.append(i)
        return modified

    def verify_batch_update(self, new_peaks, appended_leafs,
                            leaf_mutations) -> bool:
        """Replay mutations + appends against the claimed new peaks
        (mmr_accumulator.rs:307-369)."""
        indices = [m.leaf_index for m in leaf_mutations]
        if len(set(indices)) != len(indices):
            return False
        if any(i >= self._leaf_count for i in indices):
            return False
        mutations = [
            LeafMutation(m.leaf_index, m.new_leaf,
                         m.membership_proof.clone())
            for m in leaf_mutations
        ]
        running_peaks = list(self._peaks)
        while mutations:
            mutation = mutations.pop(0)
            running_peaks = shared_basic.calculate_new_peaks_from_leaf_mutation(
                running_peaks,
                self._leaf_count,
                mutation.new_leaf,
                mutation.leaf_index,
                mutation.membership_proof,
            )
            MmrMembershipProof.batch_update_from_leaf_mutation(
                [m.membership_proof for m in mutations],
                [m.leaf_index for m in mutations],
                mutation,
            )
        count = self._leaf_count
        for leaf in appended_leafs:
            running_peaks, _ = shared_basic.calculate_new_peaks_from_append(
                count, running_peaks, leaf
            )
            count += 1
        return running_peaks == list(new_peaks)

    def to_accumulator(self) -> "MmrAccumulator":
        return MmrAccumulator(self._peaks, self._leaf_count)

    def __eq__(self, other):
        return isinstance(other, MmrAccumulator) and \
            self._leaf_count == other._leaf_count and \
            self._peaks == other._peaks

    def __repr__(self):
        return f"MmrAccumulator(leaf_count={self._leaf_count}, " \
            f"peaks={len(self._peaks)})"


def mmra_with_mps(leaf_count: int, specified_leafs: list[tuple[int, Digest]],
                  rng=None) -> tuple["MmrAccumulator", list]:
    """Test-fixture factory (mmr_accumulator.rs util::mmra_with_mps): build a
    consistent MMR accumulator with the given digests at the given leaf
    indices — without materializing the other leafs — plus valid membership
    proofs for them. Unspecified siblings are filled with random digests,
    level by level, so shared path prefixes stay consistent."""
    from ...math.b_field_element import P as _P

    rng = rng or np.random.default_rng()

    def rand_digest():
        return Digest([int(v) for v in rng.integers(0, _P, 5, dtype=np.uint64)])

    assert len({i for i, _ in specified_leafs}) == len(specified_leafs), \
        "Specified leaf indices must be unique"
    assert all(0 <= i < leaf_count for i, _ in specified_leafs)

    num_peaks = bin(leaf_count).count("1")
    peaks = [rand_digest() for _ in range(num_peaks)]
    if not specified_leafs:
        return MmrAccumulator(peaks, leaf_count), []

    # Group specified leafs by peak; build each affected local Merkle tree
    # top-down as a dict {local_node_index: digest} with random padding.
    by_peak: dict[int, list[tuple[int, int, Digest]]] = {}
    for leaf_index, digest in specified_leafs:
        mt_index, peak_index = shared_basic.leaf_index_to_mt_index_and_peak_index(
            leaf_index, leaf_count
        )
        by_peak.setdefault(peak_index, []).append((mt_index, leaf_index, digest))

    proofs_by_leaf: dict[int, list[Digest]] = {}
    for peak_index, entries in by_peak.items():
        nodes: dict[int, Digest] = {}
        needed: set[int] = set()
        for mt_index, _, digest in entries:
            assert mt_index not in nodes or nodes[mt_index] == digest
            nodes[mt_index] = digest
            idx = mt_index
            while idx > 1:
                needed.add(idx // 2)
                idx //= 2
        # fill bottom-up: deepest internal nodes first
        for node in sorted(needed, reverse=True):
            for child in (2 * node, 2 * node + 1):
                if child not in nodes:
                    nodes[child] = rand_digest()
            nodes[node] = Tip5.hash_pair(nodes[2 * node], nodes[2 * node + 1])
        peaks[peak_index] = nodes.get(1, entries[0][2])
        for mt_index, leaf_index, _ in entries:
            path = []
            idx = mt_index
            while idx > 1:
                path.append(nodes[idx ^ 1])
                idx //= 2
            proofs_by_leaf[leaf_index] = path

    membership_proofs = [
        MmrMembershipProof(proofs_by_leaf[leaf_index])
        for leaf_index, _ in specified_leafs
    ]
    acc = MmrAccumulator(peaks, leaf_count)
    return acc, membership_proofs


def bag_peaks(peaks: list[Digest], leaf_count: int) -> Digest:
    """Commitment to the whole MMR: fold hash_pair right-to-left, seeded with
    hash_10 of the padded leaf-count encoding (mmr_accumulator.rs:379-391)."""
    from ...math.b_field_element import bfe

    lo = leaf_count & 0xFFFFFFFF
    hi = (leaf_count >> 32) & 0xFFFFFFFF
    padded = [bfe(lo), bfe(hi)] + [bfe(0)] * 8
    acc = Digest(Tip5.hash_10(padded))
    for peak in reversed(peaks):
        acc = Tip5.hash_pair(peak, acc)
    return acc
