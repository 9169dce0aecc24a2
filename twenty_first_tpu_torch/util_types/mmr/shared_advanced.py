"""MMR advanced index math (mirrors shared_advanced.rs). Pure integer math.

A copy of ``twenty_first_tpu/util_types/mmr/shared_advanced.py``
(importing that package would import JAX), held against it by
``tests/test_torch_mmr.py``.
"""

from __future__ import annotations

from typing import Optional

from .shared_basic import left_child, right_child


def leftmost_ancestor(node_index: int) -> tuple[int, int]:
    """(index, height) of the leftmost ancestor: closest 2^n - 1 >= index."""
    height = node_index.bit_length() - 1
    index = (1 << (height + 1)) - 1
    return index, height


def right_lineage_length_and_own_height(node_index: int) -> tuple[int, int]:
    """How many ancestors (incl. self) are right children, and own height."""
    candidate, candidate_height = leftmost_ancestor(node_index)
    right_ancestor_count = 0
    while True:
        if candidate == node_index:
            return right_ancestor_count, candidate_height
        lc = left_child(candidate, candidate_height)
        if lc < node_index:
            candidate = right_child(candidate)
            right_ancestor_count += 1
        else:
            candidate = lc
            right_ancestor_count = 0
        candidate_height -= 1


def right_lineage_length_from_node_index(node_index: int) -> int:
    """log-time variant (shared_advanced.rs:46-57)."""
    bit_width = node_index.bit_length()
    npo2 = 1 << bit_width
    dist = npo2 - node_index
    if bit_width < dist:
        return right_lineage_length_from_node_index(
            node_index - (1 << (bit_width - 1)) + 1
        )
    return dist - 1


def leaf_index_to_node_index(leaf_index: int) -> int:
    return 2 * leaf_index - bin(leaf_index).count("1") + 1


def parent(node_index: int) -> int:
    right_count, height = right_lineage_length_and_own_height(node_index)
    if right_count != 0:
        return node_index + 1
    return node_index + (1 << (height + 1))


def left_sibling(node_index: int, height: int) -> int:
    return node_index - (1 << (height + 1)) + 1


def right_sibling(node_index: int, height: int) -> int:
    return node_index + (1 << (height + 1)) - 1


def num_leafs_to_num_nodes(num_leafs: int) -> int:
    return 2 * num_leafs - bin(num_leafs).count("1")


def node_indices_added_by_append(old_leaf_count: int) -> list[int]:
    node_index = leaf_index_to_node_index(old_leaf_count)
    added = [node_index]
    right_count = right_lineage_length_from_node_index(node_index)
    while right_count != 0:
        node_index += 1
        added.append(node_index)
        right_count -= 1
    return added


def auth_path_node_indices(num_leafs: int, leaf_index: int) -> list[int]:
    """Node indices of the authentication path from leaf to its peak
    (shared_advanced.rs:119-151)."""
    assert leaf_index < num_leafs, \
        f"Leaf index out-of-bounds: {leaf_index}/{num_leafs}"
    from .shared_basic import leaf_index_to_mt_index_and_peak_index

    merkle_tree_index, _ = leaf_index_to_mt_index_and_peak_index(
        leaf_index, num_leafs
    )
    node_index = leaf_index_to_node_index(leaf_index)
    height = 0
    ret = []
    while merkle_tree_index > 1:
        is_left_sibling = merkle_tree_index & 1 == 0
        if is_left_sibling:
            sibling = node_index + (1 << (height + 1)) - 1
            node_index += 1 << (height + 1)
        else:
            sibling = node_index - (1 << (height + 1)) + 1
            node_index += 1
        ret.append(sibling)
        merkle_tree_index >>= 1
        height += 1
    return ret


def get_authentication_path_node_indices(start_node_index: int,
                                         peak_node_index: int,
                                         node_count: int
                                         ) -> Optional[list[int]]:
    """Sibling indices needed to climb from start to peak; None if the walk
    does not land on the peak (shared_advanced.rs:155-188)."""
    out = []
    node_index = start_node_index
    while node_index <= node_count and node_index != peak_node_index:
        right_count, height = right_lineage_length_and_own_height(node_index)
        if right_count != 0:
            out.append(left_sibling(node_index, height))
            node_index += 1
        else:
            out.append(right_sibling(node_index, height))
            node_index += 1 << (height + 1)
    return out if node_index == peak_node_index else None


def get_peak_heights(leaf_count: int) -> list[int]:
    """Peak heights == indices of set bits, highest first."""
    if leaf_count == 0:
        return []
    return [i for i in range(leaf_count.bit_length() - 1, -1, -1)
            if leaf_count & (1 << i)]


def get_peak_heights_and_peak_node_indices(leaf_count: int
                                           ) -> tuple[list[int], list[int]]:
    """Peak heights and their MMR node indices (shared_advanced.rs:216-250).

    Peak k (highest first) sits at the running sum of full-subtree node
    counts: index = sum over peaks so far of (2^(h+1) - 1)."""
    heights = get_peak_heights(leaf_count)
    node_indices = []
    acc = 0
    for h in heights:
        acc += (1 << (h + 1)) - 1
        node_indices.append(acc)
    return heights, node_indices


def node_index_to_leaf_index(node_index: int) -> Optional[int]:
    """Inverse of leaf_index_to_node_index; None for internal nodes."""
    _, own_height = right_lineage_length_and_own_height(node_index)
    if own_height != 0:
        return None
    node, node_height = leftmost_ancestor(node_index)
    leaf_index = 0
    while node_height > 0:
        lc = left_child(node, node_height)
        if node_index <= lc:
            node = lc
        else:
            node = right_child(node)
            leaf_index += 1 << (node_height - 1)
        node_height -= 1
    return leaf_index
