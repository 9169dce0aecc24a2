"""The host's time in the span ``tft.open`` an operation
(``util_types/merkle_tree.py::MerkleTree.inclusion_proof_for_leaf_indices``:
the opening's node indices, its one gather and copy, its Digests), over
the operations traced; None where the program opens no such span."""

import spantrace

KERNELS = {}
SPAN = "tft.open"


def read(window):
    spans = [s for s in spantrace.spans_of(window) if s.name == SPAN]
    if not spans:
        return None
    return 1e-3 * sum(s.end_us - s.start_us for s in spans) / window.ops
