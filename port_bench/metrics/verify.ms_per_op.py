"""The host's time in the span ``tft.verify`` an operation
(``util_types/merkle_tree.py::PartialMerkleTree.fill``: the partial
tree's plan, its copy to the card, a gather and a K2 launch a level), in
every verification of the operation, over the operations traced; None
where the program opens no such span."""

import spantrace

KERNELS = {}
SPAN = "tft.verify"


def read(window):
    spans = [s for s in spantrace.spans_of(window) if s.name == SPAN]
    if not spans:
        return None
    return 1e-3 * sum(s.end_us - s.start_us for s in spans) / window.ops
