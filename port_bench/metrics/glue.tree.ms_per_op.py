"""The glue's device time an operation under the span ``tft.tree``
(``ops/tip5_commit.py::reduce_layers``, ``util_types/merkle_tree.py::
MerkleTree.new``: the nodes' fill and the leafs' copy), over the
operations traced."""

import spantrace

KERNELS = {}


def read(window):
    return spantrace.glue_ms_per_op(window, "tft.tree")
