"""The glue's device time an operation under the span ``tft.lde``
(``parallel/pipeline.py::TraceLdeCommit.leaf_digests``: the padded planes'
zero fill and both NTTs): records of no csrc/ kernel launched while it or
a span inside it (``tft.ntt``) was open, over the operations traced."""

import spantrace

KERNELS = {}


def read(window):
    return spantrace.glue_ms_per_op(window, "tft.lde")
