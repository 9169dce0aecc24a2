"""The glue's device time an operation under the span ``tft.sponge``
(``tip5/permutation.py::hash_varlen_padded``: the state's zero fill and
each absorb's chunk copy), over the operations traced."""

import spantrace

KERNELS = {}


def read(window):
    return spantrace.glue_ms_per_op(window, "tft.sponge")
