"""The glue's device time an operation under the span ``tft.pad``
(``tip5/permutation.py::pad_for_varlen``: the padding's fills and the
padded copy of the table), over the operations traced."""

import spantrace

KERNELS = {}


def read(window):
    return spantrace.glue_ms_per_op(window, "tft.pad")
