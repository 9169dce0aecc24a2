"""The glue's device time an operation under the span ``tft.leaf_hash``
(``parallel/pipeline.py::hash_rows``: the leaf states' zero fill, the
planes' copy into them, the ones fill and, after K1, the digests' copy),
over the operations traced."""

import spantrace

KERNELS = {}


def read(window):
    return spantrace.glue_ms_per_op(window, "tft.leaf_hash")
