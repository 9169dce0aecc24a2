"""The host's time inside the program an operation: the summed durations
of the outermost ``tft.*`` spans (``tft.trace_commit``; ``tft.pad``,
``tft.sponge``, ``tft.tree``), its launches and the Python between them,
under the profiler, over the operations traced."""

import spantrace

KERNELS = {}


def read(window):
    return spantrace.dispatch_ms_per_op(window)
