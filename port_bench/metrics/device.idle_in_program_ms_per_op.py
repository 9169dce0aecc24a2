"""The device's idle time an operation that the program's own host code
caused: the gaps between device records whose middle falls inside an
outermost ``tft.*`` span, over the operations traced (the rest of the
idle falls in the caller's code: the harness, the root's read)."""

import spantrace

KERNELS = {}


def read(window):
    return spantrace.idle_in_program_ms_per_op(window)
