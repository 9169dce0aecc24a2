"""The device's idle share: 1 - the union of the device records' intervals
over the traced window's span by CUDA events, as a percentage."""

KERNELS = {}


def read(window):
    if window.span_s <= 0 or window.busy_s <= 0:
        return None
    return 100.0 * (1.0 - window.busy_s / window.span_s)
