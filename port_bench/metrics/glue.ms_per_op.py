"""The glue's device time an operation: every device record of the traced
window (kernels, fills, copies, memsets) that is no kernel of the port's
csrc/, over the operations traced."""

KERNELS = {}


def read(window):
    glue = sum(r.seconds for r in window.records if not window.is_own(r.name))
    return 1e3 * glue / window.ops
