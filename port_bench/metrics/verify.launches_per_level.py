"""Device records launched under the span ``tft.verify``
(``util_types/merkle_tree.py::PartialMerkleTree.fill``) over the levels
the fills hashed in the traced window, by the program's counter
``PartialMerkleTree.fill.levels``: a gather and one K2 launch a level,
and the nodes' one copy a fill. None where the program has no such span
or counter (a fill that hashes on the host launches nothing)."""

import spantrace

KERNELS = {}
LEVELS = ("twenty_first_tpu_torch.util_types.merkle_tree:"
          "PartialMerkleTree.fill.levels")
#: the program's counters this reader reads over the traced window
COUNTERS = (LEVELS,)
spantrace.watch(COUNTERS)


def read(window):
    levels = getattr(window, "counts", {}).get(LEVELS)
    if not levels or not any(s.name == "tft.verify"
                             for s in spantrace.spans_of(window)):
        return None
    return sum(1 for r in window.records
               if spantrace.under(r, "tft.verify")) / levels
