"""Device records launched under the span ``tft.sponge`` (each absorb's
chunk copy and K1 launch, the state's fill) over the chunks the sponge
absorbed in the traced window, by the program's counter
``hash_varlen_padded.absorbs``."""

import spantrace

KERNELS = {}
#: the program's counters this reader reads over the traced window
COUNTERS = (spantrace.ABSORBS,)
spantrace.watch(COUNTERS)


def read(window):
    return spantrace.launches_per_absorb(window)
