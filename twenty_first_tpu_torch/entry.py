"""Entry point: the flagship step at ``__graft_entry__.entry``'s shape.

The analogue of ``__graft_entry__.entry``: returns the step (``lde_commit``)
and its example arguments, a (16, 64) trace made from a numpy seed.
"""

from __future__ import annotations

import numpy as np

from .math import gf
from .parallel.pipeline import lde_commit


def entry(device="cuda"):
    """(step, args): ``step(*args)`` is the (1, 5) root of a (16, 64) trace
    drawn from ``np.random.default_rng(0)``, on ``device`` (the card unless
    the caller asks for another; a machine without one raises)."""
    rows, n = 16, 64
    rng = np.random.default_rng(0)
    data = rng.integers(0, (1 << 64) - (1 << 32) + 1, size=(rows, n),
                        dtype=np.uint64)
    return lde_commit, (gf.from_u64(data).to(device),)
