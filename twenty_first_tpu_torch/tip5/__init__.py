"""Tip5: the permutation and its batched hash entry points
(``permutation``), the scalar sponge (``Tip5``), its inverse
(``InverseTip5``) and ``Digest``."""

from .constants import (  # noqa: F401
    CAPACITY,
    LOOKUP_TABLE,
    MDS_MATRIX_FIRST_COLUMN,
    NUM_ROUNDS,
    NUM_SPLIT_AND_LOOKUP,
    RATE,
    ROUND_CONSTANTS,
    STATE_SIZE,
)
from .digest import Digest  # noqa: F401
from .inverse import InverseTip5  # noqa: F401
from .tip5 import Tip5  # noqa: F401
from . import permutation  # noqa: F401
