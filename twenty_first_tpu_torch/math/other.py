"""Randomness helpers (mirrors twenty-first/src/math/other.rs).

A copy of ``twenty_first_tpu/math/other.py`` (importing that package would
import JAX)."""

from __future__ import annotations

import numpy as np

from .b_field_element import BFieldElement, P
from .x_field_element import XFieldElement
from ..tip5.digest import Digest


def random_elements(n: int, kind=BFieldElement, rng=None) -> list:
    """n uniformly random elements of the given type (BFieldElement,
    XFieldElement, or Digest)."""
    rng = rng or np.random.default_rng()
    if kind is BFieldElement:
        return [BFieldElement(int(v))
                for v in rng.integers(0, P, n, dtype=np.uint64)]
    if kind is XFieldElement:
        vals = rng.integers(0, P, (n, 3), dtype=np.uint64)
        return [XFieldElement((int(a), int(b), int(c))) for a, b, c in vals]
    if kind is Digest:
        vals = rng.integers(0, P, (n, 5), dtype=np.uint64)
        return [Digest([int(x) for x in row]) for row in vals]
    raise TypeError(f"no random sampler for {kind}")
