"""Runtime configuration (mirrors twenty-first/src/config.rs).

A copy of ``twenty_first_tpu/config.py`` (importing that package would
import JAX); ``tests/test_torch_field_elements.py`` holds it against the
JAX package's. The reference's single knob switches Merkle construction
between rayon-parallel and sequential below a node-count cutoff
(config.rs:32-77). Here it decides one thing only: host leafs that
``MmrAccumulator.peaks_from_leafs`` is asked to reduce on the CPU take the
scalar sweep below the cutoff; batched work on a card runs there at every
size. The reference's environment variable is honored.
"""

from __future__ import annotations

import os

_ENV_VAR = "TWENTY_FIRST_MERKLE_TREE_PARALLELIZATION_CUTOFF"
_DEFAULT_CUTOFF = 512
_MIN_CUTOFF = 2

_cutoff: int | None = None


def merkle_tree_parallelization_cutoff() -> int:
    """Current cutoff; env var wins over programmatic setting (config.rs:68-77)."""
    env = os.environ.get(_ENV_VAR)
    if env is not None:
        try:
            return max(int(env), _MIN_CUTOFF)
        except ValueError:
            pass
    if _cutoff is not None:
        return _cutoff
    return _DEFAULT_CUTOFF


def set_merkle_tree_parallelization_cutoff(cutoff: int) -> None:
    global _cutoff
    _cutoff = max(int(cutoff), _MIN_CUTOFF)
