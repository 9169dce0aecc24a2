"""The standalone Tip5 batch entry points of ``ops/tip5_pallas.py``, over K1.

The counterparts of the JAX package's

* T4 ``permutation`` (:118) and ``permutation_values`` (:140): the narrow
  kernel ``_permutation_kernel`` (:102) over (tile, 16) blocks;
* T5 ``permutation_dense`` (:383), ``permutation_dense_nogrid`` (:466) and
  ``permutation_dense_values`` (:485): the lane-dense ``_dense_kernel``
  (:252) over 8 states interleaved per 128-lane row, with a grid or a
  grid-free ``lax.map`` over tiles.

All of them compute Tip5 on (B, 16) states, which is K1's function
(``csrc/tip5.cu``). Their blocks, the lane interleave and the tiling exist
for TPU lanes and the TPU's compile path only, so each entry point here is
one K1 launch on the (B, 16) carrier for any B. ``tile`` and ``interpret``
keep the JAX signatures and have no meaning on Hopper. A CUDA tensor
launches K1 (or raises); a CPU tensor takes its plain twin.
"""

from __future__ import annotations

import numpy as np

from ..math import gf
from ..tip5.permutation import tip5_tables
from . import tip5_cuda


def permutation(states, tile: int = 2048, interpret: bool = False):
    """T4: (B, 16) int64 states -> permuted states. ``tile`` and
    ``interpret`` have no meaning on Hopper and are ignored."""
    del tile, interpret
    return tip5_cuda.tip5_permute(states, *tip5_tables(states.device))


def permutation_values(states, tile: int = 2048, interpret: bool = False,
                       device="cuda") -> np.ndarray:
    """T4 on host arrays: uint64 (B, 16) -> permuted, on ``device``."""
    x = gf.from_u64(np.asarray(states, dtype=np.uint64)).to(device)
    return gf.to_u64(permutation(x, tile, interpret))


# T5's grid and grid-free forms and its host-array form: the same function
# through the same K1 launch (the JAX forms' default tile, 512, is ignored
# as T4's is).
permutation_dense = permutation_dense_nogrid = permutation
permutation_dense_values = permutation_values
