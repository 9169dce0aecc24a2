"""Spans at the port's layer boundaries, for ``torch.profiler``.

``span(name)`` is ``torch.profiler.record_function("tft." + name)`` while
a profiler records, and one shared null context otherwise: there is no
switch, the spans show whenever a caller profiles. One span is opened per
call of a layer's function, never per iteration of a loop inside it
(entering ``record_function`` costs ~15 us, gating it ~0.5 us); a loop's
iterations are counted on its function instead (say
``hash_varlen_padded.absorbs``, the chunks absorbed, or
``PartialMerkleTree.fill.levels``, the levels hashed), as the kernel
wrappers count their ``.launches``.

The spans, outermost first:

- ``tft.trace_commit``: ``parallel/pipeline.py::TraceLdeCommit.forward``;
- ``tft.lde``: ``TraceLdeCommit.leaf_digests``, the padded planes and both
  NTTs;
- ``tft.ntt``: ``math/ntt.py::ntt`` on a tensor, one transform;
- ``tft.leaf_hash``: ``parallel/pipeline.py::hash_rows``;
- ``tft.pad``: ``tip5/permutation.py::pad_for_varlen`` on a tensor;
- ``tft.sponge``: ``tip5/permutation.py::hash_varlen_padded``, every
  absorb;
- ``tft.tree``: ``ops/tip5_commit.py::reduce_layers`` and
  ``util_types/merkle_tree.py::MerkleTree.new``;
- ``tft.open``: ``util_types/merkle_tree.py::MerkleTree.
  inclusion_proof_for_leaf_indices``, the opening's one gather and copy;
- ``tft.verify``: ``util_types/merkle_tree.py::PartialMerkleTree.fill``,
  every level of a verification's partial tree.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "tft."
NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager: the profiler's span ``tft.<name>`` while a
    profiler records, else the shared null context."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(PREFIX + name)
    return NULL
