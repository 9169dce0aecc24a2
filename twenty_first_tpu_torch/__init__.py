"""twenty_first_tpu_torch — the STARK primitives on PyTorch and CUDA.

The PyTorch counterpart of ``twenty_first_tpu`` (the JAX reference, which
stays beside it unchanged). Field elements travel as int64 tensors holding
the u64 bit pattern of a canonical Goldilocks value, in natural order: that
is the contract at every seam between modules.

Layout, each module named after its counterpart in the JAX package:

* ``math/gf.py``: field arithmetic on the int64 carrier (plain torch), and
  the inverse and batch inversion (K8, K7 on the card);
* ``math/gf_ext.py``: the extension field on (..., 3, n) carriers;
* ``math/ntt.py``: the natural-order NTT over the last axis at every
  power-of-two length up to 2^32 (one, two or three passes of K3), its
  limb-plane API, and the NTT-domain convolutions;
* ``math/poly_batch.py``: batch-first polynomial ops (coset LDE, products,
  barycentric evaluation, out-of-domain extrapolation);
* ``math/polynomial.py``, ``math/zerofier_tree.py``, ``math/field_list.py``:
  the polynomial engine's object API (``Polynomial``, ``ZerofierTree``,
  ``FieldElements``), host logic over numpy and the native core that sends
  work above its host/device crossovers to the card (``ntt.routed_*``,
  ``ntt.DEVICE``); ``math/ntt.py`` also has the host NTT (``ntt_host``)
  and the scalar-object ``ntt``/``intt``;
* ``native.py``: the port's loader of the native host core
  (``native/twenty_first_native.cpp``, built with g++ into ``.build/``);
* ``math/b_field_element.py``, ``math/x_field_element.py``: the scalar
  field elements (host side); ``math/bfield_codec.py``: the BFieldCodec
  serialization; ``math/lattice.py``: the ring F_p[X]/(X^64 + 1) and its
  KEM (numpy and hashlib); ``math/other.py``: ``random_elements``;
* ``errors.py``: the JAX package's error types; ``config.py``: the
  reference's Merkle parallelization cutoff;
* ``tip5/permutation.py``: the Tip5 permutation, its trace, and the batch,
  hash and sponge entry points (fixed, variable and mixed lengths);
  ``tip5/digest.py``, ``tip5/tip5.py``, ``util_types/sponge.py``: the
  Tip5 object API (``Digest``, the scalar sponge on the native host core,
  ``Tip5.hash``/``hash_batch`` of encodings, the batch on K1);
  ``tip5/inverse.py``: ``InverseTip5``; ``tip5/blake3_mini.py``: the
  round constants' derivation;
* ``util_types/merkle_tree.py``: ``MerkleTree`` on a device (K2 builds it
  level by level; host leafs up to ``HOST_MERKLE_MAX_LEAFS`` take the
  native core), authentication structures and inclusion proofs;
  ``util_types/mmr/``: the MMR accumulator, the archival MMR, membership
  and successor proofs;
* ``ops/tip5_cuda.py``, ``ops/ntt_cuda.py``, ``ops/probe_cuda.py``,
  ``ops/poly_cuda.py``: wrappers of the hand-written Hopper kernels in
  ``csrc/`` (Tip5 permutation and its trace mode, multi-level Merkle
  commit, NTT local pass, the probes' NTT stage and field-op chain, the
  extrapolation's coefficient fold, batch inversion and elementwise field
  ops), each beside its plain PyTorch twin;
* ``ops/tip5_batch.py``: the standalone Tip5 batch entry points of
  ``ops/tip5_pallas.py``, over the permutation kernel;
* ``ops/tip5_commit.py``: the Merkle commit launch plan;
* ``parallel/pipeline.py``: the trace LDE + commit step;
* ``probes/``: the Pallas probes' counterparts, timing tools for the card;
* ``entry.py``: the analogue of ``__graft_entry__.entry``;
* ``prelude.py``: the user-facing re-exports.

Importing the package imports ``errors``, ``math``, ``tip5``,
``util_types``, ``config`` and ``prelude``, as the JAX package's does; it
builds nothing (the kernels build at their first launch, the native core
at its first call).

A CUDA tensor goes to the kernels (built with nvcc at first use) or raises;
a CPU tensor takes the plain twins. Functions that make their own tensors
put them on the card unless the caller names another device. Nothing here
imports JAX.
"""

__version__ = "0.1.0"

from . import errors  # noqa: F401
from . import math  # noqa: F401
from . import tip5  # noqa: F401
from . import util_types  # noqa: F401
from . import config  # noqa: F401
from . import prelude  # noqa: F401
