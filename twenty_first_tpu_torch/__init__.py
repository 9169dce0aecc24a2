"""twenty_first_tpu_torch — the STARK primitives on PyTorch and CUDA.

The PyTorch counterpart of ``twenty_first_tpu`` (the JAX reference, which
stays beside it unchanged). Field elements travel as int64 tensors holding
the u64 bit pattern of a canonical Goldilocks value, in natural order: that
is the contract at every seam between modules.

Layout, each module named after its counterpart in the JAX package:

* ``math/gf.py``: field arithmetic on the int64 carrier (plain torch), and
  the inverse and batch inversion (K8, K7 on the card);
* ``math/gf_ext.py``: the extension field on (..., 3, n) carriers;
* ``math/ntt.py``: the natural-order NTT over the last axis (four-step),
  and the NTT-domain convolutions;
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
  field elements (host side);
* ``errors.py``: the JAX package's error types; ``config.py``: the
  reference's Merkle parallelization cutoff;
* ``tip5/permutation.py``: the Tip5 permutation, its trace, and the batch,
  hash and sponge entry points (fixed, variable and mixed lengths);
  ``tip5/digest.py``, ``tip5/tip5.py``, ``util_types/sponge.py``: the
  Tip5 object API (``Digest``, the scalar sponge, host side);
* ``util_types/merkle_tree.py``: ``MerkleTree`` on a device (K2 builds it
  level by level), authentication structures and inclusion proofs;
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
* ``entry.py``: the analogue of ``__graft_entry__.entry``.

A CUDA tensor goes to the kernels (built with nvcc at first use) or raises;
a CPU tensor takes the plain twins. Functions that make their own tensors
put them on the card unless the caller names another device. Nothing here
imports JAX.
"""

__version__ = "0.1.0"
