"""twenty_first_tpu_torch — the STARK LDE + Tip5 Merkle commit on PyTorch and CUDA.

The PyTorch counterpart of ``twenty_first_tpu`` (the JAX reference, which
stays beside it unchanged). Field elements travel as int64 tensors holding
the u64 bit pattern of a canonical Goldilocks value, in natural order: that
is the contract at every seam between modules.

Layout, each module named after its counterpart in the JAX package:

* ``math/gf.py``: field arithmetic on the int64 carrier (plain torch);
* ``math/ntt.py``: the natural-order NTT over the last axis (four-step);
* ``tip5/permutation.py``: the Tip5 permutation and hash entry points;
* ``ops/tip5_cuda.py``, ``ops/ntt_cuda.py``: wrappers of the hand-written
  Hopper kernels in ``csrc/`` (Tip5 permutation, multi-level Merkle commit,
  NTT local pass), each beside its plain PyTorch twin;
* ``ops/tip5_commit.py``: the Merkle commit launch plan;
* ``parallel/pipeline.py``: the trace LDE + commit step;
* ``entry.py``: the analogue of ``__graft_entry__.entry``.

A CUDA tensor goes to the kernels (built with nvcc at first use) or raises;
a CPU tensor takes the plain twins. Nothing here imports JAX.
"""

__version__ = "0.1.0"
