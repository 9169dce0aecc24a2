"""Goldilocks field arithmetic on u64 planes: the counterpart of
``twenty_first_tpu/math/gf64.py``.

The JAX package holds an element as two uint32 limb planes in ``gf.py`` and
as one packed uint64 plane here. The port's carrier, an int64 tensor
holding the u64 bit pattern, is that packed plane already, so ``pack`` and
``unpack`` map between the JAX package's limb planes (uint32 tensors) and
the carrier, and every other function is the carrier form of ``gf.py``
with the JAX module's name. Lazy values are any u64 residues (any x <
2^64 congruent to the value); each lazy form gives the JAX module's
representative bit for bit, and the canonical forms (``canon``, ``mul``,
``add``, ``sub``) take any u64 residues, as there.
"""

from __future__ import annotations

from . import gf
from .b_field_element import P
from .gf import (add_lazy, mul_by_i_lazy, mul_by_pow2_lazy,  # noqa: F401
                 mul_lazy, reduce128_lazy, sub_lazy)


def pack(x):
    """(lo, hi) uint32 limb planes -> the carrier (the packed u64 plane)."""
    return gf.carrier_of(x)


def unpack(v):
    """The carrier -> (lo, hi) uint32 limb planes."""
    return gf.limbs_of(v)


def canon(a):
    """Canonicalize any u64 residue."""
    return gf.canon(a)


def mul_const_lazy(a, k: int):
    """Multiply by a python-int constant (lazy residue out)."""
    return mul_lazy(a, gf.full_like(a, k % P))


def mul(a, b):
    """Canonical product of any u64 residues."""
    return gf.canon(mul_lazy(a, b))


def add(a, b):
    """Canonical sum of any u64 residues."""
    return gf.canon(add_lazy(a, b))


def sub(a, b):
    """Canonical difference of any u64 residues."""
    return gf.canon(sub_lazy(a, b))
