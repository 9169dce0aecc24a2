"""Lazy field-element sequences backed by canonical uint64 arrays.

A copy of ``twenty_first_tpu/math/field_list.py`` (importing that package
would import JAX) over the port's scalar elements;
``tests/test_torch_polynomial.py`` holds it against the JAX package's. The
times below are the JAX package's, measured on its host.

The batch-first kernels produce whole numpy arrays; the reference-parity
APIs return lists of scalar field elements. Materializing 2^16
`BFieldElement` objects costs more than the transform that produced them
(measured: 33 ms of object construction vs a 7 ms NTT), so list-returning
APIs hand out this lazy Sequence instead: elements are built on access,
wholesale consumers (anything funneling through `_to_field_array`) read
the backing array directly, and equality against plain lists compares
values without materializing.

Semantically a read-only `list` of BFieldElement / XFieldElement; index,
slice, iterate, compare, and concatenate like a list.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np

from .b_field_element import BFieldElement
from .x_field_element import XFieldElement


def _make_bfe(v: int) -> BFieldElement:
    o = BFieldElement.__new__(BFieldElement)
    o._v = v
    return o


def _make_xfe(r) -> XFieldElement:
    c0 = BFieldElement.__new__(BFieldElement)
    c0._v = r[0]
    c1 = BFieldElement.__new__(BFieldElement)
    c1._v = r[1]
    c2 = BFieldElement.__new__(BFieldElement)
    c2._v = r[2]
    o = XFieldElement.__new__(XFieldElement)
    o.coefficients = (c0, c1, c2)
    return o


class FieldElements(Sequence):
    """Read-only sequence of field elements over a (n,) or (n, 3) canonical
    uint64 array. `is_extension` selects BFieldElement vs XFieldElement."""

    __slots__ = ("_arr", "_x")

    def __init__(self, arr: np.ndarray, is_extension: bool):
        arr = np.asarray(arr, dtype=np.uint64)
        assert arr.ndim == (2 if is_extension else 1)
        self._arr = arr
        self._x = bool(is_extension)

    # -- array access (wholesale consumers) ---------------------------------

    @property
    def is_extension(self) -> bool:
        return self._x

    def to_array(self) -> np.ndarray:
        """The backing canonical array ((n,) or (n, 3)); treat as read-only."""
        return self._arr

    # -- sequence protocol ----------------------------------------------------

    def __len__(self) -> int:
        return self._arr.shape[0]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return FieldElements(self._arr[i], self._x)
        row = self._arr[i]
        if self._x:
            return _make_xfe([int(row[0]), int(row[1]), int(row[2])])
        return _make_bfe(int(row))

    def __iter__(self):
        make = _make_xfe if self._x else _make_bfe
        for v in self._arr.tolist():
            yield make(v)

    def __reversed__(self):
        make = _make_xfe if self._x else _make_bfe
        for v in self._arr[::-1].tolist():
            yield make(v)

    # -- comparison / composition ---------------------------------------------

    def __eq__(self, other) -> bool:
        if isinstance(other, FieldElements):
            return self._x == other._x and np.array_equal(self._arr,
                                                          other._arr)
        if isinstance(other, (list, tuple)):
            if len(other) != len(self):
                return False
            return all(a == b for a, b in zip(self, other))
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    __hash__ = None  # mutable-ish container semantics, like list

    def __add__(self, other):
        if isinstance(other, FieldElements) and other._x == self._x:
            return FieldElements(
                np.concatenate([self._arr, other._arr]), self._x)
        return list(self) + list(other)

    def __radd__(self, other):
        return list(other) + list(self)

    def __repr__(self) -> str:
        kind = "XFieldElement" if self._x else "BFieldElement"
        n = len(self)
        if n <= 8:
            return f"FieldElements([{', '.join(str(e) for e in self)}])"
        head = ", ".join(str(self[i]) for i in range(3))
        return f"FieldElements(<{n} {kind}>, [{head}, ...])"

    def to_list(self) -> list:
        """Materialize a plain list of scalar objects."""
        return list(self)
