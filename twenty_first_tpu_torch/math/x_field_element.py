"""Scalar cubic-extension field element F_p[x]/(x^3 - x + 1) (host side).

A copy of ``twenty_first_tpu/math/x_field_element.py`` (importing that
package would import JAX), held against it by
``tests/test_torch_field_elements.py`` and, for ``shah_polynomial`` and
``from_polynomial``, ``tests/test_torch_polynomial.py``.
Mirrors twenty-first/src/math/x_field_element.rs. The product formula is the
reference's explicit reduction mod the "Shah polynomial" x^3 - x + 1
(x_field_element.rs:512-535); the inverse uses the closed-form adjugate of the
multiplication matrix instead of polynomial XGCD — same values, branch-free,
and directly vectorizable on device.
"""

from __future__ import annotations

from typing import Iterable

from .b_field_element import BFieldElement, bfe

EXTENSION_DEGREE = 3


class XFieldElement:
    """Element c0 + c1*x + c2*x^2 of the degree-3 extension."""

    __slots__ = ("coefficients",)

    def __init__(self, coefficients: Iterable):
        coeffs = tuple(bfe(c) for c in coefficients)
        if len(coeffs) != EXTENSION_DEGREE:
            raise ValueError("XFieldElement needs exactly 3 coefficients")
        self.coefficients = coeffs

    # -- constructors -------------------------------------------------------

    @classmethod
    def new(cls, coefficients) -> "XFieldElement":
        return cls(coefficients)

    @classmethod
    def new_const(cls, element) -> "XFieldElement":
        return cls((bfe(element), BFieldElement(0), BFieldElement(0)))

    @classmethod
    def zero(cls) -> "XFieldElement":
        return cls((0, 0, 0))

    @classmethod
    def one(cls) -> "XFieldElement":
        return cls((1, 0, 0))

    @classmethod
    def primitive_root_of_unity(cls, n: int) -> "XFieldElement | None":
        root = BFieldElement.primitive_root_of_unity(n)
        return None if root is None else cls.new_const(root)

    @staticmethod
    def shah_polynomial():
        """The defining modulus x^3 - x + 1 as a base-field Polynomial."""
        from .polynomial import Polynomial

        return Polynomial([bfe(1), bfe(-1), bfe(0), bfe(1)])

    # -- accessors ----------------------------------------------------------

    def to_digest(self):
        """Interpret as a Digest by padding two zeros (x_field_element.rs:270-292)."""
        from ..tip5.digest import Digest

        c0, c1, c2 = self.coefficients
        return Digest((c0, c1, c2, BFieldElement(0), BFieldElement(0)))

    @classmethod
    def try_from_digest(cls, digest) -> "XFieldElement":
        """Inverse of to_digest; requires the two padding zeros."""
        from ..errors import TryFromXFieldElementError

        values = list(digest.values())
        if not values[3].is_zero() or not values[4].is_zero():
            raise TryFromXFieldElementError(
                "digest is not a padded extension-field element"
            )
        return cls(values[:3])

    @classmethod
    def from_polynomial(cls, poly) -> "XFieldElement":
        """Reduce an arbitrary base-field polynomial mod the Shah polynomial
        (x_field_element.rs From<Polynomial> impl)."""
        reduced = poly % cls.shah_polynomial()
        coeffs = (list(reduced.coefficients)
                  + [BFieldElement(0)] * EXTENSION_DEGREE)
        return cls(coeffs[:EXTENSION_DEGREE])

    def increment(self, index: int) -> None:
        """Add one to coefficient `index`, in place
        (x_field_element.rs incr/decr API)."""
        c = list(self.coefficients)
        c[index] = c[index] + BFieldElement(1)
        self.coefficients = tuple(c)

    def decrement(self, index: int) -> None:
        c = list(self.coefficients)
        c[index] = c[index] - BFieldElement(1)
        self.coefficients = tuple(c)

    def unlift(self) -> BFieldElement | None:
        c0, c1, c2 = self.coefficients
        if c1.is_zero() and c2.is_zero():
            return c0
        return None

    def is_zero(self) -> bool:
        return all(c.is_zero() for c in self.coefficients)

    def is_one(self) -> bool:
        c0, c1, c2 = self.coefficients
        return c0.is_one() and c1.is_zero() and c2.is_zero()

    # -- arithmetic ---------------------------------------------------------

    def __add__(self, other):
        other = _coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return XFieldElement(
            tuple(a + b for a, b in zip(self.coefficients, other.coefficients))
        )

    __radd__ = __add__

    def __sub__(self, other):
        other = _coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return XFieldElement(
            tuple(a - b for a, b in zip(self.coefficients, other.coefficients))
        )

    def __rsub__(self, other):
        other = _coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return other - self

    def __mul__(self, other):
        if isinstance(other, BFieldElement):
            return XFieldElement(tuple(c * other for c in self.coefficients))
        other = _coerce(other)
        if other is NotImplemented:
            return NotImplemented
        # (reference formula, x_field_element.rs:512-535)
        c, b, a = self.coefficients
        f, e, d = other.coefficients
        r0 = c * f - a * e - b * d
        r1 = b * f + c * e - a * d + a * e + b * d
        r2 = a * f + b * e + c * d + a * d
        return XFieldElement((r0, r1, r2))

    def __rmul__(self, other):
        if isinstance(other, BFieldElement):
            return self * other
        return self.__mul__(other)

    def __neg__(self):
        return XFieldElement(tuple(-c for c in self.coefficients))

    def __truediv__(self, other):
        other = _coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return self * other.inverse()

    def inverse(self) -> "XFieldElement":
        if self.is_zero():
            raise ZeroDivisionError(
                "Cannot invert the zero element in the extension field."
            )
        i0, i1, i2, det = _inverse_parts(*self.coefficients)
        det_inv = det.inverse()
        return XFieldElement((i0 * det_inv, i1 * det_inv, i2 * det_inv))

    def inverse_or_zero(self) -> "XFieldElement":
        return XFieldElement.zero() if self.is_zero() else self.inverse()

    def square(self) -> "XFieldElement":
        return self * self

    def mod_pow(self, e: int) -> "XFieldElement":
        if e < 0:
            return self.inverse().mod_pow(-e)
        result = XFieldElement.one()
        base = self
        e = int(e)
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    mod_pow_u32 = mod_pow
    mod_pow_u64 = mod_pow
    __pow__ = mod_pow

    @staticmethod
    def batch_inversion(elements: list["XFieldElement"]) -> list["XFieldElement"]:
        from .b_field_element import _batch_inversion

        return _batch_inversion(elements, XFieldElement.zero(), XFieldElement.one())

    def get_cyclic_group_elements(self, max_elements: int | None = None) -> list:
        elements = [XFieldElement.one()]
        acc = self
        while not acc.is_one() and (
            max_elements is None or len(elements) < max_elements
        ):
            elements.append(acc)
            acc = acc * self
        return elements[:max_elements] if max_elements else elements

    # -- misc ---------------------------------------------------------------

    def __eq__(self, other):
        other = _coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return self.coefficients == other.coefficients

    def __hash__(self):
        return hash(self.coefficients)

    def __repr__(self):
        c = [v.value() for v in self.coefficients]
        return f"XFieldElement({c[0]}, {c[1]}, {c[2]})"

    def __str__(self):
        # Display (x_field_element.rs:438-447): unliftable values print as
        # "{bfe}_xfe", the rest as the full degree-2 polynomial.
        lifted = self.unlift()
        if lifted is not None:
            return f"{lifted}_xfe"
        c0, c1, c2 = self.coefficients
        return f"({c2}·x² + {c1}·x + {c0})"


def _inverse_parts(c0, c1, c2):
    """Adjugate-column and determinant of the multiply-by-u matrix.

    For u = c0 + c1*x + c2*x^2 in F_p[x]/(x^3 - x + 1):
        inv(u) = (i0 + i1*x + i2*x^2) / det
    """
    c, b, a = c0, c1, c2
    ca = c + a
    m00 = ca * ca - b * (b - a)
    m01 = b * ca - a * (b - a)
    m02 = b * b - a * ca
    det = c * m00 + a * m01 - b * m02
    return m00, -m01, m02, det


def _coerce(x):
    if isinstance(x, XFieldElement):
        return x
    if isinstance(x, BFieldElement):
        return XFieldElement.new_const(x)
    if isinstance(x, int):
        return XFieldElement.new_const(BFieldElement.from_int(x))
    return NotImplemented


def as_flat_list(xfes) -> list[BFieldElement]:
    """Flatten extension elements to their base-field coefficients — the
    Python analogue of the reference's zero-copy reinterpretation
    `&[XFieldElement] -> &[BFieldElement]` (x_field_element.rs:236-268),
    used when hashing extension-field data."""
    return [c for x in xfes for c in x.coefficients]


as_flat_slice = as_flat_list  # reference name (x_field_element.rs:236)


def xfe(value) -> XFieldElement:
    """Shorthand constructor mirroring the reference's `xfe!` macro."""
    if isinstance(value, XFieldElement):
        return value
    if isinstance(value, (tuple, list)):
        return XFieldElement(value)
    return XFieldElement.new_const(bfe(value))


def xfe_vec(values) -> list[XFieldElement]:
    return [xfe(v) for v in values]


def xfe_array(values) -> list[XFieldElement]:
    return [xfe(v) for v in values]
