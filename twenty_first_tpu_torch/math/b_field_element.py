"""The Goldilocks field's constants and its scalar element (host side).

Copied from ``twenty_first_tpu/math/b_field_element.py`` (importing that
package would import JAX); ``tests/test_torch_gf.py`` asserts every
constant equals the JAX package's, ``tests/test_torch_field_elements.py``
holds ``BFieldElement`` against the JAX class.

``BFieldElement`` is the user-facing scalar type, a canonical residue mod
p = 2^64 - 2^32 + 1 backed by a python int, for scalar logic, index math
and tests (twenty-first/src/math/b_field_element.rs, without Montgomery
form). Batch work belongs on a device, on the int64 carrier of
``math/gf.py``.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from ..errors import ParseBFieldElementError

P = 0xFFFF_FFFF_0000_0001
MAX = P - 1
GENERATOR = 7  # multiplicative generator of the field
R = (1 << 64) % P  # Montgomery radix residue, used only by Tip5's S-box
R_INV = pow(1 << 64, -1, P)

# 2^k-th primitive roots of unity for k = 0..32: the NTT domains of the field.
PRIMITIVE_ROOTS: dict[int, int] = {
    0: 1,
    1: 1,
    2: 18446744069414584320,
    4: 281474976710656,
    8: 18446744069397807105,
    16: 17293822564807737345,
    32: 70368744161280,
    64: 549755813888,
    128: 17870292113338400769,
    256: 13797081185216407910,
    512: 1803076106186727246,
    1024: 11353340290879379826,
    2048: 455906449640507599,
    4096: 17492915097719143606,
    8192: 1532612707718625687,
    16384: 16207902636198568418,
    32768: 17776499369601055404,
    65536: 6115771955107415310,
    131072: 12380578893860276750,
    262144: 9306717745644682924,
    524288: 18146160046829613826,
    1048576: 3511170319078647661,
    2097152: 17654865857378133588,
    4194304: 5416168637041100469,
    8388608: 16905767614792059275,
    16777216: 9713644485405565297,
    33554432: 5456943929260765144,
    67108864: 17096174751763063430,
    134217728: 1213594585890690845,
    268435456: 6414415596519834757,
    536870912: 16116352524544190054,
    1073741824: 9123114210336311365,
    2147483648: 4614640910117430873,
    4294967296: 1753635133440165772,
}


class BFieldElement:
    """An element of the Goldilocks prime field, canonical value in [0, p)."""

    __slots__ = ("_v",)

    P = P
    MAX = MAX
    BYTES = 8
    # -2^-1 mod p (b_field_element.rs:232)
    MINUS_TWO_INVERSE_VALUE = 0x7FFF_FFFF_8000_0000

    def __init__(self, value: int):
        # Like the reference's `new`, accepts any u64-ish integer and reduces.
        self._v = int(value) % P

    # -- constructors -------------------------------------------------------

    @classmethod
    def new(cls, value: int) -> "BFieldElement":
        return cls(value)

    @classmethod
    def try_new(cls, value: int) -> "BFieldElement":
        if not cls.is_canonical(value):
            raise ParseBFieldElementError(f"non-canonical value {value}")
        return cls(value)

    @classmethod
    def from_int(cls, value: int) -> "BFieldElement":
        """Signed conversion: negative ints wrap mod p (bfe!(-1) == p - 1)."""
        return cls(int(value) % P)

    @staticmethod
    def is_canonical(value: int) -> bool:
        return 0 <= int(value) < P

    @classmethod
    def zero(cls) -> "BFieldElement":
        return cls(0)

    @classmethod
    def one(cls) -> "BFieldElement":
        return cls(1)

    @classmethod
    def generator(cls) -> "BFieldElement":
        """A generator of the multiplicative group (== 7)."""
        return cls(7)

    @classmethod
    def minus_two_inverse(cls) -> "BFieldElement":
        return cls(cls.MINUS_TWO_INVERSE_VALUE)

    @classmethod
    def primitive_root_of_unity(cls, n: int) -> "BFieldElement | None":
        root = PRIMITIVE_ROOTS.get(int(n))
        return None if root is None else cls(root)

    # -- accessors ----------------------------------------------------------

    def value(self) -> int:
        return self._v

    def lift(self):
        from .x_field_element import XFieldElement

        return XFieldElement((self, BFieldElement(0), BFieldElement(0)))

    # Montgomery raw views; the Tip5 S-box is *specified* on these bytes
    # (tip5/mod.rs:197-207). raw == value * 2^64 mod p, canonical representative.
    def raw_u64(self) -> int:
        return (self._v * R) % P

    def raw_bytes(self) -> bytes:
        return self.raw_u64().to_bytes(8, "little")

    @classmethod
    def from_raw_u64(cls, raw: int) -> "BFieldElement":
        return cls((int(raw) * R_INV) % P)

    @classmethod
    def from_raw_bytes(cls, raw: bytes) -> "BFieldElement":
        return cls.from_raw_u64(int.from_bytes(raw, "little"))

    def raw_u16s(self) -> list[int]:
        r = self.raw_u64()
        return [(r >> (16 * i)) & 0xFFFF for i in range(4)]

    def raw_u128(self) -> int:
        """Montgomery representative widened (b_field_element.rs:409-411)."""
        return self.raw_u64()

    @classmethod
    def from_raw_u16s(cls, chunks: Iterable[int]) -> "BFieldElement":
        chunks = list(chunks)
        raw = sum((int(c) & 0xFFFF) << (16 * i) for i, c in enumerate(chunks))
        return cls.from_raw_u64(raw)

    # -- arithmetic ---------------------------------------------------------

    def __add__(self, other):
        other = _coerce(other)
        if other is NotImplemented:
            return NotImplemented
        s = self._v + other._v
        return BFieldElement(s - P if s >= P else s)

    __radd__ = __add__

    def __sub__(self, other):
        other = _coerce(other)
        if other is NotImplemented:
            return NotImplemented
        d = self._v - other._v
        return BFieldElement(d + P if d < 0 else d)

    def __rsub__(self, other):
        other = _coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return other - self

    def __mul__(self, other):
        from .x_field_element import XFieldElement

        if isinstance(other, XFieldElement):
            return other * self
        other = _coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return BFieldElement((self._v * other._v) % P)

    __rmul__ = __mul__

    def __neg__(self):
        return BFieldElement(P - self._v if self._v else 0)

    def __truediv__(self, other):
        other = _coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return self * other.inverse()

    def __pow__(self, e: int):
        return self.mod_pow(e)

    def mod_pow(self, e: int) -> "BFieldElement":
        if e < 0:
            return self.inverse().mod_pow(-e)
        return BFieldElement(pow(self._v, int(e), P))

    mod_pow_u32 = mod_pow
    mod_pow_u64 = mod_pow

    def inverse(self) -> "BFieldElement":
        if self._v == 0:
            raise ZeroDivisionError(
                "Attempted to find the multiplicative inverse of zero."
            )
        return BFieldElement(pow(self._v, P - 2, P))

    def inverse_or_zero(self) -> "BFieldElement":
        return BFieldElement(0) if self._v == 0 else self.inverse()

    def square(self) -> "BFieldElement":
        return self * self

    def is_zero(self) -> bool:
        return self._v == 0

    def is_one(self) -> bool:
        return self._v == 1

    def increment(self) -> "BFieldElement":
        return self + BFieldElement(1)

    def decrement(self) -> "BFieldElement":
        return self - BFieldElement(1)

    @staticmethod
    def batch_inversion(elements: list["BFieldElement"]) -> list["BFieldElement"]:
        return _batch_inversion(elements, BFieldElement(0), BFieldElement(1))

    def get_cyclic_group_elements(self, max_elements: int | None = None) -> list:
        """Powers of self until the cycle closes (traits.rs
        CyclicGroupGenerator), optionally capped."""
        elements = [BFieldElement(1)]
        acc = self
        while not acc.is_one() and (
            max_elements is None or len(elements) < max_elements
        ):
            elements.append(acc)
            acc = acc * self
        return elements[:max_elements] if max_elements else elements

    @staticmethod
    def power_accumulator(base: list, tail: list, m: int) -> list:
        """Square each base element M times, then multiply by the tail
        (b_field_element.rs:286-309)."""
        result = list(base)
        for _ in range(m):
            result = [r * r for r in result]
        return [r * t for r, t in zip(result, tail)]

    # -- misc ---------------------------------------------------------------

    def __eq__(self, other):
        other = _coerce(other)
        if other is NotImplemented:
            return NotImplemented
        return self._v == other._v

    def __hash__(self):
        return hash(self._v)

    def __int__(self):
        return self._v

    def __index__(self):
        return self._v

    def __repr__(self):
        return f"BFieldElement({self._v})"

    def __str__(self):
        # Reference Display (b_field_element.rs:429-441): values within 256
        # of p print as negatives, small values plain, the rest zero-padded
        # to 20 digits.
        cutoff = 256
        if self._v >= P - cutoff:
            return f"-{P - self._v}"
        if self._v <= cutoff:
            return str(self._v)
        return f"{self._v:>020}"

    @classmethod
    def from_str(cls, s: str) -> "BFieldElement":
        """Parse a decimal string in the open interval (-p, p)
        (b_field_element.rs:443-458): negatives wrap, values at or beyond
        +/-p are rejected."""
        try:
            parsed = int(str(s).strip())
        except ValueError as e:
            raise ParseBFieldElementError(f"cannot parse {s!r}: {e}") from e
        if parsed <= -P or parsed >= P:
            raise ParseBFieldElementError(f"non-canonical value {parsed}")
        return cls(parsed + P if parsed < 0 else parsed)

    def to_bytes(self) -> bytes:
        return self._v.to_bytes(8, "little")

    @classmethod
    def from_bytes(cls, data: bytes) -> "BFieldElement":
        return cls.try_new(int.from_bytes(data, "little"))


def _coerce(x) -> "BFieldElement":
    if isinstance(x, BFieldElement):
        return x
    if isinstance(x, (int, np.integer)):
        return BFieldElement(int(x) % P)
    return NotImplemented


def _batch_inversion(elements, zero, one):
    """Montgomery batch inversion (traits.rs:93-121), generic over field."""
    n = len(elements)
    if n == 0:
        return []
    scratch = [zero] * n
    acc = one
    for i, e in enumerate(elements):
        if e.is_zero():
            raise ZeroDivisionError("Cannot do batch inversion on zero")
        scratch[i] = acc
        acc = acc * e
    acc = acc.inverse()
    res = list(elements)
    for i in range(n - 1, -1, -1):
        tmp = acc * res[i]
        res[i] = acc * scratch[i]
        acc = tmp
    return res


def bfe(value) -> BFieldElement:
    """Shorthand constructor mirroring the reference's `bfe!` macro."""
    if isinstance(value, BFieldElement):
        return value
    return BFieldElement.from_int(value)


def bfe_vec(values) -> list[BFieldElement]:
    return [bfe(v) for v in values]


def bfe_array(values) -> list[BFieldElement]:
    return [bfe(v) for v in values]
