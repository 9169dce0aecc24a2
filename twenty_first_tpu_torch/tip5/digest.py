"""Digest: the result of Tip5 hashing — five base-field elements.

A copy of ``twenty_first_tpu/tip5/digest.py`` (importing that package
would import JAX), held against it by ``tests/test_torch_tip5_object.py``.
Mirrors twenty-first/src/tip5/digest.rs: ordering is reversed-limb
lexicographic (:37-45), byte/hex forms are the 40 little-endian bytes of the
canonical values (:144-175, :237-246), big-integer form is base-p (:177-211).
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from ..errors import TryFromDigestError, TryFromHexDigestError
from ..math.b_field_element import BFieldElement, bfe, P


class Digest:
    """Five base-field elements, held as their canonical values (python
    ints): a proof holds hundreds of Digests, and ints cost neither an
    object each nor the garbage collector's attention."""

    __slots__ = ("_words",)

    LEN = 5
    BYTES = 5 * 8

    def __init__(self, values: Iterable):
        words = tuple(bfe(v).value() for v in values)
        if len(words) != Digest.LEN:
            raise TryFromDigestError(f"digest needs {Digest.LEN} elements")
        self._words = words

    # -- constructors -------------------------------------------------------

    @classmethod
    def new(cls, values) -> "Digest":
        return cls(values)

    @classmethod
    def all_zero(cls) -> "Digest":
        return cls((0, 0, 0, 0, 0))

    @classmethod
    def from_bytes(cls, data: bytes) -> "Digest":
        if len(data) != cls.BYTES:
            raise TryFromDigestError(f"need {cls.BYTES} bytes, got {len(data)}")
        vals = []
        for i in range(cls.LEN):
            v = int.from_bytes(data[8 * i: 8 * i + 8], "little")
            if not BFieldElement.is_canonical(v):
                raise TryFromDigestError(f"non-canonical element {v}")
            vals.append(v)
        return cls(vals)

    @classmethod
    def try_from_hex(cls, data: str) -> "Digest":
        try:
            raw = bytes.fromhex(data)
        except ValueError as e:
            raise TryFromHexDigestError(str(e)) from e
        return cls.from_bytes(raw)

    @classmethod
    def from_str(cls, s: str) -> "Digest":
        """Parse the "a,b,c,d,e" form (digest.rs:105-118)."""
        parts = s.split(",")
        if len(parts) != cls.LEN:
            raise TryFromDigestError(f"need {cls.LEN} comma-separated values")
        vals = []
        for p in parts:
            try:
                vals.append(BFieldElement.from_str(p))
            except Exception as e:
                raise TryFromDigestError(str(e)) from e
        return cls(vals)

    @classmethod
    def from_biguint(cls, value: int) -> "Digest":
        remaining = int(value)
        if remaining < 0:
            raise TryFromDigestError("negative value")
        vals = []
        for _ in range(cls.LEN):
            vals.append(remaining % P)
            remaining //= P
        if remaining:
            raise TryFromDigestError("overflow")
        return cls(vals)

    @classmethod
    def from_array(cls, arr) -> "Digest":
        return cls(int(v) for v in np.asarray(arr, dtype=np.uint64))

    @classmethod
    def _of_canonical(cls, words) -> "Digest":
        """Five canonical values (python ints) as a Digest, without the
        checks of ``__init__``: for words the port's own kernels wrote."""
        digest = cls.__new__(cls)
        digest._words = tuple(words)
        return digest

    # -- accessors ----------------------------------------------------------

    def values(self) -> tuple:
        return tuple(map(BFieldElement, self._words))

    def to_array(self) -> np.ndarray:
        return np.array(self._words, dtype=np.uint64)

    def to_bytes(self) -> bytes:
        return b"".join(v.to_bytes(8, "little") for v in self._words)

    def to_hex(self) -> str:
        return self.to_bytes().hex()

    def to_biguint(self) -> int:
        acc = 0
        for v in reversed(self._words):
            acc = acc * P + v
        return acc

    def hash(self) -> "Digest":
        """Tip5::hash_pair(self, ALL_ZERO) (digest.rs:226-228)."""
        from .tip5 import Tip5

        return Tip5.hash_pair(self, Digest.all_zero())

    def reversed(self) -> "Digest":
        """Digest with its elements in reverse order — an involutive
        endomorphism (digest.rs:67-70)."""
        return Digest(list(reversed(self._words)))

    # -- comparisons --------------------------------------------------------

    def _ord_key(self):
        return tuple(reversed(self._words))

    def __eq__(self, other):
        return isinstance(other, Digest) and self._words == other._words

    def __hash__(self):  # a BFieldElement hashes as its value
        return hash(self._words)

    def __lt__(self, other):
        return self._ord_key() < other._ord_key()

    def __le__(self, other):
        return self._ord_key() <= other._ord_key()

    def __gt__(self, other):
        return self._ord_key() > other._ord_key()

    def __ge__(self, other):
        return self._ord_key() >= other._ord_key()

    def __repr__(self):
        return f"Digest({', '.join(map(str, self._words))})"

    def __str__(self):
        return ",".join(map(str, self._words))

    def __iter__(self):
        return iter(self.values())


class DigestCorruptor:
    """Test helper for negative-path testing (digest.rs:300-324): corrupt a
    digest at chosen element indices by adding chosen deltas (which must not
    all be zero)."""

    def __init__(self, indices: list[int], deltas: list):
        if len(indices) != len(deltas):
            raise ValueError("indices and deltas must have equal length")
        if all(bfe(d).is_zero() for d in deltas):
            raise ValueError("corruption must corrupt")
        self.indices = list(indices)
        self.deltas = [bfe(d) for d in deltas]

    def corrupt(self, digest: Digest) -> Digest:
        values = list(digest.values())
        for i, d in zip(self.indices, self.deltas):
            values[i] = values[i] + d
        return Digest(values)

    def corrupt_digest(self, digest: Digest) -> Digest:
        """Reference-style corruption (digest.rs:312-322): REPLACE the
        elements at the chosen indices; reject corruption that does not
        change the digest."""
        values = list(digest.values())
        for i, d in zip(self.indices, self.deltas):
            values[i] = d
        corrupted = Digest(values)
        if corrupted == digest:
            raise ValueError("corruption must change digest")
        return corrupted
