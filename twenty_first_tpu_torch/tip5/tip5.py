"""Scalar Tip5 sponge (host side) and its hash entry points.

The counterpart of ``twenty_first_tpu/tip5/tip5.py``, held against it by
``tests/test_torch_tip5_object.py`` and ``tests/test_torch_bfield_codec.py``.
As in the JAX package, the scalar permutation and ``hash_varlen`` run on
the native host core (the port's loader, ``native.py``) when it is
available; the JAX package's direct-from-spec rounds over canonical field
values (python ints), copied here (byte lookup on the Montgomery bytes,
x^7, the circulant MDS as a plain field matvec, round constants), run
otherwise (``TWENTY_FIRST_TPU_NO_NATIVE``, or no g++) and are the oracle
the tests hold the native path against (``_permute_rounds``).

``hash`` hashes an object's BFieldCodec encoding (``math/bfield_codec.py``)
on the host. Batch-sized work goes to ``tip5/permutation.py`` on
``device``: ``hash_varlen_batch`` and ``hash_batch`` (encodings) hash many
inputs at once (K1 on the card), and the Merkle tree and the MMR build
their trees with K2 (``util_types/merkle_tree.py``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..errors import SpongeError
from ..math.b_field_element import BFieldElement, bfe, P, R, R_INV
from ..math.x_field_element import XFieldElement, EXTENSION_DEGREE
from ..util_types.sponge import Domain, Sponge
from .constants import (
    LOOKUP_TABLE,
    MDS_MATRIX_FIRST_COLUMN,
    NUM_ROUNDS,
    NUM_SPLIT_AND_LOOKUP,
    RATE,
    ROUND_CONSTANTS,
    STATE_SIZE,
)
from .digest import Digest

_LUT = LOOKUP_TABLE.tolist()
_COL = [int(c) for c in MDS_MATRIX_FIRST_COLUMN]
_RC = [int(c) for c in ROUND_CONSTANTS]


def _permute_values(state: list[int]) -> list[int]:
    """The Tip5 permutation on 16 canonical values (python ints): the
    native host core's when it is available, else ``_permute_rounds``."""
    from .. import native

    if native.available():
        out = native.tip5_permute_batch(np.array([state], dtype=np.uint64))
        return [int(v) for v in out[0]]
    return _permute_rounds(state)


def _permute_rounds(state: list[int]) -> list[int]:
    """The permutation by the pure-Python rounds (the oracle)."""
    for r in range(NUM_ROUNDS):
        state = _round_values(state, r)
    return state


class Tip5(Sponge):
    """The Tip5 sponge/permutation with STATE_SIZE=16, RATE=10, 5 rounds."""

    RATE = RATE

    def __init__(self, domain: Domain = Domain.VARIABLE_LENGTH):
        if domain == Domain.FIXED_LENGTH:
            self.state = [bfe(0)] * RATE + [bfe(1)] * (STATE_SIZE - RATE)
        else:
            self.state = [bfe(0)] * STATE_SIZE

    @classmethod
    def new(cls, domain: Domain) -> "Tip5":
        return cls(domain)

    @classmethod
    def init(cls) -> "Tip5":
        return cls(Domain.VARIABLE_LENGTH)

    # -- permutation --------------------------------------------------------

    def permutation(self) -> None:
        values = _permute_values([e.value() for e in self.state])
        self.state = [bfe(v) for v in values]

    def trace(self) -> list[list[BFieldElement]]:
        """Initial state plus the state after each round ((1+5) x 16)."""
        out = [list(self.state)]
        values = [e.value() for e in self.state]
        for r in range(NUM_ROUNDS):
            values = _round_values(values, r)
            out.append([bfe(v) for v in values])
        self.state = out[-1]
        return out

    # -- sponge interface ---------------------------------------------------

    def absorb(self, input_chunk: Sequence) -> None:
        chunk = [bfe(e) for e in input_chunk]
        if len(chunk) != RATE:
            raise SpongeError(f"absorb needs exactly {RATE} elements")
        self.state[:RATE] = chunk
        self.permutation()

    def squeeze(self) -> list[BFieldElement]:
        produce = list(self.state[:RATE])
        self.permutation()
        return produce

    # -- hash APIs ----------------------------------------------------------

    @classmethod
    def hash_10(cls, input_elements: Sequence) -> list[BFieldElement]:
        elements = [bfe(e) for e in input_elements]
        if len(elements) != RATE:
            raise SpongeError(f"hash_10 needs exactly {RATE} elements")
        sponge = cls(Domain.FIXED_LENGTH)
        sponge.state[:RATE] = elements
        sponge.permutation()
        return list(sponge.state[: Digest.LEN])

    @classmethod
    def hash_pair(cls, left: Digest, right: Digest) -> Digest:
        return Digest(cls.hash_10(list(left.values()) + list(right.values())))

    @classmethod
    def hash_varlen(cls, input_elements: Sequence) -> Digest:
        from .. import native

        if native.available():
            vals = np.array([bfe(e).value() for e in input_elements],
                            dtype=np.uint64)
            return Digest.from_array(native.tip5_hash_varlen(vals))
        sponge = cls.init()
        sponge.pad_and_absorb_all(input_elements)
        return Digest(sponge.state[: Digest.LEN])

    @classmethod
    def hash(cls, value) -> Digest:
        """Hash an object via its BFieldCodec encoding (tip5/mod.rs:593-595)."""
        from ..math.bfield_codec import encode

        return cls.hash_varlen(encode(value))

    @classmethod
    def hash_varlen_batch(cls, inputs: Sequence[Sequence], device="cuda",
                          plain: bool = False) -> list[Digest]:
        """Hash many variable-length inputs at once on ``device`` (inputs
        of mixed lengths; see ``permutation.hash_varlen_ragged``: one K1
        launch an absorb step on the card). Equal to ``hash_varlen`` of
        each input."""
        from . import permutation as device_path

        arrs = [
            np.array([bfe(e).value() for e in seq], dtype=np.uint64)
            if not isinstance(seq, np.ndarray) else seq
            for seq in inputs
        ]
        out = device_path.hash_varlen_ragged(arrs, device=device, plain=plain)
        return [Digest.from_array(row) for row in out]

    @classmethod
    def hash_batch(cls, values: Sequence, device="cuda",
                   plain: bool = False) -> list[Digest]:
        """Hash many objects via their BFieldCodec encodings at once on
        ``device`` (``hash_varlen_batch``: K1 on the card). Equal to
        ``hash`` of each object."""
        from ..math.bfield_codec import encode

        return cls.hash_varlen_batch([encode(v) for v in values],
                                     device=device, plain=plain)

    # -- Fiat-Shamir helpers -------------------------------------------------

    def sample_indices(self, upper_bound: int, num_indices: int) -> list[int]:
        """Von-Neumann-rejection uniform u32 samples mod a power of two
        (tip5/mod.rs:636-656): squeezed elements equal to p-1 are rejected."""
        if upper_bound <= 0 or upper_bound & (upper_bound - 1):
            raise SpongeError("upper_bound must be a power of two")
        indices: list[int] = []
        buffer: list[BFieldElement] = []
        while len(indices) < num_indices:
            if not buffer:
                buffer = self.squeeze()
            element = buffer.pop(0)
            if element.value() != BFieldElement.MAX:
                indices.append((element.value() & 0xFFFFFFFF) % upper_bound)
        return indices

    def sample_scalars(self, num_elements: int) -> list[XFieldElement]:
        """Squeeze ceil(3n/RATE) times, group into extension elements
        (tip5/mod.rs:664-674)."""
        needed = num_elements * EXTENSION_DEGREE
        num_squeezes = -(-needed // RATE)
        flat: list[BFieldElement] = []
        for _ in range(num_squeezes):
            flat.extend(self.squeeze())
        return [
            XFieldElement(flat[3 * i: 3 * i + 3]) for i in range(num_elements)
        ]

    # -- python Hasher-like convenience --------------------------------------

    def write(self, data: bytes) -> None:
        """Absorb raw bytes in 8-byte little-endian chunks (tip5/mod.rs:701-721)."""
        elements = []
        for off in range(0, len(data), 8):
            chunk = data[off: off + 8]
            elements.append(bfe(int.from_bytes(chunk.ljust(8, b"\0"), "little")))
        for off in range(0, len(elements), RATE):
            chunk = elements[off: off + RATE]
            chunk.extend([bfe(0)] * (RATE - len(chunk)))
            self.absorb(chunk)

    def finish(self) -> int:
        return self.state[0].value()


def _sbox_values(state: list[int]) -> list[int]:
    """The S-box layer on canonical values: byte LUT on raw Montgomery
    bytes for the first 4 words (tip5/mod.rs:197-207), x^7 for the rest
    (tip5/mod.rs:184-194)."""
    state = list(state)
    for i in range(NUM_SPLIT_AND_LOOKUP):
        m = (state[i] * R) % P
        out = 0
        for byte in range(8):
            out |= _LUT[(m >> (8 * byte)) & 0xFF] << (8 * byte)
        state[i] = (out * R_INV) % P
    for i in range(NUM_SPLIT_AND_LOOKUP, STATE_SIZE):
        state[i] = pow(state[i], 7, P)
    return state


def _round_values(state: list[int], r: int) -> list[int]:
    """One round on canonical values."""
    state = _sbox_values(state)
    state = [
        sum(_COL[(i - j) % STATE_SIZE] * state[j] for j in range(STATE_SIZE)) % P
        for i in range(STATE_SIZE)
    ]
    base = r * STATE_SIZE
    return [(state[i] + _RC[base + i]) % P for i in range(STATE_SIZE)]


def hash_varlen_array(values: np.ndarray, device="cuda",
                      plain: bool = False) -> Digest:
    """Hash of a host uint64 array through the batch path on ``device``."""
    from . import permutation as device_path

    out = device_path.hash_varlen(np.asarray(values, dtype=np.uint64),
                                  device=device, plain=plain)
    return Digest.from_array(out)
