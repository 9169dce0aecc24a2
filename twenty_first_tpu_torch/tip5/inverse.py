"""The inverse of the Tip5 permutation (tip5/inverse.rs:1-112).

A copy of ``twenty_first_tpu/tip5/inverse.py`` (importing that package
would import JAX), held against it and against the port's permutation by
``tests/test_torch_tip5_inverse.py``.

`InverseTip5.inv_permutation` undoes `Tip5.permutation`; each step undoes
the corresponding forward step. Useful for constructing initial states
that lead to "interesting" internal states before some step — the
reference ships this as a test-support module and we mirror that role.

All inverse constants are *derived* here rather than pinned:

  * INV_LOOKUP_TABLE inverts the offset Fermat cube map byte bijection.
  * INV_POWER_MAP_EXPONENT is 7^-1 mod (p-1) (the reference pins
    10540996611094048183 and checks the Bezout identity,
    inverse.rs:72-75,131-135).
  * INV_MDS_MATRIX_FIRST_COLUMN inverts the circulant MDS matrix in the
    size-16 cyclic NTT domain: M = circ(c) acts as cyclic convolution by
    c, so circ(c)^-1 = circ(d) where the DFT of d is the pointwise field
    inverse of the DFT of c (the reference pins the 16 words,
    inverse.rs:39-56; tests spot-pin ours against two of them).
"""

from __future__ import annotations

from ..math.b_field_element import BFieldElement, bfe, P, R, R_INV
from .constants import (
    LOOKUP_TABLE,
    MDS_MATRIX_FIRST_COLUMN,
    NUM_ROUNDS,
    NUM_SPLIT_AND_LOOKUP,
    ROUND_CONSTANTS,
    STATE_SIZE,
)

# Inverse byte bijection of the offset Fermat cube map.
INV_LOOKUP_TABLE = [0] * 256
for _idx, _looked_up in enumerate(LOOKUP_TABLE.tolist()):
    INV_LOOKUP_TABLE[_looked_up] = _idx

# 7th-root exponent: INV_POWER_MAP_EXPONENT * 7 == 1 (mod p - 1).
INV_POWER_MAP_EXPONENT = pow(7, -1, P - 1)


def _inv_circulant_first_column(col: list[int]) -> list[int]:
    """First column of circ(col)^-1 via the size-16 cyclic NTT.

    circ(col) @ s is the cyclic convolution col * s, so inversion is
    pointwise in the DFT domain over GF(p) (7 generates GF(p)^*, so
    omega = 7^((p-1)/16) has exact order 16)."""
    n = len(col)
    omega = pow(7, (P - 1) // n, P)
    hat = [sum(col[j] * pow(omega, j * k, P) for j in range(n)) % P
           for k in range(n)]
    inv_hat = [pow(h, P - 2, P) for h in hat]
    omega_inv = pow(omega, P - 2, P)
    n_inv = pow(n, P - 2, P)
    return [
        n_inv * sum(inv_hat[k] * pow(omega_inv, j * k, P) for k in range(n))
        % P
        for j in range(n)
    ]


INV_MDS_MATRIX_FIRST_COLUMN = _inv_circulant_first_column(
    [int(c) for c in MDS_MATRIX_FIRST_COLUMN]
)

_RC = [int(c) for c in ROUND_CONSTANTS]


class InverseTip5:
    """Step-by-step inverse of the Tip5 permutation (inverse.rs:58-111)."""

    def __init__(self, state):
        self.state = [bfe(e) for e in state]

    def inv_permutation(self) -> None:
        for i in reversed(range(NUM_ROUNDS)):
            self.inv_round(i)

    def inv_round(self, round_index: int) -> None:
        self.subtract_constants(round_index)
        self.inv_mds_matrix_mul()
        self.inv_sbox_layer()

    def subtract_constants(self, round_index: int) -> None:
        base = round_index * STATE_SIZE
        self.state = [
            bfe((e.value() - _RC[base + i]) % P)
            for i, e in enumerate(self.state)
        ]

    def inv_mds_matrix_mul(self) -> None:
        vals = [e.value() for e in self.state]
        self.state = [
            bfe(
                sum(
                    INV_MDS_MATRIX_FIRST_COLUMN[(i - j) % STATE_SIZE] * vals[j]
                    for j in range(STATE_SIZE)
                )
                % P
            )
            for i in range(STATE_SIZE)
        ]

    def inv_sbox_layer(self) -> None:
        for i in range(NUM_SPLIT_AND_LOOKUP):
            self.state[i] = self._split_and_inv_lookup(self.state[i])
        for i in range(NUM_SPLIT_AND_LOOKUP, STATE_SIZE):
            self.state[i] = bfe(
                pow(self.state[i].value(), INV_POWER_MAP_EXPONENT, P)
            )

    @staticmethod
    def _split_and_inv_lookup(element: BFieldElement) -> BFieldElement:
        m = (element.value() * R) % P
        out = 0
        for byte in range(8):
            out |= INV_LOOKUP_TABLE[(m >> (8 * byte)) & 0xFF] << (8 * byte)
        return bfe((out * R_INV) % P)
