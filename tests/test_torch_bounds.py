"""The multiply count behind the benchmark's Tip5 roofline.

port_bench/roofline.py counts Tip5's MDS layer at the fewest products of
a known algorithm, not at the 16 x 16 products of K1's matvec: the CRT
tower of the Tip5 reference's ``mds_cyclomul``. A cyclic convolution of
length n splits into one of length n/2 (mod x^{n/2} - 1) and a negacyclic
one (mod x^{n/2} + 1); a negacyclic one of length n is a product of
complex polynomials of n/2 terms modulo x^{n/2} - i, done by Karatsuba; a
complex multiply by a fixed factor is three products. Here the tower runs
over the field, counting every product of an input-dependent value by a
constant derived from the MDS column (the constants are made once, so
their own arithmetic is not counted). It must equal the circulant matvec and use
``roofline.MDS_PRODUCTS`` products.
"""

import numpy as np
import pytest

from port_bench import roofline
from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu_torch.tip5.constants import MDS_MATRIX_FIRST_COLUMN

P = (1 << 64) - (1 << 32) + 1
HALF = pow(2, P - 2, P)
COL = [int(c) for c in MDS_MATRIX_FIRST_COLUMN]


class Products:
    """x * c mod p for an input-dependent x and a constant c, counted."""

    def __init__(self):
        self.count = 0

    def __call__(self, x, c):
        self.count += 1
        return x * c % P


def cadd(a, b):
    return (a[0] + b[0]) % P, (a[1] + b[1]) % P


def csub(a, b):
    return (a[0] - b[0]) % P, (a[1] - b[1]) % P


def cmul(mul, a, c):
    """(a0 + i a1)(c0 + i c1) with c constant: three products."""
    k1 = mul(a[0] + a[1], c[0])
    k2 = mul(a[0], (c[1] - c[0]) % P)
    k3 = mul(a[1], (c[0] + c[1]) % P)
    return (k1 - k3) % P, (k1 + k2) % P


def karatsuba(mul, a, c):
    """The full product of complex polynomials of n terms (n a power of
    two): 2n - 1 terms."""
    n = len(a)
    if n == 1:
        return [cmul(mul, a[0], c[0])]
    h = n // 2
    lo = karatsuba(mul, a[:h], c[:h])
    hi = karatsuba(mul, a[h:], c[h:])
    mid = karatsuba(mul, [cadd(x, y) for x, y in zip(a[:h], a[h:])],
                    [cadd(x, y) for x, y in zip(c[:h], c[h:])])
    out = [(0, 0)] * (2 * n - 1)
    for i in range(2 * h - 1):
        out[i] = cadd(out[i], lo[i])
        out[i + n] = cadd(out[i + n], hi[i])
        out[i + h] = cadd(out[i + h], csub(csub(mid[i], lo[i]), hi[i]))
    return out


def negacyclic(mul, a, c):
    """a * c mod x^n + 1 as a complex product mod x^{n/2} - i, where x^{n/2}
    plays i: word j and word n/2 + j form one complex coefficient."""
    n = len(a)
    if n == 1:
        return [mul(a[0], c[0])]
    h = n // 2
    prod = karatsuba(mul, list(zip(a[:h], a[h:])), list(zip(c[:h], c[h:])))
    out = prod[:h]
    for k in range(h, 2 * h - 1):  # x^h = i: i * (re + i im) = -im + i re
        out[k - h] = cadd(out[k - h], ((-prod[k][1]) % P, prod[k][0]))
    return [re for re, _ in out] + [im for _, im in out]


def cyclic(mul, a, c):
    """a * c mod x^n - 1 by the CRT split; the 1/2 of the recombination
    goes into the constants."""
    n = len(a)
    if n == 1:
        return [mul(a[0], c[0])]
    h = n // 2
    plus = cyclic(mul, [(x + y) % P for x, y in zip(a[:h], a[h:])],
                  [(x + y) * HALF % P for x, y in zip(c[:h], c[h:])])
    minus = negacyclic(mul, [(x - y) % P for x, y in zip(a[:h], a[h:])],
                       [(x - y) * HALF % P for x, y in zip(c[:h], c[h:])])
    return ([(p + m) % P for p, m in zip(plus, minus)]
            + [(p - m) % P for p, m in zip(plus, minus)])


def matvec(state):
    return [sum(COL[(i - j) % 16] * state[j] for j in range(16)) % P
            for i in range(16)]


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_tower_is_a_cyclic_convolution(n):
    rng = np.random.default_rng(n)
    a = [int(v) for v in rng.integers(0, P, n, dtype=np.uint64)]
    c = [int(v) for v in rng.integers(0, P, n, dtype=np.uint64)]
    want = [0] * n
    for i in range(n):
        for j in range(n):
            want[(i + j) % n] = (want[(i + j) % n] + a[i] * c[j]) % P
    assert cyclic(Products(), a, c) == want


def test_mds_products():
    """The tower gives the MDS layer with roofline.MDS_PRODUCTS products;
    one Tip5 permutation then costs roofline.IMAD_PER_PERM IMAD: x^7 on 12
    words in each of 5 rounds (two squares, two products) and two of the
    tower's convolutions a round."""
    rng = np.random.default_rng(41)
    for _ in range(4):
        state = [int(v) for v in rng.integers(0, P, 16, dtype=np.uint64)]
        mul = Products()
        assert cyclic(mul, state, COL) == matvec(state)
        assert mul.count == roofline.MDS_PRODUCTS == 41
    assert roofline.IMAD_PER_PERM == 5 * (12 * 14 + 2 * 41) == 1250
    assert roofline.POW7_IMAD_PER_PERM == 840
    assert roofline.MDS_IMAD_PER_PERM == 410


class Tracked:
    """A field value that counts the additions and subtractions made on
    input-dependent values (shared counter ``adds``)."""

    def __init__(self, v, adds):
        self.v, self.adds = v % P, adds

    def _other(self, o):
        return o.v if isinstance(o, Tracked) else o

    def __add__(self, o):
        if not (isinstance(o, int) and o == 0):  # a copy into a zero slot
            self.adds[0] += 1
        return Tracked(self.v + self._other(o), self.adds)

    __radd__ = __add__

    def __sub__(self, o):
        self.adds[0] += 1
        return Tracked(self.v - self._other(o), self.adds)

    def __rsub__(self, o):
        self.adds[0] += 1
        return Tracked(self._other(o) - self.v, self.adds)

    def __neg__(self):
        return Tracked(-self.v, self.adds)

    def __mul__(self, c):
        return Tracked(self.v * self._other(c), self.adds)

    def __mod__(self, m):
        return self

    def __eq__(self, o):
        return self.v == self._other(o)


#: additions and subtractions of input-dependent values in one 16-point
#: convolution of the tower (PERF.md counts the MDS candidates with it)
MDS_TOWER_ADDS = 151


def test_mds_tower_additions():
    """The tower's other cost: its additions, each of a value wider than
    32 bits (two SASS instructions or more as 64-bit integers)."""
    adds = [0]
    state = [Tracked(v, adds) for v in range(1, 17)]
    got = cyclic(Products(), state, COL)
    assert [g.v for g in got] == matvec(list(range(1, 17)))
    assert adds[0] == MDS_TOWER_ADDS
