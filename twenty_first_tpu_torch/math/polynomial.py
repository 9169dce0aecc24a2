"""Univariate polynomials over the Goldilocks field and its cubic extension.

The port of ``twenty_first_tpu/math/polynomial.py`` (importing that
package would import JAX), with its names, algorithms, cutoffs and values:
the capability surface of twenty-first/src/math/polynomial.rs
(multiply/divide/xgcd/reduce/zerofier/evaluate/interpolate/coset ops/
modular coset interpolation/extrapolation/barycentric evaluation).

Coefficients are numpy uint64 arrays, shape (n,) over the base field and
(n, 3) over the extension, as in the JAX package; that array is the carry
format between the two (``Polynomial.from_array(jax_poly.to_array(),
jax_poly.is_extension)``). Host work is whole-array numpy and the native
host core (``twenty_first_tpu_torch/native.py``). The card takes:

* transforms and convolutions above the crossovers (``ntt.routed_*``:
  ``HOST_NTT_MAX_ELEMS``, ``HOST_CONV_MAX_ELEMS``): K3, and K8 for the
  pointwise products and inverses;
* the zerofier tree's and interpolations' batched row products
  (``_mul_rows``) of more than ``HOST_CONV_MAX_ELEMS`` elements a level:
  one batched convolution, K3 and K8;
* batch inversions of more than ``HOST_INVERSE_MAX_ELEMS`` elements
  (``_finv``): K7, or K8's inverse where an element is 0;
* extrapolations of power-of-two codewords of 2^14 and more (the JAX
  package's gate and its ``TWENTY_FIRST_TPU_EXTRAPOLATE_DEVICE`` knob):
  ``poly_batch.batch_coset_extrapolate(_xfe)``, K3 and K6.

"The card" is ``ntt.DEVICE`` (default "cuda"; the CPU tests set "cpu"),
chosen by size alone: where the JAX package asks ``jax.default_backend()``,
this module never looks for a card, and a machine without one raises where
the card is due.

The host-side cutoffs and their comments are the JAX package's: the times
those comments quote were measured there, on that package's host, and
explain cutoffs the port keeps for the same values; the port's own times
are in PERF.md.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

from ..errors import PolynomialError, PolynomialDivisionError
from . import gf_numpy as gfn
from . import xgf_numpy as xgf
from . import ntt as ntt_mod
from .b_field_element import BFieldElement, bfe, GENERATOR
from .field_list import FieldElements
from .x_field_element import XFieldElement
from .zerofier_tree import RECURSION_CUTOFF_THRESHOLD, ZerofierTree

P = int(gfn.P)

# Benchmark-derived crossover constants (reference polynomial.rs:704-753).
FAST_MULTIPLY_CUTOFF_THRESHOLD = 1 << 8
FAST_SQUARE_CUTOFF_THRESHOLD = 64
FAST_INTERPOLATE_CUTOFF_THRESHOLD_SEQUENTIAL = 1 << 12
FAST_INTERPOLATE_CUTOFF_THRESHOLD_PARALLEL = 1 << 8
FAST_ZEROFIER_CUTOFF_THRESHOLD = 100
# polynomial.rs:724-734
FAST_MODULAR_COSET_INTERPOLATE_CUTOFF_THRESHOLD_PREFER_LAGRANGE = 1 << 8
# The reference crosses from iNTT to the even/odd recursion at 2^17
# (polynomial.rs:731-734) because both branches run compiled there. Here,
# as in the JAX package, the iNTT branch is one transform (on the card
# above the crossover) and the recursion host-orchestrated Python, so the
# JAX package's 2^26 is kept: both branches give the same values, and the
# recursion is tested at small sizes with this threshold lowered
# (tests/test_torch_polynomial_interp.py).
FAST_MODULAR_COSET_INTERPOLATE_CUTOFF_THRESHOLD_PREFER_INTT = 1 << 26
FAST_COSET_EXTRAPOLATE_THRESHOLD = 100
CLEAN_DIVIDE_CUTOFF = 1 << 9
FAST_REDUCE_CUTOFF_THRESHOLD = 1 << 8
# polynomial.rs:1741 (batched interpolation leaf size)
BATCH_INTERPOLATE_CUTOFF = 16


# ---------------------------------------------------------------------------
# array-level field helpers (field selected by the `x` flag: extension?)
# ---------------------------------------------------------------------------


def _native_host_on() -> bool:
    """True when the native C++ host core is loaded and not disabled."""
    if os.environ.get("TWENTY_FIRST_TPU_NATIVE_HOST") == "0":
        return False
    from .. import native as _nat

    return _nat.available()


def _zeros(n: int, x: bool) -> np.ndarray:
    return np.zeros((n, 3) if x else (n,), dtype=np.uint64)


def _one_row(x: bool) -> np.ndarray:
    if x:
        return np.array([1, 0, 0], dtype=np.uint64)
    return np.uint64(1)


def _fmul(a, b, x: bool):
    return xgf.mul(a, b) if x else gfn.mul(a, b)


def _fmul_scalar(arr, s, x: bool):
    """Array times one scalar row (s: () or (3,))."""
    if x:
        return xgf.mul(arr, np.broadcast_to(s, arr.shape))
    return gfn.mul(arr, s)


# Above this many elements a batch inversion goes to ntt.DEVICE (K7): the
# card's round trip beats the native Montgomery inversion from 2^13
# elements on an H100's host (the crossover sweep of
# probes/polynomial_probe.py; its reading is in PERF.md section 6, with
# the port's bring-up).
HOST_INVERSE_MAX_ELEMS = 1 << 12


def _finv_device(arr: np.ndarray, x: bool) -> np.ndarray:
    """Elementwise inverse-or-zero on ntt.DEVICE: K7's batch inversion when
    no element is 0 (a 0 would zero its whole row there), else K8's
    inverse."""
    from . import gf, gf_ext

    nonzero = bool(arr.any(axis=-1).all()) if x else bool(np.all(arr != 0))
    if x:
        t = gf_ext.from_u64(arr).to(ntt_mod.DEVICE)
        inv = (gf_ext.batch_inversion(t) if nonzero
               else gf_ext.inverse_or_zero(t))
        return gf_ext.to_u64(inv)
    t = gf.from_u64(arr).to(ntt_mod.DEVICE)
    return gf.to_u64(gf.batch_inversion(t) if nonzero
                     else gf.inverse_or_zero(t))


def _finv(arr, x: bool):
    if arr.size > HOST_INVERSE_MAX_ELEMS:
        return _finv_device(arr, x)
    if x:
        return xgf.inverse(arr)
    from .. import native

    if native.available() and arr.size and bool(np.all(arr != 0)):
        # native Montgomery batch inversion: 3n muls + one scalar inverse,
        # vs the 72-vectorized-mul addition chain — wins on the host for
        # everything but huge arrays. (Zero entries fall through to the
        # chain, which maps 0 -> 0.)
        return native.batch_inverse(np.ascontiguousarray(arr))
    return gfn.inverse(arr)


def _fsum(arr: np.ndarray, x: bool):
    """Field sum along axis 0 (pairwise fold, vectorized)."""
    n = arr.shape[0]
    if n == 0:
        return _zeros(1, x)[0]
    while n > 1:
        half = n // 2
        head = gfn.add(arr[:half], arr[half: 2 * half])
        arr = np.concatenate([head, arr[2 * half: n]], axis=0) \
            if n % 2 else head
        n = arr.shape[0]
    return arr[0]


def _antidiag_sum(table: np.ndarray, x: bool) -> np.ndarray:
    """Modular sum of the anti-diagonals of an (la, lb[, 3]) product table:
    R[k] = sum_i table[i, k-i] — the convolution combine step.

    Rows are aligned by an overlapping strided view (row stride L-1 over a
    zero-padded (la, L) buffer shifts row i right by i), so the whole
    combine is one pairwise _fsum fold of vectorized adds instead of one
    numpy call per row."""
    out = _batch_antidiag_sum(table[None], x)
    return out[0]


def _batch_antidiag_sum(table: np.ndarray, x: bool) -> np.ndarray:
    """Batched anti-diagonal sum: (m, la, lb[, 3]) -> (m, la+lb-1[, 3])."""
    m, la, lb = table.shape[0], table.shape[1], table.shape[2]
    w = la + lb - 1
    L = la + lb  # padded row length; stride L-1 aligns the diagonals
    if x:
        c = np.zeros((m, la, L, 3), dtype=np.uint64)
        c[:, :, :lb] = table
        flat = c.reshape(-1)
        it = flat.strides[0]
        v = np.lib.stride_tricks.as_strided(
            flat, shape=(m, la, w, 3),
            strides=(la * L * 3 * it, (L - 1) * 3 * it, 3 * it, it))
    else:
        c = np.zeros((m, la, L), dtype=np.uint64)
        c[:, :, :lb] = table
        flat = c.reshape(-1)
        it = flat.strides[0]
        v = np.lib.stride_tricks.as_strided(
            flat, shape=(m, la, w),
            strides=(la * L * it, (L - 1) * it, it))
    # reads with k < i land in the zero padding of the previous row:
    # flat[i*(L-1)+k] = c[i-1, L-i+k] and L-i+k >= lb for all k >= 0;
    # row la-1's largest index (la-1)(L-1)+w-1 = (la-1)L + lb - 1 stays
    # inside the m-block.
    # pairwise fold over the row axis (axis 1), vectorized across batches
    n = la
    while n > 1:
        half = n // 2
        head = gfn.add(v[:, :half], v[:, half: 2 * half])
        v = np.concatenate([head, v[:, 2 * half: n]], axis=1) \
            if n % 2 else head
        n = v.shape[1]
    return v[:, 0]


def _batch_rows_multiply(a: np.ndarray, b: np.ndarray, x: bool) -> np.ndarray:
    """Batched small-polynomial products: (m, la[, 3]) x (m, lb[, 3]) ->
    (m, la+lb-1[, 3]) via one outer product + anti-diagonal fold."""
    if x:
        table = xgf.mul(a[:, :, None, :], b[:, None, :, :])
    else:
        table = gfn.mul(a[:, :, None], b[:, None, :])
    return _batch_antidiag_sum(table, x)


def _lift3(arr: np.ndarray) -> np.ndarray:
    """(n,) base-field -> (n, 3) extension with zero high components."""
    out = np.zeros(arr.shape + (3,), dtype=np.uint64)
    out[..., 0] = arr
    return out


def _scalar_value(e) -> np.ndarray:
    """Field element / int -> scalar array (() base or (3,) ext)."""
    if isinstance(e, XFieldElement):
        return np.array([c.value() for c in e.coefficients], dtype=np.uint64)
    if isinstance(e, BFieldElement):
        return np.uint64(e.value())
    return np.uint64(int(e) % P)


def _is_x_scalar(s: np.ndarray) -> bool:
    return s.ndim == 1


def _obj(row, x: bool):
    if x:
        return XFieldElement((int(row[0]), int(row[1]), int(row[2])))
    return BFieldElement(int(row))


def _objs_from_array(arr: np.ndarray, x: bool) -> FieldElements:
    """Scalar field elements over a canonical uint64 array — returned as the
    lazy FieldElements sequence: materializing 2^16 BFieldElement objects
    measured 33-85 ms (the NTT producing them is 7 ms), and wholesale
    consumers re-enter `_to_field_array` which reads the backing array."""
    return FieldElements(arr, x)


def _to_field_array(seq) -> tuple[np.ndarray, bool]:
    """Sequence of field elements / ints (or ndarray) -> (arr, is_extension)."""
    if isinstance(seq, FieldElements):
        return seq.to_array(), seq.is_extension
    if isinstance(seq, np.ndarray):
        if seq.ndim == 2 and seq.shape[-1] == 3:
            return seq.astype(np.uint64, copy=False), True
        return seq.astype(np.uint64, copy=False), False
    seq = list(seq)
    if not seq:
        return np.zeros(0, dtype=np.uint64), False
    if any(isinstance(e, XFieldElement) for e in seq):
        rows = []
        for e in seq:
            if isinstance(e, XFieldElement):
                rows.append([c.value() for c in e.coefficients])
            elif isinstance(e, BFieldElement):
                rows.append([e.value(), 0, 0])
            else:
                rows.append([int(e) % P, 0, 0])
        return np.array(rows, dtype=np.uint64), True
    vals = [e.value() if isinstance(e, BFieldElement) else int(e) % P
            for e in seq]
    return np.array(vals, dtype=np.uint64), False


def _promote(a: "Polynomial", b: "Polynomial"):
    """Common-field coefficient arrays for a binary operation."""
    if a._x == b._x:
        return a._c, b._c, a._x
    if a._x:
        return a._c, _lift3(b._c), True
    return _lift3(a._c), b._c, True


def _trimmed_len(arr: np.ndarray) -> int:
    """Number of coefficients up to and including the leading nonzero."""
    if arr.shape[0] == 0:
        return 0
    nz = arr.any(axis=-1) if arr.ndim == 2 else arr != 0
    idx = np.flatnonzero(nz)
    return 0 if idx.size == 0 else int(idx[-1]) + 1


def _powers_arr(s: np.ndarray, n: int, x: bool) -> np.ndarray:
    """[1, s, s^2, ..., s^(n-1)] for a scalar s; (n,) or (n, 3)."""
    if not x:
        return gfn.powers(int(s), n)
    out = _zeros(n, True)
    if n == 0:
        return out
    out[0, 0] = 1
    filled = 1
    # maintain step = s^filled by squaring (filled only ever doubles until
    # the final partial block) instead of recomputing s^filled from scratch
    # per level — the from-scratch _scalar_pow chain was ~120 ms across one
    # clean_divide's three scale() calls.
    step = tuple(int(v) for v in np.asarray(s, dtype=np.uint64).reshape(3))
    while filled < n:
        take = min(filled, n - filled)
        # materialize the broadcast so the product is a same-shape pair
        # (native one-pass path); a (take,3)x(1,3) broadcast product falls
        # back to ~13 python-dispatched numpy passes per component
        step_rows = np.ascontiguousarray(np.broadcast_to(
            np.array(step, dtype=np.uint64), (take, 3)))
        out[filled: filled + take] = xgf.mul(out[:take], step_rows)
        filled += take
        if filled < n:
            # python-int squaring: a (3,)-shaped xgf.mul costs ~9 numpy
            # array ops (~80 us); the int formula is ~2 us
            step = _xfe_mul_ints(step, step)
    return out


def _xfe_mul_ints(a: tuple, b: tuple) -> tuple:
    """Scalar extension-field product on python ints
    (x_field_element.rs:512-535 formula, mod x^3 - x + 1)."""
    s0, s1, s2 = a
    o0, o1, o2 = b
    r0 = (s0 * o0 - s2 * o1 - s1 * o2) % P
    r1 = (s1 * o0 + s0 * o1 + s2 * o1 + (s1 - s2) * o2) % P
    r2 = (s2 * o0 + s1 * o1 + (s0 + s2) * o2) % P
    return (r0, r1, r2)


def _scalar_pow(s: np.ndarray, e: int, x: bool):
    if not x:
        return np.uint64(pow(int(s), int(e), P))
    result = np.array([1, 0, 0], dtype=np.uint64)
    base = s.copy()
    e = int(e)
    while e:
        if e & 1:
            result = xgf.mul(result, base)
        e >>= 1
        if e:
            base = xgf.mul(base, base)
    return result


def _eval_many(coeffs: np.ndarray, cx: bool, points: np.ndarray, px: bool
               ) -> np.ndarray:
    """Evaluate one polynomial at many points, vectorized Horner.

    coeffs: (k,[3]); points: (m,[3]); result in the wider field.
    Above 64 coefficients the Horner runs BLOCKED (chunks of ~sqrt(k)
    evaluated simultaneously, then combined with powers of p^blk):
    ~4*sqrt(k) numpy calls instead of 2k, same values."""
    x = cx or px
    if not x:
        kk = _trimmed_len(coeffs)
        if kk and kk * points.shape[0] >= (1 << 14):
            from .. import native

            if native.available():
                # lane-blocked native Horner: 8 points per vector register,
                # OpenMP across blocks — replaces ~4*sqrt(k) numpy passes
                return native.horner_points(coeffs[:kk], points)
    c = _lift3(coeffs) if (x and not cx) else coeffs
    z = _lift3(points) if (x and not px) else points
    m = z.shape[0]
    k = _trimmed_len(c)
    if k == 0:
        return _zeros(m, x)
    c = c[:k]
    if k <= 64:
        acc = np.broadcast_to(c[k - 1], z.shape).copy()
        for i in range(k - 2, -1, -1):
            acc = gfn.add(_fmul(acc, z, x), np.broadcast_to(c[i], z.shape))
        return acc
    log_blk = (k.bit_length() + 1) // 2
    blk = 1 << log_blk
    nch = -(-k // blk)
    if nch * blk > k:
        c = np.concatenate([c, _zeros(nch * blk - k, x)], axis=0)
    cc = c.reshape((nch, blk, 3) if x else (nch, blk))

    def col(i):
        v = cc[:, i][:, None, :] if x else cc[:, i][:, None]
        return np.broadcast_to(v, acc_shape)

    acc_shape = (nch,) + z.shape
    acc = col(blk - 1).copy()
    zz = z[None]
    for i in range(blk - 2, -1, -1):
        acc = gfn.add(_fmul(acc, zz, x), col(i))
    pc = z
    for _ in range(log_blk):
        pc = _fmul(pc, pc, x)
    res = acc[nch - 1]
    for j in range(nch - 2, -1, -1):
        res = gfn.add(_fmul(res, pc, x), acc[j])
    return res


def _eval_one(coeffs: np.ndarray, cx: bool, point: np.ndarray, px: bool):
    """Evaluate at a single scalar point via powers + dot (O(log n) numpy
    calls instead of an O(n) Python Horner loop)."""
    x = cx or px
    c = _lift3(coeffs) if (x and not cx) else coeffs
    k = _trimmed_len(c)
    if k == 0:
        return _zeros(1, x)[0]
    z = _lift3(point[None])[0] if (x and not px) else point
    pw = _powers_arr(z, k, x)
    return _fsum(_fmul(c[:k], pw, x), x)


def _ntt_mul_arrays(a: np.ndarray, b: np.ndarray, x: bool) -> np.ndarray:
    """Full product of two coefficient arrays via NTT-domain convolution
    (ntt.routed_conv_values: the host round trip up to the crossover, K3
    and K8 on the card above). Matches polynomial.rs:900-932."""
    la, lb = a.shape[0], b.shape[0]
    out_len = la + lb - 1
    n = 1 << max((out_len - 1).bit_length(), 0)
    pa = _zeros(n, x)
    pb = _zeros(n, x)
    pa[:la] = a
    pb[:lb] = b
    return ntt_mod.routed_conv_values(pa, pb, xfield=x)[:out_len]


def _divmod_arrays(num: np.ndarray, den: np.ndarray, x: bool
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Long division on trimmed coefficient arrays -> (quotient, remainder).

    Vectorized inner loop; the base-field path dispatches to the native C++
    core (native/twenty_first_native.cpp gl_poly_divmod) when available."""
    dn, dd = num.shape[0] - 1, den.shape[0] - 1
    if dd < 0:
        raise PolynomialDivisionError("division by zero polynomial")
    if dn < dd:
        return _zeros(0, x), num.copy()
    if not x:
        from .. import native

        if native.available() and dn >= 1:
            q, r = native.poly_divmod(num, den)
            return q.astype(np.uint64), r.astype(np.uint64)
    lc_inv = _finv(den[dd: dd + 1], x)[0]
    rem = num.copy()
    quot = _zeros(dn - dd + 1, x)
    den_body = den[:dd]
    for i in range(dn - dd, -1, -1):
        q = _fmul(rem[i + dd], lc_inv, x)
        quot[i] = q
        if dd:
            rem[i: i + dd] = gfn.sub(
                rem[i: i + dd], _fmul_scalar(den_body, q, x))
    return quot, rem[:dd]


# ---------------------------------------------------------------------------
# Polynomial
# ---------------------------------------------------------------------------


class Polynomial:
    __slots__ = ("_c", "_x")

    def __init__(self, coefficients: Iterable = ()):
        self._c, self._x = _to_field_array(coefficients)

    # -- constructors -------------------------------------------------------

    @classmethod
    def new(cls, coefficients) -> "Polynomial":
        return cls(coefficients)

    # The reference distinguishes owned/borrowed coefficient storage
    # (polynomial.rs:2460-2499); arrays make that moot.
    new_borrowed = new

    @classmethod
    def from_array(cls, arr: np.ndarray, extension: bool = False
                   ) -> "Polynomial":
        """Zero-copy constructor from a uint64 coefficient array
        ((n,) base field, or (n, 3) extension)."""
        p = cls.__new__(cls)
        p._c = np.asarray(arr, dtype=np.uint64)
        p._x = extension or (p._c.ndim == 2)
        return p

    def to_array(self) -> np.ndarray:
        """Trimmed uint64 coefficient array ((n,) or (n, 3))."""
        return self._c[: _trimmed_len(self._c)]

    @property
    def is_extension(self) -> bool:
        return self._x

    @classmethod
    def zero(cls) -> "Polynomial":
        return cls.from_array(np.zeros(0, dtype=np.uint64))

    @classmethod
    def one(cls) -> "Polynomial":
        return cls.from_array(np.ones(1, dtype=np.uint64))

    @classmethod
    def from_constant(cls, c) -> "Polynomial":
        return cls([c])

    @classmethod
    def x_to_the(cls, n: int) -> "Polynomial":
        arr = np.zeros(n + 1, dtype=np.uint64)
        arr[n] = 1
        return cls.from_array(arr)

    # -- basic structure ----------------------------------------------------

    @property
    def coefficients(self) -> list:
        """Coefficients as scalar field-element objects, trailing zeros
        trimmed — accessing the coefficients is equivalent to normalizing
        then raw access (polynomial.rs `coefficients()` contract).
        Internal code uses the arrays directly."""
        return _objs_from_array(self.to_array(), self._x)

    def degree(self) -> int:
        return _trimmed_len(self._c) - 1

    def normalize(self) -> "Polynomial":
        return Polynomial.from_array(self.to_array(), self._x)

    def reverse(self) -> "Polynomial":
        """Coefficient reversal x^deg * f(1/x) on the normalized form
        (polynomial.rs:677-683); the backbone of the formal-power-series
        inverse and structured-multiple machinery."""
        return Polynomial.from_array(self.to_array()[::-1].copy(), self._x)

    def leading_coefficient(self):
        deg = self.degree()
        return None if deg < 0 else _obj(self._c[deg], self._x)

    def is_zero(self) -> bool:
        return self.degree() < 0

    def is_one(self) -> bool:
        return self.degree() == 0 and _trimmed_len(self._c) == 1 and (
            int(self._c[0][0] if self._x else self._c[0]) == 1
        ) and (not self._x or (self._c[0][1] == 0 and self._c[0][2] == 0))

    def is_x(self) -> bool:
        a = self.to_array()
        if a.shape[0] != 2:
            return False
        c0, c1 = a[0], a[1]
        if self._x:
            return (not c0.any()) and c1[0] == 1 and c1[1] == 0 and c1[2] == 0
        return c0 == 0 and c1 == 1

    def _field_zero(self):
        return XFieldElement.zero() if self._x else BFieldElement(0)

    def coefficient(self, i: int):
        if i < self._c.shape[0]:
            return _obj(self._c[i], self._x)
        return self._field_zero()

    def into_coefficients(self) -> list:
        """Normalized (trailing-zero-free) coefficient objects
        (polynomial.rs:211-214; ownership transfer is a no-op here)."""
        return _objs_from_array(self.to_array(), self._x)

    def __eq__(self, other):
        if not isinstance(other, Polynomial):
            return NotImplemented
        a, b, _ = _promote(self, other)
        la, lb = _trimmed_len(a), _trimmed_len(b)
        if la != lb:
            return False
        return np.array_equal(a[:la], b[:lb])

    def __hash__(self):
        deg = self.degree()
        return hash(tuple(_objs_from_array(self._c[: deg + 1], self._x)))

    def __repr__(self):
        return f"Polynomial({_objs_from_array(self.to_array(), self._x)})"

    def __str__(self):
        deg = self.degree()
        if deg < 0:
            return "0"
        terms = []
        for i in range(deg, -1, -1):
            c = _obj(self._c[i], self._x)
            if c.is_zero():
                continue
            if i == 0:
                terms.append(f"{c}")
            elif i == 1:
                terms.append(f"{c}x" if not c.is_one() else "x")
            else:
                terms.append(f"{c}x^{i}" if not c.is_one() else f"x^{i}")
        return " + ".join(terms)

    # -- ring operations ----------------------------------------------------

    def __add__(self, other) -> "Polynomial":
        other = _coerce_poly(other)
        if other is NotImplemented:
            return NotImplemented
        a, b, x = _promote(self, other)
        n = max(a.shape[0], b.shape[0])
        pa, pb = _zeros(n, x), _zeros(n, x)
        pa[: a.shape[0]] = a
        pb[: b.shape[0]] = b
        return Polynomial.from_array(gfn.add(pa, pb), x)

    __radd__ = __add__

    def __sub__(self, other) -> "Polynomial":
        other = _coerce_poly(other)
        if other is NotImplemented:
            return NotImplemented
        a, b, x = _promote(self, other)
        n = max(a.shape[0], b.shape[0])
        pa, pb = _zeros(n, x), _zeros(n, x)
        pa[: a.shape[0]] = a
        pb[: b.shape[0]] = b
        return Polynomial.from_array(gfn.sub(pa, pb), x)

    def __rsub__(self, other) -> "Polynomial":
        other = _coerce_poly(other)
        if other is NotImplemented:
            return NotImplemented
        return other - self

    def __neg__(self) -> "Polynomial":
        return Polynomial.from_array(gfn.neg(self._c), self._x)

    def __mul__(self, other) -> "Polynomial":
        if isinstance(other, (BFieldElement, XFieldElement, int)):
            return self.scalar_mul(other)
        if not isinstance(other, Polynomial):
            return NotImplemented
        return self.multiply(other)

    def __rmul__(self, other) -> "Polynomial":
        if isinstance(other, (BFieldElement, XFieldElement, int)):
            return self.scalar_mul(other)
        return NotImplemented

    def scalar_mul(self, scalar) -> "Polynomial":
        s = _scalar_value(scalar)
        if _is_x_scalar(s) and not self._x:
            return Polynomial.from_array(
                _fmul_scalar(_lift3(self._c), s, True), True)
        if not _is_x_scalar(s) and self._x:
            return Polynomial.from_array(gfn.mul(self._c, s), True)
        return Polynomial.from_array(
            _fmul_scalar(self._c, s, self._x), self._x)

    def scalar_mul_mut(self, scalar) -> None:
        """In-place scalar multiply (polynomial.rs:498-509). The functional
        API is `scalar_mul`; this mutating spelling exists for drop-in
        parity with the reference."""
        out = self.scalar_mul(scalar)
        self._c = out._c
        self._x = out._x

    def into_owned(self) -> "Polynomial":
        """Reference API parity (polynomial.rs:691): the Rust type can
        borrow its coefficients (Cow); here coefficients are always owned
        arrays, so this returns self."""
        return self

    def multiply(self, other: "Polynomial") -> "Polynomial":
        """Dispatch: schoolbook below the NTT cutoff (polynomial.rs:873-887)."""
        if self.degree() + other.degree() < FAST_MULTIPLY_CUTOFF_THRESHOLD:
            return self.naive_multiply(other)
        return self.fast_multiply(other)

    def naive_multiply(self, other: "Polynomial") -> "Polynomial":
        a, b, x = _promote(self, other)
        la, lb = _trimmed_len(a), _trimmed_len(b)
        if la == 0 or lb == 0:
            return Polynomial.from_array(_zeros(0, x), x)
        a, b = a[:la], b[:lb]
        if lb < la:
            a, b, la, lb = b, a, lb, la
        if la * lb <= (1 << 20):
            # one vectorized outer product + anti-diagonal fold (log la
            # adds) instead of la per-row numpy calls
            if x:
                table = xgf.mul(a[:, None, :], b[None, :, :])
            else:
                table = gfn.mul(a[:, None], b[None, :])
            return Polynomial.from_array(_antidiag_sum(table, x), x)
        out = _zeros(la + lb - 1, x)
        for i in range(la):
            out[i: i + lb] = gfn.add(out[i: i + lb],
                                     _fmul_scalar(b, a[i], x))
        return Polynomial.from_array(out, x)

    def fast_multiply(self, other: "Polynomial") -> "Polynomial":
        """NTT multiply (polynomial.rs:900-932)."""
        a, b, x = _promote(self, other)
        la, lb = _trimmed_len(a), _trimmed_len(b)
        if la == 0 or lb == 0:
            return Polynomial.from_array(_zeros(0, x), x)
        return Polynomial.from_array(_ntt_mul_arrays(a[:la], b[:lb], x), x)

    @staticmethod
    def batch_multiply(factors: Sequence["Polynomial"]) -> "Polynomial":
        """Product tree (polynomial.rs:935-984)."""
        if not factors:
            return Polynomial.one()
        layer = list(factors)
        while len(layer) > 1:
            nxt = [
                layer[i] * layer[i + 1] for i in range(0, len(layer) - 1, 2)
            ]
            if len(layer) % 2:
                nxt.append(layer[-1])
            layer = nxt
        return layer[0]

    par_batch_multiply = batch_multiply

    def square(self) -> "Polynomial":
        if self.degree() < FAST_SQUARE_CUTOFF_THRESHOLD:
            return self.naive_multiply(self)
        return self.fast_square()

    def fast_square(self) -> "Polynomial":
        return self.fast_multiply(self)

    def slow_square(self) -> "Polynomial":
        """O(n^2) squaring oracle (polynomial.rs:401-423): 2·c_i·c_j cross
        terms plus c_i^2 diagonal; used to cross-check the fast path."""
        if self.degree() < 0:
            return Polynomial.zero()
        return self.naive_multiply(self)

    def pow(self, exponent: int) -> "Polynomial":
        if exponent == 0:
            return Polynomial.one()
        result = Polynomial.one()
        base = self
        e = int(exponent)
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    fast_pow = pow
    __pow__ = pow

    def shift_coefficients(self, power: int) -> "Polynomial":
        """Multiply by x^power (polynomial.rs:480-484)."""
        return Polynomial.from_array(
            np.concatenate([_zeros(power, self._x), self._c]), self._x)

    def scale(self, alpha) -> "Polynomial":
        """p(x) -> p(alpha * x) (polynomial.rs:760-773)."""
        s = _scalar_value(alpha)
        sx = _is_x_scalar(s)
        x = self._x or sx
        c = _lift3(self._c) if (x and not self._x) else self._c
        pw = _powers_arr(s if sx else s, c.shape[0], sx)
        if sx:
            return Polynomial.from_array(xgf.mul(c, pw), True)
        if x:
            return Polynomial.from_array(gfn.mul(c, pw[:, None]), True)
        return Polynomial.from_array(gfn.mul(c, pw), False)

    def truncate(self, k: int) -> "Polynomial":
        """The leading k+1 coefficients (lowest-degree terms dropped)."""
        deg = self.degree()
        take = min(k + 1, deg + 1)
        return Polynomial.from_array(
            self._c[deg + 1 - take: deg + 1], self._x)

    def mod_x_to_the_n(self, n: int) -> "Polynomial":
        """Remainder modulo x^n: the n lowest coefficients."""
        out = _zeros(n, self._x)
        take = min(n, self._c.shape[0])
        out[:take] = self._c[:take]
        return Polynomial.from_array(out, self._x)

    def formal_derivative(self) -> "Polynomial":
        n = self._c.shape[0]
        if n <= 1:
            return Polynomial.from_array(_zeros(0, self._x), self._x)
        idx = np.arange(1, n, dtype=np.uint64)
        body = self._c[1:]
        if self._x:
            return Polynomial.from_array(gfn.mul(body, idx[:, None]), True)
        return Polynomial.from_array(gfn.mul(body, idx), False)

    # -- division -----------------------------------------------------------

    def naive_divide(self, divisor: "Polynomial") -> tuple:
        """Long division -> (quotient, remainder) (polynomial.rs:552-600)."""
        a, b, x = _promote(self, divisor)
        la, lb = _trimmed_len(a), _trimmed_len(b)
        if lb == 0:
            raise PolynomialDivisionError("division by zero polynomial")
        q, r = _divmod_arrays(a[:la], b[:lb], x)
        return Polynomial.from_array(q, x), Polynomial.from_array(r, x)

    def divide(self, divisor: "Polynomial") -> tuple:
        return self.naive_divide(divisor)

    def __truediv__(self, other) -> "Polynomial":
        q, _ = self.divide(_coerce_poly(other))
        return q

    def __floordiv__(self, other) -> "Polynomial":
        q, _ = self.divide(_coerce_poly(other))
        return q

    def __mod__(self, other) -> "Polynomial":
        _, r = self.divide(_coerce_poly(other))
        return r

    def __divmod__(self, other) -> tuple:
        return self.divide(_coerce_poly(other))

    def clean_divide(self, divisor: "Polynomial") -> "Polynomial":
        """Exact division, where the caller guarantees divisibility
        (polynomial.rs:2334-2413). Small sizes use long division; large
        sizes evaluate both operands on a coset whose offset is lifted into
        the *extension field*, where a base-field divisor cannot vanish —
        so the pointwise division on the coset is always well-defined."""
        if divisor.degree() < 0:
            raise PolynomialDivisionError("division by zero polynomial")
        if self.degree() < CLEAN_DIVIDE_CUTOFF or divisor.degree() < 1:
            q, r = self.naive_divide(divisor)
            if not r.is_zero():
                raise PolynomialError("clean_divide: division was not clean")
            return q
        if self._x or divisor._x:
            # extension-field operands: no lift available one level up;
            # fall back to exact long division.
            q, r = self.naive_divide(divisor)
            if not r.is_zero():
                raise PolynomialError("clean_divide: division was not clean")
            return q
        result_len = self.degree() - divisor.degree() + 1
        n = 1 << max(self.degree().bit_length(), 1)
        # offset = g * x: an extension-field element outside every proper
        # subfield, so a nonzero base-field polynomial cannot vanish on the
        # whole coset offset*<omega> (polynomial.rs:2334-2413 lifts the
        # same way).
        offset = XFieldElement((0, GENERATOR, 0))
        num = self.scale(offset)
        den = divisor.scale(offset)
        na, da_ = num.to_array(), den.to_array()
        pn, pd = _zeros(n, True), _zeros(n, True)
        pn[: na.shape[0]] = na
        pd[: da_.shape[0]] = da_
        # one NTT-domain division round trip (the card above the
        # crossover, the host below: ntt.routed_conv_values)
        coeffs = ntt_mod.routed_conv_values(
            pn, pd, xfield=True, divide=True)[:result_len]
        q = Polynomial.from_array(coeffs, True).scale(offset.inverse())
        # the quotient of base-field operands is base-field: unlift
        arr = q.to_array()
        if arr.shape[0] and (arr[:, 1].any() or arr[:, 2].any()):
            raise PolynomialError("clean_divide: division was not clean")
        out = _zeros(result_len, False)
        out[: arr.shape[0]] = arr[:, 0] if arr.shape[0] else out[:0]
        return Polynomial.from_array(out, False)

    def xgcd(self, other: "Polynomial") -> tuple:
        """Extended Euclid; gcd is normalized monic (polynomial.rs:616-649).
        Returns (gcd, a, b) with a*self + b*other == gcd."""
        x = self.normalize()
        y = _coerce_poly(other).normalize()
        a0, a1 = Polynomial.one(), Polynomial.zero()
        b0, b1 = Polynomial.zero(), Polynomial.one()
        while not y.is_zero():
            q, r = x.divide(y)
            x, y = y, r
            a0, a1 = a1, a0 - q * a1
            b0, b1 = b1, b0 - q * b1
        lc = x.leading_coefficient()
        if lc is not None and not lc.is_zero() and not lc.is_one():
            lc_inv = lc.inverse()
            x = x.scalar_mul(lc_inv)
            a0 = a0.scalar_mul(lc_inv)
            b0 = b0.scalar_mul(lc_inv)
        return x, a0, b0

    # -- modular reduction & power series ------------------------------------

    def reduce(self, modulus: "Polynomial") -> "Polynomial":
        """self mod modulus (dispatcher, polynomial.rs:989-1002)."""
        if modulus.degree() < 0:
            raise PolynomialDivisionError("reduction modulo zero polynomial")
        if (
            self.degree() < FAST_REDUCE_CUTOFF_THRESHOLD
            or modulus.degree() < 1
            or self.degree() < 2 * modulus.degree()
        ):
            _, r = self.divide(modulus)
            return r
        return self.fast_reduce(modulus)

    def fast_reduce(self, modulus: "Polynomial") -> "Polynomial":
        """Three-phase chunked reduction (polynomial.rs:1010-1046).

        1. Reduce by an NTT-friendly structured multiple of the modulus
           (X^n + low tail, n a power of two ~2x the modulus degree),
           chunk-wise: each chunk costs two size-n NTTs and touches every
           coefficient once — O(len(self)/n * n log n) total.
        2. The surviving window (length < n + tail) is finished by long
           division. (The reference splits 2 into a schoolbook chunk phase
           + long division; the window here is already a single chunk, so
           plain division covers both.)

        The previous implementation repeatedly split off the top above a
        degree-(2d+1) structured multiple, shrinking the degree by only ~d
        per full-size multiply — O(n^2/d) work; reducing a deg-2^17
        polynomial by a deg-2^9 zerofier took ~100 s. This form does it in
        well under a second (same values, bit-exact)."""
        shift_ntt, tail_length = modulus.shift_factor_ntt_with_tail_length()
        intermediate = self.reduce_by_ntt_friendly_modulus(
            shift_ntt, tail_length)
        _, r = intermediate.divide(modulus)
        return r

    def shift_factor_ntt_with_tail_length(self) -> tuple[np.ndarray, int]:
        """NTT of a structured multiple + its tail length, the preprocessing
        for reduce_by_ntt_friendly_modulus (polynomial.rs:1051-1074)."""
        n = max(FAST_REDUCE_CUTOFF_THRESHOLD, 2 * max(self.degree(), 0))
        n = 1 << (n - 1).bit_length()
        multiple = self.structured_multiple_of_degree(n)
        arr = multiple.to_array()
        body = arr[:-1] if arr.shape[0] else arr
        m = _trimmed_len(body)
        m = max(m, 1)
        shift = _zeros(n, self._x)
        shift[: min(n, arr.shape[0])] = arr[:n]
        if self._x:
            shift_ntt = ntt_mod.routed_ntt_values(shift.T).T
        else:
            shift_ntt = ntt_mod.routed_ntt_values(shift)
        return shift_ntt, m

    def reduce_by_ntt_friendly_modulus(self, shift_ntt: np.ndarray,
                                       tail_length: int) -> "Polynomial":
        """Reduce by a structured modulus X^(n-tail)+tail given in NTT form
        (polynomial.rs:1087-1144)."""
        sx = shift_ntt.ndim == 2
        x = self._x or sx
        domain_length = shift_ntt.shape[0]
        if domain_length & (domain_length - 1):
            raise PolynomialError("shift table length must be a power of two")
        chunk_size = domain_length - tail_length
        coeffs = _lift3(self._c) if (x and not self._x) else self._c
        if coeffs.shape[0] < chunk_size + tail_length:
            return Polynomial.from_array(coeffs.copy(), x)
        num_reducible_chunks = -(-(coeffs.shape[0] - (tail_length + chunk_size))
                                 // chunk_size)
        range_start = num_reducible_chunks * chunk_size
        if not x:
            from .. import native

            if native.available():
                # whole chunk loop in one native call: ~L/D short NTTs
                # with zero per-chunk Python/numpy dispatch
                log_d = domain_length.bit_length() - 1
                window = native.reduce_by_ntt_modulus(
                    coeffs, shift_ntt, tail_length,
                    ntt_mod._host_stage_tw_flat(log_d, False),
                    ntt_mod._host_stage_tw_flat(log_d, True),
                    pow(domain_length, P - 2, P))
                return Polynomial.from_array(window, False)
        window = _zeros(chunk_size + tail_length, x)
        if range_start < coeffs.shape[0]:
            take = coeffs.shape[0] - range_start
            window[:take] = coeffs[range_start:]
        # prepare the shift table once for every chunk's convolution round
        # trip (on the card above the crossover, a host array below):
        # ntt.routed_conv_table_* mirror the reference's cached-NTT chunk
        # loop, polynomial.rs:1087-1144.
        table = ntt_mod.routed_conv_table_prepare(shift_ntt, xfield=sx)
        for chunk_index in range(num_reducible_chunks - 1, -1, -1):
            product = _zeros(domain_length, x)
            product[:chunk_size] = window[tail_length:]
            product = ntt_mod.routed_conv_table_values(
                product, table, xfield=x, table_xfield=sx)
            new_window = _zeros(chunk_size + tail_length, x)
            new_window[chunk_size:] = window[:tail_length]
            stop = min(chunk_size, coeffs.shape[0] - chunk_index * chunk_size)
            new_window[:stop] = coeffs[
                chunk_index * chunk_size: chunk_index * chunk_size + stop]
            window = gfn.sub(new_window,
                             product[: chunk_size + tail_length])
        return Polynomial.from_array(window, x)

    def formal_power_series_inverse_minimal(self, precision: int) -> "Polynomial":
        """Minimal-degree g with self*g == 1 mod x^precision
        (polynomial.rs:657-675), by explicit coefficient recurrence."""
        x = self._x
        if self._c.shape[0] == 0 or not (
            self._c[0].any() if x else self._c[0]
        ):
            raise PolynomialError("constant term must be invertible")
        f0_inv = _finv(self._c[0:1], x)[0]
        out = _zeros(precision, x)
        out[0] = f0_inv
        k = min(_trimmed_len(self._c) - 1, precision)
        for i in range(1, precision):
            j_max = min(i, k)
            if j_max >= 1:
                terms = _fmul(self._c[1: j_max + 1],
                              out[i - j_max: i][::-1], x)
                acc = _fsum(terms, x)
            else:
                acc = _zeros(1, x)[0]
            out[i] = _fmul(gfn.neg(acc), f0_inv, x)
        return Polynomial.from_array(out, x)

    def formal_power_series_inverse_newton(self, precision: int) -> "Polynomial":
        """Newton iteration g <- g*(2 - f*g), doubling precision
        (polynomial.rs:1281-1361)."""
        x = self._x
        if self._c.shape[0] == 0 or not (
            self._c[0].any() if x else self._c[0]
        ):
            raise PolynomialError("constant term must be invertible")
        g = Polynomial.from_array(_finv(self._c[0:1], x), x)
        current = 1
        two = Polynomial([bfe(2)])
        while current < precision:
            current *= 2
            fg = (self.mod_x_to_the_n(current) * g).mod_x_to_the_n(current)
            g = (g * (two - fg)).mod_x_to_the_n(current)
        return g.mod_x_to_the_n(precision)

    def structured_multiple(self) -> "Polynomial":
        """Multiple of the form x^(3n+1) + (tail of degree <= 2n)
        (polynomial.rs:1147-1153)."""
        return self.structured_multiple_of_degree(3 * self.degree() + 1)

    def structured_multiple_of_degree(self, n: int) -> "Polynomial":
        """A multiple of self of the form x^n + (tail of degree < deg(self)),
        via reversal + formal power series inverse (polynomial.rs:1161-1186)."""
        deg = self.degree()
        if deg < 0 or n < deg:
            raise PolynomialError(
                "structured multiple needs deg >= 0 and n >= deg")
        if deg == 0:
            return Polynomial.x_to_the(n)
        rev = Polynomial.from_array(self.to_array()[::-1].copy(), self._x)
        inv = rev.formal_power_series_inverse_newton(n - deg + 1)
        q = Polynomial.from_array(
            inv.mod_x_to_the_n(n - deg + 1).to_array()[::-1].copy(), inv._x)
        return (q * self).normalize()

    # -- zerofiers ----------------------------------------------------------

    @staticmethod
    def zerofier(domain: Sequence) -> "Polynomial":
        """Unique monic polynomial vanishing exactly on `domain`
        (polynomial.rs:1418-1441). The reference's smart/fast cutoff
        balances scalar Rust loops; here everything above one leaf chunk
        routes to the batched product tree (same values)."""
        if len(domain) <= RECURSION_CUTOFF_THRESHOLD:
            return Polynomial.smart_zerofier(domain)
        return Polynomial.fast_zerofier(domain)

    @staticmethod
    def naive_zerofier(domain: Sequence) -> "Polynomial":
        """Fold of linear factors (x - r) oracle (polynomial.rs:2482-2488)."""
        pts, x = _to_field_array(domain)
        result = Polynomial.one()
        for r in _objs_from_array(pts, x):
            result = result * Polynomial([-r, type(r).one()])
        return result

    @staticmethod
    def smart_zerofier(domain: Sequence) -> "Polynomial":
        """Incremental O(n^2) construction, vectorized inner loop
        (polynomial.rs:1462-1474)."""
        pts, x = _to_field_array(domain)
        n = pts.shape[0]
        if n == 0:
            return Polynomial.one()
        acc = _zeros(n + 1, x)
        acc[0] = _one_row(x)
        zero_row = _zeros(1, x)
        for k in range(n):
            neg_root = gfn.neg(pts[k])
            scaled = _fmul_scalar(acc[: k + 1], neg_root, x)
            shifted = np.concatenate([zero_row, acc[: k + 1]], axis=0)
            acc[: k + 2] = gfn.add(shifted,
                                   np.concatenate([scaled, zero_row], axis=0))
        return Polynomial.from_array(acc, x)

    @staticmethod
    def batch_smart_zerofier_rows(pts: np.ndarray, x: bool) -> np.ndarray:
        """Zerofier coefficient rows for a BATCH of equal-length domains:
        (L, k[, 3]) points -> (L, k+1[, 3]) monic zerofiers, with 2k
        vectorized numpy calls total instead of 2k per domain. Feeds the
        zerofier-tree leaf construction."""
        nb, k = pts.shape[0], pts.shape[1]
        acc = np.zeros((nb, k + 1, 3) if x else (nb, k + 1), dtype=np.uint64)
        acc[:, 0] = _one_row(x)
        for j in range(k):
            root = pts[:, j]
            neg = xgf.neg(root) if x else gfn.neg(root)
            old = acc[:, : j + 1].copy()
            scaled = _fmul(old, neg[:, None, :] if x else neg[:, None], x)
            acc[:, 1: j + 2] = old
            acc[:, 0] = 0
            acc[:, : j + 1] = gfn.add(acc[:, : j + 1], scaled)
        return acc

    @staticmethod
    def fast_zerofier(domain: Sequence) -> "Polynomial":
        """Divide and conquer (polynomial.rs:1478-1484), realized as a
        fully-BATCHED product tree: 16-point leaf chunks built in one
        batched incremental pass, then each tree level as one batched
        outer-product convolution (batched NTT multiply once products get
        large). Same values as the reference recursion."""
        pts, x = _to_field_array(domain)
        if pts.shape[0] <= RECURSION_CUTOFF_THRESHOLD:
            return Polynomial.smart_zerofier(domain)
        return Polynomial.from_array(Polynomial._zerofier_rows(pts, x), x)

    @staticmethod
    def _zerofier_rows(pts: np.ndarray, x: bool) -> np.ndarray:
        """Zerofier coefficient row for one domain (length n+1, monic)."""
        k = RECURSION_CUTOFF_THRESHOLD
        n = pts.shape[0]
        rows_by_len: dict = {}

        def add(arr):
            ln = arr.shape[1]
            if ln in rows_by_len:
                rows_by_len[ln] = np.concatenate([rows_by_len[ln], arr],
                                                 axis=0)
            else:
                rows_by_len[ln] = arr

        n_full = n // k
        if n_full:
            add(Polynomial.batch_smart_zerofier_rows(
                pts[: n_full * k].reshape(
                    (n_full, k, 3) if x else (n_full, k)), x))
        if n % k:
            rem = pts[n_full * k:]
            add(Polynomial.batch_smart_zerofier_rows(
                rem.reshape((1,) + rem.shape), x))
        while sum(a.shape[0] for a in rows_by_len.values()) > 1:
            new_groups: dict = {}

            def add_new(arr):
                ln = arr.shape[1]
                if ln in new_groups:
                    new_groups[ln] = np.concatenate([new_groups[ln], arr],
                                                    axis=0)
                else:
                    new_groups[ln] = arr

            singles = []
            for ln in sorted(rows_by_len):
                arr = rows_by_len[ln]
                m = arr.shape[0]
                pairs = m // 2
                if pairs:
                    add_new(Polynomial._mul_rows(
                        arr[0: 2 * pairs: 2], arr[1: 2 * pairs: 2], x))
                if m % 2:
                    singles.append(arr[-1:])
            while len(singles) >= 2:
                a, b = singles.pop(), singles.pop()
                add_new(Polynomial._mul_rows(a, b, x))
            if singles:
                add_new(singles[0])
            rows_by_len = new_groups
        return next(iter(rows_by_len.values()))[0]

    @staticmethod
    def _mul_rows(a: np.ndarray, b: np.ndarray, x: bool) -> np.ndarray:
        """Batched products of row pairs: (m, la[,3]) * (m, lb[,3]).

        Small products use one outer-product + anti-diagonal fold; large
        ones a BATCHED NTT convolution (one transform for all m rows), on
        the host up to HOST_CONV_MAX_ELEMS elements a level and on the
        card above (K3, K8): a level is one batched round trip, so it
        crosses where a one-shot convolution of its size does (PERF.md
        section 6)."""
        m, la, lb = a.shape[0], a.shape[1], b.shape[1]
        # With the AVX-512 native row-NTT the batched transform beats the
        # schoolbook outer-product at almost every tree shape; schoolbook
        # survives only for short rows or tiny totals (measured sweep:
        # L=9 school wins to m=1024, L=17 NTT wins from m~100, single
        # short rows school). Old element-op cutoff (2^20) left 20x on
        # the table at e.g. (m=32, L=129): 21.1 vs 0.9 ms.
        # short-row schoolbook is capped by total element count so the
        # (m, la, lb) outer product stays bounded (the measured win region
        # ends around m~1024 for L=9 anyway; beyond it the batched NTT wins
        # AND the materialization would grow without bound)
        if (min(la, lb) <= 12 and m * la * lb <= (1 << 22)) \
                or m * la * lb <= (1 << 12) or x:
            if not x:
                return _batch_antidiag_sum(gfn.mul(a[:, :, None],
                                                   b[:, None, :]), False)
            outs = [_ntt_mul_arrays(a[i], b[i], True)
                    if la * lb > (1 << 20) else
                    _antidiag_sum(xgf.mul(a[i][:, None, :],
                                          b[i][None, :, :]), True)
                    for i in range(m)]
            return np.stack(outs, axis=0)
        out_len = la + lb - 1
        size = 1 << max((out_len - 1).bit_length(), 1)
        pa = np.zeros((m, size), dtype=np.uint64)
        pa[:, :la] = a
        pb = np.zeros((m, size), dtype=np.uint64)
        pb[:, :lb] = b
        if pa.size > ntt_mod.HOST_CONV_MAX_ELEMS:
            prod = ntt_mod.conv_values(pa, pb, device=ntt_mod.DEVICE)
            return np.ascontiguousarray(prod[:, :out_len])
        fa = ntt_mod.ntt_host(pa)
        fb = ntt_mod.ntt_host(pb)
        prod = ntt_mod.ntt_host(gfn.mul(fa, fb), inverse=True)
        return np.ascontiguousarray(prod[:, :out_len])

    par_zerofier = zerofier

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, point):
        """Evaluate at one point; the point may live in the extension of the
        coefficient field (polynomial.rs:309-329)."""
        s = _scalar_value(point)
        px = _is_x_scalar(s)
        out = _eval_one(self._c, self._x, s, px)
        return _obj(out, self._x or px)

    evaluate_in_same_field = evaluate

    def iterative_batch_evaluate(self, domain: Sequence) -> list:
        """Point-by-point Horner oracle (polynomial.rs:1876-1878); used to
        cross-check the divide-and-conquer path."""
        return [self.evaluate(p) for p in domain]

    def batch_evaluate(self, domain: Sequence) -> list:
        """Evaluate on many points (polynomial.rs:1840-1894): reduce-then-
        evaluate when the degree dwarfs the domain, else zerofier-tree
        divide-and-conquer."""
        if len(domain) == 0:
            return []
        pts, px = _to_field_array(domain)
        out = self._batch_evaluate_arr(pts, px)
        return _objs_from_array(out, self._x or px)

    par_batch_evaluate = batch_evaluate

    def _batch_evaluate_arr(self, pts: np.ndarray, px: bool) -> np.ndarray:
        m = pts.shape[0]
        if self.degree() < 0:
            return _zeros(m, self._x or px)
        # direct (blocked-Horner) evaluation is O(deg*m) element-ops; past
        # ~2^18 of those the zerofier-tree divide-and-conquer below wins
        # (the reference D&Cs for everything above the leaf cutoff,
        # polynomial.rs:1840-1894 — scalar-loop economics differ here)
        # blocked Horner is O(deg*m) element-ops but all-vectorized; the
        # measured crossover vs the batched remainder tree is ~2^24 ops
        # for the base field (the D&C object path for xfe keeps the old
        # 2^18 threshold: its per-node reduce costs more)
        horner_cap = 1 << 24 if (not self._x and not px) else 1 << 18
        if not self._x and not px:
            from .. import native

            if native.available():
                # with the lane-blocked native Horner (~3.2 G mul-add/s)
                # and the native chunked reduce, the measured crossover
                # vs reduce-then-evaluate sits near 2^26 element-ops
                # (2^18 coeffs x 2^10 points: direct Horner 84 ms,
                # native-reduce + short Horner ~40 ms)
                horner_cap = 1 << 26
        if self.degree() <= RECURSION_CUTOFF_THRESHOLD \
                or (self.degree() + 1) * m <= horner_cap:
            return _eval_many(self.to_array(), self._x, pts, px)
        if not self._x and not px:
            return self._remainder_tree_eval(pts)
        tree = ZerofierTree.new_from_domain(
            _objs_from_array(pts, px))
        reduced = self.reduce(tree.zerofier())
        out = reduced._dc_eval_arr(tree.root, px)
        return out

    def _remainder_tree_eval(self, pts: np.ndarray) -> np.ndarray:
        """Base-field multipoint evaluation as a level-synchronous batched
        remainder tree (polynomial.rs:1840-1894 realized batch-first):
        one padded zerofier level pyramid, one reduce by the root, then
        one batched `_rows_mod` per level down to blocked-Horner leaves."""
        n = pts.shape[0]
        s_leaf = RECURSION_CUTOFF_THRESHOLD
        n_leafs = max(1, -(-n // s_leaf))
        n_leafs = 1 << (n_leafs - 1).bit_length()
        n_pad = n_leafs * s_leaf
        # pad with repeats of the last point: extra evaluations, dropped
        # at the end (a zerofier with repeated roots still evaluates fine)
        ptsp = np.concatenate(
            [pts, np.broadcast_to(pts[-1:], (n_pad - n,))]) \
            if n_pad > n else pts
        depth = n_leafs.bit_length() - 1
        z = [None] * (depth + 1)
        z[depth] = Polynomial.batch_smart_zerofier_rows(
            ptsp.reshape(n_leafs, s_leaf), False)
        for d in range(depth - 1, -1, -1):
            z[d] = Polynomial._mul_rows(z[d + 1][0::2], z[d + 1][1::2],
                                        False)
        # Top-level reduce stays on the chunked fast_reduce: the Newton
        # reversal-trick modulo was measured SLOWER here (864 ms of
        # full-length convolutions vs 159 ms of L/D short chunk NTTs at
        # 2^18 by 2^10 — O(L log L) with multi-pass constants loses to
        # O(L log D) streaming chunks once L >> D).
        root = Polynomial.from_array(z[0][0].copy(), False)
        reduced = self.reduce(root).to_array()
        # after the root reduction the problem is n_pad coefficients at n
        # points; below ~2^24 element-ops the lane-blocked native Horner
        # beats the remaining descent's numpy dispatch outright
        if reduced.shape[0] * n <= (1 << 24):
            from .. import native

            if native.available() and reduced.shape[0]:
                return native.horner_points(reduced, pts)
        rows = np.zeros((1, n_pad), dtype=np.uint64)
        rows[0, : reduced.shape[0]] = reduced
        rows, e = Polynomial._descend_remainder_tree(z, rows)
        vals = _horner_rows(rows, ptsp.reshape(1 << e, n_pad >> e))
        return vals.reshape(-1)[:n].copy()

    def divide_and_conquer_batch_evaluate(self, tree: ZerofierTree) -> list:
        if tree.root is None:
            return []
        first_leaf = tree.root
        while not first_leaf.is_leaf:
            first_leaf = first_leaf.left
        _, px = _to_field_array(first_leaf.points)
        return _objs_from_array(self._dc_eval_arr(tree.root, px),
                                self._x or px)

    def _dc_eval_arr(self, node, px: bool) -> np.ndarray:
        if node.is_leaf:
            pts, px2 = _to_field_array(node.points)
            return _eval_many(self.to_array(), self._x, pts, px2)
        outs = []
        for child in (node.left, node.right):
            if child is not None:
                reduced = self.reduce(child.zerofier)
                outs.append(reduced._dc_eval_arr(child, px))
        return np.concatenate(outs, axis=0)

    # -- interpolation -------------------------------------------------------

    @staticmethod
    def interpolate(domain: Sequence, values: Sequence) -> "Polynomial":
        """Unique interpolant of degree < n (polynomial.rs:1502-1543)."""
        if len(domain) != len(values) or len(domain) == 0:
            raise PolynomialError(
                "interpolation needs a nonempty domain matching the values")
        if len(domain) < FAST_INTERPOLATE_CUTOFF_THRESHOLD_PARALLEL:
            return Polynomial.lagrange_interpolate(domain, values)
        return Polynomial.fast_interpolate(domain, values)

    par_interpolate = interpolate

    @staticmethod
    def lagrange_interpolate_zipped(points: Sequence) -> "Polynomial":
        """Interpolate through (x, y) pairs (polynomial.rs:1549-1562);
        rejects empty input and repeated x values."""
        if len(points) == 0:
            raise PolynomialError(
                "interpolation must happen through more than zero points")
        xs = [p[0] for p in points]
        ys = [p[1] for p in points]
        seen = set()
        for x in xs:
            key = str(x)
            if key in seen:
                raise PolynomialError(f"repeated x values received: {x}")
            seen.add(key)
        return Polynomial.lagrange_interpolate(xs, ys)

    @staticmethod
    def lagrange_interpolate(domain: Sequence, values: Sequence) -> "Polynomial":
        """Zerofier-based O(n^2) Lagrange (polynomial.rs:1565-1607),
        vectorized over the domain axis."""
        pts, px = _to_field_array(domain)
        vals, vx = _to_field_array(values)
        x = px or vx
        if x and not px:
            pts = _lift3(pts)
        if x and not vx:
            vals = _lift3(vals)
        n = pts.shape[0]
        if n != vals.shape[0] or n == 0:
            raise PolynomialError(
                "interpolation needs a nonempty domain matching the values")
        if not x and n >= 8 and _native_host_on():
            # base-field single pair: one native C++ call replaces ~n
            # python-dispatched vectorized passes (2^9: 27 ms -> 10.7 ms)
            from .. import native as _nat

            return Polynomial.from_array(
                _nat.lagrange_interpolate(pts, vals), False)
        Q, inv = _lagrange_precompute(pts, x)
        return Polynomial.from_array(_lagrange_apply(Q, inv, vals, x), x)

    @staticmethod
    def fast_interpolate(domain: Sequence, values: Sequence) -> "Polynomial":
        """Recursive half-domain interpolation with batch-inverted offsets
        (polynomial.rs:1611-1701). Below 2^12 points a single base-field
        pair routes through the native O(n^2) Lagrange instead — one C++
        call (AVX-512 chains since round 4) beats the batched tree's
        python dispatch overhead up to the measured crossover
        (2^11: 17 ms vs 144; 2^12: 69 vs 174; 2^13: 276 vs 208 — the
        tree wins above)."""
        if len(domain) != len(values) or len(domain) == 0:
            raise PolynomialError(
                "interpolation needs a nonempty domain matching the values")
        if len(domain) <= (1 << 12):
            pts, px = _to_field_array(domain)
            vals, vx = _to_field_array(values)
            if not (px or vx) and _native_host_on():
                return Polynomial.lagrange_interpolate(pts, vals)
        return Polynomial.batch_fast_interpolate(domain, [values])[0]

    par_fast_interpolate = fast_interpolate

    @staticmethod
    def batch_fast_interpolate(domain: Sequence, value_batches: Sequence
                               ) -> list:
        """Interpolate many value sets on one shared domain, sharing the
        zerofier/offset-inverse work across batches via memoization
        (polynomial.rs:1703-1837)."""
        if len(domain) == 0:
            raise PolynomialError("cannot interpolate through zero points")
        pts, px = _to_field_array(domain)
        batches = []
        x_any = px
        for v in value_batches:
            arr, vx = _to_field_array(v)
            x_any = x_any or vx
            batches.append((arr, vx))
        x = x_any
        pts_x = _lift3(pts) if (x and not px) else pts
        mats = [(_lift3(a) if (x and not vx) else a) for a, vx in batches]
        n = pts.shape[0]
        if batches and (not x) and n >= 2 * RECURSION_CUTOFF_THRESHOLD \
                and n & (n - 1) == 0:
            coeffs = Polynomial._batch_interp_pow2(pts, [a for a, _ in batches])
            return [Polynomial.from_array(coeffs[b].copy(), False)
                    for b in range(coeffs.shape[0])]
        zerofier_memo: dict = {}
        offset_inv_memo: dict = {}
        polys = Polynomial._batch_interp_memo(
            pts_x, x, mats, zerofier_memo, offset_inv_memo)
        return polys

    @staticmethod
    def _batch_interp_pow2(pts: np.ndarray, mats: list) -> np.ndarray:
        """Level-synchronous (breadth-first) memoized batch interpolation
        for power-of-two base-field domains. Identical values to the
        recursive form (_batch_interp_memo / polynomial.rs:1703-1837), but
        every tree level is a handful of vectorized numpy calls across ALL
        nodes and value batches at once instead of per-node work — the
        host-object API's analogue of the device kernels' batch-first rule.

        Returns (B, n) coefficient rows."""
        n = pts.shape[0]
        s_leaf = RECURSION_CUTOFF_THRESHOLD
        n_leafs = n // s_leaf
        depth = n_leafs.bit_length() - 1  # n = s_leaf * 2^depth
        # 1. zerofier rows for EVERY tree node, bottom-up; z[d] holds the
        #    2^d nodes at depth d as (2^d, n/2^d + 1) rows
        z = [None] * (depth + 1)
        z[depth] = Polynomial.batch_smart_zerofier_rows(
            pts.reshape(n_leafs, s_leaf), False)
        for d in range(depth - 1, -1, -1):
            z[d] = Polynomial._mul_rows(z[d + 1][0::2], z[d + 1][1::2],
                                        False)
        # 2. Lagrange weights via the derivative identity: the recursive
        #    scheme's per-level sibling-zerofier denominators telescope to
        #    Z'(x_i) (prod over levels of sibling-zerofier values times the
        #    within-leaf denominators equals the full zerofier's derivative
        #    at x_i), so ONE remainder-tree evaluation of Z' replaces a
        #    sibling-evaluation tree per level — the dominant cost of the
        #    previous top-down scaling (measured 2^14: 1.4 s -> this form).
        deriv = gfn.mul(z[0][0, 1:].copy(),
                        np.arange(1, n + 1, dtype=np.uint64))
        dvals = Polynomial._eval_row_remainder_tree(z, deriv, pts)
        winv = _finv(dvals, False)[None]  # (1, n): 1/Z'(x_i)
        t = gfn.mul(np.stack(mats, 0), winv)  # (B, n) weights
        bsz = t.shape[0]
        # 3. numerator-only leaf Lagrange (denominators live in Z'),
        #    batched across all leaves and batches
        q = _batch_lagrange_tables(pts.reshape(n_leafs, s_leaf),
                                   z[depth], want_inv=False)
        w = t.reshape(bsz, n_leafs, s_leaf)
        terms = gfn.mul(q[None], w[:, :, :, None])  # (B, M, S_pts, S_coef)
        while terms.shape[2] > 1:
            h = terms.shape[2] // 2
            head = gfn.add(terms[:, :, :h], terms[:, :, h: 2 * h])
            terms = np.concatenate([head, terms[:, :, 2 * h:]], axis=2) \
                if terms.shape[2] % 2 else head
        coeffs = terms[:, :, 0]  # (B, M, s_leaf)
        # 4. bottom-up combine: node = left*right_zerofier + right*left_zerofier
        for d in range(depth - 1, -1, -1):
            m = 1 << d
            ln = coeffs.shape[2]
            lp = np.ascontiguousarray(coeffs[:, 0::2]).reshape(bsz * m, ln)
            rp = np.ascontiguousarray(coeffs[:, 1::2]).reshape(bsz * m, ln)
            lz = np.broadcast_to(z[d + 1][0::2][None], (bsz, m, ln + 1)
                                 ).reshape(bsz * m, ln + 1)
            rz = np.broadcast_to(z[d + 1][1::2][None], (bsz, m, ln + 1)
                                 ).reshape(bsz * m, ln + 1)
            a = Polynomial._mul_rows(lp, rz, False)
            b = Polynomial._mul_rows(rp, lz, False)
            coeffs = gfn.add(a, b).reshape(bsz, m, 2 * ln)
        return coeffs[:, 0]

    @staticmethod
    def _rows_ps_inverse(rows: np.ndarray, prec: int) -> np.ndarray:
        """Row-batched formal-power-series inverse to precision `prec`
        (Newton doubling; polynomial.rs:1281-1361 batched across rows).
        Constant terms must be invertible. (M, L) -> (M, prec)."""
        m = rows.shape[0]
        cur = _finv(rows[:, 0].copy(), False)[:, None]
        p = 1
        while p < prec:
            p2 = min(2 * p, prec)
            a = rows[:, :p2] if rows.shape[1] >= p2 else np.pad(
                rows, ((0, 0), (0, p2 - rows.shape[1])))
            t = Polynomial._mul_rows(cur, a, False)[:, :p2]
            t = gfn.neg(t)
            t[:, 0] = gfn.add(t[:, 0], np.full(m, 2, dtype=np.uint64))
            cur = Polynomial._mul_rows(cur, t, False)[:, :p2]
            p = p2
        return cur

    @staticmethod
    def _rows_mod(a: np.ndarray, b: np.ndarray,
                  binv_rev: np.ndarray) -> np.ndarray:
        """Row-batched A mod B for monic divisor rows B ((M, D+1)),
        A ((M, L)) with L > D, via the reversal trick: rev(Q) = rev(A) *
        rev(B)^-1 mod x^(L-D). binv_rev must cover precision L-D."""
        L, D = a.shape[1], b.shape[1] - 1
        qlen = L - D
        q_rev = Polynomial._mul_rows(
            a[:, ::-1][:, :qlen].copy(), binv_rev[:, :qlen], False)[:, :qlen]
        qb = Polynomial._mul_rows(q_rev[:, ::-1].copy(), b, False)
        return gfn.sub(a[:, :D], qb[:, :D])

    @staticmethod
    def _descend_remainder_tree(z: list, rows: np.ndarray
                                ) -> tuple[np.ndarray, int]:
        """Shared remainder-tree descent: level-synchronous batched
        mod-reduction of `rows` ((1, L)) down the precomputed zerofier
        tree `z`, stopping at the leaves or once rows are narrow.

        Reversed-divisor inverses are parent-seeded instead of
        Newton-computed per level: rev(Z_parent) = rev(Z_left)·rev(Z_right)
        gives 1/rev(Z_left) ≡ rev(Z_right)·(1/rev(Z_parent)) mod x^k, so
        below the top level each inverse batch is ONE truncated multiply
        (measured: the per-level Newton chains were the dominant cost of
        arbitrary-domain interpolation). Returns (rows, level)."""
        depth = len(z) - 1
        e = 0
        binv_prev: np.ndarray | None = None
        prec_prev = 0
        while e < depth and rows.shape[1] > 64:
            div = z[e + 1]
            h = div.shape[1] - 1
            rep = np.repeat(rows, 2, axis=0)
            qlen = rep.shape[1] - h
            if binv_prev is None or prec_prev < qlen:
                binv = Polynomial._rows_ps_inverse(div[:, ::-1].copy(),
                                                   qlen)
            else:
                sib = np.empty_like(div)
                sib[0::2] = div[1::2]
                sib[1::2] = div[0::2]
                prod = Polynomial._mul_rows(
                    sib[:, ::-1].copy(),
                    np.repeat(binv_prev[:, :qlen], 2, axis=0), False)
                binv = np.ascontiguousarray(prod[:, :qlen])
            rows = Polynomial._rows_mod(rep, div, binv)
            binv_prev, prec_prev = binv, qlen
            e += 1
        return rows, e

    @staticmethod
    def _eval_row_remainder_tree(z: list, row: np.ndarray, pts: np.ndarray
                                 ) -> np.ndarray:
        """Evaluate ONE base-field polynomial row (degree < n) at all n
        domain points: descend the precomputed zerofier tree `z` with
        level-synchronous batched mod-reductions (the fast multipoint
        evaluation of polynomial.rs:1840-1894, realized batch-first),
        finish with batched Horner once rows are narrow. Returns (n,)."""
        n = pts.shape[0]
        rows, e = Polynomial._descend_remainder_tree(z, row.reshape(1, -1))
        ptse = pts.reshape(1 << e, n >> e)
        return _horner_rows(rows, ptse).reshape(n)

    @staticmethod
    def _batch_interp_memo(pts: np.ndarray, x: bool, mats: list,
                           zerofier_memo: dict, offset_inv_memo: dict,
                           lo: int = 0, hi: int | None = None) -> list:
        if hi is None:
            hi = pts.shape[0]
        n = hi - lo
        if n < BATCH_INTERPOLATE_CUTOFF:
            key = ("leaf", lo, hi)
            tables = offset_inv_memo.get(key)
            if tables is None:
                tables = _lagrange_precompute(pts[lo:hi], x)
                offset_inv_memo[key] = tables
            Q, inv = tables
            return [
                Polynomial.from_array(_lagrange_apply(Q, inv, m, x), x)
                for m in mats
            ]
        half = n // 2
        mid = lo + half
        lkey, rkey = (lo, mid), (mid, hi)
        lzero = zerofier_memo.get(lkey)
        if lzero is None:
            lzero = Polynomial.zerofier(_objs_from_array(pts[lo:mid], x))
            zerofier_memo[lkey] = lzero
        rzero = zerofier_memo.get(rkey)
        if rzero is None:
            rzero = Polynomial.zerofier(_objs_from_array(pts[mid:hi], x))
            zerofier_memo[rkey] = rzero
        linv = offset_inv_memo.get(lkey)
        if linv is None:
            lvals = rzero._batch_evaluate_arr(pts[lo:mid], x)
            linv = _finv(lvals, x)
            offset_inv_memo[lkey] = linv
        rinv = offset_inv_memo.get(rkey)
        if rinv is None:
            rvals = lzero._batch_evaluate_arr(pts[mid:hi], x)
            rinv = _finv(rvals, x)
            offset_inv_memo[rkey] = rinv
        left_targets = [_fmul(m[:half], linv, x) for m in mats]
        right_targets = [_fmul(m[half:], rinv, x) for m in mats]
        left_polys = Polynomial._batch_interp_memo(
            pts, x, left_targets, zerofier_memo, offset_inv_memo, lo, mid)
        right_polys = Polynomial._batch_interp_memo(
            pts, x, right_targets, zerofier_memo, offset_inv_memo, mid, hi)
        return [
            lp * rzero + rp * lzero
            for lp, rp in zip(left_polys, right_polys)
        ]

    # -- coset (Reed-Solomon) transforms -------------------------------------

    def fast_coset_evaluate(self, offset, order: int) -> list:
        """Evaluate on the coset offset * <omega> of size `order`:
        scale then NTT (polynomial.rs:1374-1399)."""
        if order & (order - 1) or order == 0:
            raise PolynomialError("coset order must be a power of two")
        if self.degree() >= order:
            raise PolynomialError("degree must be less than the coset order")
        arr = self.fast_coset_evaluate_array(offset, order)
        return _objs_from_array(arr, self._x)

    def fast_coset_evaluate_array(self, offset, order: int) -> np.ndarray:
        s = _scalar_value(offset)
        scaled = self.scale(s if not _is_x_scalar(s) else _obj(s, True))
        arr = scaled.to_array()
        padded = _zeros(order, scaled._x)
        padded[: arr.shape[0]] = arr
        if scaled._x:
            return ntt_mod.routed_ntt_values(padded.T).T
        return ntt_mod.routed_ntt_values(padded)

    @staticmethod
    def fast_coset_interpolate(offset, values: Sequence) -> "Polynomial":
        """iNTT then scale by offset^-1 (polynomial.rs:1907-1918)."""
        vals, vx = _to_field_array(values)
        if vx:
            coeffs = ntt_mod.routed_ntt_values(vals.T, inverse=True).T
        else:
            coeffs = ntt_mod.routed_ntt_values(vals, inverse=True)
        s = _scalar_value(offset)
        if _is_x_scalar(s):
            inv_obj = _obj(s, True).inverse()
        else:
            inv_obj = BFieldElement(int(s)).inverse()
        return Polynomial.from_array(coeffs, vx).scale(inv_obj)

    # -- modular coset interpolation (polynomial.rs:1963-2113) ---------------

    @staticmethod
    def fast_modular_coset_interpolate(values, offset, modulus: "Polynomial",
                                       preprocessed=None) -> "Polynomial":
        """f(X) mod m(X) where f interpolates `values` on the coset
        offset*<omega_n> (polynomial.rs:2002-2113). Three-way dispatch:
        Lagrange (< 2^8), iNTT + structured reduce (<= 2^17), recursive
        even/odd split with sparse zerofiers and the (-2)^-1 trick."""
        vals, vx = _to_field_array(values)
        off = np.uint64(_scalar_value(offset))
        if modulus.degree() < 0:
            raise PolynomialDivisionError("cannot reduce modulo zero")
        n = vals.shape[0]
        if preprocessed is None:
            preprocessed = Polynomial.fast_modular_coset_interpolate_preprocess(
                n, offset, modulus)
        return Polynomial._fmci(vals, vx, int(off), modulus, preprocessed)

    @staticmethod
    def fast_modular_coset_interpolate_with_zerofiers_and_ntt_friendly_multiple(
            values, offset, modulus: "Polynomial",
            preprocessed) -> "Polynomial":
        """Reference-named entry point (polynomial.rs:2020-2113; pub for
        benchmarking there) — the preprocessed-data variant."""
        return Polynomial.fast_modular_coset_interpolate(
            values, offset, modulus, preprocessed)

    @staticmethod
    def fast_modular_coset_interpolate_preprocess(
            n: int, offset, modulus: "Polynomial"
    ) -> "ModularInterpolationPreprocessingData":
        """Preprocessing: modularly-reduced sparse zerofiers for every
        recursion level + the NTT-friendly multiple of the modulus
        (polynomial.rs:1963-1997)."""
        off = int(np.uint64(_scalar_value(offset)))
        log_n = max(n.bit_length() - 1, 0)
        omega = int(ntt_mod.PRIMITIVE_ROOTS[n]) if n > 1 else 1
        # X^(2^i) mod m(X), by repeated modular squaring
        modular_squares = []
        acc = Polynomial.x_to_the(1)
        for _ in range(log_n):
            modular_squares.append(acc)
            acc = acc.multiply(acc).reduce(modulus)
        off_inv = pow(off, P - 2, P)
        off_omega_inv = pow(off * omega % P, P - 2, P)
        even_zerofiers = []
        odd_zerofiers = []
        one = Polynomial.one()
        for i in range(log_n):
            lc_e = pow(off_inv, 1 << i, P)
            lc_o = pow(off_omega_inv, 1 << i, P)
            even_zerofiers.append(
                modular_squares[i].scalar_mul(bfe(lc_e)) - one)
            odd_zerofiers.append(
                modular_squares[i].scalar_mul(bfe(lc_o)) - one)
        shift_ntt, tail_length = modulus.shift_factor_ntt_with_tail_length()
        return ModularInterpolationPreprocessingData(
            even_zerofiers, odd_zerofiers, shift_ntt, tail_length)

    @staticmethod
    def _fmci(vals: np.ndarray, vx: bool, off: int, modulus: "Polynomial",
              pre) -> "Polynomial":
        n = vals.shape[0]
        omega = int(ntt_mod.PRIMITIVE_ROOTS[n]) if n > 1 else 1
        if n < FAST_MODULAR_COSET_INTERPOLATE_CUTOFF_THRESHOLD_PREFER_LAGRANGE:
            domain = gfn.powers(omega, n)
            domain = gfn.mul(domain, np.uint64(off))
            interpolant = Polynomial.lagrange_interpolate(
                domain if not vx else _lift3(domain), vals)
            return interpolant.reduce(modulus)
        if n <= FAST_MODULAR_COSET_INTERPOLATE_CUTOFF_THRESHOLD_PREFER_INTT:
            if vx:
                coeffs = ntt_mod.routed_ntt_values(vals.T, inverse=True).T
            else:
                coeffs = ntt_mod.routed_ntt_values(vals, inverse=True)
            interpolant = Polynomial.from_array(coeffs, vx).scale(
                bfe(pow(off, P - 2, P)))
            return interpolant.reduce_by_ntt_friendly_modulus(
                pre.shift_coefficients, pre.tail_length).reduce(modulus)
        # recursion: even/odd split; zerofier cross-evaluations are the
        # constant -2, so targets are just values * (-2)^-1. The sub-calls
        # rebuild preprocessing for their own (offset, omega) pair, exactly
        # as the reference's recursive call through the public entry point
        # does (polynomial.rs:2102-2106) — the parent's zerofier tables are
        # built against the parent's omega and do not apply below.
        minus_two_inv = np.uint64(pow(P - 2, P - 2, P))
        even_targets = gfn.mul(vals[0::2], minus_two_inv)
        odd_targets = gfn.mul(vals[1::2], minus_two_inv)
        even_interp = Polynomial.fast_modular_coset_interpolate(
            even_targets, bfe(off), modulus)
        odd_interp = Polynomial.fast_modular_coset_interpolate(
            odd_targets, bfe(off * omega % P), modulus)
        level = (n // 2).bit_length() - 1
        interpolant = (
            even_interp.multiply(pre.odd_zerofiers[level])
            + odd_interp.multiply(pre.even_zerofiers[level])
        )
        return interpolant.reduce(modulus)

    # -- extrapolation (polynomial.rs:2117-2331) ------------------------------

    @staticmethod
    def coset_extrapolate(domain_offset, codeword: Sequence, points: Sequence
                          ) -> list:
        """Extrapolate a codeword over coset `domain_offset * <omega>` to
        arbitrary points; dispatch per polynomial.rs:2117-2127, plus a
        card route (coefficient route: one row-batched iNTT on K3, then
        K6's fold, exact at every point, including points on the coset)
        when the codeword is large enough (_device_extrapolate_allowed)."""
        dev = Polynomial._try_device_coset_extrapolate(
            domain_offset, codeword, points)
        if dev is not None:
            return dev
        if len(points) < FAST_COSET_EXTRAPOLATE_THRESHOLD:
            return Polynomial._fast_coset_extrapolate(
                domain_offset, codeword, points)
        return Polynomial._naive_coset_extrapolate(
            domain_offset, codeword, points)

    @staticmethod
    def _try_device_coset_extrapolate(domain_offset, codeword, points
                                      ) -> list | None:
        """Route big extrapolations through poly_batch's coefficient route
        on ntt.DEVICE. Returns None when the host path should run instead:
        small codewords (unless forced by
        TWENTY_FIRST_TPU_EXTRAPOLATE_DEVICE=1)."""
        if not Polynomial._device_extrapolate_allowed(len(codeword)):
            return None
        cw, cx = _to_field_array(codeword)
        pts, px = _to_field_array(points)
        off = int(np.uint64(_scalar_value(domain_offset)))
        out = Polynomial._device_extrapolate_rows(off, cw[None], cx, pts, px)
        return _objs_from_array(out[0], cx or px)

    @staticmethod
    def _device_extrapolate_allowed(n: int) -> bool:
        """Gate for the card's extrapolation route: power-of-two codewords
        of >= 2^14; TWENTY_FIRST_TPU_EXTRAPOLATE_DEVICE=1/0
        forces/disables. The JAX package also asks for a non-CPU backend;
        here the route goes to ntt.DEVICE, whatever it is."""
        knob = os.environ.get("TWENTY_FIRST_TPU_EXTRAPOLATE_DEVICE")
        if knob == "0":
            return False
        if n == 0 or n & (n - 1):
            return False
        return knob == "1" or n >= (1 << 14)

    @staticmethod
    def _device_extrapolate_rows(off: int, cw_rows: np.ndarray, cx: bool,
                                 pts: np.ndarray, px: bool) -> np.ndarray:
        """One call on ntt.DEVICE for (rows, n) codewords at (m,) points.

        Both take the coefficient route (one row-batched iNTT, K3, then
        K6's fold), which is exact at every point, including points ON
        the coset, so there is no host fallback."""
        from . import poly_batch

        if px or cx:
            pts_x = pts if px else _lift3(pts)
            return poly_batch.batch_coset_extrapolate_xfe(
                cw_rows, off, pts_x, device=ntt_mod.DEVICE)
        return poly_batch.batch_coset_extrapolate(
            cw_rows, off, pts, device=ntt_mod.DEVICE)

    @staticmethod
    def _fast_coset_extrapolate(domain_offset, codeword, points) -> list:
        zerofier_tree = ZerofierTree.new_from_domain(points)
        minimal_interpolant = Polynomial.fast_modular_coset_interpolate(
            codeword, domain_offset, zerofier_tree.zerofier())
        return minimal_interpolant.divide_and_conquer_batch_evaluate(
            zerofier_tree)

    @staticmethod
    def _naive_coset_extrapolate(domain_offset, codeword, points) -> list:
        poly = Polynomial.fast_coset_interpolate(domain_offset, codeword)
        return poly.batch_evaluate(points)

    @staticmethod
    def batch_coset_extrapolate(domain_offset, codeword_length: int,
                                codewords: Sequence, points: Sequence) -> list:
        """Many codewords, one domain, shared points (flattened results);
        preprocessing shared across codewords (polynomial.rs:2188-2253)."""
        if codeword_length & (codeword_length - 1) or codeword_length == 0:
            raise PolynomialError("codeword length must be a power of two")
        cw, cx = _to_field_array(codewords)
        num = cw.shape[0] // codeword_length
        if Polynomial._device_extrapolate_allowed(codeword_length):
            pts_arr, px = _to_field_array(points)
            shape = (num, codeword_length, 3) if cx \
                else (num, codeword_length)
            rows = cw.reshape(shape)
            dev = Polynomial._device_extrapolate_rows(
                int(np.uint64(_scalar_value(domain_offset))), rows, cx,
                pts_arr, px)
            flat = dev.reshape((-1, 3) if dev.ndim == 3 else (-1,))
            return _objs_from_array(flat, cx or px)
        out: list = []
        if len(points) < FAST_COSET_EXTRAPOLATE_THRESHOLD:
            zerofier_tree = ZerofierTree.new_from_domain(points)
            modulus = zerofier_tree.zerofier()
            pre = Polynomial.fast_modular_coset_interpolate_preprocess(
                codeword_length, domain_offset, modulus)
            for i in range(num):
                piece = cw[i * codeword_length: (i + 1) * codeword_length]
                interp = Polynomial.fast_modular_coset_interpolate(
                    piece, domain_offset, modulus, preprocessed=pre)
                out.extend(
                    interp.divide_and_conquer_batch_evaluate(zerofier_tree))
            return out
        zerofier_tree = ZerofierTree.new_from_domain(points)
        shift_ntt, tail_length = \
            zerofier_tree.zerofier().shift_factor_ntt_with_tail_length()
        inv_obj = _coerce_scalar_obj(domain_offset).inverse()
        for i in range(num):
            piece = cw[i * codeword_length: (i + 1) * codeword_length]
            if cx:
                coeffs = ntt_mod.routed_ntt_values(piece.T,
                                                   inverse=True).T
            else:
                coeffs = ntt_mod.routed_ntt_values(piece, inverse=True)
            poly = Polynomial.from_array(coeffs, cx).scale(inv_obj)
            reduced = poly.reduce_by_ntt_friendly_modulus(
                shift_ntt, tail_length)
            out.extend(reduced.divide_and_conquer_batch_evaluate(
                zerofier_tree))
        return out

    par_batch_coset_extrapolate = batch_coset_extrapolate

    # -- colinearity ---------------------------------------------------------

    @staticmethod
    def are_colinear_3(p0, p1, p2) -> bool:
        (ax, ay), (bx, by), (cx, cy) = p0, p1, p2
        dy = by - ay
        dx = bx - ax
        return (cy - ay) * dx == dy * (cx - ax)

    @staticmethod
    def are_colinear(points: Sequence) -> bool:
        if len(points) < 3:
            return False
        if len({p[0] for p in points}) != len(points):
            return False
        return all(
            Polynomial.are_colinear_3(points[0], points[1], p)
            for p in points[2:]
        )

    @staticmethod
    def get_colinear_y(p0, p1, x):
        (ax, ay), (bx, by) = p0, p1
        if ax == bx:
            raise PolynomialError(
                "unique line requires distinct x-coordinates")
        return (by - ay) * (x - ax) / (bx - ax) + ay


@dataclass
class ModularInterpolationPreprocessingData:
    """Preprocessed tables for fast modular coset interpolation
    (polynomial.rs:171-184)."""

    even_zerofiers: list
    odd_zerofiers: list
    shift_coefficients: np.ndarray
    tail_length: int


def _horner_rows(coeffs: np.ndarray, ptsm: np.ndarray) -> np.ndarray:
    """Row-batched Horner: evaluate polynomial row m (coeffs (M, k)) on
    its own point row ptsm[m] ((M, t)) -> (M, t). Base field. Blocked
    above 64 coefficients (~4*sqrt(k) numpy calls instead of 2k)."""
    k = coeffs.shape[1]
    if k <= 64:
        acc = np.broadcast_to(coeffs[:, k - 1: k], ptsm.shape).copy()
        for j in range(k - 2, -1, -1):
            acc = gfn.add(gfn.mul(acc, ptsm), coeffs[:, j: j + 1])
        return acc
    nrows, t = ptsm.shape
    log_blk = (k.bit_length() + 1) // 2
    blk = 1 << log_blk
    nch = -(-k // blk)
    if nch * blk > k:
        coeffs = np.concatenate(
            [coeffs, np.zeros((nrows, nch * blk - k), dtype=np.uint64)],
            axis=1)
    cc = coeffs.reshape(nrows, nch, blk)
    acc = np.broadcast_to(cc[:, :, blk - 1][:, :, None],
                          (nrows, nch, t)).copy()
    zz = ptsm[:, None, :]
    for i in range(blk - 2, -1, -1):
        acc = gfn.add(gfn.mul(acc, zz), cc[:, :, i][:, :, None])
    pc = ptsm
    for _ in range(log_blk):
        pc = gfn.mul(pc, pc)
    res = acc[:, nch - 1]
    for j in range(nch - 2, -1, -1):
        res = gfn.add(gfn.mul(res, pc), acc[:, j])
    return res


def _batch_lagrange_tables(ptsm: np.ndarray, zrows: np.ndarray,
                           want_inv: bool = True):
    """Batched Lagrange tables for M equal-size leaf domains: synthetic-
    division quotient tensor Q[m, i, j] (coeff j of Z_m/(X - d_{m,i})) and,
    with ``want_inv``, the inverted denominators Q_{m,i}(d_{m,i}). Base
    field; the batched form of _lagrange_precompute. Callers whose
    denominators are folded into the full-zerofier derivative (the
    interpolation weight identity) pass want_inv=False and get Q alone."""
    m_, s = ptsm.shape
    q = np.zeros((m_, s, s), dtype=np.uint64)
    col = np.broadcast_to(zrows[:, s: s + 1], (m_, s)).copy()
    q[:, :, s - 1] = col
    for j in range(s - 1, 0, -1):
        col = gfn.add(np.broadcast_to(zrows[:, j: j + 1], (m_, s)),
                      gfn.mul(col, ptsm))
        q[:, :, j - 1] = col
    if not want_inv:
        return q
    acc = q[:, :, s - 1].copy()
    for j in range(s - 2, -1, -1):
        acc = gfn.add(gfn.mul(acc, ptsm), q[:, :, j])
    inv = _finv(acc.reshape(-1), False).reshape(m_, s)
    return q, inv


def _lagrange_precompute(pts: np.ndarray, x: bool
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Per-domain Lagrange tables: the synthetic-division quotient matrix
    Q[i, j] (coefficients of Z/(X - d_i)) and the inverted denominators
    Q_i(d_i). Shared across value batches (polynomial.rs:1565-1607)."""
    n = pts.shape[0]
    if n == 1:
        Q = np.ones((1, 1, 3) if x else (1, 1), dtype=np.uint64)
        if x:
            Q[0, 0] = [1, 0, 0]
        return Q, _finv(Q[:, 0].copy(), x)
    zerofier = Polynomial.zerofier(_objs_from_array(pts, x))
    z = zerofier.to_array()  # length n+1, monic
    # q_i[n-1] = z[n];  q_i[j-1] = z[j] + d_i * q_i[j], vectorized over i
    Q = np.zeros((n, n, 3) if x else (n, n), dtype=np.uint64)
    col = np.broadcast_to(z[n], pts.shape).copy()
    Q[:, n - 1] = col
    for j in range(n - 1, 0, -1):
        col = gfn.add(np.broadcast_to(z[j], pts.shape), _fmul(col, pts, x))
        Q[:, j - 1] = col
    denom = _eval_rows(Q, pts, x)
    return Q, _finv(denom, x)


def _lagrange_apply(Q: np.ndarray, inv: np.ndarray, vals: np.ndarray,
                    x: bool) -> np.ndarray:
    w = _fmul(vals, inv, x)
    if x:
        terms = xgf.mul(Q, w[:, None, :])
    else:
        terms = gfn.mul(Q, w[:, None])
    return _fsum(terms, x)


def _eval_rows(Q: np.ndarray, pts: np.ndarray, x: bool) -> np.ndarray:
    """Row-wise Horner: evaluate polynomial in row i at pts[i]."""
    n = Q.shape[1]
    acc = Q[:, n - 1].copy()
    for j in range(n - 2, -1, -1):
        acc = gfn.add(_fmul(acc, pts, x), Q[:, j])
    return acc


def _coerce_scalar_obj(v):
    if isinstance(v, (BFieldElement, XFieldElement)):
        return v
    return bfe(int(v))


def _coerce_poly(x):
    if isinstance(x, Polynomial):
        return x
    if isinstance(x, (BFieldElement, XFieldElement)):
        return Polynomial([x])
    if isinstance(x, int):
        return Polynomial([bfe(x)])
    return NotImplemented


# ---------------------------------------------------------------------------
# Barycentric evaluation of codewords (polynomial.rs:2587-2638)
# ---------------------------------------------------------------------------


def barycentric_evaluate(codeword: Sequence, indeterminate):
    """Evaluate the interpolant of a codeword over <omega> at a point using
    the barycentric formula (no interpolation):

        p(z) = [sum_i c_i * w_i / (z - d_i)] / [sum_i w_i / (z - d_i)]

    with d_i = omega^i. Requires z outside the domain."""
    cw, cx = _to_field_array(codeword)
    n = cw.shape[0]
    if n == 0 or n & (n - 1):
        raise PolynomialError("codeword length must be a power of two")
    z = _scalar_value(indeterminate)
    zx = _is_x_scalar(z)
    x = cx or zx
    domain = gfn.powers(int(ntt_mod.PRIMITIVE_ROOTS[n]) if n > 1 else 1, n)
    if zx:
        diffs = gfn.sub(np.broadcast_to(z, (n, 3)).copy(), _lift3(domain))
    else:
        diffs = gfn.sub(np.broadcast_to(z, (n,)), domain)
    inv = _finv(diffs, zx)
    if zx:
        terms_w = gfn.mul(inv, domain[:, None])
    else:
        terms_w = gfn.mul(inv, domain)
    cw_x = _lift3(cw) if (x and not cx) else cw
    tw_x = _lift3(terms_w) if (x and not zx) else terms_w
    numerator = _fsum(_fmul(cw_x, tw_x, x), x)
    denominator = _fsum(tw_x, x)
    num_obj = _obj(numerator, x)
    den_obj = _obj(denominator, x)
    return num_obj / den_obj
