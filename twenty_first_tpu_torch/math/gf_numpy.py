"""Goldilocks arithmetic on host numpy uint64 arrays: tables, oracles and
the polynomial engine's host side.

A copy of ``twenty_first_tpu/math/gf_numpy.py``: numpy has native 64-bit
integers, so the 128-bit products are formed from 32-bit halves. As there,
same-shape products, sums, differences and inverses of 16 elements and
more go through the native host core (``twenty_first_tpu_torch/native.py``,
one C pass in place of about 13 numpy passes a product) when it is loaded
and ``TWENTY_FIRST_TPU_NATIVE_HOST`` is not ``0``; the numpy forms stay the
oracle and give the same values. ``tests/test_torch_gf.py`` holds every
function against the JAX package's.
"""

from __future__ import annotations

import numpy as np

P = np.uint64(0xFFFF_FFFF_0000_0001)
EPSILON = np.uint64(0xFFFF_FFFF)
_M32 = np.uint64(0xFFFF_FFFF)
_S32 = np.uint64(32)
# below this many elements a ctypes call costs more than the numpy passes
_NATIVE_MIN = 16


def _native_binop(name: str, a: np.ndarray, b: np.ndarray):
    """``name``'s native elementwise pass over a and b, broadcast to one
    shape, or None where the numpy form should run (the core unavailable or
    switched off, tiny or unbroadcastable shapes)."""
    from .. import native

    lib = native.host_arithmetic()
    if lib is None:
        return None
    if a.shape != b.shape:
        # a broadcast copy is one numpy pass against the numpy form's ~13
        # (mul) or ~4 (add, sub)
        try:
            shape = np.broadcast_shapes(a.shape, b.shape)
        except ValueError:
            return None
        if int(np.prod(shape)) < (_NATIVE_MIN if name == "gl_mul_arrays"
                                  else 4 * _NATIVE_MIN):
            return None
        a = np.ascontiguousarray(np.broadcast_to(a, shape))
        b = np.ascontiguousarray(np.broadcast_to(b, shape))
    elif a.size < _NATIVE_MIN:
        return None
    else:
        a = np.ascontiguousarray(a)
        b = np.ascontiguousarray(b)
    out = np.empty_like(a)
    getattr(lib, name)(a.ctypes.data, b.ctypes.data, out.ctypes.data, a.size)
    return out


def _split(x):
    return x & _M32, x >> _S32


def reduce128(lo, hi):
    """Reduce lo + hi * 2^64 mod p to canonical form."""
    with np.errstate(over="ignore"):
        hi_lo, hi_hi = _split(hi)
        t = lo - hi_hi
        t = np.where(lo < hi_hi, t - EPSILON, t)
        res = t + hi_lo * EPSILON
        res = np.where(res < t, res + EPSILON, res)
        return np.where(res >= P, res - P, res)


def mul(a, b):
    """Canonical modular product of uint64 arrays (inputs may be any u64)."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    fast = _native_binop("gl_mul_arrays", a, b)
    if fast is not None:
        return fast
    with np.errstate(over="ignore"):
        a0, a1 = _split(a)
        b0, b1 = _split(b)
        ll = a0 * b0
        lh = a0 * b1
        hl = a1 * b0
        hh = a1 * b1
        # mid = lh + hl, tracking the carry (worth 2^32 at bit 32 => 2^64)
        mid = lh + hl
        midc = (mid < lh).astype(np.uint64)
        lo = ll + (mid << _S32)
        c = (lo < ll).astype(np.uint64)
        hi = hh + (mid >> _S32) + (midc << _S32) + c
    return reduce128(lo, hi)


def add(a, b):
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    fast = _native_binop("gl_add_arrays", a, b)
    if fast is not None:
        return fast
    with np.errstate(over="ignore"):
        s = a + b
        s = np.where(s < a, s + EPSILON, s)
    return np.where(s >= P, s - P, s)


def sub(a, b):
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    fast = _native_binop("gl_sub_arrays", a, b)
    if fast is not None:
        return fast
    with np.errstate(over="ignore"):
        d = a - b
        return np.where(a < b, d - EPSILON, d)


def neg(a):
    return sub(np.uint64(0), a)


def pow_scalar(base: int, e: int) -> int:
    return pow(int(base), int(e), int(P))


def inverse(a):
    """Elementwise inverse-or-zero via the fixed Goldilocks addition chain
    for x^(p-2) (b_field_element.rs:252-284). 0 -> 0. Arrays of 32 and
    more take the native zero-tolerant batch inversion where it is loaded."""
    x = np.asarray(a, dtype=np.uint64)
    if x.size >= 32:
        from .. import native

        if native.host_arithmetic() is not None:
            return native.batch_inverse_or_zero(x).reshape(x.shape)

    def nsquare(v, n):
        for _ in range(n):
            v = mul(v, v)
        return v

    bin2 = mul(mul(x, x), x)
    bin3 = mul(mul(bin2, bin2), x)
    bin6 = mul(nsquare(bin3, 3), bin3)
    bin12 = mul(nsquare(bin6, 6), bin6)
    bin24 = mul(nsquare(bin12, 12), bin12)
    bin30 = mul(nsquare(bin24, 6), bin6)
    bin31 = mul(mul(bin30, bin30), x)
    bin31_z = mul(bin31, bin31)
    bin32 = mul(mul(bin31, bin31), x)
    return mul(nsquare(bin31_z, 32), bin32)


def powers(base: int, n: int) -> np.ndarray:
    """[1, base, base^2, ..., base^(n-1)] as uint64, by chunk doubling."""
    out = np.empty(n, dtype=np.uint64)
    if n == 0:
        return out
    out[0] = 1
    filled = 1
    while filled < n:
        take = min(filled, n - filled)
        step = np.uint64(pow(int(base) % int(P), filled, int(P)))
        out[filled:filled + take] = mul(out[:take], step)
        filled += take
    return out
