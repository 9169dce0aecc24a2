"""Goldilocks field (p = 2^64 - 2^32 + 1) arithmetic on the int64 carrier.

The counterpart of ``twenty_first_tpu/math/gf.py``. A field element is an
int64 tensor element holding the u64 bit pattern of a canonical residue in
[0, p). PyTorch has no usable unsigned 64-bit arithmetic on the CPU (no
add, shift, compare or ``%`` on uint64) and its int64 ``>>`` is arithmetic,
so this module

* adds, subtracts and multiplies in int64, which wraps mod 2^64 like u64;
* compares unsigned by flipping the sign bit first (``_ult``);
* shifts right logically by masking after the arithmetic shift (``_shr``);
* forms 64x64 -> 128-bit products from 32-bit halves (``mul_wide``).

Every function is plain torch on any device: it is the plain twin that the
CUDA kernels (``csrc/goldilocks.cuh``) are held against. The two
exceptions are ``inverse_or_zero`` and ``batch_inversion``, which go
through the wrappers of K8 and K7 (``ops/poly_cuda.py``: the kernel on a
CUDA tensor, the twin on a CPU one) unless ``plain`` asks for their twins
here. The JAX package's u32 limb helpers (``mul32``, ``add64``,
``mul64_wide``, ...) are at the end with its names, taking and returning
uint32 planes and computing through the carrier.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .b_field_element import GENERATOR, MAX, P  # noqa: F401

P_LO = np.uint32(P & 0xFFFF_FFFF)  # 0x0000_0001
P_HI = np.uint32(P >> 32)  # 0xFFFF_FFFF
# Montgomery radix residue and its inverse: Tip5's S-box is *specified* on
# the byte decomposition of the Montgomery representative x * 2^64 mod p.
R = (1 << 64) % P  # == 2^32 - 1
R_INV = pow(1 << 64, -1, P)  # 2^-64 mod p

EPSILON = (1 << 32) - 1  # 2^64 mod p
_M32 = 0xFFFF_FFFF
_SIGN = -(1 << 63)
_P_I64 = P - (1 << 64)  # p's bit pattern as an int64


def to_i64(value: int) -> int:
    """The int64 holding the bit pattern of a u64 python int."""
    value &= (1 << 64) - 1
    return value - (1 << 64) if value >> 63 else value


# ---------------------------------------------------------------------------
# Carrier conversions
# ---------------------------------------------------------------------------


def from_u64(values) -> torch.Tensor:
    """numpy uint64 (or python ints) -> int64 carrier tensor on the CPU."""
    arr = np.ascontiguousarray(np.asarray(values, dtype=np.uint64))
    return torch.from_numpy(arr.view(np.int64).copy())


def to_u64(x: torch.Tensor) -> np.ndarray:
    """int64 carrier tensor (any device) -> numpy uint64."""
    return x.detach().cpu().contiguous().numpy().view(np.uint64).copy()


def from_jax_limbs(limbs) -> torch.Tensor:
    """The JAX package's u32 limb planes ``(lo, hi)`` -> int64 carrier."""
    lo, hi = limbs
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    return from_u64(lo | (hi << np.uint64(32)))


def to_jax_limbs(x: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """int64 carrier -> numpy u32 limb planes ``(lo, hi)`` as the JAX
    package's ``gf.to_limbs`` lays them out."""
    v = to_u64(x)
    return ((v & np.uint64(_M32)).astype(np.uint32),
            (v >> np.uint64(32)).astype(np.uint32))


# The JAX package's limb API: a field array as two uint32 planes (lo, hi).
# Here the planes are uint32 tensors on a named device, converted to and
# from the int64 carrier at the seam; no kernel takes them.


def limbs_of(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 carrier -> uint32 planes (lo, hi) on its device."""
    return ((x & _M32).to(torch.uint32),
            ((x >> 32) & _M32).to(torch.uint32))


def carrier_of(limbs) -> torch.Tensor:
    """uint32 planes (lo, hi) -> int64 carrier on their device."""
    lo, hi = limbs
    return lo.to(torch.int64) | (hi.to(torch.int64) << 32)


def to_limbs(values, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Host integers (array-like of python ints or np.uint64) -> uint32
    limb planes (lo, hi) on ``device``."""
    return limbs_of(from_u64(values).to(device))


def from_limbs(x) -> np.ndarray:
    """Limb planes (lo, hi), tensors on any device or arrays -> a host
    np.uint64 array."""
    lo, hi = (np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v,
                         dtype=np.uint64) for v in x)
    return lo | (hi << np.uint64(32))


def const_limbs(value: int):
    """A python-int constant as uint32 scalar limbs (lo, hi)."""
    return np.uint32(value & _M32), np.uint32((value >> 32) & _M32)


def full_like(x: torch.Tensor, value: int) -> torch.Tensor:
    return torch.full_like(x, to_i64(value % P))


# ---------------------------------------------------------------------------
# Unsigned helpers
# ---------------------------------------------------------------------------


def _ult(a, b):
    """Unsigned a < b on u64 bit patterns held in int64."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _shr(x, k: int):
    """Logical right shift of a u64 bit pattern by 0 < k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


# ---------------------------------------------------------------------------
# Field operations (canonical in -> canonical out unless stated)
# ---------------------------------------------------------------------------


def canon(x):
    """Canonicalize any u64 residue: one conditional subtract of p (valid
    for every x < 2^64, because 2^64 < 2p)."""
    return torch.where(_ult(x, _P_I64), x, x - _P_I64)


def add(a, b):
    s = a + b
    # a 64-bit wrap lost 2^64 == EPSILON (mod p); s + EPSILON cannot wrap
    s = torch.where(_ult(s, a), s + EPSILON, s)
    return canon(s)


def sub(a, b):
    d = a - b
    # a borrow added 2^64 == EPSILON (mod p); d - EPSILON cannot borrow
    return torch.where(_ult(a, b), d - EPSILON, d)


def neg(a):
    return sub(torch.zeros_like(a), a)


def mul_wide(a, b):
    """Full 128-bit product of two u64 patterns -> (lo, hi) u64 patterns."""
    a0, a1 = a & _M32, _shr(a, 32)
    b0, b1 = b & _M32, _shr(b, 32)
    p00 = a0 * b0  # each partial product < 2^64: exact mod 2^64
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = _shr(p00, 32) + (p01 & _M32) + (p10 & _M32)  # < 3 * 2^32
    lo = (p00 & _M32) | (mid << 32)
    hi = p11 + _shr(p01, 32) + _shr(p10, 32) + (mid >> 32)
    return lo, hi


def reduce128(lo, hi):
    """lo + hi * 2^64 mod p, canonical. With hi = hh * 2^32 + hl, 2^64 ==
    2^32 - 1 and 2^96 == -1 (mod p) give lo + hl * (2^32 - 1) - hh."""
    hh, hl = _shr(hi, 32), hi & _M32
    t = lo - hh
    t = torch.where(_ult(lo, hh), t - EPSILON, t)
    m = (hl << 32) - hl
    r = t + m
    r = torch.where(_ult(r, m), r + EPSILON, r)
    return canon(r)


def mul(a, b):
    """Modular product; inputs may be any u64 patterns, output canonical."""
    return reduce128(*mul_wide(a, b))


def square(a):
    return mul(a, a)


# ---------------------------------------------------------------------------
# Lazy (non-canonical) forms: any u64 residue in, a u64 residue out. Each
# reproduces the JAX package's representative bit for bit (its limb-plane
# steps, read as u64 arithmetic mod 2^64), so a chain of them returns the
# same raw words as ``twenty_first_tpu.math.gf`` does.
# ---------------------------------------------------------------------------


def reduce128_lazy(lo, hi):
    """``reduce128`` without the final canonicalisation: a u64 residue of
    lo + hi * 2^64. Both EPSILON fix-ups wrap mod 2^64 as in JAX."""
    hh, hl = _shr(hi, 32), hi & _M32
    t = lo - hh
    t = torch.where(_ult(lo, hh), t - EPSILON, t)
    m = (hl << 32) - hl
    r = t + m
    return torch.where(_ult(r, m), r + EPSILON, r)


def mul_lazy(a, b):
    """Modular product of any u64 residues, u64 residue out."""
    return reduce128_lazy(*mul_wide(a, b))


def add_lazy(a, b):
    """Modular sum of any u64 residues: a 64-bit wrap adds EPSILON, and a
    second EPSILON when the wrapped sum is >= p (k wraps in one pass)."""
    s = a + b
    wrap = _ult(s, a)
    k = wrap.to(s.dtype) + (wrap & ~_ult(s, _P_I64)).to(s.dtype)
    return s + k * EPSILON


def sub_lazy(a, b):
    """Modular difference of any u64 residues: a borrow subtracts EPSILON,
    and a second EPSILON when the difference is below EPSILON."""
    d = a - b
    borrow = _ult(a, b)
    k = borrow.to(d.dtype) + (borrow & _ult(d, EPSILON)).to(d.dtype)
    return d - k * EPSILON


class _ShiftRangeError(ValueError, AssertionError):
    """A shift outside 1..95. The JAX package asserts the range, so callers
    of either package catch this as an AssertionError or a ValueError."""


def mul_by_pow2_lazy(a, e: int, negate: bool = False):
    """a * (+-2^e) for 0 < e < 96, a lazy residue out, from the shifted
    32-bit words of a folded as the JAX package folds them (the 2^128 word
    by 2^128 == -2^32)."""
    if not 0 < e < 96:
        raise _ShiftRangeError(f"shift must be 1..95, got {e}")
    lo, hi = a & _M32, _shr(a, 32)
    zero = torch.zeros_like(a)
    q, r = divmod(e, 32)
    if r == 0:
        shifted = [lo, hi]
    else:
        shifted = [(lo << r) & _M32, ((hi << r) | (lo >> (32 - r))) & _M32,
                   hi >> (32 - r)]
    words = ([zero] * q + shifted + [zero] * 3)[:4]
    out = reduce128_lazy(words[0] | (words[1] << 32),
                         words[2] | (words[3] << 32))
    if q == 2 and r != 0:
        out = sub_lazy(out, shifted[2] << 32)
    if negate:
        out = sub_lazy(zero, out)
    return out


def mul_by_i_lazy(a, inverse: bool = False):
    """a * i with i = omega_4 = 2^48; i^-1 = -2^48 (2^96 == -1 mod p)."""
    return mul_by_pow2_lazy(a, 48, negate=inverse)


def mul_const(a, k: int):
    """Multiply by a python-int constant (canonical output)."""
    return mul(a, full_like(a, k))


def pow_const(a, e: int):
    """a ** e for a non-negative python-int exponent (square and multiply)."""
    result = full_like(a, 1)
    base = a
    while e:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result


def _nsquare(x, n: int):
    for _ in range(n):
        x = square(x)
    return x


def inverse_or_zero(a, *, plain: bool = False):
    """Elementwise inverse by the fixed addition chain for x^(p-2) (the JAX
    package's ``gf.inverse_or_zero``, :444); 0 -> 0. Through K8's wrapper
    unless ``plain`` asks for the chain here, its twin."""
    if not plain:
        from ..ops import poly_cuda

        return poly_cuda.gf_pointwise(a, None, "inv")
    x = a
    bin2 = mul(square(x), x)  # x^(2^2 - 1)
    bin3 = mul(square(bin2), x)  # x^(2^3 - 1)
    bin6 = mul(_nsquare(bin3, 3), bin3)
    bin12 = mul(_nsquare(bin6, 6), bin6)
    bin24 = mul(_nsquare(bin12, 12), bin12)
    bin30 = mul(_nsquare(bin24, 6), bin6)
    bin31 = mul(square(bin30), x)
    bin31_z = square(bin31)
    bin32 = mul(square(bin31), x)
    return mul(_nsquare(bin31_z, 32), bin32)


def batch_inversion(x, axis: int = -1, *, plain: bool = False):
    """Montgomery batch inversion along ``axis`` (the JAX package's
    ``gf.batch_inversion``, :503): one inverse per lane of the other axes.
    A lane holding a 0 comes out all zeros (its product's inverse is 0).
    Through K7's wrapper unless ``plain`` asks for its twin here, JAX's
    prefix-product form (Hillis-Steele scans both ways)."""
    lanes = torch.movedim(x, axis, -1)
    if not plain:
        from ..ops import poly_cuda

        rows = lanes.reshape(-1, lanes.shape[-1])
        res = poly_cuda.batch_inversion(rows).view(lanes.shape)
        return torch.movedim(res, -1, axis)
    pre = _prefix_prod(lanes)
    inv_total = inverse_or_zero(pre[..., -1:], plain=True)
    suf = torch.flip(_prefix_prod(torch.flip(lanes, (-1,))), (-1,))
    one = torch.ones_like(lanes[..., :1])
    pre_excl = torch.cat([one, pre[..., :-1]], -1)
    suf_excl = torch.cat([suf[..., 1:], one], -1)
    res = mul(mul(pre_excl, suf_excl), inv_total)
    return torch.movedim(res, -1, axis)


def _prefix_prod(x):
    """Inclusive prefix product along the last axis (Hillis-Steele,
    log-depth), as the JAX package's ``gf._prefix_prod`` (:544)."""
    n = x.shape[-1]
    shift = 1
    while shift < n:
        shifted = torch.cat([torch.ones_like(x[..., :shift]),
                             x[..., :-shift]], -1)
        x = mul(x, shifted)
        shift *= 2
    return x


def to_montgomery(a):
    """canonical v -> canonical Montgomery representative v * 2^64 mod p."""
    return mul_const(a, R)


def from_montgomery(m):
    """Montgomery representative (ANY u64) -> canonical m * 2^-64 mod p."""
    return mul_const(m, R_INV)


# ---------------------------------------------------------------------------
# The JAX package's u32 limb helpers: 64-bit arithmetic on (lo, hi) uint32
# planes, which it needs because the TPU's lanes are 32 bits wide. Here they
# take and return uint32 tensors at the seam and compute through the int64
# carrier (the CPU torch has no uint32 add, compare or shift).
# ---------------------------------------------------------------------------


def _u32(x) -> torch.Tensor:
    """The low 32 bits of an int64 tensor as a uint32 tensor."""
    return (x & _M32).to(torch.uint32)


def _words(x) -> tuple:
    """A 128-bit (lo, hi) pair of u64 patterns -> four uint32 words,
    little-endian."""
    lo, hi = x
    return _u32(lo), _u32(_shr(lo, 32)), _u32(hi), _u32(_shr(hi, 32))


def mul32(a, b):
    """Full 32x32 -> 64-bit product of uint32 planes as (lo, hi) uint32."""
    return limbs_of(a.to(torch.int64) * b.to(torch.int64))


def add64(a, b):
    """(a + b) mod 2^64 of (lo, hi) pairs, with the carry-out (uint32 0/1)."""
    x = carrier_of(a)
    s = x + carrier_of(b)
    return limbs_of(s), _ult(s, x).to(torch.uint32)


def sub64(a, b):
    """(a - b) mod 2^64 of (lo, hi) pairs, with the borrow-out (uint32
    0/1)."""
    x, y = carrier_of(a), carrier_of(b)
    return limbs_of(x - y), _ult(x, y).to(torch.uint32)


def mul64_wide(a, b):
    """Full 64x64 -> 128-bit product of (lo, hi) pairs as four uint32 words
    (x0, x1, x2, x3)."""
    return _words(mul_wide(carrier_of(a), carrier_of(b)))


def mul_u32(a, b):
    """Modular product of (lo, hi) pairs holding any u64 residues,
    canonical (lo, hi) out."""
    return limbs_of(mul(carrier_of(a), carrier_of(b)))


def mul_lazy_u32(a, b):
    """``mul_lazy`` on (lo, hi) pairs: the JAX package's lazy residue."""
    return limbs_of(mul_lazy(carrier_of(a), carrier_of(b)))


@contextlib.contextmanager
def u32_ops():
    """The JAX package's switch to its pure-u32 limb forms inside Pallas
    kernels (Mosaic has no 64-bit integers). The port has one form of each
    operation, the carrier's, and its kernels are CUDA: the context changes
    nothing here and is kept so that code written for the JAX package
    runs."""
    yield
