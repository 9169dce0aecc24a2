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
CUDA kernels (``csrc/goldilocks.cuh``) are held against.
"""

from __future__ import annotations

import numpy as np
import torch

from .b_field_element import P

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


def to_montgomery(a):
    """canonical v -> canonical Montgomery representative v * 2^64 mod p."""
    return mul_const(a, R)


def from_montgomery(m):
    """Montgomery representative (ANY u64) -> canonical m * 2^-64 mod p."""
    return mul_const(m, R_INV)
