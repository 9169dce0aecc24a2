"""Goldilocks field arithmetic, p = 2^64 - 2^32 + 1, in plain torch.

An element is an int64 tensor holding the bit pattern of its canonical
u64 value (values above 2^63 read as negative). Every operation works on
any device, elementwise, with wrapping int64 arithmetic; unsigned
comparisons flip the sign bit first. Nothing here is shared with the
program under test.
"""

from __future__ import annotations

import numpy as np
import torch

P = (1 << 64) - (1 << 32) + 1
GENERATOR = 7
M32 = 0xFFFF_FFFF
EPSILON = M32  # 2^64 mod p
_SIGN = -(1 << 63)


def as_int64(value: int) -> int:
    """A u64 value as the int64 with the same bits."""
    value %= 1 << 64
    return value - (1 << 64) if value >= 1 << 63 else value


def from_u64(values) -> torch.Tensor:
    """uint64 numpy values (or ints) -> int64 carrier tensor on the CPU."""
    arr = np.ascontiguousarray(np.asarray(values, dtype=np.uint64))
    return torch.from_numpy(arr.view(np.int64).copy())


def to_u64(x: torch.Tensor) -> np.ndarray:
    """int64 carrier tensor -> uint64 numpy array on the host."""
    return x.detach().cpu().numpy().view(np.uint64)


def _shr(x, k: int):
    """Logical right shift of the u64 bit pattern."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _ult(a, b):
    """a < b as unsigned 64-bit words."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def canonical(x):
    """Any u64 word -> its canonical representative in [0, p)."""
    return torch.where((x ^ _SIGN) < (as_int64(P) ^ _SIGN), x, x + EPSILON)


def add(a, b):
    s = a + b
    s = torch.where(_ult(s, a), s + EPSILON, s)  # carry: 2^64 = eps mod p
    return canonical(s)


def sub(a, b):
    d = a - b
    return torch.where(_ult(a, b), d - EPSILON, d)  # borrow: add p


def reduce128(lo, hi):
    """(hi * 2^64 + lo) mod p for u64 words lo, hi; canonical."""
    hi_lo, hi_hi = hi & M32, _shr(hi, 32)
    t0 = lo - hi_hi  # 2^96 = -1 mod p
    t0 = torch.where(_ult(lo, hi_hi), t0 - EPSILON, t0)
    t1 = (hi_lo << 32) - hi_lo  # hi_lo * (2^32 - 1) < 2^64
    s = t0 + t1
    s = torch.where(_ult(s, t1), s + EPSILON, s)
    return canonical(s)


def mul(a, b):
    """a * b mod p for any u64 words a, b (canonical or not)."""
    a0, a1 = a & M32, _shr(a, 32)
    b0, b1 = b & M32, _shr(b, 32)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1  # wrap as u64
    mid = _shr(p00, 32) + (p01 & M32) + (p10 & M32)  # < 3 * 2^32
    lo = (p00 & M32) | (mid << 32)
    hi = p11 + _shr(p01, 32) + _shr(p10, 32) + _shr(mid, 32)
    return reduce128(lo, hi)


def pow_int(base: int, exp: int) -> int:
    return pow(base % P, exp, P)


def inverse_int(x: int) -> int:
    if x % P == 0:
        raise ZeroDivisionError("0 has no inverse")
    return pow(x, P - 2, P)


def scalar(value: int, like: torch.Tensor) -> torch.Tensor:
    """The field element ``value`` as a 0-d carrier on ``like``'s device."""
    return torch.tensor(as_int64(value % P), dtype=torch.int64,
                        device=like.device)


def powers(base: int, n: int, device) -> torch.Tensor:
    """(n,) carriers base^0 .. base^(n-1), by repeated doubling of a prefix
    on ``device``."""
    out = torch.ones(n, dtype=torch.int64, device=device)
    filled, step = 1, base % P
    while filled < n:
        take = min(filled, n - filled)
        out[filled:filled + take] = mul(out[:take],
                                        torch.full((take,), as_int64(step),
                                                   dtype=torch.int64,
                                                   device=device))
        filled += take
        step = step * step % P
    return out


def random_elements(shape, generator: torch.Generator, device,
                    block: int = 1 << 26) -> torch.Tensor:
    """Uniform canonical elements from ``generator``, drawn on ``device``
    as two 32-bit halves, ``block`` elements at a time (so the draw's
    temporaries stay small beside a large output); a word of p or more
    (high half 2^32 - 1, low half above 0) is reduced to lo - 1."""
    out = torch.empty(shape, dtype=torch.int64, device=device)
    flat = out.view(-1)
    for start in range(0, flat.numel(), block):
        part = flat[start:start + block]
        hi = torch.randint(0, 1 << 32, part.shape, generator=generator,
                           device=device, dtype=torch.int64)
        lo = torch.randint(0, 1 << 32, part.shape, generator=generator,
                           device=device, dtype=torch.int64)
        over = (hi == M32) & (lo > 0)
        part.copy_(torch.where(over, lo - 1, (hi << 32) | lo))
    return out
