"""The number-theoretic transform and the coset low-degree extension, as a
textbook radix-2 transform in plain torch (goldilocks.py's arithmetic).

ntt(x)[k] = sum_j x[j] w^(jk) along the last axis, natural order in and out,
with w = 7^((p - 1) / n), the field generator's power of order n; intt is
its inverse (w^-1, then 1/n). Every twiddle is worked out here.
"""

from __future__ import annotations

import torch

from . import goldilocks as gl


def root_of_unity(n: int) -> int:
    if n & (n - 1) or not 1 <= n <= 1 << 32:
        raise ValueError(f"no root of unity of order {n}")
    return gl.pow_int(gl.GENERATOR, (gl.P - 1) // n)


def _bit_reverse_index(n: int, device) -> torch.Tensor:
    log_n = n.bit_length() - 1
    idx = torch.arange(n, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def _transform(x: torch.Tensor, root: int) -> torch.Tensor:
    """Decimation in time: bit-reversed input, natural output."""
    n = x.shape[-1]
    if n == 1:
        return x.clone()
    lead = x.shape[:-1]
    x = x[..., _bit_reverse_index(n, x.device)]
    tw = gl.powers(root, n // 2, x.device)  # w^0 .. w^(n/2 - 1)
    half = 1
    while half < n:
        blocks = x.reshape(*lead, n // (2 * half), 2, half)
        u, v = blocks[..., 0, :], blocks[..., 1, :]
        v = gl.mul(v, tw[::n // (2 * half)])
        x = torch.stack([gl.add(u, v), gl.sub(u, v)], dim=-2).reshape(*lead, n)
        half *= 2
    return x


def ntt(x: torch.Tensor) -> torch.Tensor:
    return _transform(x, root_of_unity(x.shape[-1]))


def intt(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    out = _transform(x, gl.inverse_int(root_of_unity(n)))
    return gl.mul(out, gl.scalar(gl.inverse_int(n), out))


def coset_lde(trace: torch.Tensor, expansion: int, offset: int) -> torch.Tensor:
    """(W, n) values on the order-n subgroup -> (W, expansion * n) values of
    the same polynomials on offset * <w_(expansion * n)>: interpolate,
    scale coefficient j by offset^j, zero-pad, evaluate."""
    w, n = trace.shape
    coeffs = gl.mul(intt(trace), gl.powers(offset, n, trace.device))
    padded = torch.zeros((w, expansion * n), dtype=torch.int64,
                         device=trace.device)
    padded[:, :n] = coeffs
    return ntt(padded)
