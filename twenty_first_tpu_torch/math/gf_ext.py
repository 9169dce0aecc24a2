"""Extension-field arithmetic on the int64 carrier, component axis -2.

The counterpart of ``twenty_first_tpu/math/gf_ext.py``. An element of
F_p[x]/(x^3 - x + 1) rides as three base-field planes on axis -2 of a
(..., 3, n) carrier, ``n`` the minor axis, so the NTT (``math/ntt.py``)
transforms extension data unchanged (its twiddles are base-field scalars,
the reference's ``MulAssign<BFieldElement>`` bound).

The product and inverse mirror the reference's Shah-polynomial reduction
and adjugate inverse (x_field_element.rs:512-535, :370-399) in the JAX
package's order of operations. ``mul``, ``mul_base`` and the adjugate's
products go through K8's wrapper (``ops/poly_cuda.py``: the kernel on a
CUDA tensor, its twin on a CPU one), and ``inverse_or_zero`` /
``batch_inversion`` through ``gf``'s (K8's inverse, K7), unless ``plain``
asks for the plain torch forms here, which are K8's twins.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gf
from ..ops import poly_cuda

P = gf.P


def _comp(x, i):
    return x[..., i, :]


def _stack3(a, b, c):
    return torch.stack([a, b, c], dim=-2)


def from_u64(values) -> torch.Tensor:
    """Host (..., 3) uint64 xfe array -> (..., 3, n)-style carrier on the
    CPU: the trailing component axis moves to -2 (the JAX package's
    ``to_limbs``; input (n, 3) -> output (3, n))."""
    arr = np.asarray(values, dtype=np.uint64)
    arr = np.moveaxis(arr, -1, -2) if arr.ndim >= 2 else arr
    return gf.from_u64(arr)


def to_u64(x: torch.Tensor) -> np.ndarray:
    """(..., 3, n) carrier -> host (..., n, 3) uint64 (``from_limbs``)."""
    return np.moveaxis(gf.to_u64(x), -2, -1)


def to_limbs(values, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Host (..., 3) uint64 xfe array -> uint32 limb planes (lo, hi) of
    the (..., 3, n) layout on ``device`` (input (n, 3) -> planes (3, n))."""
    return gf.limbs_of(from_u64(values).to(device))


def from_limbs(x) -> np.ndarray:
    """(..., 3, n) limb planes (lo, hi) -> host (..., n, 3) uint64."""
    return np.moveaxis(gf.from_limbs(x), -2, -1)


def add(a, b):
    return gf.add(a, b)


def sub(a, b):
    return gf.sub(a, b)


def neg(a):
    return gf.neg(a)


def _bmul(a, b, plain: bool):
    """Base-field product, through K8 unless ``plain``."""
    return gf.mul(a, b) if plain else poly_cuda.gf_pointwise(a, b, "mul")


def mul(a, b, *, plain: bool = False):
    """Extension product of (..., 3, n) carriers (broadcastable)."""
    if not plain:
        return poly_cuda.gf_pointwise(a, b, "xmul")
    s0, s1, s2 = _comp(a, 0), _comp(a, 1), _comp(a, 2)
    o0, o1, o2 = _comp(b, 0), _comp(b, 1), _comp(b, 2)
    r0 = gf.sub(gf.mul(s0, o0), gf.add(gf.mul(s2, o1), gf.mul(s1, o2)))
    r1 = gf.add(gf.mul(s1, o0), gf.mul(s0, o1))
    r1 = gf.add(r1, gf.mul(s2, o1))
    r1 = gf.add(r1, gf.mul(gf.sub(s1, s2), o2))
    r2 = gf.add(gf.mul(s2, o0), gf.mul(s1, o1))
    r2 = gf.add(r2, gf.mul(gf.add(s0, s2), o2))
    return _stack3(r0, r1, r2)


def mul_base(a, b, *, plain: bool = False):
    """(..., 3, n) xfe carrier times (..., n) base-field carrier."""
    if not plain:
        return poly_cuda.gf_pointwise(a, b, "xmul_base")
    return gf.mul(a, b.unsqueeze(-2))


def lift(b):
    """(..., n) base carrier -> (..., 3, n) xfe carrier."""
    z = torch.zeros_like(b)
    return _stack3(b, z, z)


def _inverse_parts(a, plain: bool = False):
    c0, c1, c2 = _comp(a, 0), _comp(a, 1), _comp(a, 2)
    ca = gf.add(c0, c2)
    b_m_a = gf.sub(c1, c2)
    m00 = gf.sub(_bmul(ca, ca, plain), _bmul(c1, b_m_a, plain))
    m01 = gf.sub(_bmul(c1, ca, plain), _bmul(c2, b_m_a, plain))
    m02 = gf.sub(_bmul(c1, c1, plain), _bmul(c2, ca, plain))
    det = gf.sub(gf.add(_bmul(c0, m00, plain), _bmul(c2, m01, plain)),
                 _bmul(c1, m02, plain))
    return m00, gf.neg(m01), m02, det


def inverse_or_zero(a, *, plain: bool = False):
    """Elementwise inverse of (..., 3, n) xfe carriers; 0 -> 0."""
    i0, i1, i2, det = _inverse_parts(a, plain)
    det_inv = gf.inverse_or_zero(det, plain=plain)
    return mul_base(_stack3(i0, i1, i2), det_inv, plain=plain)


def batch_inversion(a, axis: int = -1, *, plain: bool = False):
    """Batch inversion along the lane axis: ONE base-field batch inversion
    of the determinants (K7 on the card), then the adjugates times it."""
    i0, i1, i2, det = _inverse_parts(a, plain)
    det_inv = gf.batch_inversion(det, axis=axis, plain=plain)
    return mul_base(_stack3(i0, i1, i2), det_inv, plain=plain)
