"""Vectorized extension-field arithmetic on host (numpy uint64, (..., 3)).

F_p[x]/(x^3 - x + 1) with p the Goldilocks prime. Component axis is the
LAST axis (size 3), matching XFieldElement.coefficients order (c0, c1, c2).
A copy of ``twenty_first_tpu/math/xgf_numpy.py``, whose same-shape
products of 16 elements and more go through the native host core as
``gf_numpy``'s do (``_native_mul``). The product and inverse mirror the
reference's Shah-polynomial reduction and adjugate inverse
(x_field_element.rs:512-535, :370-399). ``tests/test_torch_gf_ext.py``
holds every function against the JAX package's.
"""

from __future__ import annotations

import numpy as np

from . import gf_numpy as gfn

P = gfn.P


def add(a, b):
    return gfn.add(a, b)


def sub(a, b):
    return gfn.sub(a, b)


def neg(a):
    return gfn.neg(a)


def _native_mul(a: np.ndarray, b: np.ndarray):
    """(..., 3) products in one native pass over the interleaved
    components (x_field_element.rs:512-535), or None where the numpy form
    should run (the core unavailable or switched off, broadcasting leading
    dims, tiny arrays)."""
    if a.shape != b.shape or a.shape[-1:] != (3,) or a.size < 48:
        return None
    from .. import native

    lib = native.host_arithmetic()
    if lib is None:
        return None
    ac, bc = np.ascontiguousarray(a), np.ascontiguousarray(b)
    out = np.empty_like(ac)
    lib.gl_xfe_mul_arrays(ac.ctypes.data, bc.ctypes.data, out.ctypes.data,
                          ac.size // 3)
    return out


def mul(a, b):
    """(..., 3) x (..., 3) -> (..., 3), broadcastable leading dims."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    fast = _native_mul(a, b)
    if fast is not None:
        return fast
    s0, s1, s2 = a[..., 0], a[..., 1], a[..., 2]
    o0, o1, o2 = b[..., 0], b[..., 1], b[..., 2]
    # r0 = s0*o0 - s2*o1 - s1*o2
    r0 = gfn.sub(gfn.mul(s0, o0),
                 gfn.add(gfn.mul(s2, o1), gfn.mul(s1, o2)))
    # r1 = s1*o0 + s0*o1 - s2*o2 + s2*o1 + s1*o2
    r1 = gfn.add(gfn.mul(s1, o0), gfn.mul(s0, o1))
    r1 = gfn.add(r1, gfn.mul(s2, o1))
    r1 = gfn.add(r1, gfn.mul(gfn.sub(s1, s2), o2))
    # r2 = s2*o0 + s1*o1 + s0*o2 + s2*o2
    r2 = gfn.add(gfn.mul(s2, o0), gfn.mul(s1, o1))
    r2 = gfn.add(r2, gfn.mul(gfn.add(s0, s2), o2))
    return np.stack([r0, r1, r2], axis=-1)


def mul_base(a, b):
    """(..., 3) xfe times (...) base-field scalar array."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    return gfn.mul(a, b[..., None])


def lift(b):
    """(...) base-field -> (..., 3) with zero high components."""
    b = np.asarray(b, dtype=np.uint64)
    out = np.zeros(b.shape + (3,), dtype=np.uint64)
    out[..., 0] = b
    return out


def _inverse_parts(a):
    c0, c1, c2 = a[..., 0], a[..., 1], a[..., 2]
    ca = gfn.add(c0, c2)
    b_m_a = gfn.sub(c1, c2)
    m00 = gfn.sub(gfn.mul(ca, ca), gfn.mul(c1, b_m_a))
    m01 = gfn.sub(gfn.mul(c1, ca), gfn.mul(c2, b_m_a))
    m02 = gfn.sub(gfn.mul(c1, c1), gfn.mul(c2, ca))
    det = gfn.sub(
        gfn.add(gfn.mul(c0, m00), gfn.mul(c2, m01)),
        gfn.mul(c1, m02),
    )
    return m00, gfn.neg(m01), m02, det


def inverse(a):
    """Elementwise inverse-or-zero of (..., 3) extension elements."""
    a = np.asarray(a, dtype=np.uint64)
    i0, i1, i2, det = _inverse_parts(a)
    det_inv = gfn.inverse(det)
    return np.stack(
        [gfn.mul(i0, det_inv), gfn.mul(i1, det_inv), gfn.mul(i2, det_inv)],
        axis=-1,
    )
