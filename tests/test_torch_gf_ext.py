"""The port's extension field (twenty_first_tpu_torch.math.gf_ext and the
host copy math/xgf_numpy) against the JAX package's, exactly: integer
field arithmetic, so the tolerance is 0.

The port's carrier keeps JAX's layout, components on axis -2; inputs are
made with numpy and reach JAX through its limb converters. On the CPU the
K8 wrapper takes its plain twin, so each case also holds the twin
(``plain=True``) against the wrapper."""

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu.math import gf as jgf
from twenty_first_tpu.math import gf_ext as jgfe
from twenty_first_tpu.math import xgf_numpy as jxgf
from twenty_first_tpu.math.b_field_element import P
from twenty_first_tpu_torch.math import gf, gf_ext
from twenty_first_tpu_torch.math import xgf_numpy as txgf
from twenty_first_tpu_torch.ops import poly_cuda

EDGES = [0, 1, P - 1, 1 << 32, (1 << 32) - 1]


def _xfe(seed: int, n: int):
    """(n, 3) host xfe values; the first rows (up to 25) pair the edge
    words."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, P, size=(n, 3), dtype=np.uint64)
    e = np.array(EDGES, dtype=np.uint64)
    k = min(n, 25)
    v[:k, 0], v[:k, 1] = np.repeat(e, 5)[:k], np.tile(e, 5)[:k]
    v[:min(n, 5), 2] = e[:min(n, 5)]
    return v


def _jax(fn, *args):
    return jgfe.from_limbs(fn(*(jgfe.to_limbs(a) for a in args)))


def _port(fn, *args):
    return gf_ext.to_u64(fn(*(gf_ext.from_u64(a) for a in args)))


def test_carrier_layout_equals_jax_limbs():
    v = _xfe(1, 40).reshape(2, 20, 3)
    lo, hi = jgfe.to_limbs(v)
    t = gf_ext.from_u64(v)
    assert t.shape == (2, 3, 20)
    np.testing.assert_array_equal(gf.to_jax_limbs(t)[0], np.asarray(lo))
    np.testing.assert_array_equal(gf.to_jax_limbs(t)[1], np.asarray(hi))
    np.testing.assert_array_equal(gf_ext.to_u64(t), v)


@pytest.mark.parametrize("name", ["add", "sub", "mul"])
def test_binary_ops_match_jax(name):
    a, b = _xfe(2, 200), _xfe(3, 200)[::-1].copy()
    want = _jax(getattr(jgfe, name), a, b)
    np.testing.assert_array_equal(_port(getattr(gf_ext, name), a, b), want)
    if name == "mul":
        np.testing.assert_array_equal(
            _port(lambda x, y: gf_ext.mul(x, y, plain=True), a, b), want)
        np.testing.assert_array_equal(want, jxgf.mul(a, b))


def test_mul_broadcasts_a_row_over_rows():
    a = _xfe(4, 60).reshape(3, 20, 3)
    b = _xfe(5, 20)
    want = jxgf.mul(a, b[None])
    got = gf_ext.to_u64(gf_ext.mul(gf_ext.from_u64(a), gf_ext.from_u64(b)))
    np.testing.assert_array_equal(got, want)


def test_neg_and_lift_match_jax():
    a = _xfe(6, 100)
    np.testing.assert_array_equal(_port(gf_ext.neg, a), _jax(jgfe.neg, a))
    b = np.random.default_rng(7).integers(0, P, size=(2, 30), dtype=np.uint64)
    want = jgfe.from_limbs(jgfe.lift(jgf.to_limbs(b)))
    np.testing.assert_array_equal(gf_ext.to_u64(gf_ext.lift(gf.from_u64(b))),
                                  want)


def test_mul_base_matches_jax():
    a = _xfe(8, 120).reshape(2, 60, 3)
    b = np.random.default_rng(9).integers(0, P, size=(2, 60), dtype=np.uint64)
    b[0, :5] = EDGES
    want = jgfe.from_limbs(jgfe.mul_base(jgfe.to_limbs(a), jgf.to_limbs(b)))
    ta, tb = gf_ext.from_u64(a), gf.from_u64(b)
    for plain in (False, True):
        np.testing.assert_array_equal(
            gf_ext.to_u64(gf_ext.mul_base(ta, tb, plain=plain)), want)
    np.testing.assert_array_equal(want, jxgf.mul_base(a, b))


def test_inverse_or_zero_matches_jax():
    a = _xfe(10, 64)
    a[7] = 0  # the zero element -> 0
    want = _jax(jgfe.inverse_or_zero, a)
    np.testing.assert_array_equal(_port(gf_ext.inverse_or_zero, a), want)
    np.testing.assert_array_equal(
        _port(lambda x: gf_ext.inverse_or_zero(x, plain=True), a), want)
    np.testing.assert_array_equal(want, jxgf.inverse(a))
    assert not want[7].any()


@pytest.mark.parametrize("axis", [0, -1])
def test_batch_inversion_matches_jax(axis):
    """Along the lane axis and along the leading one; a lane holding a zero
    element comes out all zeros."""
    a = _xfe(11, 96).reshape(4, 24, 3)
    a[1, 5] = 0
    want = _jax(lambda x: jgfe.batch_inversion(x, axis=axis), a)
    np.testing.assert_array_equal(
        _port(lambda x: gf_ext.batch_inversion(x, axis=axis), a), want)
    np.testing.assert_array_equal(
        _port(lambda x: gf_ext.batch_inversion(x, axis=axis, plain=True), a),
        want)
    zero_lane = want[1] if axis == -1 else want[:, 5]
    assert not zero_lane.any()


@pytest.mark.parametrize("name", ["add", "sub", "mul", "mul_base", "lift",
                                  "neg", "inverse"])
def test_xgf_numpy_copy_equals_jax(name):
    """The host copy on random and edge words (JAX's takes its native route
    where it is built)."""
    a, b = _xfe(12, 300), _xfe(13, 300)
    scalars = a[:, 1].copy()
    args = {"add": (a, b), "sub": (a, b), "mul": (a, b),
            "mul_base": (a, scalars), "lift": (scalars,), "neg": (a,),
            "inverse": (a,)}[name]
    np.testing.assert_array_equal(getattr(txgf, name)(*args),
                                  getattr(jxgf, name)(*args))


def test_k8_wrapper_rejects_bad_operands():
    x = gf_ext.from_u64(_xfe(14, 8))
    with pytest.raises(ValueError):
        poly_cuda.gf_pointwise(x, x[..., :4], "xmul")  # lengths differ
    with pytest.raises(ValueError):
        poly_cuda.gf_pointwise(x[:2], x[:2], "xmul")  # no component axis
    with pytest.raises(ValueError):
        poly_cuda.gf_pointwise(x, None, "mul")
    with pytest.raises(ValueError):
        poly_cuda.gf_pointwise(x, x, "div")
    with pytest.raises(ValueError):
        poly_cuda.gf_pointwise(x, x.to(torch.int32), "mul")
