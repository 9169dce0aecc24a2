"""The port's polynomial engine (twenty_first_tpu_torch.math.polynomial,
field_list, the polynomial methods of x_field_element) against the JAX
package's, exactly: ring operations in both fields and mixed, division,
reduction, power series, evaluation, barycentric evaluation, the carry
format, the public surface and the card route.

Each case runs twice on the port's side: on its default host routes, and
on the card's routes with the crossovers forced to 0, ``ntt.DEVICE`` set
to "cpu" (so the kernels' plain twins compute) and the extrapolation knob
set for the port's calls only. The JAX side stays on its host path (no
jit, no eager device extrapolation).
"""

import contextlib
import inspect
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu import errors as jerr
from twenty_first_tpu.math import field_list as jfl
from twenty_first_tpu.math import ntt as jntt
from twenty_first_tpu.math import polynomial as jpoly
from twenty_first_tpu.math import zerofier_tree as jzt
from twenty_first_tpu.math.b_field_element import BFieldElement as JB
from twenty_first_tpu.math.b_field_element import bfe as jbfe
from twenty_first_tpu.math.x_field_element import XFieldElement as JX
from twenty_first_tpu.math.x_field_element import xfe as jxfe
from twenty_first_tpu_torch import errors as terr
from twenty_first_tpu_torch.math import field_list as tfl
from twenty_first_tpu_torch.math import ntt as tntt
from twenty_first_tpu_torch.math import polynomial as tpoly
from twenty_first_tpu_torch.math import zerofier_tree as tzt
from twenty_first_tpu_torch.math.b_field_element import BFieldElement as TB
from twenty_first_tpu_torch.math.b_field_element import bfe as tbfe
from twenty_first_tpu_torch.math.x_field_element import XFieldElement as TX
from twenty_first_tpu_torch.math.x_field_element import xfe as txfe
from twenty_first_tpu_torch.probes import polynomial_probe

P = 0xFFFF_FFFF_0000_0001
EXTRAPOLATE_KNOB = "TWENTY_FIRST_TPU_EXTRAPOLATE_DEVICE"
JAX = SimpleNamespace(name="jax", Polynomial=jpoly.Polynomial, mod=jpoly,
                      bfe=jbfe, xfe=jxfe, B=JB, X=JX, errors=jerr,
                      ZerofierTree=jzt.ZerofierTree)
PORT = SimpleNamespace(name="port", Polynomial=tpoly.Polynomial, mod=tpoly,
                       bfe=tbfe, xfe=txfe, B=TB, X=TX, errors=terr,
                       ZerofierTree=tzt.ZerofierTree)


@pytest.fixture(params=["host", "card"])
def route(request, monkeypatch):
    """The port's routes: "host" keeps the default crossovers, "card"
    sends every transform, convolution, row product and inversion to
    ``ntt.DEVICE`` ("cpu" here, so the kernels' plain twins compute)."""
    monkeypatch.setattr(tntt, "DEVICE", "cpu")
    if request.param == "card":
        monkeypatch.setattr(tntt, "HOST_NTT_MAX_ELEMS", 0)
        monkeypatch.setattr(tntt, "HOST_CONV_MAX_ELEMS", 0)
        monkeypatch.setattr(tpoly, "HOST_INVERSE_MAX_ELEMS", 0)
    return request.param


@contextlib.contextmanager
def port_side(route):
    """The extrapolation knob on for the card route, around the port's
    calls only: the JAX package reads the same variable."""
    old = os.environ.pop(EXTRAPOLATE_KNOB, None)
    if route == "card":
        os.environ[EXTRAPOLATE_KNOB] = "1"
    try:
        yield
    finally:
        os.environ.pop(EXTRAPOLATE_KNOB, None)
        if old is not None:
            os.environ[EXTRAPOLATE_KNOB] = old


def carry(poly, package):
    """A polynomial of one package as ``package``'s: its coefficient array,
    (n,) base field or (n, 3) extension, is the carry format."""
    return package.Polynomial.from_array(poly.to_array(), poly.is_extension)


def plain(v):
    """Package-free data of a result, for comparing the two packages."""
    if isinstance(v, (jpoly.Polynomial, tpoly.Polynomial)):
        return ("poly", v.is_extension, v.to_array().tolist())
    if isinstance(v, (JB, TB)):
        return v.value()
    if isinstance(v, (JX, TX)):
        return tuple(c.value() for c in v.coefficients)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple, jfl.FieldElements, tfl.FieldElements)):
        return [plain(e) for e in v]
    return v


def both(fn, route="host"):
    """fn(package) through the JAX package and the port; the port's result,
    after requiring the two to be equal."""
    want = fn(JAX)
    with port_side(route):
        got = fn(PORT)
    assert plain(got) == plain(want)
    return got


def both_raise(fn, route, exc: str):
    """fn(package) raises the package's ``exc`` in both packages."""
    for pkg in (JAX, PORT):
        with port_side(route if pkg is PORT else "host"):
            with pytest.raises(getattr(pkg.errors, exc)):
                fn(pkg)


def rand(rng, n, x=False, low=0):
    return rng.integers(low, P, size=(n, 3) if x else n, dtype=np.uint64)


def poly(pkg, arr):
    return pkg.Polynomial.from_array(arr, arr.ndim == 2)


FIELDS = [(False, False), (False, True), (True, False), (True, True)]


@pytest.mark.parametrize("xa,xb", FIELDS)
@pytest.mark.parametrize("la,lb", [(6, 20), (300, 200)])
def test_ring_operations_match_jax(route, xa, xb, la, lb):
    """Schoolbook below the multiply cutoff (deg a + deg b < 2^8), the NTT
    product above; every operand pair of the two fields."""
    rng = np.random.default_rng(la + 2 * xa + xb)
    a, b = rand(rng, la, xa), rand(rng, lb, xb)
    sb, sx = int(rand(rng, 1)[0]), tuple(int(v) for v in rand(rng, 3))

    def ops(k):
        pa, pb = poly(k, a), poly(k, b)
        return [pa + pb, pa - pb, -pa, pa * pb, pb * pa,
                pa.naive_multiply(pb), pa.fast_multiply(pb),
                pa.multiply(pb), pa.scalar_mul(k.bfe(sb)),
                pa * k.xfe(sx), k.bfe(sb) * pb, pa * 5, 3 + pa, pa - 2,
                7 - pa, pa.square(), pa.fast_square(), pa.slow_square(),
                pa.pow(3), pa ** 2, pa.fast_pow(0),
                pa.shift_coefficients(3), pa.scale(k.bfe(sb)),
                pa.scale(k.xfe(sx)), pa.truncate(4), pa.mod_x_to_the_n(5),
                pa.formal_derivative(), pa.reverse(), pa.normalize(),
                k.Polynomial.batch_multiply([pa, pb, pa]),
                k.Polynomial.par_batch_multiply([pb]),
                pa.degree(), pa.leading_coefficient(), pa.coefficient(1),
                pa.coefficient(10 ** 6), pa.is_zero(), pa.is_one(),
                pa.is_x(), pa == pb, pa == carry(pa, k), pa.is_extension,
                pa.into_coefficients()]

    both(ops, route)


def test_scalar_mul_mut_and_into_owned():
    def ops(k):
        p = k.Polynomial([k.bfe(3), k.bfe(4)])
        q = p.into_owned()
        p.scalar_mul_mut(k.xfe((1, 2, 3)))
        return [p, q is p]

    both(ops)


def test_zero_one_and_short_polynomials_match_jax(route):
    def ops(k):
        zero, one = k.Polynomial.zero(), k.Polynomial.one()
        empty = k.Polynomial([])
        trailing = k.Polynomial([k.bfe(0), k.bfe(0)])
        c = k.Polynomial.from_constant(k.bfe(5))
        x = k.Polynomial.x_to_the(1)
        return [zero.degree(), empty.degree(), trailing.degree(),
                one.degree(), zero.is_zero(), trailing.is_zero(),
                one.is_one(), x.is_x(), x.is_one(), c.is_x(),
                k.Polynomial.x_to_the(5), zero + one, zero * one,
                zero * trailing, one * c, zero.leading_coefficient(),
                trailing == zero, zero.coefficients, trailing.coefficients,
                zero.formal_derivative(), c.formal_derivative(),
                zero.truncate(3), zero.reverse(), zero.slow_square(),
                zero.scale(k.bfe(3)), zero.evaluate(k.bfe(3)),
                c.evaluate(k.xfe((1, 2, 3))), str(zero), str(one),
                str(x), repr(c), zero.pow(0), c.pow(5),
                k.Polynomial.batch_multiply([]),
                zero.fast_multiply(c), c.naive_multiply(zero),
                k.Polynomial([k.xfe((0, 0, 0))]).is_zero(),
                k.Polynomial([k.xfe((1, 0, 0))]).is_one(),
                k.Polynomial([k.xfe((0, 0, 0)), k.xfe((1, 0, 0))]).is_x()]

    both(ops, route)


@pytest.mark.parametrize("xa,xb", FIELDS)
def test_division_matches_jax(route, xa, xb):
    """Long division, the operators, xgcd, and clean division below and
    above CLEAN_DIVIDE_CUTOFF (the extension-field coset route for base
    operands)."""
    rng = np.random.default_rng(7 + 2 * xa + xb)
    a, b = rand(rng, 40, xa), rand(rng, 9, xb)
    q, d = rand(rng, 460, xa), rand(rng, 60, xb)

    def ops(k):
        pa, pb = poly(k, a), poly(k, b)
        big = poly(k, q) * poly(k, d)
        return [pa.divide(pb), pa.naive_divide(pb), pa / pb, pa // pb,
                pa % pb, divmod(pa, pb), pb.divide(pa), pa % 3,
                pa.xgcd(pb), pa.xgcd(k.Polynomial.zero()),
                (pa * pb).clean_divide(pb), big.clean_divide(poly(k, d))]

    both(ops, route)


def test_division_errors_match_jax(route):
    def zero_div(k):
        k.Polynomial([k.bfe(1), k.bfe(2)]).divide(k.Polynomial.zero())

    def zero_clean(k):
        k.Polynomial([k.bfe(1)]).clean_divide(k.Polynomial([]))

    def zero_reduce(k):
        k.Polynomial([k.bfe(1)]).reduce(k.Polynomial.zero())

    def unclean(k):
        big = k.Polynomial.x_to_the(600) + k.Polynomial.one()
        big.clean_divide(k.Polynomial([k.bfe(2), k.bfe(1)]))

    def unclean_small(k):
        k.Polynomial.x_to_the(5).clean_divide(
            k.Polynomial([k.bfe(2), k.bfe(1)]))

    def not_invertible(k):
        f = k.Polynomial([k.bfe(0), k.bfe(1)])
        f.formal_power_series_inverse_newton(4)

    def not_invertible_minimal(k):
        k.Polynomial([]).formal_power_series_inverse_minimal(4)

    def structured_zero(k):
        k.Polynomial.zero().structured_multiple()

    for fn in (zero_div, zero_clean, zero_reduce):
        both_raise(fn, route, "PolynomialDivisionError")
    for fn in (unclean, unclean_small, not_invertible,
               not_invertible_minimal, structured_zero):
        both_raise(fn, route, "PolynomialError")


@pytest.mark.parametrize("xa,xm", FIELDS)
def test_reduction_matches_jax(route, xa, xm):
    """reduce's three regimes (long division, fast_reduce's structured
    multiple and chunked NTT reduction), the preprocessing and the
    reduction by a given NTT-friendly modulus."""
    rng = np.random.default_rng(11 + 2 * xa + xm)
    a, m = rand(rng, 1500, xa), rand(rng, 70, xm)
    small = rand(rng, 100, xa)

    def ops(k):
        pa, pm = poly(k, a), poly(k, m)
        shift, tail = pm.shift_factor_ntt_with_tail_length()
        return [pa.reduce(pm), pa.fast_reduce(pm), poly(k, small).reduce(pm),
                shift, tail,
                pa.reduce_by_ntt_friendly_modulus(shift, tail),
                poly(k, small).reduce_by_ntt_friendly_modulus(shift, tail)]

    both(ops, route)


@pytest.mark.parametrize("x", [False, True])
def test_power_series_and_structured_multiples_match_jax(route, x):
    rng = np.random.default_rng(5 + x)
    f = rand(rng, 30, x, low=1)

    def ops(k):
        pf = poly(k, f)
        return [pf.formal_power_series_inverse_minimal(40),
                pf.formal_power_series_inverse_newton(40),
                pf.formal_power_series_inverse_newton(1),
                pf.structured_multiple(),
                pf.structured_multiple_of_degree(100),
                k.Polynomial([k.bfe(3)]).structured_multiple_of_degree(7)]

    both(ops, route)


@pytest.mark.parametrize("x", [False, True])
def test_evaluation_matches_jax(route, x):
    """One point in either field (powers and dot), many points (blocked
    Horner past 64 coefficients; the native Horner for base operands)."""
    rng = np.random.default_rng(9 + x)
    c = rand(rng, 200, x)
    pts = rand(rng, 100)
    zb, zx = int(rand(rng, 1)[0]), tuple(int(v) for v in rand(rng, 3))

    def ops(k):
        p = poly(k, c)
        return [p.evaluate(k.bfe(zb)), p.evaluate(k.xfe(zx)),
                p.evaluate_in_same_field(k.bfe(zb)),
                p.iterative_batch_evaluate([k.bfe(int(v)) for v in pts[:5]]),
                p.batch_evaluate(pts), p.par_batch_evaluate(pts[:3]),
                p.batch_evaluate([]), poly(k, c[:3]).batch_evaluate(pts)]

    both(ops, route)


@pytest.mark.parametrize("cx,zx", FIELDS)
def test_barycentric_evaluate_matches_jax(route, cx, zx):
    rng = np.random.default_rng(13 + 2 * cx + zx)
    cw = rand(rng, 64, cx)
    z = tuple(int(v) for v in rand(rng, 3))

    def ops(k):
        point = k.xfe(z) if zx else k.bfe(z[0])
        return [k.mod.barycentric_evaluate(cw, point),
                k.mod.barycentric_evaluate(cw[:1], point)]

    both(ops, route)
    both_raise(lambda k: k.mod.barycentric_evaluate(cw[:3], k.bfe(3)), route,
               "PolynomialError")


def test_text_forms_and_lazy_coefficients_match_jax():
    rng = np.random.default_rng(17)
    b, x = rand(rng, 12), rand(rng, 5, True)

    def ops(k):
        pb, px = poly(k, b), poly(k, x)
        cb, cx = pb.coefficients, px.coefficients
        mixed = k.Polynomial([k.bfe(1), k.bfe(-1), k.bfe(0), k.bfe(1)])
        return [str(pb), repr(pb), str(px), repr(px), str(mixed),
                len(cb), cb[3], cb[-1], cb[2:5], list(cb), list(reversed(cb)),
                cb == list(cb), cb == cb[:], cb != cx, cb == cb[:4],
                cb + cb[:2], cb[:2] + cx[:1], [k.bfe(1)] + cb[:1],
                repr(cb), repr(cb[:3]), repr(cx), cx.to_list(),
                cb.is_extension, cx.is_extension, cb.to_array(),
                cb == (1, 2), cb.__eq__(3)]

    both(ops)


def test_shah_polynomial_and_from_polynomial_match_jax():
    rng = np.random.default_rng(19)
    c = rand(rng, 9)

    def ops(k):
        shah = k.X.shah_polynomial()
        return [shah, str(shah), k.X.from_polynomial(poly(k, c)),
                k.X.from_polynomial(poly(k, c[:2])),
                k.X.from_polynomial(k.Polynomial.zero()),
                k.X.from_polynomial(shah)]

    both(ops)


def test_carry_across_keeps_what_a_polynomial_computes(route):
    """A JAX polynomial carried into the port and back (its coefficient
    array) computes the same things in both packages."""
    rng = np.random.default_rng(23)
    for x in (False, True):
        jp = jpoly.Polynomial.from_array(rand(rng, 300, x), x)
        tp = carry(jp, PORT)
        assert carry(tp, JAX) == jp
        assert tp.is_extension == jp.is_extension
        pts = rand(rng, 40)
        with port_side(route):
            got = [tp.evaluate(tbfe(5)), tp.batch_evaluate(pts), tp * tp,
                   tp.fast_coset_evaluate(tbfe(7), 512)]
        want = [jp.evaluate(jbfe(5)), jp.batch_evaluate(pts), jp * jp,
                jp.fast_coset_evaluate(jbfe(7), 512)]
        assert plain(got) == plain(want)
        assert carry(got[2], JAX) == want[2]
    # trailing zeros, an empty array, a list input
    arr = np.array([3, 0, 0], dtype=np.uint64)
    assert plain(carry(jpoly.Polynomial.from_array(arr), PORT)) == \
        ("poly", False, [3])
    assert tpoly.Polynomial.from_array(np.zeros(0, np.uint64)).degree() == -1
    assert plain(tpoly.Polynomial([tbfe(1), 2, txfe((0, 1, 0))])) == plain(
        jpoly.Polynomial([jbfe(1), 2, jxfe((0, 1, 0))]))


def _public(obj):
    return {n for n in dir(obj) if not n.startswith("_")}


def test_the_port_has_the_public_surface_of_the_jax_modules():
    """Every public name of the JAX polynomial.py, zerofier_tree.py,
    field_list.py and math/__init__.py, and the NTT module's object API
    and table helpers, exists in the port; the polynomial classes have
    every public method."""
    import twenty_first_tpu.math as jmath
    import twenty_first_tpu_torch.math as tmath

    pairs = [(jpoly, tpoly), (jzt, tzt), (jfl, tfl)]
    for jmod, tmod in pairs:
        names = {n for n, v in vars(jmod).items() if not n.startswith("_")
                 and getattr(v, "__module__", jmod.__name__) == jmod.__name__}
        names |= {n for n, v in vars(jmod).items() if n.isupper()}
        missing = sorted(n for n in names if not hasattr(tmod, n))
        assert not missing, (jmod.__name__, missing)
    for name in ("gf", "gf_numpy", "BFieldElement", "bfe", "bfe_vec",
                 "bfe_array", "XFieldElement", "EXTENSION_DEGREE", "xfe",
                 "xfe_vec", "xfe_array", "ntt"):
        assert hasattr(jmath, name) and hasattr(tmath, name), name
    for name in ("ntt", "intt", "ntt_values", "intt_values", "ntt_host",
                 "swap_indices", "twiddle_factors", "HOST_NTT_MAX_ELEMS",
                 "HOST_CONV_MAX_ELEMS", "_bit_reverse_permutation",
                 "_twiddles_host", "_host_stage_tw_flat", "_ntt_host_native",
                 "conv_values", "conv_table_prepare", "conv_table_values",
                 "NttDomainError"):
        assert hasattr(jntt, name) and hasattr(tntt, name), name
    for jcls, tcls in ((jpoly.Polynomial, tpoly.Polynomial),
                       (jpoly.ModularInterpolationPreprocessingData,
                        tpoly.ModularInterpolationPreprocessingData),
                       (jzt.ZerofierTree, tzt.ZerofierTree),
                       (jzt.ZerofierTreeNode, tzt.ZerofierTreeNode),
                       (jfl.FieldElements, tfl.FieldElements)):
        missing = sorted(_public(jcls) - _public(tcls))
        assert not missing, (jcls.__name__, missing)
    for jcls, tcls in ((JX, TX), (JB, TB)):
        missing = sorted(_public(jcls) - _public(tcls))
        assert not missing, (jcls.__name__, missing)
    assert (inspect.signature(jpoly.Polynomial.coset_extrapolate)
            == inspect.signature(tpoly.Polynomial.coset_extrapolate))


def test_cutoff_constants_equal_jax():
    for name in ("FAST_MULTIPLY_CUTOFF_THRESHOLD",
                 "FAST_SQUARE_CUTOFF_THRESHOLD",
                 "FAST_INTERPOLATE_CUTOFF_THRESHOLD_SEQUENTIAL",
                 "FAST_INTERPOLATE_CUTOFF_THRESHOLD_PARALLEL",
                 "FAST_ZEROFIER_CUTOFF_THRESHOLD",
                 "FAST_MODULAR_COSET_INTERPOLATE_CUTOFF_THRESHOLD_PREFER_"
                 "LAGRANGE",
                 "FAST_MODULAR_COSET_INTERPOLATE_CUTOFF_THRESHOLD_PREFER_INTT",
                 "FAST_COSET_EXTRAPOLATE_THRESHOLD", "CLEAN_DIVIDE_CUTOFF",
                 "FAST_REDUCE_CUTOFF_THRESHOLD", "BATCH_INTERPOLATE_CUTOFF",
                 "RECURSION_CUTOFF_THRESHOLD", "P"):
        assert getattr(tpoly, name) == getattr(jpoly, name), name
    assert tzt.RECURSION_CUTOFF_THRESHOLD == jzt.RECURSION_CUTOFF_THRESHOLD
    for cls in ("PolynomialError", "PolynomialDivisionError"):
        assert [c.__name__ for c in getattr(terr, cls).__mro__] == \
            [c.__name__ for c in getattr(jerr, cls).__mro__]


def test_the_default_device_raises_above_the_crossover(monkeypatch):
    """With ntt.DEVICE at its default, "cuda", work above a crossover goes
    to the card: on a machine without one it raises, it never computes on
    the host instead; below the crossovers the host computes."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the route computes there")
    assert tntt.DEVICE == "cuda"
    rng = np.random.default_rng(29)
    a = tpoly.Polynomial.from_array(rand(rng, 300))
    monkeypatch.setattr(tntt, "HOST_CONV_MAX_ELEMS", 1024)
    small = (a * a).to_array()  # a convolution of 1024: on the host
    assert np.array_equal(small, (jpoly.Polynomial.from_array(
        a.to_array()) ** 2).to_array())
    monkeypatch.setattr(tntt, "HOST_CONV_MAX_ELEMS", 512)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        a * a
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        tntt.ntt([tbfe(1)] * (tntt.HOST_NTT_MAX_ELEMS * 2))
    monkeypatch.setattr(tpoly, "HOST_INVERSE_MAX_ELEMS", 8)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        tpoly.barycentric_evaluate(rand(rng, 16), tbfe(3))
    cw = rand(rng, 1 << 14)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        tpoly.Polynomial.coset_extrapolate(tbfe(7), cw, rand(rng, 4))


def test_pinned_polynomial_is_jax_s():
    """chip_smoke.py's PINNED_POLYNOMIAL: the JAX package's values, and the
    port's on the card's routes (run here on the CPU)."""
    want = chip_smoke.PINNED_POLYNOMIAL
    assert chip_smoke.polynomial_pin(JAX) == want
    with polynomial_probe.card_routes("cpu"):
        assert chip_smoke.polynomial_pin(PORT) == want
    assert tntt.HOST_NTT_MAX_ELEMS > 0 and tntt.DEVICE == "cuda"
