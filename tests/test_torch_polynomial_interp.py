"""The port's zerofiers, zerofier tree, multipoint evaluation,
interpolation, coset transforms, modular coset interpolation and
extrapolation against the JAX package's, exactly, on the port's host and
card routes (see tests/test_torch_polynomial.py, whose helpers this file
uses)."""

import numpy as np
import pytest

from test_torch_polynomial import (FIELDS, JAX, PORT, both, both_raise,
                                   plain, poly, port_side, rand)
from test_torch_polynomial import route  # noqa: F401  (the fixture)
from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu.math import polynomial as jpoly
from twenty_first_tpu_torch.math import polynomial as tpoly

P = 0xFFFF_FFFF_0000_0001
CUTOFF = "FAST_MODULAR_COSET_INTERPOLATE_CUTOFF_THRESHOLD"
NAMED_ENTRY = ("fast_modular_coset_interpolate_with_zerofiers_and_"
               "ntt_friendly_multiple")


def elements(k, arr):
    """Package k's elements of a (n,) or (n, 3) array."""
    if arr.ndim == 2:
        return [k.xfe(tuple(int(v) for v in row)) for row in arr]
    return [k.bfe(int(v)) for v in arr]


def distinct(rng, n, x=False):
    """n distinct points: (n,) base or (n, 3) extension."""
    if x:
        return np.unique(rand(rng, 2 * n, True), axis=0)[:n]
    return np.unique(rand(rng, 2 * n, low=1))[:n]


@pytest.mark.parametrize("x", [False, True])
@pytest.mark.parametrize("n", [1, 5, 16, 17, 100])
def test_zerofiers_and_the_zerofier_tree_match_jax(route, x, n):
    """Below and above the leaf size (16): the smart, fast, naive and
    dispatching forms, the batched leaf rows and the tree's nodes."""
    rng = np.random.default_rng(n + 100 * x)
    pts = distinct(rng, n, x)

    def ops(k):
        # the tree's leafs keep their slice of the domain: elements here
        dom = elements(k, pts) if x else pts
        tree = k.ZerofierTree.new_from_domain(dom)
        leafs, stack = [], [tree.root]
        while stack:
            node = stack.pop()
            if node.is_leaf:
                leafs.append((node.points, node.zerofier))
            else:
                stack += [node.right, node.left]
        rows = pts[: (n // 16) * 16].reshape(
            (n // 16, 16, 3) if x else (n // 16, 16))
        return [k.Polynomial.zerofier(pts), k.Polynomial.par_zerofier(pts),
                k.Polynomial.smart_zerofier(pts),
                k.Polynomial.fast_zerofier(pts),
                k.Polynomial.naive_zerofier(pts[:6]),
                k.Polynomial.batch_smart_zerofier_rows(rows, x),
                tree.zerofier(), leafs]

    both(ops, route)


def test_empty_domains_match_jax():
    def ops(k):
        tree = k.ZerofierTree.new_from_domain([])
        return [tree.root is None, tree.zerofier(),
                k.Polynomial.zerofier([]), k.Polynomial.smart_zerofier([]),
                k.Polynomial.one().divide_and_conquer_batch_evaluate(tree)]

    both(ops)


@pytest.mark.parametrize("cx,px", FIELDS)
def test_multipoint_evaluation_matches_jax(route, cx, px):
    """Horner below the caps; the zerofier-tree divide and conquer; the
    base field's level-synchronous remainder tree, called directly (the
    native Horner takes the public path below 2^26 element-ops)."""
    rng = np.random.default_rng(31 + 2 * cx + px)
    c = rand(rng, 300, cx)
    pts = distinct(rng, 150, px)
    base_pts = distinct(rng, 200)

    def ops(k):
        p = poly(k, c)
        tree = k.ZerofierTree.new_from_domain(
            elements(k, pts[:40]) if px else pts[:40])
        out = [p.batch_evaluate(pts),
               p.divide_and_conquer_batch_evaluate(tree)]
        if not cx:
            out.append(p._remainder_tree_eval(base_pts))
        return out

    both(ops, route)


@pytest.mark.parametrize("x", [False, True])
def test_interpolation_matches_jax(route, x):
    """Lagrange (the native core for base points), the dispatcher on both
    sides of 2^8 points, the zipped form, fast and batched interpolation
    (the power-of-two base path and the memoized recursion)."""
    rng = np.random.default_rng(41 + x)
    pts = distinct(rng, 260, x)
    vals = rand(rng, 260, x)
    vals_b = rand(rng, 260)

    def ops(k):
        zipped = [(k.bfe(int(a)), k.bfe(int(b)))
                  for a, b in zip(distinct(rng_z, 5), rand(rng_z, 5))]
        return [k.Polynomial.lagrange_interpolate(pts[:20], vals[:20]),
                k.Polynomial.lagrange_interpolate(pts[:5], vals_b[:5]),
                k.Polynomial.interpolate(pts[:40], vals[:40]),
                k.Polynomial.interpolate(pts, vals_b) if not x else None,
                k.Polynomial.par_interpolate(pts[:3], vals[:3]),
                k.Polynomial.lagrange_interpolate_zipped(zipped),
                k.Polynomial.fast_interpolate(pts[:64], vals_b[:64]),
                k.Polynomial.par_fast_interpolate(pts[:34], vals[:34]),
                k.Polynomial.batch_fast_interpolate(pts[:32],
                                                    [vals[:32], vals_b[:32]]),
                k.Polynomial.batch_fast_interpolate(pts[:21], [vals[:21]]),
                k.Polynomial.interpolate(pts[:1], vals[:1])]

    rng_z = np.random.default_rng(43)
    want = ops(JAX)
    rng_z = np.random.default_rng(43)
    with port_side(route):
        got = ops(PORT)
    assert plain(got) == plain(want)


def test_power_of_two_interpolation_matches_the_recursion(route):
    """2^8 base points: the level-synchronous path (zerofier pyramid, the
    derivative identity's weights, a parent-seeded inverse at the second
    level) against JAX and the memoized recursion of both packages."""
    rng = np.random.default_rng(47)
    dom = distinct(rng, 1 << 8)
    batches = [rand(rng, 1 << 8) for _ in range(2)]

    def ops(k):
        return [k.Polynomial.batch_fast_interpolate(dom, batches),
                k.Polynomial._batch_interp_memo(dom, False, batches, {}, {})]

    got = both(ops, route)
    assert plain(got[0]) == plain(got[1])


def test_interpolation_errors_match_jax(route):
    def mismatch(k):
        k.Polynomial.interpolate([k.bfe(1), k.bfe(2)], [k.bfe(1)])

    def empty(k):
        k.Polynomial.fast_interpolate([], [])

    def empty_batch(k):
        k.Polynomial.batch_fast_interpolate([], [[]])

    def zipped_empty(k):
        k.Polynomial.lagrange_interpolate_zipped([])

    def zipped_repeated(k):
        k.Polynomial.lagrange_interpolate_zipped(
            [(k.bfe(1), k.bfe(2)), (k.bfe(1), k.bfe(3))])

    def lagrange_mismatch(k):
        k.Polynomial.lagrange_interpolate([k.bfe(1)], [])

    for fn in (mismatch, empty, empty_batch, zipped_empty, zipped_repeated,
               lagrange_mismatch):
        both_raise(fn, route, "PolynomialError")


@pytest.mark.parametrize("x", [False, True])
def test_coset_transforms_match_jax(route, x):
    rng = np.random.default_rng(53 + x)
    c = rand(rng, 200, x)
    cw = rand(rng, 256, x)

    def ops(k):
        p = poly(k, c)
        ev = p.fast_coset_evaluate(k.bfe(7), 256)
        return [ev, p.fast_coset_evaluate_array(k.xfe((3, 1, 4)), 512),
                k.Polynomial.fast_coset_interpolate(k.bfe(7), ev),
                k.Polynomial.fast_coset_interpolate(k.bfe(5), cw),
                k.Polynomial.fast_coset_interpolate(k.xfe((1, 2, 3)), cw)]

    both(ops, route)
    both_raise(lambda k: poly(k, c).fast_coset_evaluate(k.bfe(7), 100),
               route, "PolynomialError")
    both_raise(lambda k: poly(k, c).fast_coset_evaluate(k.bfe(7), 128),
               route, "PolynomialError")


@pytest.mark.parametrize("x", [False, True])
def test_modular_coset_interpolation_matches_jax(route, x, monkeypatch):
    """The Lagrange branch (< 2^8 values), the iNTT branch with the
    structured reduction, the shared preprocessing, the reference-named
    entry point, and the even/odd recursion (its threshold lowered on both
    sides, as the JAX package's tests do)."""
    rng = np.random.default_rng(59 + x)
    small, big = rand(rng, 32, x), rand(rng, 256, x)
    m5, m9 = rand(rng, 6), rand(rng, 10)

    def ops(k):
        fmci = k.Polynomial.fast_modular_coset_interpolate
        pre = k.Polynomial.fast_modular_coset_interpolate_preprocess(
            256, k.bfe(7), poly(k, m9))
        return [fmci(small, k.bfe(7), poly(k, m5)),
                fmci(big, k.bfe(7), poly(k, m9)),
                fmci(big, k.bfe(7), poly(k, m9), preprocessed=pre),
                getattr(k.Polynomial, NAMED_ENTRY)(big, k.bfe(7), poly(k, m9),
                                                   pre),
                pre.even_zerofiers, pre.odd_zerofiers,
                pre.shift_coefficients, pre.tail_length]

    both(ops, route)
    for mod in (jpoly, tpoly):
        monkeypatch.setattr(mod, f"{CUTOFF}_PREFER_LAGRANGE", 8)
        monkeypatch.setattr(mod, f"{CUTOFF}_PREFER_INTT", 16)
    values = rand(rng, 64, x)

    def recursion(k):
        out = k.Polynomial.fast_modular_coset_interpolate(
            values, k.bfe(9), poly(k, m5))
        oracle = k.Polynomial.fast_coset_interpolate(
            k.bfe(9), values).reduce(poly(k, m5))
        return [out, out == oracle]

    assert both(recursion, route)[1]
    both_raise(lambda k: k.Polynomial.fast_modular_coset_interpolate(
        small, k.bfe(7), k.Polynomial.zero()), route,
        "PolynomialDivisionError")


@pytest.mark.parametrize("cx,px", FIELDS)
def test_extrapolation_matches_jax(route, cx, px):
    """coset_extrapolate on both sides of 100 points (the fast modular and
    the naive host forms; on the card route the port takes
    poly_batch's, K3 and K6), points on the coset among them, and
    batch_coset_extrapolate's three routes."""
    rng = np.random.default_rng(61 + 2 * cx + px)
    n = 64
    cw = rand(rng, n, cx)
    pts = distinct(rng, 100, px)
    omega = pow(7, (P - 1) // n, P)
    on_coset = np.array([7 * pow(omega, i, P) % P for i in (0, 5)],
                        dtype=np.uint64)
    if px:
        on_coset = np.stack([on_coset, 0 * on_coset, 0 * on_coset], -1)
    few = np.concatenate([pts[:6], on_coset])
    cws = rand(rng, 2 * n, cx)

    def ops(k):
        # the zerofier tree keeps slices of the points: elements for xfe
        few_, pts_ = (elements(k, few), elements(k, pts)) if px else (few, pts)
        return [k.Polynomial.coset_extrapolate(k.bfe(7), cw, few_),
                k.Polynomial.coset_extrapolate(k.bfe(7), cw, pts_),
                k.Polynomial.batch_coset_extrapolate(k.bfe(7), n, cws, few_),
                k.Polynomial.batch_coset_extrapolate(k.bfe(7), n, cws, pts_),
                k.Polynomial.par_batch_coset_extrapolate(k.bfe(7), n,
                                                         cws[:n], few_[:2]),
                k.Polynomial._naive_coset_extrapolate(k.bfe(7), cw, few_),
                k.Polynomial._fast_coset_extrapolate(k.bfe(7), cw, few_)]

    both(ops, route)
    both_raise(lambda k: k.Polynomial.batch_coset_extrapolate(
        k.bfe(7), 100, cws[:100], few), route, "PolynomialError")


def test_extrapolation_gate_matches_jax_on_the_host(monkeypatch):
    """The card route's gate: power-of-two codewords of 2^14 and more, the
    knob forcing it on (any power of two) or off."""
    gate = tpoly.Polynomial._device_extrapolate_allowed
    monkeypatch.delenv("TWENTY_FIRST_TPU_EXTRAPOLATE_DEVICE", raising=False)
    assert [gate(n) for n in (0, 3, 1 << 13, 1 << 14, (1 << 14) + 1)] == \
        [False, False, False, True, False]
    monkeypatch.setenv("TWENTY_FIRST_TPU_EXTRAPOLATE_DEVICE", "1")
    assert [gate(n) for n in (0, 6, 8, 1 << 14)] == [False, False, True, True]
    monkeypatch.setenv("TWENTY_FIRST_TPU_EXTRAPOLATE_DEVICE", "0")
    assert not gate(1 << 20)


def test_colinearity_matches_jax():
    def ops(k):
        b = k.bfe
        line = [(b(1), b(3)), (b(2), b(5)), (b(4), b(9)), (b(7), b(15))]
        bent = line[:3] + [(b(5), b(12))]
        return [k.Polynomial.are_colinear(line),
                k.Polynomial.are_colinear(bent),
                k.Polynomial.are_colinear(line[:2]),
                k.Polynomial.are_colinear(line + [line[0]]),
                k.Polynomial.are_colinear_3(*line[:3]),
                k.Polynomial.get_colinear_y(line[0], line[1], b(10)),
                k.Polynomial.get_colinear_y(line[0], line[3], b(123))]

    both(ops)
    both_raise(lambda k: k.Polynomial.get_colinear_y(
        (k.bfe(1), k.bfe(2)), (k.bfe(1), k.bfe(3)), k.bfe(4)), "host",
        "PolynomialError")
