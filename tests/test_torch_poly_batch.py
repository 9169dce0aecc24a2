"""The port's device polynomial batch (twenty_first_tpu_torch.math.poly_batch)
against the JAX package's, exactly: integer field arithmetic, so the
tolerance is 0. JAX runs as its own tests run it on the CPU (use_jit=False,
the CPU inverse loop); the port on the CPU, where the K3/K6/K7/K8 wrappers
take their plain twins.

Beside them, numpy models of K6's and K7's schedules (csrc/poly.cu): K6's
segments folded by Horner and scaled by w^(s 2^log_l), summed by block
and by group as ``fold_plan`` lays them out; K7's segment products, the
per-row inversion of those products from one inverse, and each thread's
back-sweep from its block's exclusive prefix and suffix products. Each is
held against the twin and JAX, so the card's first build meets a schedule
already shown to give the same values."""

import numpy as np
import pytest

import chip_smoke
from twenty_first_tpu.math import poly_batch as jpb
from twenty_first_tpu.math.b_field_element import P
from twenty_first_tpu_torch.math import gf, gf_ext, ntt, poly_batch
from twenty_first_tpu_torch.math import gf_numpy as gfn
from twenty_first_tpu_torch.math import xgf_numpy as xgf
from twenty_first_tpu_torch.ops import poly_cuda

EDGES = [0, 1, P - 1, 1 << 32, (1 << 32) - 1]


def _values(seed: int, shape):
    v = np.random.default_rng(seed).integers(0, P, size=shape,
                                             dtype=np.uint64)
    flat = v.reshape(-1)
    k = min(flat.size, len(EDGES))
    flat[:k] = EDGES[:k]
    return v


def test_batch_ntt_and_intt_match_jax():
    x = _values(1, (3, 1 << 6))
    y = poly_batch.batch_ntt(x, device="cpu")
    np.testing.assert_array_equal(y, jpb.batch_ntt(x))
    np.testing.assert_array_equal(poly_batch.batch_intt(y, device="cpu"),
                                  jpb.batch_intt(y))


def test_coset_evaluate_and_interpolate_match_jax():
    """A zero row among them; k < order."""
    coeffs = _values(2, (4, 20))
    coeffs[2] = 0
    want = jpb.batch_coset_evaluate(coeffs, 64)
    got = poly_batch.batch_coset_evaluate(coeffs, 64, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        poly_batch.batch_coset_evaluate(coeffs, 64, device="cpu", plain=True),
        want)
    back = poly_batch.batch_coset_interpolate(got, device="cpu")
    np.testing.assert_array_equal(back, jpb.batch_coset_interpolate(want))
    np.testing.assert_array_equal(back[:, :20], coeffs)


def test_batch_multiply_matches_jax():
    a, b = _values(3, (4, 9)), _values(4, (4, 13))
    a[1] = 0
    want = jpb.batch_multiply(a, b)
    np.testing.assert_array_equal(
        poly_batch.batch_multiply(a, b, device="cpu"), want)


@pytest.mark.parametrize("where", ["outside", "in_domain"])
def test_barycentric_matches_jax(where):
    """Outside the domain, and at a domain point, where the batch
    inversion's row holds a 0 and both give 0."""
    cw = _values(5, (3, 32))
    cw[1] = 0
    z = 987654321 if where == "outside" else pow(
        poly_batch.PRIMITIVE_ROOTS[32], 5, P)
    want = jpb.batch_evaluate_barycentric(cw, z)
    got = poly_batch.batch_evaluate_barycentric(cw, z, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3,)


@pytest.mark.parametrize("name", sorted(chip_smoke.PINNED_EXTRAPOLATE))
def test_pinned_extrapolations_match_jax(name):
    """chip_smoke.py's PINNED_EXTRAPOLATE, re-derived from JAX, and the
    port's values at those inputs."""
    cw, pts = chip_smoke.extrapolate_pin_inputs()[name]
    if name == "base":
        want = jpb.batch_coset_extrapolate(cw, 7, pts, use_jit=False)
        got = poly_batch.batch_coset_extrapolate(cw, 7, pts, device="cpu")
    else:
        want = jpb.batch_coset_extrapolate_xfe(cw, 7, pts, use_jit=False)
        got = poly_batch.batch_coset_extrapolate_xfe(cw, 7, pts, device="cpu")
    first, digest = chip_smoke.PINNED_EXTRAPOLATE[name]
    assert chip_smoke.pin_of(want) == (first, digest)
    np.testing.assert_array_equal(got, want)


def test_extrapolate_zero_rows_and_in_domain_points_match_jax():
    """A zero codeword row, points in the coset (the codeword's own values
    come back) and out of it, at the base pin's shapes (whose JAX ops are
    compiled by then)."""
    cw, pts = chip_smoke.extrapolate_pin_inputs()["base"]
    cw, pts = cw.copy(), pts.copy()
    n = cw.shape[1]
    cw[0] = 0
    pts[:2] = [7 * pow(poly_batch.PRIMITIVE_ROOTS[n], k, P) % P
               for k in (0, 5)]
    want = jpb.batch_coset_extrapolate(cw, 7, pts, use_jit=False)
    for plain in (False, True):
        got = poly_batch.batch_coset_extrapolate(cw, 7, pts, point_chunk=16,
                                                 device="cpu", plain=plain)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want[1, :2], cw[1, [0, 5]])
    assert not want[0].any()


def test_extrapolate_xfe_codewords_with_a_zero_row_match_jax():
    cwx, pts = chip_smoke.extrapolate_pin_inputs()["xfe_xfe"]
    cwx = cwx.copy()
    cwx[1] = 0
    want = jpb.batch_coset_extrapolate_xfe(cwx, 7, pts, use_jit=False)
    got = poly_batch.batch_coset_extrapolate_xfe(cwx, 7, pts, point_chunk=2,
                                                 device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 4, 3) and not got[1].any()


# ---------------------------------------------------------------------------
# K6's schedule
# ---------------------------------------------------------------------------


def _xpow2(w, k: int):
    """w^(2^k) of (..., 3) xfe values."""
    for _ in range(k):
        w = xgf.mul(w, w)
    return w


def k6_model(b, w, plan):
    """K6 on host arrays: b (rows, n) or (rows, 3, n), w (m,) or (m, 3)."""
    xpts, xcoef = w.ndim == 2, b.ndim == 3
    n, m = b.shape[-1], w.shape[0]
    log_l, nseg = plan["log_l"], plan["nseg"]
    big_l = 1 << log_l
    rows = b.shape[0]
    # lanes (row, point, segment): Horner over the segment, top down
    shape = (rows, m, nseg) + ((3,) if xpts else ())
    acc = np.zeros(shape, dtype=np.uint64)
    wb = w[None, :, None] if xpts else w[None, :, None]
    for off in range(big_l - 1, -1, -1):
        k = np.arange(nseg) * big_l + off
        live = k < n
        kk = np.where(live, k, 0)
        acc_next = xgf.mul(acc, wb) if xpts else gfn.mul(acc, wb)
        if xcoef:
            coef = np.moveaxis(b[:, :, kk], 1, -1)[:, None]  # (rows,1,nseg,3)
        else:
            coef = b[:, kk][:, None]  # (rows, 1, nseg)
            if xpts:
                coef = xgf.lift(coef)
        acc_next = gfn.add(acc_next, coef)
        mask = live[None, None, :, None] if xpts else live[None, None, :]
        acc = np.where(mask, acc_next, acc)
    # the scale w^(s 2^log_l), segment by segment
    step = _xpow2(w, log_l) if xpts else np.array(
        [pow(int(v), big_l, P) for v in w], dtype=np.uint64)
    scale = np.empty((m, nseg) + ((3,) if xpts else ()), dtype=np.uint64)
    cur = xgf.lift(np.ones(m, np.uint64)) if xpts else np.ones(m, np.uint64)
    for s in range(nseg):
        scale[:, s] = cur
        cur = xgf.mul(cur, step) if xpts else gfn.mul(cur, step)
    acc = xgf.mul(acc, scale[None]) if xpts else gfn.mul(acc, scale[None])
    # a block's segments, then the groups
    per_block = poly_cuda.FOLD_THREADS >> plan["log_p"]
    out = np.zeros((rows, m) + ((3,) if xpts else ()), dtype=np.uint64)
    for g in range(plan["groups"]):
        part = np.zeros_like(out)
        for s in range(g * per_block, min((g + 1) * per_block, nseg)):
            part = gfn.add(part, acc[:, :, s])
        out = gfn.add(out, part)
    return out


# (rows, n, m, xfe points, xfe coefficients, forced segment, against JAX):
# JAX runs at the pins' shapes, whose ops are compiled by then, and once
# at a small xfe shape
@pytest.mark.parametrize("case", [
    (3, 1 << 10, 64, False, False, None, True),
    (3, 1 << 10, 64, False, False, 0, False),
    (3, 1 << 10, 64, False, False, 3, False),
    (3, 1 << 10, 64, False, False, 10, False),
    (1, 1 << 12, 40, False, False, None, False),
    (2, 1 << 10, 4, True, False, None, True),
    (2, 1 << 8, 5, True, False, 2, True),
    (2, 1 << 8, 5, True, True, 4, False), (2, 2, 33, True, True, 0, False),
    (1, 1, 3, False, False, None, False)])
def test_k6_schedule_model_matches_twin_and_jax(case):
    """The model at forced and planned segments against the twin, and the
    extrapolation it stands in against JAX."""
    rows, n, m, xpts, xcoef, seg, against_jax = case
    cw = _values(10 + n, (rows, n, 3) if xcoef else (rows, n))
    pts = _values(11 + n, (m, 3) if xpts else (m,))
    x = gf_ext.from_u64(cw) if xcoef else gf.from_u64(cw)
    coeffs = gf.to_u64(ntt.intt(x))
    off_inv = np.uint64(pow(7, P - 2, P))
    w = xgf.mul_base(pts, off_inv) if xpts else gfn.mul(pts, off_inv)
    plan = poly_cuda.fold_plan(rows, n, m, seg)
    got = k6_model(coeffs, w, plan)
    twin = gf.to_u64(poly_cuda.coset_extrapolate_fold(
        gf.from_u64(coeffs), gf.from_u64(w), point_chunk=16))
    np.testing.assert_array_equal(got, twin)
    if against_jax:
        if xpts:
            want = jpb.batch_coset_extrapolate_xfe(cw, 7, pts, use_jit=False)
        else:
            want = jpb.batch_coset_extrapolate(cw, 7, pts, use_jit=False)
        np.testing.assert_array_equal(got, want)


def test_k6_plan_covers_every_coefficient():
    """Segments tile the coefficients with none empty; blocks of segments
    cover every segment; a warp's lanes are whole groups of points."""
    for rows, n, m in [(1, 1 << 18, 1 << 10), (8, 1 << 20, 16),
                       (2, 1 << 20, 16), (3, 1 << 10, 64), (1, 1, 1),
                       (5, 1000, 3), (70000, 4, 2)]:
        for seg in (None, 0, 5):
            p = poly_cuda.fold_plan(rows, n, m, seg)
            big_l = 1 << p["log_l"]
            assert (p["nseg"] - 1) * big_l < n <= p["nseg"] * big_l
            per_block = poly_cuda.FOLD_THREADS >> p["log_p"]
            assert (p["groups"] - 1) * per_block < p["nseg"]
            assert p["groups"] * per_block >= p["nseg"]
            assert 1 << p["log_p"] <= 32 and p["tiles"] << p["log_p"] >= m
    bench = poly_cuda.fold_plan(1, 1 << 18, 1 << 10)
    assert (bench["log_l"], bench["groups"]) == (10, 32)
    assert bench["groups"] * poly_cuda.FOLD_THREADS * bench["tiles"] \
        == poly_cuda.FOLD_TARGET_LANES


# ---------------------------------------------------------------------------
# K7's schedule
# ---------------------------------------------------------------------------


def _scan_ex(t):
    """Exclusive prefix and suffix products along the last axis."""
    pre, suf = np.ones_like(t), np.ones_like(t)
    for k in range(1, t.shape[-1]):
        pre[..., k] = gfn.mul(pre[..., k - 1], t[..., k - 1])
        j = t.shape[-1] - 1 - k
        suf[..., j] = gfn.mul(suf[..., j + 1], t[..., j + 1])
    return pre, suf


def k7_model(x):
    """K7 on a (rows, n) host array, launch by launch."""
    rows, n = x.shape
    threads, per = poly_cuda.INV_THREADS, poly_cuda.INV_PER_THREAD
    seg_len = poly_cuda.INV_SEGMENT
    nseg = -(-n // seg_len)
    pad = np.ones((rows, nseg * seg_len), dtype=np.uint64)
    pad[:, :n] = x
    v = pad.reshape(rows, nseg, per, threads)  # element s*S + e*256 + k
    pre = np.empty_like(v)
    acc = np.ones((rows, nseg, threads), dtype=np.uint64)
    for e in range(per):
        acc = gfn.mul(acc, v[:, :, e])
        pre[:, :, e] = acc
    # launch 1: each segment's product
    totals = np.ones((rows, nseg), dtype=np.uint64)
    for k in range(threads):
        totals = gfn.mul(totals, acc[:, :, k])
    # launch 2: runs of ceil(nseg / 256) totals a thread, one inversion
    run = -(-nseg // threads)
    inv_totals = np.empty_like(totals)
    for r in range(rows):
        runs = [totals[r, j * run:(j + 1) * run] for j in range(threads)]
        prods = np.array([int(np.prod([int(u) for u in rr], dtype=object)
                              % P) if len(rr) else 1 for rr in runs],
                         dtype=np.uint64)
        p_ex, s_ex = _scan_ex(prods[None])
        total = int(gfn.mul(p_ex[0, -1], prods[-1]))
        inv_total = pow(total, P - 2, P) if total else 0
        for j, rr in enumerate(runs):
            a = int(gfn.mul(gfn.mul(np.uint64(inv_total), p_ex[0, j]),
                            s_ex[0, j]))
            local = np.cumprod([1] + [int(u) for u in rr], dtype=object)
            for i in range(len(rr) - 1, -1, -1):
                inv_totals[r, j * run + i] = a * int(local[i]) % P
                a = a * int(rr[i]) % P
    # launch 3: each thread's inverse, then back over its elements
    p_ex, s_ex = _scan_ex(acc)
    a = gfn.mul(gfn.mul(inv_totals[:, :, None], p_ex), s_ex)
    out = np.empty_like(v)
    for e in range(per - 1, -1, -1):
        out[:, :, e] = gfn.mul(a, pre[:, :, e - 1]) if e else a
        a = gfn.mul(a, v[:, :, e])
    return out.reshape(rows, -1)[:, :n]


@pytest.mark.parametrize("rows,n,against_jax", [
    (3, 5000, True), (2, 2048, False), (1, 1, False), (4, 300, False),
    (1, 3 * 2048 + 1, False)])
def test_k7_schedule_model_matches_twin_and_jax(rows, n, against_jax):
    """Rows of one and several segments, a row holding a 0 (all zeros out);
    the twin is held against JAX at every shape by test_torch_gf.py."""
    x = _values(20 + n, (rows, n))
    x[x == 0] = 3
    if rows > 1:
        x[1, n // 3] = 0
    got = k7_model(x)
    np.testing.assert_array_equal(
        got, gf.to_u64(poly_cuda.batch_inversion(gf.from_u64(x))))
    if against_jax:
        from twenty_first_tpu.math import gf as jgf

        np.testing.assert_array_equal(
            got, jgf.from_limbs(jgf.batch_inversion(jgf.to_limbs(x))))
    if rows > 1:
        assert not got[1].any()
    assert (gfn.mul(got[0], x[0]) == 1).all()
