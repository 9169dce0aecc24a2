"""The port's device polynomial batch (twenty_first_tpu_torch.math.poly_batch)
against the JAX package's, exactly: integer field arithmetic, so the
tolerance is 0. JAX runs as its own tests run it on the CPU (use_jit=False,
the CPU inverse loop); the port on the CPU, where the K3/K6/K7/K8 wrappers
take their plain twins.

Beside them, numpy models of K6's and K7's schedules (csrc/poly.cu): K6's
segments folded a block of B terms at a time, each block's products summed
unreduced in the kernel's 32-bit words and reduced once, the blocks chained
by w^B, each segment scaled by w^(s 2^log_l) and summed by block and by
group as ``fold_plan`` lays them out; K7's one pass over each segment
(each thread's running products, the block's scans both ways, one
inversion a segment, each thread's back-sweep) and its zeroing of the rows
whose segment products hold a 0. Each is
held against the twin and JAX, so the card's first build meets a schedule
already shown to give the same values."""

import numpy as np
import pytest

import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401
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

M32, S32 = np.uint64(0xFFFF_FFFF), np.uint64(32)
#: the most products one of K6's accumulators takes in a block of B terms:
#: the outer product by w^B and the block's terms (column 2 of an xfe x xfe
#: product takes three of each)
MOST_PRODUCTS = {(False, False): lambda b: b + 1,
                 (True, False): lambda b: b + 3,
                 (True, True): lambda b: 3 * b + 3}


class Wide:
    """K6's accumulator (csrc/poly.cu ``Wide``) word by word: e, five 32-bit
    words of sum a_lo b_lo + a_hi b_hi 2^64, and x, three words of the
    cross products, each word a uint64 array below 2^32; a carry out of the
    top word fails. With ``exact``, the same sum as Python integers beside
    it."""

    def __init__(self, shape, exact: bool = False):
        self.e = [np.zeros(shape, np.uint64) for _ in range(5)]
        self.x = [np.zeros(shape, np.uint64) for _ in range(3)]
        self.exact = np.zeros(shape, dtype=object) if exact else None

    @staticmethod
    def _chain(words, start, terms):
        """words[start:] += terms (32-bit each) with the carry running up
        to the last word, which must not pass 32 bits."""
        c = np.zeros_like(words[0])
        for i in range(start, len(words)):
            t = words[i] + c + (terms[i - start] if i - start < len(terms)
                                else 0)
            words[i], c = t & M32, t >> S32
        assert not c.any(), "a carry left the accumulator"

    def mac(self, a, b):
        a, b = np.broadcast_arrays(np.asarray(a, np.uint64),
                                   np.asarray(b, np.uint64))
        a0, a1, b0, b1 = a & M32, a >> S32, b & M32, b >> S32
        ll, hh = a0 * b0, a1 * b1
        self._chain(self.e, 0, [ll & M32, ll >> S32, hh & M32, hh >> S32])
        for m in (a0 * b1, a1 * b0):
            self._chain(self.x, 0, [m & M32, m >> S32])
        if self.exact is not None:
            self.exact = self.exact + a.astype(object) * b.astype(object)

    def value(self):
        e = sum(w.astype(object) << (32 * i) for i, w in enumerate(self.e))
        x = sum(w.astype(object) << (32 * i) for i, w in enumerate(self.x))
        return e + (x << 32)

    def reduce(self):
        """reduce_wide: a lazy residue of the sum."""
        w = [self.e[0]] + [v.copy() for v in self.e[1:]]
        self._chain(w, 1, self.x)
        r = _lazy(gf.reduce128_lazy, w[0] | (w[1] << S32),
                  w[2] | (w[3] << S32))
        return _lazy(gf.sub_lazy, r, w[4] << S32)


def _lazy(fn, *args):
    """One of the port's lazy forms (math/gf.py, JAX's words bit for bit,
    tests/test_torch_gf.py) on uint64 arrays."""
    return gf.to_u64(fn(*(gf.from_u64(np.ascontiguousarray(a))
                          for a in args)))


def _canon(x):
    return np.where(x >= gfn.P, x - gfn.P, x)


def _xpow(w, e: int):
    """w^e of (..., 3) xfe values, e >= 0."""
    r = xgf.lift(np.ones(w.shape[:-1], np.uint64))
    while e:
        if e & 1:
            r = xgf.mul(r, w)
        w, e = xgf.mul(w, w), e >> 1
    return r


def _pow(w, e: int):
    r = np.ones_like(w)
    while e:
        if e & 1:
            r = gfn.mul(r, w)
        w, e = gfn.mul(w, w), e >> 1
    return r


def k6_model(b, w, plan, exact: bool = False):
    """K6 on host arrays, as csrc/poly.cu schedules it: b (rows, n) or
    (rows, 3, n), w (m,) or (m, 3). A lane is (row, point, segment of
    2^log_l coefficients); it folds its segment B = ``FOLD_BLOCK`` terms at
    a time from the top, acc = reduce(acc * w^B + sum_i b[k0 + i] w^i),
    every product of a block summed unreduced in ``Wide`` accumulators (an
    xfe point's outer product by its 3x3 matrix, xfe coefficients by the
    schoolbook product's five columns, X^3 = X - 1); then it scales by
    w^(s 2^log_l) and the lanes are summed by block of segments and by
    group as ``fold_plan`` lays them out. With ``exact`` it checks every
    block's words against the exact sum and records the widest sum's bits
    in ``k6_model.widest_sum_bits``."""
    xpts, xcoef = w.ndim == 2, b.ndim == 3
    rows, n, m = b.shape[0], b.shape[-1], w.shape[0]
    big_l, big_b = 1 << plan["log_l"], poly_cuda.FOLD_BLOCK
    nseg = plan["nseg"]
    lanes = (rows, m, nseg)
    comps = 3 if xpts else 1
    wc = w if xpts else w[:, None]  # (m, comps)
    one = xgf.lift(np.ones(m, np.uint64)) if xpts else np.ones((m, 1),
                                                              np.uint64)
    mul = xgf.mul if xpts else (lambda u, v: gfn.mul(u, v))
    pw = [one]
    for _ in range(big_b):
        pw.append(mul(pw[-1], wc))
    wb = pw.pop()  # w^B; pw[i] = w^i, i < B
    if xpts:
        w0, w1, w2 = (wb[:, c] for c in range(3))
        # the entries of w^B's matrix: (W0, W1, W2, -W1, -W2, W0 + W2,
        # W1 - W2), every product of non-negative operands
        o = [w0, w1, w2, gfn.neg(w1), gfn.neg(w2), gfn.add(w0, w2),
             gfn.sub(w1, w2)]
    acc = [np.zeros(lanes, np.uint64) for _ in range(comps)]
    lo = np.arange(nseg) * big_l
    hi = np.minimum(lo + big_l, n)
    nb = -(-big_l // big_b)
    most = 0
    for j in range(nb - 1, -1, -1):
        s = [Wide(lanes, exact) for _ in range(5 if xcoef else comps)]
        # the outer product acc * w^B
        if xpts:
            for col, terms in enumerate(((0, 4, 3), (1, 5, 6), (2, 1, 5))):
                for v, oi in zip(acc, terms):
                    s[col].mac(v, o[oi][None, :, None])
        else:
            s[0].mac(acc[0], wb[None, :, None, 0])
        for i in range(big_b):
            k = lo + j * big_b + i
            live = k < hi
            kk = np.where(live, k, 0)
            v = [pw[i][None, :, None, c] for c in range(comps)]
            if xcoef:
                cf = [np.where(live, b[:, c, kk], 0)[:, None, :]
                      for c in range(3)]
                for col, pairs in enumerate((((0, 0),), ((0, 1), (1, 0)),
                                             ((0, 2), (1, 1), (2, 0)),
                                             ((1, 2), (2, 1)), ((2, 2),))):
                    for ci, vi in pairs:
                        s[col].mac(cf[ci], v[vi])
            else:
                cf = np.where(live, b[:, kk], 0)[:, None, :]
                for c in range(comps):
                    s[c].mac(cf, v[c])
        for acc_w in s if exact else ():
            assert (acc_w.value() == acc_w.exact).all()
            most = max(most, int(max(acc_w.exact.reshape(-1))).bit_length())
        acc = [w_.reduce() for w_ in s[:comps]]
        if xcoef:
            c3, c4 = s[3].reduce(), s[4].reduce()
            acc = [_lazy(gf.sub_lazy, acc[0], c3),
                   _lazy(gf.sub_lazy, _lazy(gf.add_lazy, acc[1], c3), c4),
                   _lazy(gf.add_lazy, acc[2], c4)]
    # the segment's scale w^(s 2^log_l)
    acc = np.stack([_canon(a) for a in acc], axis=-1)  # (rows, m, nseg, c)
    for seg in range(nseg):
        scale = _xpow(w, seg * big_l) if xpts else _pow(w, seg * big_l)[:,
                                                                       None]
        acc[:, :, seg] = mul(acc[:, :, seg], scale[None])
    # a block's segments, then the groups
    per_block = poly_cuda.FOLD_THREADS >> plan["log_p"]
    out = np.zeros((rows, m, comps), dtype=np.uint64)
    for g in range(plan["groups"]):
        part = np.zeros_like(out)
        for seg in range(g * per_block, min((g + 1) * per_block, nseg)):
            part = gfn.add(part, acc[:, :, seg])
        out = gfn.add(out, part)
    k6_model.widest_sum_bits = most
    return out if xpts else out[..., 0]


def _jax_fold(b, w):
    """JAX's cores (poly_batch.py:152, :226) on the same coefficients and
    points; the points padded to the chunk the pin tests compiled (64 base,
    16 xfe)."""
    from twenty_first_tpu.math import gf as jgf

    xpts = w.ndim == 2
    chunk = 16 if xpts else 64
    wp = np.zeros((chunk,) + w.shape[1:], np.uint64)
    wp[:w.shape[0]] = w
    bl, bh = jgf.to_limbs(b)
    wl, wh = jgf.to_limbs(wp)
    if xpts:
        out = jpb._coset_extrapolate_xfe_pow_core(bl, bh, wl, wh, b.ndim == 3)
    else:
        out = jpb._coset_extrapolate_pow_core(bl, bh, wl, wh)
    return jgf.from_limbs(out)[:, :w.shape[0]]


def _points(seed: int, m: int, xpts: bool):
    """m points with 0, 1, p - 1 and 2^32 - 1 among them (as xfe: lifted,
    and a base point lifted beside a full one)."""
    pts = _values(seed, (m, 3) if xpts else (m,))
    special = [0, 1, P - 1, (1 << 32) - 1][:m]
    if xpts:
        pts[:len(special)] = xgf.lift(np.array(special, np.uint64))
    else:
        pts[:len(special)] = special
    return pts


# (rows, n, m, xfe points, xfe coefficients, forced segment, against JAX):
# n a power of two, as the twin takes it, from 1 and 8 (below B, so no
# multiple of it) to 2^10, segments of 1, 2, 8 and 64 coefficients; JAX's
# cores at the shapes the pin tests compile (2^10 coefficients) and at n = 1
@pytest.mark.parametrize("case", [
    (3, 1 << 10, 64, False, False, None, True),
    (3, 1, 1, False, False, None, True),
    (3, 1 << 10, 64, False, False, 3, False),
    (3, 1 << 10, 64, False, False, 0, False),
    (1, 8, 33, False, False, None, False),
    (2, 1 << 10, 16, True, False, None, True),
    (2, 1 << 8, 5, True, False, 6, False),
    (2, 8, 16, True, True, None, False),
    (2, 1 << 10, 16, True, True, None, True),
    (2, 4, 33, True, True, 1, False),
    (1, 1, 1, True, True, None, False),
    (2, 1 << 10, 16, True, False, 3, True)])
def test_k6_schedule_model_matches_twin_and_jax(case):
    """The model at planned and forced segments (segments shorter than a
    block, n not a multiple of B, n = 1, m = 1 and 33; edge words among the
    coefficients and the points 0, 1, p - 1, 2^32 - 1 and a lifted base
    point) against the twin, and against JAX's cores."""
    rows, n, m, xpts, xcoef, seg, against_jax = case
    b = _values(10 + n, (rows, 3, n) if xcoef else (rows, n))
    w = _points(11 + n, m, xpts)
    plan = poly_cuda.fold_plan(rows, n, m, seg, xpts=xpts, xcoef=xcoef)
    got = k6_model(b, w, plan)
    twin = gf.to_u64(poly_cuda.coset_extrapolate_fold(
        gf.from_u64(b), gf.from_u64(w), point_chunk=16))
    np.testing.assert_array_equal(got, twin)
    if against_jax:
        np.testing.assert_array_equal(got, _jax_fold(b, w))


@pytest.mark.parametrize("word", [P - 1, (1 << 64) - 1])
@pytest.mark.parametrize("kinds", sorted(MOST_PRODUCTS))
def test_k6_accumulator_cannot_overflow(kinds, word):
    """At B = FOLD_BLOCK, the most products one accumulator takes in a block
    of all-(p - 1) operands (and of the largest lazy residue, 2^64 - 1)
    stay exact in its words, far below 2^160, and reduce to the sum."""
    count = MOST_PRODUCTS[kinds](poly_cuda.FOLD_BLOCK)
    acc = Wide((1,), exact=True)
    for _ in range(count):
        acc.mac(np.array([word], np.uint64), np.array([word], np.uint64))
    want = count * word * word
    assert acc.value()[0] == acc.exact[0] == want < 1 << 136
    assert int(acc.reduce()[0]) % P == want % P


def test_k6_model_with_all_p_minus_1_matches_twin():
    """Coefficients and points all p - 1, B = 16, every field kind."""
    for b_shape, w_shape in (((2, 128), (3,)), ((2, 128), (3, 3)),
                             ((2, 3, 128), (3, 3))):
        b = np.full(b_shape, P - 1, np.uint64)
        w = np.full(w_shape, P - 1, np.uint64)
        plan = poly_cuda.fold_plan(2, 128, 3, 6, xpts=len(w_shape) == 2,
                                   xcoef=len(b_shape) == 3)
        got = k6_model(b, w, plan, exact=True)
        assert k6_model.widest_sum_bits <= 134
        np.testing.assert_array_equal(got, gf.to_u64(
            poly_cuda.coset_extrapolate_fold(gf.from_u64(b), gf.from_u64(w))))


def test_k6_plan_covers_every_coefficient():
    """Segments tile the coefficients with none empty; blocks of segments
    cover every segment; a warp's lanes are whole groups of points; the
    path's shapes fill their lane targets."""
    for rows, n, m in [(1, 1 << 18, 1 << 10), (8, 1 << 20, 16),
                       (2, 1 << 20, 16), (3, 1 << 10, 64), (1, 1, 1),
                       (5, 1000, 3), (70000, 4, 2)]:
        for seg in (None, 0, 5):
            for kinds in poly_cuda.FOLD_TARGET_LANES:
                p = poly_cuda.fold_plan(rows, n, m, seg, xpts=kinds[0],
                                        xcoef=kinds[1])
                big_l = 1 << p["log_l"]
                assert (p["nseg"] - 1) * big_l < n <= p["nseg"] * big_l
                per_block = poly_cuda.FOLD_THREADS >> p["log_p"]
                assert (p["groups"] - 1) * per_block < p["nseg"]
                assert p["groups"] * per_block >= p["nseg"]
                assert 1 << p["log_p"] <= 32 and p["tiles"] << p["log_p"] >= m
    for rows, n, m, kinds in ((1, 1 << 18, 1 << 10, (False, False)),
                              (8, 1 << 20, 16, (True, False)),
                              (2, 1 << 20, 16, (True, True))):
        plan = poly_cuda.fold_plan(rows, n, m, xpts=kinds[0], xcoef=kinds[1])
        lanes = rows * plan["groups"] * poly_cuda.FOLD_THREADS * plan["tiles"]
        assert lanes == poly_cuda.FOLD_TARGET_LANES[kinds]


def test_fold_probe_forces_the_planned_segment_for_a_lane_target():
    """probes/fold_probe.py sweeps lane targets by forcing the segment that
    fold_plan picks for each: at the plan's own targets that is the plan's
    segment, and a larger target gives a segment no longer."""
    from twenty_first_tpu_torch.probes import fold_probe

    for _, rows, n, m, xpts, xcoef in fold_probe.SHAPES:
        target = poly_cuda.FOLD_TARGET_LANES[xpts, xcoef]
        plan = poly_cuda.fold_plan(rows, n, m, xpts=xpts, xcoef=xcoef)
        log_t = target.bit_length() - 1
        assert fold_probe.seg_log2_for(rows, n, m, log_t) == plan["log_l"]
        assert fold_probe.seg_log2_for(rows, n, m, log_t + 1) <= plan["log_l"]


# ---------------------------------------------------------------------------
# K7's schedule
# ---------------------------------------------------------------------------


def _scan_ex(t, axis=-1):
    """Exclusive prefix and suffix products along ``axis``."""
    t = np.moveaxis(t, axis, -1)
    pre, suf = np.ones_like(t), np.ones_like(t)
    for k in range(1, t.shape[-1]):
        pre[..., k] = gfn.mul(pre[..., k - 1], t[..., k - 1])
        j = t.shape[-1] - 1 - k
        suf[..., j] = gfn.mul(suf[..., j + 1], t[..., j + 1])
    return np.moveaxis(pre, -1, axis), np.moveaxis(suf, -1, axis)


def k7_model(x):
    """K7 on a (rows, n) host array, as its two launches compute it: each
    segment's block loads its elements once (thread k: elements k, k + 256,
    ...), forms each thread's running products, scans them both ways over
    the block (lanes of a warp, then warp 0 over the warps), inverts the
    segment's product once, gives each warp its factor (that inverse times
    the warp's exclusive prefix and suffix) and each thread the inverse of
    its product, and walks back over the thread's elements; a segment whose
    product is 0 sets its flag, and the second launch zeroes every segment
    of a row with a flag."""
    rows, n = x.shape
    threads, per = poly_cuda.INV_THREADS, poly_cuda.INV_PER_THREAD
    seg_len = poly_cuda.INV_SEGMENT
    nseg = -(-n // seg_len)
    pad = np.ones((rows, nseg * seg_len), dtype=np.uint64)
    pad[:, :n] = x
    v = pad.reshape(rows, nseg, per, threads)  # element s*S + e*256 + k
    pre = np.empty_like(v)
    pre[:, :, 0] = v[:, :, 0]
    for e in range(1, per):
        pre[:, :, e] = gfn.mul(pre[:, :, e - 1], v[:, :, e])
    # the block scan: lanes of each warp, then the warps' products
    t = pre[:, :, -1].reshape(rows, nseg, threads // 32, 32)
    lane_pre, lane_suf = _scan_ex(t)
    warp_prod = gfn.mul(lane_pre[..., -1], t[..., -1])
    warp_pre, warp_suf = _scan_ex(warp_prod)
    total = gfn.mul(warp_pre[..., -1], warp_prod[..., -1])
    inv = np.array([pow(int(u), P - 2, P) for u in total.reshape(-1)],
                   dtype=np.uint64).reshape(total.shape)  # 0 -> 0
    factor = gfn.mul(inv[..., None], gfn.mul(warp_pre, warp_suf))
    a = gfn.mul(gfn.mul(factor[..., None], lane_pre), lane_suf)
    a = a.reshape(rows, nseg, threads)
    out = np.empty_like(v)
    for e in range(per - 1, -1, -1):
        out[:, :, e] = gfn.mul(a, pre[:, :, e - 1]) if e else a
        a = gfn.mul(a, v[:, :, e])
    out = out.reshape(rows, -1)[:, :n]
    # the second launch: a row with a flagged segment comes out all zeros
    out[(total == 0).any(axis=1)] = 0
    return out


SEG = poly_cuda.INV_SEGMENT


@pytest.mark.parametrize("rows,n,zeros,against_jax", [
    (3, 5000, None, True), (2, 2048, None, False), (1, 1, None, False),
    (4, 300, None, False), (1, 3 * 2048 + 1, None, False),
    # a 0 in a row's last, part segment only; 0s in two segments
    (2, 2 * SEG + 5, ((1, 2 * SEG + 3),), True),
    (3, 3 * SEG, ((1, 9), (1, 2 * SEG + 100)), True),
    # n around one segment
    (2, SEG - 1, ((1, SEG - 2),), False), (2, SEG, ((0, SEG - 1),), False),
    (2, SEG + 1, ((0, SEG),), False)])
def test_k7_schedule_model_matches_twin_and_jax(rows, n, zeros, against_jax):
    """Rows of one and several segments, rows holding a 0 (all zeros out;
    by default one at (1, n // 3) where there are two rows); the twin is
    held against JAX at every shape by test_torch_gf.py."""
    x = _values(20 + n, (rows, n))
    x[x == 0] = 3
    if zeros is None:
        zeros = ((1, n // 3),) if rows > 1 else ()
    for r, j in zeros:
        x[r, j] = 0
    got = k7_model(x)
    np.testing.assert_array_equal(
        got, gf.to_u64(poly_cuda.batch_inversion(gf.from_u64(x))))
    if against_jax:
        from twenty_first_tpu.math import gf as jgf

        np.testing.assert_array_equal(
            got, jgf.from_limbs(jgf.batch_inversion(jgf.to_limbs(x))))
    zero_rows = {r for r, _ in zeros}
    for r in range(rows):
        if r in zero_rows:
            assert not got[r].any()
        else:
            assert (gfn.mul(got[r], x[r]) == 1).all()
