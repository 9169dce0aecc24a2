"""The port's field layer (twenty_first_tpu_torch.math.gf) against the JAX
package's gf on the same inputs, exactly: integer field arithmetic.

Inputs are made with numpy and cross over through the limb converters."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from twenty_first_tpu.math import b_field_element as jbfe
from twenty_first_tpu.math import gf as jgf
from twenty_first_tpu.math import gf_numpy as jgfn
from twenty_first_tpu_torch.math import b_field_element as tbfe
from twenty_first_tpu_torch.math import gf
from twenty_first_tpu_torch.math import gf_numpy as tgfn

P = jbfe.P
EDGES = [0, 1, 2, P - 2, P - 1, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
         (1 << 63), (1 << 63) - 1, P // 2]
# u64 values at or above p, which mul, canon and from_montgomery must accept
ABOVE_P = [P, P + 1, (1 << 64) - 1, (1 << 64) - 2, P + (1 << 31)]
REPO = Path(__file__).resolve().parent.parent


def _operands(seed: int, extra=()):
    rng = np.random.default_rng(seed)
    edge = np.array(EDGES + list(extra), dtype=np.uint64)
    a = np.concatenate([np.repeat(edge, len(edge)),
                        rng.integers(0, P, size=256, dtype=np.uint64)])
    b = np.concatenate([np.tile(edge, len(edge)),
                        rng.integers(0, P, size=256, dtype=np.uint64)])
    return a, b


def _jax(fn, *args):
    return jgf.from_limbs(fn(*(jgf.to_limbs(a) for a in args)))


def _port(fn, *args):
    return gf.to_u64(fn(*(gf.from_jax_limbs(jgf.to_limbs(a)) for a in args)))


def test_copied_constants_equal_jax():
    assert tbfe.P == jbfe.P
    assert tbfe.GENERATOR == jbfe.GENERATOR == jgf.GENERATOR
    assert tbfe.PRIMITIVE_ROOTS == jbfe.PRIMITIVE_ROOTS
    assert (gf.R, gf.R_INV) == (jgf.R, jgf.R_INV)
    assert gf.EPSILON == int(jgf.EPSILON)


def test_gf_numpy_helpers_equal_jax():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 1 << 64, size=1000, dtype=np.uint64, endpoint=False)
    b = rng.integers(0, 1 << 64, size=1000, dtype=np.uint64, endpoint=False)
    np.testing.assert_array_equal(tgfn.mul(a, b), jgfn.mul(a, b))
    for base, n in ((7, 1), (7, 1000), (jbfe.PRIMITIVE_ROOTS[1 << 10], 1 << 10),
                    (P - 1, 5)):
        np.testing.assert_array_equal(tgfn.powers(base, n),
                                      jgfn.powers(base, n))


# the words where the field ops' fix-ups turn
GFN_EDGES = [0, 1, P - 1, 1 << 32, (1 << 32) - 1]


def _gfn_operands(seed: int):
    rng = np.random.default_rng(seed)
    edge = np.array(GFN_EDGES, dtype=np.uint64)
    a = np.concatenate([np.repeat(edge, len(edge)),
                        rng.integers(0, P, size=500, dtype=np.uint64)])
    b = np.concatenate([np.tile(edge, len(edge)),
                        rng.integers(0, P, size=500, dtype=np.uint64)])
    return a, b


@pytest.mark.parametrize("name", ["add", "sub", "mul"])
def test_gf_numpy_binary_copies_equal_jax(name):
    """The copies of the JAX package's host forms, on random and edge
    words (the JAX forms take their native route where it is built)."""
    a, b = _gfn_operands(13)
    got = getattr(tgfn, name)(a, b)
    np.testing.assert_array_equal(got, getattr(jgfn, name)(a, b))
    python = {"add": lambda x, y: (x + y) % P, "sub": lambda x, y: (x - y) % P,
              "mul": lambda x, y: x * y % P}[name]
    assert got.tolist() == [python(int(x), int(y)) for x, y in zip(a, b)]


def test_gf_numpy_unary_copies_equal_jax():
    a, _ = _gfn_operands(14)
    np.testing.assert_array_equal(tgfn.neg(a), jgfn.neg(a))
    inv = tgfn.inverse(a)
    np.testing.assert_array_equal(inv, jgfn.inverse(a))
    assert inv.tolist() == [pow(int(x), P - 2, P) for x in a]
    for base, e in ((0, 0), (7, P - 2), (P - 1, 1 << 40), (1 << 32, 3)):
        assert tgfn.pow_scalar(base, e) == jgfn.pow_scalar(base, e)


def test_carrier_round_trips():
    rng = np.random.default_rng(2)
    v = rng.integers(0, 1 << 64, size=(3, 7), dtype=np.uint64,
                     endpoint=False)
    t = gf.from_jax_limbs(jgf.to_limbs(v))
    assert t.dtype == torch.int64 and t.shape == (3, 7)
    np.testing.assert_array_equal(gf.to_u64(t), v)
    np.testing.assert_array_equal(gf.to_u64(gf.from_u64(v)), v)
    lo, hi = gf.to_jax_limbs(t)
    jlo, jhi = jgf.to_limbs(v)
    np.testing.assert_array_equal(lo, np.asarray(jlo))
    np.testing.assert_array_equal(hi, np.asarray(jhi))


@pytest.mark.parametrize("name", ["add", "sub", "mul"])
def test_binary_ops_match_jax(name):
    a, b = _operands(3)
    want = _jax(getattr(jgf, name), a, b)
    got = _port(getattr(gf, name), a, b)
    np.testing.assert_array_equal(got, want)
    python = {"add": lambda x, y: (x + y) % P, "sub": lambda x, y: (x - y) % P,
              "mul": lambda x, y: x * y % P}[name]
    assert got.tolist() == [python(int(x), int(y)) for x, y in zip(a, b)]


@pytest.mark.parametrize("name", ["neg", "square", "canon", "to_montgomery"])
def test_unary_ops_match_jax(name):
    a, _ = _operands(4)
    np.testing.assert_array_equal(_port(getattr(gf, name), a),
                                  _jax(getattr(jgf, name), a))


def test_mul_accepts_any_u64():
    a, b = _operands(5, ABOVE_P)
    got = _port(gf.mul, a, b)
    assert got.tolist() == [int(x) * int(y) % P for x, y in zip(a, b)]


def test_canon_of_any_u64():
    v = np.array(EDGES + ABOVE_P, dtype=np.uint64)
    got = _port(gf.canon, v)
    np.testing.assert_array_equal(got, _jax(jgf.canon, v))
    assert got.tolist() == [int(x) % P for x in v]


def test_from_montgomery_accepts_any_u64():
    v = np.array(EDGES + ABOVE_P, dtype=np.uint64)
    got = _port(gf.from_montgomery, v)
    np.testing.assert_array_equal(got, _jax(jgf.from_montgomery, v))
    assert got.tolist() == [int(x) * jgf.R_INV % P for x in v]


@pytest.mark.parametrize("k", [0, 1, 7, P - 1, jgf.R, 1 << 40])
def test_mul_const_matches_jax(k):
    a, _ = _operands(6)
    np.testing.assert_array_equal(
        _port(lambda x: gf.mul_const(x, k), a),
        _jax(lambda x: jgf.mul_const(x, k), a))


@pytest.mark.parametrize("e", [0, 1, 2, 7, 64, P - 2])
def test_pow_const_matches_jax(e):
    a, _ = _operands(7)
    np.testing.assert_array_equal(
        _port(lambda x: gf.pow_const(x, e), a),
        _jax(lambda x: jgf.pow_const(x, e), a))


def test_reduce128_matches_jax():
    rng = np.random.default_rng(8)
    words = rng.integers(0, 1 << 32, size=(4, 300), dtype=np.uint64)
    words[:, :4] = 0xFFFF_FFFF  # the all-ones 128-bit value and neighbours
    words[3, 4:8] = 0
    x0, x1, x2, x3 = (w.astype(np.uint32) for w in words)
    want = jgf.from_limbs(jgf.reduce128(x0, x1, x2, x3))
    lo = gf.from_u64(words[0] | (words[1] << np.uint64(32)))
    hi = gf.from_u64(words[2] | (words[3] << np.uint64(32)))
    got = gf.to_u64(gf.reduce128(lo, hi))
    np.testing.assert_array_equal(got, want)
    full = [int(a) | int(b) << 32 | int(c) << 64 | int(d) << 96
            for a, b, c, d in words.T]
    assert got.tolist() == [v % P for v in full]


# operands of the lazy forms: any u64, the words where their fix-ups turn
LAZY_EDGES = [0, 1, P - 1, P, (1 << 32) - 1, 1 << 32, (1 << 64) - 1]


def _lazy_operands(seed: int):
    rng = np.random.default_rng(seed)
    edge = np.array(LAZY_EDGES, dtype=np.uint64)
    rand = [rng.integers(0, 1 << 64, size=512, dtype=np.uint64,
                         endpoint=False) for _ in range(2)]
    return (np.concatenate([np.repeat(edge, len(edge)), rand[0]]),
            np.concatenate([np.tile(edge, len(edge)), rand[1]]))


@pytest.mark.parametrize("name", ["mul_lazy", "add_lazy", "sub_lazy"])
def test_lazy_binary_ops_match_jax(name):
    """The same raw words as JAX, not just the same residues."""
    a, b = _lazy_operands(9)
    got = _port(getattr(gf, name), a, b)
    np.testing.assert_array_equal(got, _jax(getattr(jgf, name), a, b))
    python = {"mul_lazy": lambda x, y: x * y, "add_lazy": lambda x, y: x + y,
              "sub_lazy": lambda x, y: x - y}[name]
    assert [int(g) % P for g in got] == [python(int(x), int(y)) % P
                                         for x, y in zip(a, b)]


def test_reduce128_lazy_matches_jax():
    rng = np.random.default_rng(10)
    words = rng.integers(0, 1 << 32, size=(4, 300), dtype=np.uint64)
    words[:, :4] = 0xFFFF_FFFF
    words[3, 4:8] = 0
    words[2, 8:12] = 0
    x0, x1, x2, x3 = (w.astype(np.uint32) for w in words)
    want = jgf.from_limbs(jgf.reduce128_lazy(x0, x1, x2, x3))
    lo = gf.from_u64(words[0] | (words[1] << np.uint64(32)))
    hi = gf.from_u64(words[2] | (words[3] << np.uint64(32)))
    np.testing.assert_array_equal(gf.to_u64(gf.reduce128_lazy(lo, hi)), want)


@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("e", [1, 24, 31, 32, 33, 48, 63, 64, 65, 72, 95])
def test_mul_by_pow2_lazy_matches_jax(e, negate):
    a, _ = _lazy_operands(11)
    got = _port(lambda x: gf.mul_by_pow2_lazy(x, e, negate), a)
    np.testing.assert_array_equal(
        got, _jax(lambda x: jgf.mul_by_pow2_lazy(x, e, negate), a))
    sign = -1 if negate else 1
    assert [int(g) % P for g in got] == [sign * int(x) * (1 << e) % P
                                         for x in a]


@pytest.mark.parametrize("inverse", [False, True])
def test_mul_by_i_lazy_matches_jax(inverse):
    a, _ = _lazy_operands(12)
    np.testing.assert_array_equal(
        _port(lambda x: gf.mul_by_i_lazy(x, inverse), a),
        _jax(lambda x: jgf.mul_by_i_lazy(x, inverse), a))


def test_mul_by_pow2_lazy_rejects_bad_shift():
    for e in (0, 96):
        with pytest.raises(ValueError):
            gf.mul_by_pow2_lazy(gf.from_u64([1]), e)


def test_inverse_or_zero_matches_jax():
    """The chain for x^(p-2) (the plain twin of K8's inverse) against JAX's
    CPU form; 0 -> 0."""
    a, _ = _operands(15)
    got = _port(lambda x: gf.inverse_or_zero(x, plain=True), a)
    np.testing.assert_array_equal(got, _jax(jgf.inverse_or_zero, a))
    np.testing.assert_array_equal(_port(gf.inverse_or_zero, a), got)
    assert got.tolist() == [pow(int(x), P - 2, P) for x in a]


# ---------------------------------------------------------------------------
# K8's inverse chain (csrc/poly.cu::inverse_or_zero: gl::sqr_red squarings
# and gl::mul_red products on lazy residues, one canonicalisation at the end)
# ---------------------------------------------------------------------------

M32, S32 = np.uint64(0xFFFF_FFFF), np.uint64(32)
EPS = np.uint64(gf.EPSILON)


def sqr_red_model(x):
    """gl::sqr_red word by word: the square (p3, p2, p1, p0) from x_lo^2,
    x_hi^2 and the doubled cross product; r = ((p1, p0) + p2 2^32 - (p2 +
    p3)) mod 2^64 and d = carry - borrow; then the one fix r + d (2^32 - 1),
    which the model checks cannot wrap."""
    a, b = x & M32, x >> S32
    with np.errstate(over="ignore"):
        aa, bb, ab = a * a, b * b, a * b
        t0 = (ab & M32) << np.uint64(1)
        t1 = ((ab >> S32) << np.uint64(1)) + (t0 >> S32)
        t0, t2, t1 = t0 & M32, t1 >> S32, t1 & M32
        s = (aa >> S32) + t0
        p1, c = s & M32, s >> S32
        s = (bb & M32) + t1 + c
        p2, c = s & M32, s >> S32
        p3 = (bb >> S32) + t2 + c
        assert (p3 <= M32).all()
        s = p1 + p2
        lo = (aa & M32) | ((s & M32) << S32)
        q = p2 + p3
        r = lo - q
        d = (s >> S32).astype(np.int64) - (lo < q).astype(np.int64)
        fixed = np.where(d > 0, r + EPS, np.where(d < 0, r - EPS, r))
    assert not ((d > 0) & (fixed < r)).any(), "r + (2^32 - 1) wrapped"
    assert not ((d < 0) & (fixed > r)).any(), "r - (2^32 - 1) wrapped"
    return fixed


def inverse_chain_model(x):
    """K8's inverse: gf.py::inverse_or_zero's addition chain (:467-477) on
    the squaring model and the port's mul_lazy."""
    def nsquare(v, n):
        for _ in range(n):
            v = sqr_red_model(v)
        return v

    def mul(a, b):  # gl::mul_red: mul_lazy's words
        return gf.to_u64(gf.mul_lazy(gf.from_u64(a), gf.from_u64(b)))

    bin2 = mul(nsquare(x, 1), x)
    bin3 = mul(nsquare(bin2, 1), x)
    bin6 = mul(nsquare(bin3, 3), bin3)
    bin12 = mul(nsquare(bin6, 6), bin6)
    bin24 = mul(nsquare(bin12, 12), bin12)
    bin30 = mul(nsquare(bin24, 6), bin6)
    bin31 = mul(nsquare(bin30, 1), x)
    bin31_z = nsquare(bin31, 1)
    bin32 = mul(bin31_z, x)
    r = mul(nsquare(bin31_z, 32), bin32)
    return np.where(r >= np.uint64(P), r - np.uint64(P), r)


def test_sqr_red_model_is_the_square():
    """Any u64 in (the words where the fix-ups turn among them): a residue
    of x^2, with the one fix-up never wrapping."""
    a, b = _lazy_operands(18)
    for x in (a, b, np.array(ABOVE_P + EDGES, dtype=np.uint64)):
        got = sqr_red_model(x)
        assert [int(g) % P for g in got] == [int(v) * int(v) % P for v in x]
        np.testing.assert_array_equal(
            np.where(got >= np.uint64(P), got - np.uint64(P), got),
            tgfn.mul(x, x))


def test_inverse_chain_model_matches_jax():
    """On 0, 1, p - 1, 2^32 - 1, 2^32, the other edge words and random
    words (the operands test_inverse_or_zero_matches_jax gives JAX)."""
    a, _ = _operands(15)
    got = inverse_chain_model(a)
    np.testing.assert_array_equal(got, _jax(jgf.inverse_or_zero, a))
    np.testing.assert_array_equal(got, _port(
        lambda v: gf.inverse_or_zero(v, plain=True), a))
    assert got.tolist() == [pow(int(v), P - 2, P) for v in a]


# ---------------------------------------------------------------------------
# K5's carry-chain forms (csrc/goldilocks.cuh), word by word as their PTX
# computes: gl::mul_red's and gl::add_lazy_cc's 32-bit carry chains. Each
# gives JAX's raw lazy words.
# ---------------------------------------------------------------------------

def _words(x):
    """The 32-bit words (lo, hi) of u64 values, as int64."""
    return (x & M32).astype(np.int64), (x >> S32).astype(np.int64)


def _mul32(x, y):
    """lo and hi words of x * y for 32-bit words (the product fits a u64)."""
    p = x.astype(np.uint64) * y.astype(np.uint64)
    return _words(p)


def _add_cc(x, y, c=0):
    """add.cc / addc.cc: the 32-bit sum and its carry."""
    s = x + y + c
    return s & 0xFFFF_FFFF, s >> 32


def _reduce_words_model(p0, p1, p2, p3):
    """gl::mul_red's reduction (gl::reduce128_lazy_cc's chain):
    (p1, p0) - p3, a borrow worth 2^32 - 1, then + p2 (2^32 - 1), a carry
    worth 2^32 - 1, each fix-up a mask from the chain's carry or borrow;
    the model checks that no fix-up carries or borrows again."""
    d = p0 - p3
    r0, borrow = d & 0xFFFF_FFFF, (d < 0).astype(np.int64)
    d = p1 - borrow
    r1, borrow = d & 0xFFFF_FFFF, (d < 0).astype(np.int64)
    c = borrow * 0xFFFF_FFFF  # subc.u32 c, 0, 0
    d = r0 - c
    r0, b = d & 0xFFFF_FFFF, (d < 0).astype(np.int64)
    d = r1 - b
    assert (d >= 0).all(), "the borrow fix-up borrowed again"
    r1 = d
    m0 = (-p2) & 0xFFFF_FFFF  # m = p2 2^32 - p2
    m1 = p2 - (p2 != 0).astype(np.int64)
    r0, c = _add_cc(r0, m0)
    r1, c = _add_cc(r1, m1, c)
    r0, c = _add_cc(r0, c * 0xFFFF_FFFF)  # neg.s32 of the carry
    r1, c = _add_cc(r1, c)
    assert not c.any(), "the carry fix-up carried again"
    return r0.astype(np.uint64) | (r1.astype(np.uint64) << S32)


def mul_red_model(a, b):
    """gl::mul_red: the 128-bit product (p3, p2, p1, p0) by its carry chain
    of 32-bit multiply-adds, then the reduction."""
    a0, a1 = _words(a)
    b0, b1 = _words(b)
    l00, h00 = _mul32(a0, b0)
    l01, h01 = _mul32(a0, b1)
    l10, h10 = _mul32(a1, b0)
    l11, h11 = _mul32(a1, b1)
    p0 = l00
    p1, c = _add_cc(h00, l01)  # mad.lo.cc p1, a0, b1, p1
    p2 = h01 + c  # madc.hi p2, a0, b1, 0
    assert (p2 <= 0xFFFF_FFFF).all()
    p1, c = _add_cc(p1, l10)  # mad.lo.cc p1, a1, b0, p1
    p2, c = _add_cc(p2, h10, c)  # madc.hi.cc p2, a1, b0, p2
    p3 = h11 + c  # madc.hi p3, a1, b1, 0
    p2, c = _add_cc(p2, l11)  # mad.lo.cc p2, a1, b1, p2
    p3 = p3 + c  # addc p3, p3, 0
    assert (p3 <= 0xFFFF_FFFF).all()
    return _reduce_words_model(p0, p1, p2, p3)


def add_lazy_cc_model(a, b):
    """gl::add_lazy_cc: the 64-bit sum, its carry worth 2^32 - 1, and that
    fix-up's carry worth 2^32 - 1 again."""
    a0, a1 = _words(a)
    b0, b1 = _words(b)
    r0, c = _add_cc(a0, b0)
    r1, c = _add_cc(a1, b1, c)
    for _ in range(2):
        r0, c2 = _add_cc(r0, c * 0xFFFF_FFFF)
        r1, c = _add_cc(r1, c2)
    assert not c.any(), "a third fix-up"
    return r0.astype(np.uint64) | (r1.astype(np.uint64) << S32)


@pytest.mark.parametrize("form,model,jax_op", [
    ("mul_red", mul_red_model, "mul_lazy"),
    ("add_lazy_cc", add_lazy_cc_model, "add_lazy")])
def test_k5_form_models_match_jax(form, model, jax_op):
    """On the edge words 0, 1, p - 1, p, 2^32 - 1, 2^32, 2^64 - 1 (every
    pair) and random u64 words: JAX's raw lazy words, not just residues."""
    a, b = _lazy_operands(19)
    np.testing.assert_array_equal(model(a, b),
                                  _jax(getattr(jgf, jax_op), a, b))


@pytest.mark.parametrize("axis", [0, -1])
def test_batch_inversion_matches_jax(axis):
    """Along either axis; a lane holding a 0 comes out all zeros in both."""
    rng = np.random.default_rng(16)
    x = rng.integers(1, P, size=(6, 40), dtype=np.uint64)
    x[0, :5] = GFN_EDGES[1:] + [1]
    x[2, 9] = 0
    want = _jax(lambda v: jgf.batch_inversion(v, axis=axis), x)
    got = _port(lambda v: gf.batch_inversion(v, axis=axis), x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _port(lambda v: gf.batch_inversion(v, axis=axis, plain=True), x), want)
    zero_lane = got[2] if axis == -1 else got[:, 9]
    assert not zero_lane.any()


def test_prefix_prod_matches_jax():
    x, _ = _operands(17)
    x = x[:300].reshape(3, 100)
    np.testing.assert_array_equal(_port(gf._prefix_prod, x),
                                  _jax(jgf._prefix_prod, x))


def test_fixed_mul_golden():
    got = gf.mul(gf.from_u64([2779336007265862836]),
                 gf.from_u64([8146517303801474933]))
    assert gf.to_u64(got).tolist() == [1857758653037316764]


def test_port_never_imports_jax():
    """Importing every module of the port leaves jax out of sys.modules of
    a fresh interpreter, and no source line of the port imports jax."""
    mods = ["twenty_first_tpu_torch", "twenty_first_tpu_torch.entry",
            "twenty_first_tpu_torch.parallel.pipeline",
            "twenty_first_tpu_torch.tip5.permutation",
            "twenty_first_tpu_torch.math.gf",
            "twenty_first_tpu_torch.math.gf_ext",
            "twenty_first_tpu_torch.math.xgf_numpy",
            "twenty_first_tpu_torch.math.ntt",
            "twenty_first_tpu_torch.math.poly_batch",
            "twenty_first_tpu_torch.errors",
            "twenty_first_tpu_torch.ops.poly_cuda",
            "twenty_first_tpu_torch.ops.tip5_commit",
            "twenty_first_tpu_torch.ops.ntt_cuda",
            "twenty_first_tpu_torch.ops.tip5_cuda",
            "twenty_first_tpu_torch.ops.tip5_batch",
            "twenty_first_tpu_torch.ops.probe_cuda",
            "twenty_first_tpu_torch.probes",
            "twenty_first_tpu_torch.probes.timing",
            "twenty_first_tpu_torch.probes.pass_probe",
            "twenty_first_tpu_torch.probes.alu_probe",
            "twenty_first_tpu_torch.probes.fold_probe",
            "twenty_first_tpu_torch.probes.inv_probe",
            "twenty_first_tpu_torch._build", "chip_smoke"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' "
              "or m.startswith(('jax.', 'jaxlib', 'twenty_first_tpu.')) "
              "or m == 'twenty_first_tpu')\n"
            + "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for src in (REPO / "twenty_first_tpu_torch").rglob("*.py"):
        for line in src.read_text().splitlines():
            words = line.split()
            assert not (words[:2] == ["import", "jax"]
                        or words[:1] == ["from"] and words[1:2]
                        and words[1].split(".")[0] in ("jax",
                                                       "twenty_first_tpu")
                        ), f"{src}: {line}"
