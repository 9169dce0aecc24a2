"""A numpy model of the Tip5 kernels' arithmetic (csrc/tip5.cu), step for
step on uint64 (wrapping) words: lazy products, the S-box's Montgomery
conversions by shifts and adds, the MDS with the round constant folded into
its half-sums, and K1's lane mode (a row's words across lanes, the MDS by
shuffle steps, the capacity lazy between permutations). It is a model,
not a twin: the plain twin's steps (tip5/permutation.py:
_split_and_lookup, _pow7, _mds) stay the specification, and the tests
hold each step of the model against them and the whole against the JAX
package, on random words and on edge words, lazy ones (>= p) included.
"""

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu.tip5 import permutation as jperm
from twenty_first_tpu_torch.math import gf
from twenty_first_tpu_torch.tip5 import permutation as tperm
from twenty_first_tpu_torch.tip5.constants import (DIGEST_LENGTH,
                                                   LOOKUP_TABLE,
                                                   MDS_MATRIX_FIRST_COLUMN,
                                                   NUM_ROUNDS,
                                                   NUM_SPLIT_AND_LOOKUP,
                                                   RATE, ROUND_CONSTANTS,
                                                   STATE_SIZE)

_U = np.uint64
_P, _EPS, _M32, _S32 = _U(0xFFFF_FFFF_0000_0001), _U(0xFFFF_FFFF), \
    _U(0xFFFF_FFFF), _U(32)


def model_reduce_lazy(lo, hi):
    """lo + hi * 2^64 as a lazy residue: lo + hl * (2^32 - 1) - hh."""
    hh, hl = hi >> _S32, hi & _M32
    t = lo - hh
    t = np.where(lo < hh, t - _EPS, t)
    m = (hl << _S32) - hl
    r = t + m
    return np.where(r < m, r + _EPS, r)


def model_mul(a, b):
    """a * b for any u64 residues on 32-bit halves, lazy out."""
    a0, a1, b0, b1 = a & _M32, a >> _S32, b & _M32, b >> _S32
    p00 = a0 * b0
    t = a0 * b1 + (p00 >> _S32)
    u = a1 * b0 + (t & _M32)
    hi = a1 * b1 + (t >> _S32) + (u >> _S32)
    return model_reduce_lazy((u << _S32) | (p00 & _M32), hi)


def model_pow7(x):
    x3 = model_mul(model_mul(x, x), x)
    return model_mul(model_mul(x3, x3), x)


def model_to_montgomery(x):
    """x * 2^64 mod p, canonical: x0 * (2^32 - 1) - x1, + p on a borrow."""
    x0, x1 = x & _M32, x >> _S32
    a = (x0 << _S32) - x0
    r = a - x1
    return np.where(a < x1, r + _P, r)


def model_from_montgomery(x):
    """x * 2^-64 mod p as p - b, b = a - (a >> 32) - carry, a = x + x << 32
    (in [1, p]: p stands for 0)."""
    a = x + (x << _S32)
    b = a - (a >> _S32) - (a < x).astype(np.uint64)
    return _P - b


def model_sbox(x):
    m = model_to_montgomery(x)
    out = np.zeros_like(m)
    for k in range(0, 64, 8):
        out |= LOOKUP_TABLE.astype(np.uint64)[(m >> _U(k)) & _U(0xFF)] \
            << _U(k)
    return model_from_montgomery(out)


def model_mds_add_rc(s, rc):
    """MDS(s) + rc for lazy (..., 16) words: the exact half-sums (below
    2^52, so a double holds them exactly too), then one combine."""
    col = [int(c) for c in MDS_MATRIX_FIRST_COLUMN]
    lo, hi = s & _M32, s >> _S32
    out = np.empty_like(s)
    for i in range(STATE_SIZE):
        acc_lo = np.full(s.shape[:-1], rc[i] & _M32, dtype=np.uint64)
        acc_hi = np.full(s.shape[:-1], rc[i] >> _S32, dtype=np.uint64)
        for j in range(STATE_SIZE):
            acc_lo = acc_lo + _U(col[(i - j) % 16]) * lo[..., j]
            acc_hi = acc_hi + _U(col[(i - j) % 16]) * hi[..., j]
        out[..., i] = model_combine(acc_lo, acc_hi)
    return out


def model_combine(acc_lo, acc_hi):
    """acc_lo + acc_hi * 2^32 (acc_hi below 2^54) as a lazy residue."""
    lo64 = acc_lo + (acc_hi << _S32)
    q = (acc_hi >> _S32) + (lo64 < acc_lo).astype(np.uint64)
    m = (q << _S32) - q
    r = lo64 + m
    return np.where(r < m, r + _EPS, r)


def model_mds_lanes(s, rc):
    """The lane mode's MDS (mds_lanes): lane i sums col[k] * s[(i - k) mod
    16] over the shuffle steps k in two chains a half (even and odd k), the
    round constant at the start of chain 0; the chains added, one combine.
    Asserts each chain's bound (below 2^53)."""
    col = [int(c) for c in MDS_MATRIX_FIRST_COLUMN]
    lanes = np.arange(STATE_SIZE)
    lo, hi = s & _M32, s >> _S32
    zero = np.zeros_like(s)
    acc_lo = [zero + (rc & _M32), zero.copy()]
    acc_hi = [zero + (rc >> _S32), zero.copy()]
    for k in range(STATE_SIZE):
        src = (lanes - k) % STATE_SIZE
        acc_lo[k & 1] = acc_lo[k & 1] + _U(col[k]) * lo[..., src]
        acc_hi[k & 1] = acc_hi[k & 1] + _U(col[k]) * hi[..., src]
    assert all((a < _U(1 << 53)).all() for a in acc_lo + acc_hi)
    return model_combine(acc_lo[0] + acc_lo[1], acc_hi[0] + acc_hi[1])


def lane_sponge_model(padded):
    """K1's lane mode on (rows, k * 10) padded words, lane i word i: every
    lane computes both S-boxes (the lookup on zeros past lane 3) and keeps
    its own, then model_mds_lanes; the capacity stays lazy from one
    permutation to the next; the digest is made canonical at the end. x^7
    is K1's representative here (the kernel's pow7_k9 gives another of the
    same residue, test_torch_tip5_mxu.py's model), which every step takes."""
    lanes = np.arange(STATE_SIZE)
    s = np.zeros((padded.shape[0], STATE_SIZE), dtype=np.uint64)
    with np.errstate(over="ignore"):
        for c in range(0, padded.shape[1], RATE):
            s[:, :RATE] = padded[:, c:c + RATE]
            for r in range(NUM_ROUNDS):
                lookup = lanes < NUM_SPLIT_AND_LOOKUP
                looked = model_sbox(np.where(lookup, s, _U(0)))
                s = np.where(lookup, looked, model_pow7(s))
                s = model_mds_lanes(s, ROUND_CONSTANTS[r * STATE_SIZE:
                                                       (r + 1) * STATE_SIZE])
    d = s[:, :DIGEST_LENGTH]
    return np.where(d >= _P, d - _P, d)


def permutation_model(states):
    """uint64 (..., 16) -> canonical (..., 16): the kernels' rounds."""
    s = np.array(states, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for r in range(NUM_ROUNDS):
            s[..., :NUM_SPLIT_AND_LOOKUP] = model_sbox(
                s[..., :NUM_SPLIT_AND_LOOKUP])
            s[..., NUM_SPLIT_AND_LOOKUP:] = model_pow7(
                s[..., NUM_SPLIT_AND_LOOKUP:])
            s = model_mds_add_rc(s, ROUND_CONSTANTS[r * STATE_SIZE:
                                                    (r + 1) * STATE_SIZE])
    return np.where(s >= _P, s - _P, s)


P = int(_P)
M = 1 << 64
RNG = np.random.default_rng(23)
EDGES = [0, 1, 2, P - 2, P - 1, P, P + 1, (1 << 32) - 1, 1 << 32,
         (1 << 32) + 1, (1 << 63), M - (1 << 32), M - 2, M - 1]


def _words(n: int, lazy: bool = True) -> np.ndarray:
    """Random words below 2^64 (or p), then every edge word."""
    rnd = RNG.integers(0, M if lazy else P, size=n, dtype=np.uint64,
                       endpoint=False)
    edges = [e for e in EDGES if lazy or e < P]
    return np.concatenate([rnd, np.array(edges, dtype=np.uint64)])


def _ints(a) -> list[int]:
    return [int(v) for v in np.asarray(a).ravel()]


def test_to_montgomery_is_canonical_for_any_word():
    x = _words(4000)
    got = _ints(model_to_montgomery(x))
    assert got == [(v * M) % P for v in _ints(x)]


def test_from_montgomery_is_a_residue_in_one_to_p():
    x = _words(4000)
    got = _ints(model_from_montgomery(x))
    r_inv = pow(M, -1, P)
    assert all(1 <= g <= P for g in got)
    assert [g % P for g in got] == [(v * r_inv) % P for v in _ints(x)]


def test_sbox_matches_split_and_lookup():
    x = _words(4000)
    want = gf.to_u64(tperm._split_and_lookup(
        gf.from_u64(np.array([v % P for v in _ints(x)], dtype=np.uint64)),
        tperm.tip5_tables("cpu")[1]))
    with np.errstate(over="ignore"):
        got = model_sbox(x)
    assert [g % P for g in _ints(got)] == _ints(want)


def test_lazy_products_and_pow7_match_the_field():
    a, b = _words(3000), _words(3000)[::-1].copy()
    with np.errstate(over="ignore"):
        prod = model_mul(a, b)
        p7 = model_pow7(a)
    assert [g % P for g in _ints(prod)] == [
        (x * y) % P for x, y in zip(_ints(a), _ints(b))]
    want7 = gf.to_u64(tperm._pow7(gf.from_u64(
        np.array([v % P for v in _ints(a)], dtype=np.uint64))))
    assert [g % P for g in _ints(p7)] == _ints(want7)


def test_mds_with_round_constants_matches_mds():
    words = _words(16 * 200)[: 16 * 200].reshape(200, 16)
    words[:len(EDGES)] = np.array(EDGES, dtype=np.uint64)[:, None]
    rc = ROUND_CONSTANTS[:16]
    with np.errstate(over="ignore"):
        got = model_mds_add_rc(words, rc)
    canon = gf.from_u64(np.array([[v % P for v in row] for row in
                                  words.tolist()], dtype=np.uint64))
    want = gf.to_u64(gf.add(tperm._mds(canon), gf.from_u64(rc)))
    assert [g % P for g in _ints(got)] == _ints(want)


def test_lane_mds_is_the_kernels_mds():
    """The lane mode's MDS, two chains a half over the shuffle steps, gives
    the thread mode's words bit for bit, on lazy and edge words (the largest
    halves included, where each chain stays below 2^53)."""
    words = _words(16 * 200)[: 16 * 200].reshape(200, 16)
    words[:len(EDGES)] = np.array(EDGES, dtype=np.uint64)[:, None]
    words[len(EDGES)] = M - 1
    for r in range(NUM_ROUNDS):
        rc = ROUND_CONSTANTS[r * 16:(r + 1) * 16]
        with np.errstate(over="ignore"):
            np.testing.assert_array_equal(model_mds_lanes(words, rc),
                                          model_mds_add_rc(words, rc))


@pytest.mark.parametrize("length", [0, 1, 9, 10, 11, 19, 20, 64])
def test_lane_sponge_model_matches_jax(length):
    """The lane mode's sponge, the capacity lazy between permutations,
    gives JAX's hash_varlen at every L mod 10."""
    x = RNG.integers(0, P, size=(3, length), dtype=np.uint64)
    x[0, :min(length, len(EDGES))] = [e % P for e in EDGES][:length]
    np.testing.assert_array_equal(
        lane_sponge_model(tperm.pad_for_varlen(x)), jperm.hash_varlen(x))


def test_mds_half_sums_stay_exact():
    """The largest half-sum (every half 2^32 - 1, the largest constant
    half) is below 2^52: exact in a u64 accumulator and in a double."""
    col_sum = sum(int(c) for c in MDS_MATRIX_FIRST_COLUMN)
    assert ((1 << 32) - 1) * col_sum + (1 << 32) - 1 < 1 << 52


@pytest.mark.parametrize("batch", [1, 64, 500])
def test_model_permutation_matches_the_twin_and_jax(batch):
    states = RNG.integers(0, P, size=(batch, 16), dtype=np.uint64)
    edges = [e for e in EDGES if e < P]
    states[0] = [edges[i % len(edges)] for i in range(16)]
    got = permutation_model(states)
    np.testing.assert_array_equal(got, jperm.permutation_values(states))
    np.testing.assert_array_equal(
        got, gf.to_u64(tperm.permutation_plain(gf.from_u64(states),
                                               *tperm.tip5_tables("cpu"))))
