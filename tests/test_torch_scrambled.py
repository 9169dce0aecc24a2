"""The port's scrambled four-step family (math/ntt.py: the DIF and
no-reverse transforms on K3's order modes, the traceable, W64 and
three-step entry points) and its scrambled LDE commit
(parallel/pipeline.py) against the JAX package's, exactly.

Inputs are made from seeds with numpy. The JAX side runs on the CPU once
a case per module (``_jax`` keeps the results): its transforms jitted
(their eager per-op compiles cost several times more on this CPU, and a
jit's compile is kept in the persistent cache), the commit's Tip5 tail
eagerly (its jit compile costs more); K3's order modes run on their plain
twin here."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu.math import gf as jgf
from twenty_first_tpu.math import gf_numpy as jgfn
from twenty_first_tpu.math import ntt as jntt
from twenty_first_tpu.math.b_field_element import GENERATOR, P
from twenty_first_tpu.parallel import pipeline as jpipeline
from twenty_first_tpu_torch.math import gf, ntt
from twenty_first_tpu_torch.ops import ntt_cuda
from twenty_first_tpu_torch.parallel import pipeline


def _rand(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint64)


def _limbs(v: np.ndarray):
    """The port's limb pair of a host array (uint32 tensors on the CPU)."""
    return gf.to_limbs(v, "cpu")


def _host(limbs) -> np.ndarray:
    """A limb pair of either package as a host uint64 array."""
    return jgf.from_limbs(tuple(np.asarray(v) for v in limbs))


def _jlimbs(v: np.ndarray):
    """JAX's limb pair of a host array."""
    return tuple(map(jnp.asarray, jgf.to_limbs(v)))


def _u64(limbs) -> np.ndarray:
    """A JAX host table's limb pair as one uint64 array."""
    lo, hi = limbs
    return lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))


@functools.lru_cache(maxsize=None)
def _jax(name: str, *args):
    """A JAX result by case name, computed once per module."""
    return _JAX_CASES[name](*args)


# ---------------------------------------------------------------------------
# K3's order modes (the twin) against the JAX DIF and no-reverse cores
# ---------------------------------------------------------------------------

LOCAL_COLS = 8
LOCAL_CASES = [(log_t, inverse, mode) for log_t in (1, 6)
               for inverse in (False, True) for mode in ("dif", "norev")]


def _local_input(log_t: int):
    return (_rand(log_t, (2, 1 << log_t, LOCAL_COLS)),
            _rand(log_t + 1, (1 << log_t, LOCAL_COLS)))


def _jax_local_pass(log_t: int, inverse: bool, mode: str):
    """JAX's ``_local_pass`` in its DIF or no-reverse mode, with a
    diagonal and a post constant."""
    def run(x, d):
        return jntt._local_pass(x, log_t, inverse, diag=d, post_const=5,
                                **{mode: True})

    return _host(jax.jit(run)(*map(_jlimbs, _local_input(log_t))))


@pytest.mark.parametrize("log_t,inverse,mode", LOCAL_CASES)
def test_order_modes_equal_jax_cores(log_t, inverse, mode):
    """rev_out is JAX's DIF core (output k on row brev(k), the diagonal
    read at the row written), rev_in its no-reverse DIT core (row r holds
    element brev(r)); both with a diagonal and a scale in the epilogue."""
    want = _jax("local_pass", log_t, inverse, mode)
    x, d = _local_input(log_t)
    tw = gf.from_u64(ntt.stage_twiddles(log_t, inverse))
    got = ntt_cuda.ntt_local_pass(gf.from_u64(x), tw, diag=gf.from_u64(d),
                                  scale=5, rev_out=mode == "dif",
                                  rev_in=mode == "norev")
    np.testing.assert_array_equal(gf.to_u64(got), want)


def test_order_modes_refuse_a_second_diagonal_and_each_other():
    x = torch.zeros((1, 4, 2), dtype=torch.int64)
    tw = gf.from_u64(ntt.stage_twiddles(2, False))
    with pytest.raises(ValueError):
        ntt_cuda.ntt_local_pass(x, tw, rev_in=True, rev_out=True)
    with pytest.raises(ValueError):
        ntt_cuda.ntt_local_pass(x, tw, diag2=x[0], rev_in=True)


# ---------------------------------------------------------------------------
# The tables: each of the port's against the JAX package's host table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log_n", [5, 8, 17])
@pytest.mark.parametrize("inverse", [False, True])
def test_diagonal_tables_equal_jax(log_n, inverse):
    split = (log_n // 2 + 1, log_n - log_n // 2 - 1)
    cases = [
        (ntt._four_step_diag_device(log_n, inverse, device="cpu"),
         jntt._four_step_diag_host(log_n, inverse)),
        (ntt._four_step_diag_device(log_n, inverse, True, "cpu"),
         jntt._four_step_diag_host(log_n, inverse, True)),
        (ntt._diag_device_general(log_n, inverse, True, split, "cpu"),
         jntt._four_step_diag_host(log_n, inverse, True, split)),
        (ntt._norev_diag_device(log_n, inverse, split, "cpu"),
         jntt._norev_diag_host(log_n, inverse, split)),
        (ntt._scrambled_diag_device(log_n, inverse, "cpu"),
         jntt._scrambled_diag_host(log_n, inverse))]
    for got, want in cases:
        np.testing.assert_array_equal(gf.to_u64(got), _u64(want))
    t1, d, perm = ntt._three_step_tables_device(log_n, inverse, "cpu")
    jt1, jd, jperm = jntt._three_step_tables_host(log_n, inverse)
    np.testing.assert_array_equal(gf.to_u64(t1), _u64(jt1))
    np.testing.assert_array_equal(gf.to_u64(d), _u64(jd))
    np.testing.assert_array_equal(perm, jperm)


@pytest.mark.parametrize("log_n", [2, 9, 17, 18])
def test_scrambled_index_equals_jax_and_is_an_involution(log_n):
    idx = ntt.scrambled_index(log_n)
    want = jntt.scrambled_index(log_n)
    assert idx.dtype == want.dtype
    np.testing.assert_array_equal(idx, want)
    np.testing.assert_array_equal(idx[idx], np.arange(1 << log_n))


def test_thresholds_are_jax_s():
    assert ntt.FOUR_STEP_THRESHOLD_LOG2 == jntt.FOUR_STEP_THRESHOLD_LOG2
    assert ntt.THREE_STEP_THRESHOLD_LOG2 == jntt.THREE_STEP_THRESHOLD_LOG2


# ---------------------------------------------------------------------------
# four_step_dif_general / norev_general at default and non-square splits
# ---------------------------------------------------------------------------

GENERAL_LOG_N = 6
SPLITS = [None, (1, 5), (4, 2)]


GENERAL_CASES = [(kind, split, inverse) for kind in ("dif", "norev")
                 for split in SPLITS for inverse in (False, True)]


def _general_input(kind: str, split, inverse: bool):
    """(x, post_diag or None) of a case."""
    x = _rand(10 * SPLITS.index(split) + 2 * inverse + (kind == "dif"),
              (3, 1 << GENERAL_LOG_N))
    s = split if split is not None else jntt._four_step_split(GENERAL_LOG_N)
    return x, (_rand(5, (1 << s[0], 1 << s[1])) if kind == "dif" else None)


def _jax_general(kind: str, split, inverse: bool):
    log_n = GENERAL_LOG_N
    s = split if split is not None else jntt._four_step_split(log_n)
    x, post = _general_input(kind, split, inverse)
    if kind == "dif":
        def run(x, d, post):
            return jntt.four_step_dif_general(x, log_n, inverse, d,
                                              split=split, post_diag=post,
                                              post_const=3)

        return _host(jax.jit(run)(
            _jlimbs(x), jntt._diag_device_general(log_n, inverse, True, s),
            _jlimbs(post)))

    def run(x, d):
        return jntt.four_step_norev_general(x, log_n, inverse, d,
                                            split=split, post_const=3)

    return _host(jax.jit(run)(_jlimbs(x),
                              jntt._norev_diag_device(log_n, inverse, s)))


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kind", ["dif", "norev"])
def test_general_four_steps_equal_jax(split, inverse, kind):
    log_n = GENERAL_LOG_N
    want = _jax("general", kind, split, inverse)
    x, post = _general_input(kind, split, inverse)
    s = split if split is not None else ntt.four_step_split(log_n)
    if kind == "dif":
        got = ntt.four_step_dif_general(
            _limbs(x), log_n, inverse,
            ntt._diag_device_general(log_n, inverse, True, s, "cpu"),
            split=split, post_diag=gf.from_u64(post), post_const=3)
    else:
        got = ntt.four_step_norev_general(
            _limbs(x), log_n, inverse,
            ntt._norev_diag_device(log_n, inverse, s, "cpu"), split=split,
            post_const=3)
    assert got[0].dtype == torch.uint32 and got[0].shape == x.shape
    np.testing.assert_array_equal(_host(got), want)


def test_general_four_steps_refuse_a_split_of_another_length():
    x = _limbs(_rand(1, (1 << GENERAL_LOG_N,)))
    d = ntt._diag_device_general(GENERAL_LOG_N, False, True, (3, 4), "cpu")
    with pytest.raises(ValueError):
        ntt.four_step_dif_general(x, GENERAL_LOG_N, False, d, split=(3, 4))


# ---------------------------------------------------------------------------
# The scrambled LDE chain (tests/test_lde_scrambled.py's) and the commit
# ---------------------------------------------------------------------------

CHAIN_SHAPES = [(6, 3, 4), (8, 8, 4), (7, 1, 2)]


def _chain_input(log_n: int, w: int, e: int) -> np.ndarray:
    return _rand(log_n * w * e, (w, 1 << log_n))


def _jax_chain(log_n: int, w: int, e: int):
    """JAX's transform chain, jitted: the DIF iNTT with pw_scr, the
    row-interleave embed, the no-reverse NTT at the split (log_n1 + log_e,
    log_n2) (tests/test_lde_scrambled.py's, and the transforms of its
    trace_lde_commit_scrambled); (scrambled coefficients, evaluations)."""
    n, log_e = 1 << log_n, e.bit_length() - 1
    log_n1, log_n2 = jntt._four_step_split(log_n)
    n1, n2 = 1 << log_n1, 1 << log_n2

    def chain(x, d1, pw, d4):
        c_scr = jntt.four_step_dif_general(x, log_n, True, d1,
                                           split=(log_n1, log_n2),
                                           post_diag=pw)

        def embed(a):
            a = a.reshape(w, n1, 1, n2)
            return jnp.pad(a, ((0, 0), (0, 0), (0, e - 1), (0, 0))).reshape(
                w, n * e)

        ev = jntt.four_step_norev_general(
            (embed(c_scr[0]), embed(c_scr[1])), log_n + log_e, False, d4,
            split=(log_n1 + log_e, log_n2))
        return c_scr, ev

    return jax.jit(chain)(_jlimbs(_chain_input(log_n, w, e)),
                          *jpipeline.lde_scrambled_tables(n, e))


def _oracle_evals(x: np.ndarray, e: int) -> np.ndarray:
    """The LDE on host transforms: iNTT, offset powers, zero pad, NTT."""
    w, n = x.shape
    padded = np.zeros((w, n * e), dtype=np.uint64)
    padded[:, :n] = jgfn.mul(jntt.ntt_host(x, inverse=True),
                             jgfn.powers(GENERATOR, n)[None, :])
    return jntt.ntt_host(padded)


@pytest.mark.parametrize("log_n,w,e", CHAIN_SHAPES)
def test_scrambled_tables_equal_jax(log_n, w, e):
    n = 1 << log_n
    for got, want in zip(pipeline.lde_scrambled_tables(n, e, device="cpu"),
                         jpipeline.lde_scrambled_tables(n, e)):
        np.testing.assert_array_equal(
            gf.to_u64(got), _u64(tuple(np.asarray(v) for v in want)))


@pytest.mark.parametrize("log_n,w,e", CHAIN_SHAPES)
def test_scrambled_chain_equals_jax(log_n, w, e):
    """The JAX test's chain through the port's public functions: the
    scrambled coefficients and the natural evaluations equal JAX's (and the
    host LDE's)."""
    n = 1 << log_n
    x = _chain_input(log_n, w, e)
    want_scr, want_ev = map(_host, _jax("chain", log_n, w, e))
    log_e = e.bit_length() - 1
    log_n1, log_n2 = ntt.four_step_split(log_n)
    n1, n2 = 1 << log_n1, 1 << log_n2
    d1, pw, d4 = pipeline.lde_scrambled_tables(n, e, device="cpu")
    c_scr = ntt.four_step_dif_general(_limbs(x), log_n, True, d1,
                                      split=(log_n1, log_n2), post_diag=pw)
    np.testing.assert_array_equal(_host(c_scr), want_scr)

    def embed(a):
        padded = torch.zeros((w, n1, e, n2), dtype=a.dtype)
        padded[:, :, 0] = a.view(w, n1, n2)
        return padded.view(w, n * e)

    ev = ntt.four_step_norev_general(tuple(map(embed, c_scr)), log_n + log_e,
                                     False, d4, split=(log_n1 + log_e, log_n2))
    np.testing.assert_array_equal(_host(ev), want_ev)
    np.testing.assert_array_equal(want_ev, _oracle_evals(x, e))


@functools.lru_cache(maxsize=None)
def _port_two_pass(log_n: int, w: int, e: int, cut: int) -> np.ndarray:
    """The port's scrambled evaluations with ``ntt.ONE_PASS_MAX_LOG_N`` at
    ``cut``: every factor above it takes ntt_columns' two passes."""
    saved = ntt.ONE_PASS_MAX_LOG_N
    ntt.ONE_PASS_MAX_LOG_N = cut
    ntt._cached_tables.cache_clear()
    try:
        x = gf.from_u64(_chain_input(log_n, w, e))
        return gf.to_u64(pipeline.scrambled_leaf_digests(x, e, tables=(
            pipeline.lde_scrambled_tables(1 << log_n, e, device="cpu"))))
    finally:
        ntt.ONE_PASS_MAX_LOG_N = saved
        ntt._cached_tables.cache_clear()


@pytest.mark.parametrize("log_n,w,e", CHAIN_SHAPES)
@pytest.mark.parametrize("cut", [2, 3])
def test_scrambled_leafs_with_two_pass_factors(log_n, w, e, cut):
    """With the one-pass cut lowered, each factor of the chain takes two
    K3 passes under its order mode (both rev_out, both rev_in: brev splits
    over the two digits); the leaf digests stay the natural step's."""
    x = gf.from_u64(_chain_input(log_n, w, e))
    step = pipeline.TraceLdeCommit(w, 1 << log_n, e, device="cpu")
    np.testing.assert_array_equal(_port_two_pass(log_n, w, e, cut),
                                  gf.to_u64(step.leaf_digests(x)))


# (8, 8) first: its Tip5 tail compiles every op shape of (6, 3)'s too
COMMIT_SHAPES = [(8, 8), (6, 3)]


def _jax_commit(log_n: int, w: int):
    """JAX's trace_lde_commit_scrambled of the chain's input: its
    transforms (the jitted chain) and its tail ``_hash_rows_commit``."""
    _, ev = _jax("chain", log_n, w, 4)
    return _host(jpipeline._hash_rows_commit(ev, w, 4 << log_n))


@pytest.mark.parametrize("log_n,w", COMMIT_SHAPES)
def test_scrambled_commit_equals_jax_and_the_natural_route(log_n, w):
    n = 1 << log_n
    x = gf.from_u64(_chain_input(log_n, w, 4))
    want = _jax("commit", log_n, w)
    tables = pipeline.lde_scrambled_tables(n, 4, device="cpu")
    got = pipeline.trace_lde_commit_scrambled(x, tables=tables)
    np.testing.assert_array_equal(gf.to_u64(got), want)
    np.testing.assert_array_equal(gf.to_u64(pipeline.trace_lde_commit(x)),
                                  want)
    np.testing.assert_array_equal(
        gf.to_u64(pipeline.trace_lde_commit_scrambled(x, 4, tables,
                                                      plain=True)), want)


@pytest.mark.parametrize("log_n,w", COMMIT_SHAPES)
def test_scrambled_commit_builds_its_tables(log_n, w):
    x = gf.from_u64(_rand(log_n, (w, 1 << log_n)))
    np.testing.assert_array_equal(
        gf.to_u64(pipeline.trace_lde_commit_scrambled(x)),
        gf.to_u64(pipeline.trace_lde_commit(x)))


@pytest.mark.parametrize("log_n,expansion", [(6, 4), (15, 4), (17, 2)])
def test_lde_commit_diags_equal_jax(log_n, expansion):
    """``lde_commit_diags`` gives JAX's four-step diagonals, None below
    2^17."""
    got = pipeline.lde_commit_diags(1 << log_n, expansion, device="cpu")
    log_big = log_n + expansion.bit_length() - 1
    for g, (j_log_n, inverse) in zip(got, ((log_n, True), (log_big, False))):
        if j_log_n < jntt.FOUR_STEP_THRESHOLD_LOG2:
            assert g is None
        else:
            np.testing.assert_array_equal(
                gf.to_u64(g), _u64(jntt._four_step_diag_host(j_log_n,
                                                             inverse)))


@pytest.mark.parametrize("log_n,expansion", [(5, 4), (6, 2)])
def test_trace_lde_commit_with_lde_commit_diags_keeps_the_root(
        monkeypatch, log_n, expansion):
    """``trace_lde_commit(trace, ntt_diags=lde_commit_diags(n))`` gives the
    root without them. Small: the one-pass cut lowered to 2^3, so both
    transforms take two passes and the step uses the diagonals, and the
    threshold to 2^4, so that ``lde_commit_diags`` gives both."""
    monkeypatch.setattr(ntt, "ONE_PASS_MAX_LOG_N", 3)
    monkeypatch.setattr(ntt, "FOUR_STEP_THRESHOLD_LOG2", 4)
    ntt._cached_tables.cache_clear()
    try:
        n = 1 << log_n
        diags = pipeline.lde_commit_diags(n, expansion, device="cpu")
        assert all(d is not None for d in diags)
        step = pipeline.TraceLdeCommit(2, n, expansion, device="cpu",
                                       ntt_diags=diags)
        assert step.inv_diag.data_ptr() == diags[0].data_ptr()
        x = gf.from_u64(_rand(log_n, (2, n)))
        np.testing.assert_array_equal(
            gf.to_u64(pipeline.trace_lde_commit(x, expansion,
                                                ntt_diags=diags)),
            gf.to_u64(pipeline.trace_lde_commit(x, expansion)))
    finally:
        ntt._cached_tables.cache_clear()


def test_trace_lde_commit_uses_the_given_diagonals(monkeypatch):
    """At a two-pass length the step's tables hold the diagonals given, not
    ones it builds."""
    n, e = 1 << 13, 2
    given = tuple(ntt._four_step_diag_device(log, inv, device="cpu")
                  for log, inv in ((13, True), (14, False)))
    built = []
    monkeypatch.setattr(ntt, "four_step_diag", lambda *a: built.append(a))
    step = pipeline.TraceLdeCommit(1, n, e, device="cpu", ntt_diags=given)
    assert built == []
    assert step.inv_diag.data_ptr() == given[0].data_ptr()
    assert step.fwd_diag.data_ptr() == given[1].data_ptr()


# ---------------------------------------------------------------------------
# The traceable, W64, three-step and scrambled entry points vs ntt_host
# ---------------------------------------------------------------------------

ENTRY_LOG_N = [1, 2, 5, 10, 17]


def _entry_input(log_n: int) -> np.ndarray:
    return _rand(100 + log_n, (2, 1 << log_n) if log_n < 17 else (1 << 17,))


@functools.lru_cache(maxsize=None)
def _host_ntt(log_n: int, inverse: bool) -> np.ndarray:
    return jntt.ntt_host(_entry_input(log_n), inverse)


@pytest.mark.parametrize("log_n", ENTRY_LOG_N)
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_ntt_traceable_and_w64_equal_ntt_host(log_n, inverse):
    x = _entry_input(log_n)
    want = _host_ntt(log_n, inverse)
    diag = ntt._four_step_diag_device(log_n, inverse, device="cpu")
    got = ntt.four_step_ntt_traceable(_limbs(x), log_n, inverse, diag)
    np.testing.assert_array_equal(_host(got), want)
    got = ntt.four_step_ntt_w64(gf.from_u64(x), log_n, inverse, diag)
    np.testing.assert_array_equal(gf.to_u64(got), want)


@pytest.mark.parametrize("log_n", ENTRY_LOG_N)
@pytest.mark.parametrize("inverse", [False, True])
def test_three_step_ntt_traceable_equals_ntt_host(log_n, inverse):
    x = _entry_input(log_n)
    t1, d, perm = ntt._three_step_tables_device(log_n, inverse, "cpu")
    got = ntt.three_step_ntt_traceable(_limbs(x), log_n, inverse, t1, d, perm)
    np.testing.assert_array_equal(_host(got), _host_ntt(log_n, inverse))


def test_three_step_refuses_another_row_permutation():
    t1, d, perm = ntt._three_step_tables_device(6, False, "cpu")
    with pytest.raises(ValueError):
        ntt.three_step_ntt_traceable(_limbs(_rand(1, (64,))), 6, False, t1,
                                     d, perm[::-1].copy())


@pytest.mark.parametrize("log_n", ENTRY_LOG_N)
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_limbs_traceable_equals_ntt_host(log_n, inverse):
    x = _entry_input(log_n)
    want = _host_ntt(log_n, inverse)
    diag = ntt._four_step_diag_device(log_n, inverse, device="cpu")
    for four_step_diag in (None, diag):
        got = ntt.ntt_limbs_traceable(_limbs(x), inverse, four_step_diag)
        np.testing.assert_array_equal(_host(got), want)


@pytest.mark.parametrize("log_n", [2, 5, 17])
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_ntt_scrambled_is_a_permuted_ntt(log_n, inverse):
    """As tests/test_ntt_conv.py holds JAX's: forward, the scrambled output
    read through scrambled_index is ntt(x); inverse, the scrambled input
    x[scrambled_index] gives intt(x)."""
    x = _entry_input(log_n)
    idx = ntt.scrambled_index(log_n)
    diag = ntt._scrambled_diag_device(log_n, inverse, "cpu")
    if inverse:
        got = _host(ntt.four_step_ntt_scrambled(_limbs(x[..., idx]), log_n,
                                                True, diag))
    else:
        got = _host(ntt.four_step_ntt_scrambled(_limbs(x), log_n, False,
                                                diag))[..., idx]
    np.testing.assert_array_equal(got, _host_ntt(log_n, inverse))


def _jax_scrambled():
    """JAX's four_step_ntt_scrambled at 2^5 both ways, by direction."""
    def run(x):
        return [jntt.four_step_ntt_scrambled(
            x, 5, inverse, jntt._scrambled_diag_device(5, inverse))
            for inverse in (False, True)]

    return dict(zip((False, True),
                    map(_host, jax.jit(run)(_jlimbs(_entry_input(5))))))


@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_ntt_scrambled_equals_jax(inverse):
    x = _entry_input(5)
    got = ntt.four_step_ntt_scrambled(
        _limbs(x), 5, inverse, ntt._scrambled_diag_device(5, inverse, "cpu"))
    np.testing.assert_array_equal(_host(got), _jax("scrambled")[inverse])


_JAX_CASES = {"local_pass": _jax_local_pass, "general": _jax_general,
              "chain": _jax_chain, "commit": _jax_commit,
              "scrambled": _jax_scrambled}
