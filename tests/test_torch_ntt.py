"""The port's NTT (twenty_first_tpu_torch.math.ntt and the K3 local pass's
plain twin) against the JAX package's tables and transforms, exactly."""

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu.math import ntt as jntt
from twenty_first_tpu.math.b_field_element import P
from twenty_first_tpu_torch.math import gf, ntt
from twenty_first_tpu_torch.ops import ntt_cuda

RNG = np.random.default_rng(23)


def _rand(shape):
    return RNG.integers(0, P, size=shape, dtype=np.uint64)


@pytest.mark.parametrize("log_n", [0, 1, 5, 12])
def test_bit_reverse_permutation_equals_jax(log_n):
    np.testing.assert_array_equal(ntt.bit_reverse_permutation(log_n),
                                  jntt._bit_reverse_permutation(log_n))


@pytest.mark.parametrize("inverse", [False, True])
def test_stage_twiddles_equal_jax(inverse):
    for log_t in range(1, 13):
        want = np.concatenate(jntt._twiddles_host(log_t, inverse))
        np.testing.assert_array_equal(ntt.stage_twiddles(log_t, inverse), want)


@pytest.mark.parametrize("log_n", [13, 14, 17])
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_tables_equal_jax(log_n, inverse):
    assert ntt.four_step_split(log_n) == jntt._four_step_split(log_n)
    lo, hi = jntt._four_step_diag_host(log_n, inverse)
    want = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    np.testing.assert_array_equal(ntt.four_step_diag(log_n, inverse), want)


@pytest.mark.parametrize("log_n", range(1, 19))
def test_ntt_matches_jax(log_n):
    """Single pass up to 2^12, four-step above; 2^17 is the JAX package's
    four-step threshold."""
    x = _rand((2, 1 << log_n))
    y = ntt.ntt_values(x, device="cpu")
    np.testing.assert_array_equal(y, jntt.ntt_values(x))
    z = ntt.intt_values(y, device="cpu")
    np.testing.assert_array_equal(z, jntt.intt_values(y))
    np.testing.assert_array_equal(z, x)


def test_ntt_matches_jax_device_path():
    """Against the JAX package's jitted limb-plane transform as well."""
    x = _rand((3, 1 << 6))
    want = np.asarray(jntt.ntt_values(x))
    from twenty_first_tpu.math import gf as jgf

    dev = jgf.from_limbs(jntt.ntt_limbs(jgf.to_limbs(x)))
    np.testing.assert_array_equal(dev, want)
    np.testing.assert_array_equal(ntt.ntt_values(x, device="cpu"), dev)


def test_ntt_golden_vector():
    got = ntt.ntt(gf.from_u64([1, 4, 0, 0]))
    assert gf.to_u64(got).tolist() == [5, 1125899906842625,
                                       18446744069414584318,
                                       18445618169507741698]


def test_ntt_keeps_leading_axes_and_length_one():
    x = _rand((2, 3, 1 << 13))
    got = ntt.ntt(gf.from_u64(x))
    assert got.shape == (2, 3, 1 << 13)
    np.testing.assert_array_equal(gf.to_u64(got), jntt.ntt_values(x))
    one = gf.from_u64(_rand((4, 1)))
    assert torch.equal(ntt.ntt(one), one)


def test_ntt_rejects_bad_lengths_and_tables():
    with pytest.raises(ValueError):
        ntt.ntt(torch.zeros(2, 12, dtype=torch.int64))
    with pytest.raises(ValueError):
        ntt.ntt_tables(1 << 33, device="cpu")
    x = gf.from_u64(_rand((1, 64)))
    with pytest.raises(ValueError):
        ntt.ntt(x, tables=ntt.ntt_tables(64, inverse=True, device="cpu"))
    with pytest.raises(ValueError):
        ntt.ntt(x, tables=ntt.ntt_tables(128, device="cpu"))


def test_length_zero_is_an_empty_copy_as_in_jax():
    """A length-0 last axis: an empty copy through every entry point."""
    z = np.zeros((3, 0), np.uint64)
    for got, want in ((ntt.ntt_values(z, device="cpu"), jntt.ntt_values(z)),
                      (ntt.intt_values(z, device="cpu"), jntt.intt_values(z)),
                      (ntt.conv_values(z, z, device="cpu"),
                       jntt.conv_values(z, z))):
        assert got.shape == want.shape == (3, 0) and got.dtype == np.uint64
    assert ntt.ntt(gf.from_u64(z)).shape == (3, 0)
    assert ntt.ntt_tables(0, device="cpu").n == 0


def test_bad_lengths_raise_ntt_domain_error():
    assert issubclass(ntt.NttDomainError, ValueError)
    assert ntt.NttDomainError.__name__ == jntt.NttDomainError.__name__
    with pytest.raises(ntt.NttDomainError):
        ntt.ntt_values(np.zeros((2, 3), np.uint64), device="cpu")
    with pytest.raises(jntt.NttDomainError):
        jntt.ntt_values(np.zeros((2, 3), np.uint64))
    with pytest.raises(ntt.NttDomainError, match=r"2\^32"):
        ntt.ntt_tables((1 << 33), device="cpu")
    with pytest.raises(jntt.NttDomainError, match=r"2\^32"):
        jntt._check_len(1 << 33)
    for log_n in range(33):  # every power of two up to 2^32, as in JAX
        assert ntt._check_len(1 << log_n) == jntt._check_len(1 << log_n)


def test_errors_copy_has_the_jax_classes():
    """The port's errors.py: every class of the JAX package's, with its
    name and the names of its bases."""
    import inspect

    from twenty_first_tpu import errors as jerr
    from twenty_first_tpu_torch import errors as terr

    def classes(mod):
        return {name: tuple(b.__name__ for b in cls.__bases__)
                for name, cls in inspect.getmembers(mod, inspect.isclass)
                if cls.__module__ == mod.__name__}

    assert classes(terr) == classes(jerr)
    assert len(classes(terr)) == 13


@pytest.mark.parametrize("layout", ["cols_fast", "elems_fast"])
@pytest.mark.parametrize("log_t", [1, 4, 9])
def test_local_pass_plain_matches_jax(layout, log_t):
    """K3's twin on strided views, with the diagonal and the scale: column
    c of out is the NTT of column c of x, times diag[:, c] and scale."""
    t, b, c = 1 << log_t, 2, 5
    vals = _rand((b, t, c))
    x = gf.from_u64(vals)
    if layout == "elems_fast":
        x = gf.from_u64(np.ascontiguousarray(vals.transpose(0, 2, 1)))
        x = x.transpose(1, 2)
    diag = _rand((t, c))
    scale = pow(t, P - 2, P)
    tw = gf.from_u64(ntt.stage_twiddles(log_t, False))
    out = torch.empty(b, c, t, dtype=torch.int64).transpose(1, 2)
    ntt_cuda.ntt_local_pass(x, tw, diag=gf.from_u64(diag), scale=scale,
                            out=out)
    cols = jntt.ntt_values(np.ascontiguousarray(vals.transpose(0, 2, 1)))
    from twenty_first_tpu.math import gf_numpy as jgfn

    want = jgfn.mul(jgfn.mul(cols.transpose(0, 2, 1), diag[None]),
                    np.uint64(scale))
    np.testing.assert_array_equal(gf.to_u64(out), want)


def test_local_pass_in_place_and_alias_rules():
    x = gf.from_u64(_rand((1, 8, 3)))
    tw = gf.from_u64(ntt.stage_twiddles(3, False))
    want = ntt_cuda.ntt_local_pass(x, tw)
    same = x.clone()
    assert ntt_cuda.ntt_local_pass(same, tw, out=same) is same
    assert torch.equal(same, want)
    base = torch.zeros(1, 8, 6, dtype=torch.int64)
    with pytest.raises(ValueError):  # another view of x's storage
        ntt_cuda.ntt_local_pass(base[:, :, :3], tw, out=base[:, :, 3:])


@pytest.mark.parametrize("bad", ["tw", "diag", "length", "out"])
def test_local_pass_rejects_bad_input(bad):
    x = gf.from_u64(_rand((1, 8, 3)))
    tw = gf.from_u64(ntt.stage_twiddles(3, False))
    kwargs = {}
    if bad == "tw":
        tw = tw[:6]
    elif bad == "diag":
        kwargs["diag"] = gf.from_u64(_rand((3, 8)))
    elif bad == "length":
        x = gf.from_u64(_rand((1, 6, 3)))
    else:
        kwargs["out"] = torch.empty(1, 8, 4, dtype=torch.int64)
    with pytest.raises(ValueError):
        ntt_cuda.ntt_local_pass(x, tw, **kwargs)


# -- the scalar-object API, the host transform and the crossover routes ----


def test_object_api_matches_jax_repro():
    """ntt.ntt over a list of BFieldElement (ntt.rs:67): the port raised
    AttributeError ('list' object has no attribute 'shape'); the JAX
    package's values, as tests/test_ntt.py pins them."""
    from twenty_first_tpu.math.b_field_element import bfe as jbfe
    from twenty_first_tpu_torch.math.b_field_element import bfe

    want = jntt.ntt([jbfe(v) for v in (1, 4, 0, 0)])
    got = ntt.ntt([bfe(v) for v in (1, 4, 0, 0)])
    assert [e.value() for e in got] == [e.value() for e in want] == [
        5, 1125899906842625, 18446744069414584318, 18445618169507741698]
    assert ntt.intt(got) == [bfe(v) for v in (1, 4, 0, 0)]
    assert ntt.ntt([]) == [] and ntt.intt([]) == []
    single = [bfe(99)]
    out = ntt.ntt(single)
    assert out == single and out is not single
    with pytest.raises(ValueError):
        ntt.ntt(single, post=gf.from_u64([1]))
    with pytest.raises(ntt.NttDomainError):
        ntt.ntt([bfe(1)] * 3)


@pytest.mark.parametrize("n", [2, 16, 512])
def test_object_api_xfe_and_bfe_match_jax(n, monkeypatch):
    from twenty_first_tpu.math.b_field_element import bfe as jbfe
    from twenty_first_tpu.math.x_field_element import xfe as jxfe
    from twenty_first_tpu_torch.math.b_field_element import bfe
    from twenty_first_tpu_torch.math.x_field_element import xfe

    monkeypatch.setattr(ntt, "DEVICE", "cpu")
    rows = _rand((n, 3))
    for limit in (ntt.HOST_NTT_MAX_ELEMS, 0):  # host, then "the card"
        monkeypatch.setattr(ntt, "HOST_NTT_MAX_ELEMS", limit)
        for inverse in (False, True):
            got = ntt.ntt([xfe(tuple(int(v) for v in r)) for r in rows],
                          inverse=inverse)
            want = jntt.ntt([jxfe(tuple(int(v) for v in r)) for r in rows],
                            inverse=inverse)
            assert [tuple(c.value() for c in e.coefficients) for e in got] \
                == [tuple(c.value() for c in e.coefficients) for e in want]
            got = ntt.ntt([bfe(int(v)) for v in rows[:, 0]], inverse)
            want = jntt.ntt([jbfe(int(v)) for v in rows[:, 0]], inverse)
            assert [e.value() for e in got] == [e.value() for e in want]


@pytest.mark.parametrize("length", [0, 1, 2, 8, 64])
def test_table_helpers_match_jax(length):
    assert ntt.swap_indices(length) == jntt.swap_indices(length)
    from twenty_first_tpu.math.b_field_element import bfe as jbfe
    from twenty_first_tpu_torch.math.b_field_element import bfe

    if length:
        root = ntt.PRIMITIVE_ROOTS[length]
        for arg, jarg in ((root, root), (bfe(root), jbfe(root))):
            got = ntt.twiddle_factors(length, arg)
            want = jntt.twiddle_factors(length, jarg)
            assert [t.tolist() for t in got] == [t.tolist() for t in want]
    with pytest.raises(ntt.NttDomainError):
        ntt.swap_indices(6)


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("shape", [(1,), (4,), (3, 128), (2, 1 << 9), (0,)])
def test_ntt_host_matches_jax(shape, native, monkeypatch):
    """The numpy radix-2 form (and, from 2^8 elements, the native core's row
    NTT) against the JAX package's ntt_host; both equal the device path."""
    monkeypatch.setenv("TWENTY_FIRST_TPU_NATIVE_HOST", native)
    x = _rand(shape)
    for inverse in (False, True):
        got = ntt.ntt_host(x, inverse)
        np.testing.assert_array_equal(got, jntt.ntt_host(x, inverse))
        np.testing.assert_array_equal(
            got, ntt.ntt_values(x, inverse, device="cpu"))
    assert ntt._bit_reverse_permutation(5).tolist() == \
        jntt._bit_reverse_permutation(5).tolist()
    for log_n in (1, 4, 9):
        for inverse in (False, True):
            assert [t.tolist() for t in ntt._twiddles_host(log_n, inverse)] \
                == [t.tolist() for t in jntt._twiddles_host(log_n, inverse)]


@pytest.mark.parametrize("xfield", [False, True])
@pytest.mark.parametrize("divide", [False, True])
def test_routed_convolutions_match_jax_on_both_sides(xfield, divide,
                                                     monkeypatch):
    """routed_conv_values and the routed table forms: the host round trip
    at the default crossover, ntt.DEVICE ("cpu" here) above it, both equal
    to the JAX package's conv_values."""
    monkeypatch.setattr(ntt, "DEVICE", "cpu")
    shape = (2, 64, 3) if xfield else (2, 64)
    a, b = _rand(shape), _rand(shape)
    b[0, 3] = 0  # a zero transform value divides to 0 in both
    table = _rand((64, 3) if xfield else (64,))
    want = jntt.conv_values(a, b, xfield=xfield, divide=divide)
    jt = jntt.conv_table_prepare(table, xfield=xfield)
    want_t = jntt.conv_table_values(a, jt, xfield=xfield,
                                    table_xfield=xfield)
    for limit in (1 << 20, 0):
        monkeypatch.setattr(ntt, "HOST_CONV_MAX_ELEMS", limit)
        got = ntt.routed_conv_values(a, b, xfield=xfield, divide=divide)
        np.testing.assert_array_equal(got, want)
        t = ntt.routed_conv_table_prepare(table, xfield=xfield)
        assert isinstance(t, ntt.ConvTable) == (limit == 0)
        np.testing.assert_array_equal(
            ntt.routed_conv_table_values(a, t, xfield=xfield,
                                         table_xfield=xfield), want_t)
    monkeypatch.setattr(ntt, "HOST_CONV_MAX_ELEMS", 1 << 20)
    with pytest.raises(ntt.NttDomainError):
        ntt.routed_conv_values(a[..., :3] if not xfield else a[:, :3],
                               b[..., :3] if not xfield else b[:, :3],
                               xfield=xfield)


def test_routed_ntt_values_cut_and_default_device(monkeypatch):
    """Up to HOST_NTT_MAX_ELEMS elements on the host, above on ntt.DEVICE:
    the default, "cuda", raises on a machine without a card."""
    x = _rand((2, 256))
    want = jntt.ntt_values(x)
    np.testing.assert_array_equal(ntt.routed_ntt_values(x), want)
    monkeypatch.setattr(ntt, "HOST_NTT_MAX_ELEMS", 256)
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            ntt.routed_ntt_values(x)
    monkeypatch.setattr(ntt, "DEVICE", "cpu")
    np.testing.assert_array_equal(ntt.routed_ntt_values(x), want)
    np.testing.assert_array_equal(ntt.routed_ntt_values(x[:, :1]), x[:, :1])


# -- the limb-plane API -------------------------------------------------------


def test_limb_api_matches_jax():
    """gf/gf_ext to_limbs, from_limbs, const_limbs, P_LO, P_HI: uint32
    tensors on the named device, the JAX package's planes element for
    element."""
    from twenty_first_tpu.math import gf as jgf
    from twenty_first_tpu.math import gf_ext as jgf_ext
    from twenty_first_tpu_torch.math import gf_ext

    assert (gf.P_LO, gf.P_HI) == (jgf.P_LO, jgf.P_HI)
    assert gf.P_LO.dtype == gf.P_HI.dtype == np.uint32
    for c in (0, 1, P - 1, (1 << 32) + 5, 1 << 63):
        assert gf.const_limbs(c) == jgf.const_limbs(c)
    x = _rand((3, 17))
    x.reshape(-1)[:4] = [0, 1, P - 1, (1 << 32) - 1]
    lo, hi = gf.to_limbs(x, device="cpu")
    jlo, jhi = jgf.to_limbs(x)
    assert lo.dtype == hi.dtype == torch.uint32 and lo.device.type == "cpu"
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(gf.from_limbs((lo, hi)), x)
    np.testing.assert_array_equal(gf.from_limbs((jlo, jhi)), x)
    xe = _rand((2, 9, 3))
    lo, hi = gf_ext.to_limbs(xe, device="cpu")
    jlo, jhi = jgf_ext.to_limbs(xe)
    assert lo.shape == (2, 3, 9)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(gf_ext.from_limbs((lo, hi)), xe)
    np.testing.assert_array_equal(gf_ext.from_limbs((lo, hi)),
                                  jgf_ext.from_limbs((jlo, jhi)))
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            gf.to_limbs(x)


@pytest.mark.parametrize("log_n", [0, 3, 13])
def test_ntt_limbs_match_jax(log_n):
    """ntt_limbs/intt_limbs on uint32 planes: JAX's limb transform's
    planes, on the planes' device."""
    from twenty_first_tpu.math import gf as jgf

    x = _rand((2, 1 << log_n))
    planes = gf.to_limbs(x, device="cpu")
    got = ntt.ntt_limbs(planes)
    assert got[0].dtype == torch.uint32 and got[0].shape == x.shape
    want = jntt.ntt_limbs(jgf.to_limbs(x))
    np.testing.assert_array_equal(gf.from_limbs(got), jgf.from_limbs(want))
    back = ntt.intt_limbs(got)
    np.testing.assert_array_equal(gf.from_limbs(back), x)


# -- the three-pass route (lengths from 2^25) -------------------------------


@pytest.mark.parametrize("log_n", range(25, 33))
def test_three_pass_split_equals_jax(log_n):
    log_a, log_b, log_c = ntt.three_pass_split(log_n)
    assert (log_a, log_b, log_c) == jntt._three_step_split(log_n)
    assert log_a + log_b + log_c == log_n
    assert max(log_a, log_b, log_c) <= 11


def _three_pass_tables(monkeypatch, n, inverse):
    """Three-pass tables of a small length: the route's threshold lowered
    to the length, so that its passes run local transforms of 2^2..2^5."""
    monkeypatch.setattr(ntt, "THREE_PASS_LOG_N", n.bit_length() - 1)
    tables = ntt.ntt_tables(n, inverse, "cpu")
    monkeypatch.undo()
    assert tables.tw3 is not None
    return tables


@pytest.mark.parametrize("log_n", range(6, 15))
def test_three_pass_route_matches_jax(log_n, monkeypatch):
    """The three-pass route, forced at 2^6..2^14, against JAX's transforms
    and the port's one- and two-pass routes at the same lengths, with
    post= and out= as well, in place too."""
    n = 1 << log_n
    x = gf.from_u64(_rand((2, n)))
    fwd = _three_pass_tables(monkeypatch, n, False)
    inv = _three_pass_tables(monkeypatch, n, True)
    y = ntt.ntt(x, tables=fwd)
    np.testing.assert_array_equal(gf.to_u64(y),
                                  jntt.ntt_values(gf.to_u64(x)))
    assert torch.equal(y, ntt.ntt(x))  # the default route at this length
    z = ntt.intt(y, tables=inv)
    np.testing.assert_array_equal(gf.to_u64(z), jntt.intt_values(gf.to_u64(y)))
    assert torch.equal(z, x)
    post = gf.from_u64(_rand((n,)))
    planes = torch.zeros((2, 2 * n), dtype=torch.int64)
    ntt.intt(y, tables=inv, post=post, out=planes[:, :n])
    assert torch.equal(planes[:, :n], gf.mul(x, post))
    assert not planes[:, n:].any()
    out = torch.empty_like(x)
    assert ntt.ntt(x, tables=fwd, post=post, out=out) is out
    assert torch.equal(out, gf.mul(y, post))
    for plain in (False, True):  # in place, through K3's argument checks too
        w = x.clone()
        assert ntt.ntt(w, tables=fwd, plain=plain, out=w) is w
        assert torch.equal(w, y)
        assert ntt.intt(w, tables=inv, plain=plain, out=w) is w
        assert torch.equal(w, x)


def test_three_pass_tables_hold_their_twiddles(monkeypatch):
    """The three tables at 2^12 (A, B, C = 16): w_BC^(b kc), w_n^(a kc),
    w_AB^(a kb), against powers of the length's root."""
    from twenty_first_tpu_torch.math.b_field_element import PRIMITIVE_ROOTS

    n = 1 << 12
    t = _three_pass_tables(monkeypatch, n, False)
    w = PRIMITIVE_ROOTS[n]
    a = b = c = 16
    for table, root, rows, cols in ((t.diag, pow(w, a, P), b, c),
                                    (t.diag2, w, a, c),
                                    (t.diag2b, pow(w, c, P), a, b)):
        want = [[pow(root, r * k, P) for k in range(cols)]
                for r in range(rows)]
        assert gf.to_u64(table).reshape(rows, cols).tolist() == want
    assert t.tw1.shape == t.tw2.shape == t.tw3.shape == (15,)
