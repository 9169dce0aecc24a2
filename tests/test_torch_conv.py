"""The port's NTT-domain convolutions (twenty_first_tpu_torch.math.ntt's
conv_values, conv_table_prepare, conv_table_values) against the JAX
package's, exactly: integer field arithmetic, so the tolerance is 0.

At these sizes JAX takes its host round trip (below HOST_CONV_MAX_ELEMS),
the values its device graph gives too (tests/test_ntt_conv.py); the port
has no crossover and runs the K3/K8 wrappers, their plain twins on the
CPU."""

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu.math import ntt as jntt
from twenty_first_tpu.math.b_field_element import P
from twenty_first_tpu_torch.math import ntt

EDGES = [0, 1, P - 1, 1 << 32, (1 << 32) - 1]


def _values(seed: int, shape):
    v = np.random.default_rng(seed).integers(0, P, size=shape,
                                             dtype=np.uint64)
    flat = v.reshape(-1)
    k = min(flat.size, len(EDGES))
    flat[:k] = EDGES[:k]
    return v


def _shape(log_n: int, xfield: bool, batch=()):
    return (*batch, 1 << log_n, 3) if xfield else (*batch, 1 << log_n)


@pytest.mark.parametrize("xfield", [False, True])
@pytest.mark.parametrize("divide", [False, True])
@pytest.mark.parametrize("log_n", [0, 1, 4, 10])
def test_conv_values_matches_jax(log_n, divide, xfield):
    a = _values(log_n, _shape(log_n, xfield, (2,)))
    b = _values(log_n + 50, _shape(log_n, xfield, (2,)))
    if divide and log_n:  # a zero value of ntt(b): its inverse is 0
        b[0] = 0
        b[0, 0] = 5
    want = jntt.conv_values(a, b, xfield=xfield, divide=divide)
    got = ntt.conv_values(a, b, xfield=xfield, divide=divide, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ntt.conv_values(a, b, xfield=xfield, divide=divide, device="cpu",
                        plain=True), want)


@pytest.mark.parametrize("a_xfe,table_xfe", [(False, False), (True, False),
                                             (True, True)])
@pytest.mark.parametrize("log_n", [3, 11])
def test_conv_table_values_matches_jax(log_n, a_xfe, table_xfe):
    """A base table on base and xfe operands, an xfe table on xfe ones."""
    tv = _values(log_n + 7, _shape(log_n, table_xfe))
    a = _values(log_n + 8, _shape(log_n, a_xfe, (3,)))
    want = jntt.conv_table_values(
        a, jntt.conv_table_prepare(tv, xfield=table_xfe), xfield=a_xfe,
        table_xfield=table_xfe)
    table = ntt.conv_table_prepare(tv, xfield=table_xfe, device="cpu")
    got = ntt.conv_table_values(a, table, xfield=a_xfe,
                                table_xfield=table_xfe)
    np.testing.assert_array_equal(got, want)


def test_conv_table_rejects_a_mismatched_field():
    """An xfe table with base-field ``a`` raises ValueError, as numpy's
    broadcast does in JAX; with xfe ``a`` and ``table_xfield`` left False,
    the table's own field decides, as on JAX's host route."""
    tv = _values(1, (8, 3))
    table = ntt.conv_table_prepare(tv, xfield=True, device="cpu")
    jtable = jntt.conv_table_prepare(tv, xfield=True)
    with pytest.raises(ValueError):
        jntt.conv_table_values(_values(2, (8,)), jtable, table_xfield=True)
    with pytest.raises(ValueError):
        ntt.conv_table_values(_values(2, (8,)), table, table_xfield=True)
    a = _values(2, (8, 3))
    np.testing.assert_array_equal(
        ntt.conv_table_values(a, table, xfield=True),
        jntt.conv_table_values(a, jtable, xfield=True))


def test_conv_rejects_bad_lengths():
    with pytest.raises(ntt.NttDomainError):
        ntt.conv_values(_values(1, (6,)), _values(2, (6,)), device="cpu")
    with pytest.raises(ntt.NttDomainError):
        ntt.conv_table_prepare(_values(1, (12, 3)), xfield=True, device="cpu")


# The table's field is its own whatever ``table_xfield`` says, as on JAX's
# host route (every table of up to 2^22 elements): an xfe table with the
# flag left False, and a base table with table_xfield=True under xfe ``a``.
TABLE_FIELD_CASES = {"xfe_table_flag_false": (True, False),
                     "base_table_flag_true": (False, True)}
C6_REPRO = ([[1, 0, 0], [2, 0, 0]], [[3, 0, 0], [4, 0, 0]],
            [[9223372034707292163, 0, 0], [9223372034707292167, 0, 0]])


@pytest.mark.parametrize("case", sorted(TABLE_FIELD_CASES))
@pytest.mark.parametrize("log_n", [1, 11])
def test_conv_table_values_take_the_tables_field(log_n, case, monkeypatch):
    """Through the device function on a CPU table, and through the routed
    one on a host table and on a device table (the routes' device set to
    the CPU: at 2^11 the port's routed table is a ConvTable)."""
    monkeypatch.setattr(ntt, "DEVICE", "cpu")
    table_xfe, flag = TABLE_FIELD_CASES[case]
    tv = _values(log_n + 30, _shape(log_n, table_xfe))
    a = _values(log_n + 31, _shape(log_n, True, (2,)))
    if log_n == 1 and table_xfe:  # the repro, its value written out
        a, tv, pinned = (np.array(v, dtype=np.uint64) for v in C6_REPRO)
    want = jntt.conv_table_values(
        a, jntt.conv_table_prepare(tv, xfield=table_xfe), xfield=True,
        table_xfield=flag)
    if log_n == 1 and table_xfe:
        np.testing.assert_array_equal(want, pinned)
    for table in (ntt.conv_table_prepare(tv, xfield=table_xfe, device="cpu"),
                  ntt.routed_conv_table_prepare(tv, xfield=table_xfe)):
        np.testing.assert_array_equal(
            ntt.routed_conv_table_values(a, table, xfield=True,
                                         table_xfield=flag), want)
    table = ntt.conv_table_prepare(tv, xfield=table_xfe, device="cpu")
    for plain in (False, True):
        np.testing.assert_array_equal(
            ntt.conv_table_values(a, table, xfield=True, table_xfield=flag,
                                  plain=plain), want)


def _raised(fn) -> Exception:
    with pytest.raises(Exception) as err:
        fn()
    return err.value


# An operand with fewer axes than its field needs: xfe ``a`` with base
# ``b``, and base ``a`` under xfield=True
FIELD_SHAPE_CASES = {"xfe_a_base_b": ((4, 3), (4,)),
                     "base_a_xfield": ((4,), (4,))}


@pytest.mark.parametrize("case", sorted(FIELD_SHAPE_CASES))
def test_a_field_shape_mismatch_raises_jaxs_class(case):
    """JAX and the host route raise numpy's AxisError (a ValueError and an
    IndexError) or an IndexError; the device function raises AxisError,
    an instance of either, on every device."""
    sa, sb = FIELD_SHAPE_CASES[case]
    a, b = _values(40, sa), _values(41, sb)
    want = _raised(lambda: jntt.conv_values(a, b, xfield=True))
    assert isinstance(want, IndexError)
    for got in (_raised(lambda: ntt.conv_values(a, b, xfield=True,
                                                device="cpu")),
                _raised(lambda: ntt.routed_conv_values(a, b, xfield=True))):
        assert isinstance(got, type(want)), (got, want)
    assert isinstance(_raised(lambda: ntt.conv_values(
        a, b, xfield=True, device="cpu")), np.exceptions.AxisError)
    if case == "base_a_xfield":
        want = _raised(lambda: jntt.conv_table_prepare(a, xfield=True))
        got = _raised(lambda: ntt.conv_table_prepare(a, xfield=True,
                                                     device="cpu"))
        assert isinstance(got, type(want)), (got, want)
        base = ntt.conv_table_prepare(b, device="cpu")
        want = _raised(lambda: jntt.conv_table_values(
            a, jntt.conv_table_prepare(b), xfield=True))
        got = _raised(lambda: ntt.conv_table_values(a, base, xfield=True))
        assert isinstance(got, type(want)), (got, want)
