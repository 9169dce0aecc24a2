"""The port's NTT-domain convolutions (twenty_first_tpu_torch.math.ntt's
conv_values, conv_table_prepare, conv_table_values) against the JAX
package's, exactly: integer field arithmetic, so the tolerance is 0.

At these sizes JAX takes its host round trip (below HOST_CONV_MAX_ELEMS),
the values its device graph gives too (tests/test_ntt_conv.py); the port
has no crossover and runs the K3/K8 wrappers, their plain twins on the
CPU."""

import numpy as np
import pytest

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
    table = ntt.conv_table_prepare(_values(1, (8, 3)), xfield=True,
                                   device="cpu")
    with pytest.raises(ValueError):
        ntt.conv_table_values(_values(2, (8,)), table, table_xfield=True)
    with pytest.raises(ValueError):
        ntt.conv_table_values(_values(2, (8, 3)), table, xfield=True)


def test_conv_rejects_bad_lengths():
    with pytest.raises(ntt.NttDomainError):
        ntt.conv_values(_values(1, (6,)), _values(2, (6,)), device="cpu")
    with pytest.raises(ntt.NttDomainError):
        ntt.conv_table_prepare(_values(1, (12, 3)), xfield=True, device="cpu")
