"""The port's NTT (twenty_first_tpu_torch.math.ntt and the K3 local pass's
plain twin) against the JAX package's tables and transforms, exactly."""

import numpy as np
import pytest
import torch

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
        ntt.ntt_tables(1 << 25, device="cpu")
    x = gf.from_u64(_rand((1, 64)))
    with pytest.raises(ValueError):
        ntt.ntt(x, tables=ntt.ntt_tables(64, inverse=True, device="cpu"))
    with pytest.raises(ValueError):
        ntt.ntt(x, tables=ntt.ntt_tables(128, device="cpu"))


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
