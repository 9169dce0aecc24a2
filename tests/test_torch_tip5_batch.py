"""The port's standalone Tip5 batch path (tip5/permutation.py's batch,
trace and sponge entry points, ops/tip5_batch.py's T4/T5 entry points)
against the JAX package, exactly, on the CPU; and the values chip_smoke.py
pins for the card, re-derived from JAX."""

import numpy as np
import pytest
import torch

import chip_smoke
from twenty_first_tpu.math.b_field_element import P, bfe
from twenty_first_tpu.ops import tip5_pallas
from twenty_first_tpu.tip5 import Digest, Tip5
from twenty_first_tpu.tip5 import permutation as jperm
from twenty_first_tpu_torch.math import gf
from twenty_first_tpu_torch.ops import tip5_batch, tip5_cuda
from twenty_first_tpu_torch.tip5 import permutation as tperm

EDGES = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, (1 << 32) + 1]


def _states(batch: int, seed: int):
    rnd = np.random.default_rng(seed).integers(0, P, size=(batch, 16),
                                               dtype=np.uint64)
    edge = np.array([[e] * 16 for e in EDGES], dtype=np.uint64)
    return np.concatenate([rnd, edge])


@pytest.fixture(scope="module")
def states_256():
    """256 states and JAX's permutation of them (the T4/T5 oracle)."""
    states = _states(250, 1)
    return states, jperm.permutation_values(states)


def test_permutation_batch_matches_jax():
    states = _states(31, 2)
    want = jperm.permutation_batch_values(states)
    np.testing.assert_array_equal(
        tperm.permutation_batch_values(states, "cpu"), want)
    np.testing.assert_array_equal(tperm.permutation_values(states, "cpu"),
                                  want)
    got = tperm.permutation_batch(gf.from_u64(states))
    np.testing.assert_array_equal(gf.to_u64(got), want)


def test_t4_entry_points_match_the_pallas_kernel(states_256):
    """T4 against ``tip5_pallas.permutation_values`` in interpret mode, as
    tests/test_pallas_kernels.py runs it."""
    states, want = states_256
    pallas = tip5_pallas.permutation_values(states, tile=128, interpret=True)
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(
        tip5_batch.permutation_values(states, tile=128, interpret=True,
                                      device="cpu"), pallas)
    got = tip5_batch.permutation(gf.from_u64(states))
    np.testing.assert_array_equal(gf.to_u64(got), pallas)


def test_t5_entry_points_match_jax(states_256):
    """T5 against the XLA path (the dense kernel's interpret mode is too
    slow to run here, tests/test_pallas_kernels.py:19-23)."""
    states, want = states_256
    x = gf.from_u64(states)
    for fn in (tip5_batch.permutation_dense,
               tip5_batch.permutation_dense_nogrid):
        np.testing.assert_array_equal(gf.to_u64(fn(x)), want)
    np.testing.assert_array_equal(
        tip5_batch.permutation_dense_values(states, device="cpu"), want)


def test_trace_matches_jax_and_pins_the_chip_trace():
    states = _states(9, 3)
    states[0] = np.arange(16)
    want = jperm.trace_values(states)
    assert [[int(r[0]), int(r[15])] for r in want[0]] == chip_smoke.PINNED_TRACE
    got = tperm.trace_values(states, "cpu")
    assert got.shape == (len(states), 6, 16)
    np.testing.assert_array_equal(got, want)
    # leading axes, and the last trace row is the permutation
    x = gf.from_u64(states[:8].reshape(2, 4, 16))
    traced = tperm.trace(x)
    assert traced.shape == (2, 4, 6, 16)
    np.testing.assert_array_equal(gf.to_u64(traced).reshape(8, 6, 16),
                                  want[:8])
    assert torch.equal(traced[..., -1, :], tperm.permutation(x))


def test_tip5_trace_wrapper_on_cpu_is_the_plain_twin():
    states = gf.from_u64(_states(4, 4))
    rc, lut = tperm.tip5_tables("cpu")
    launches = tip5_cuda.tip5_trace.launches
    got = tip5_cuda.tip5_trace(states, rc, lut)
    assert tip5_cuda.tip5_trace.launches == launches  # no kernel on a CPU
    assert torch.equal(got, tip5_cuda.tip5_trace_plain(states, rc, lut))
    with pytest.raises(ValueError):
        tip5_cuda.tip5_trace(states[:, :15].contiguous(), rc, lut)


@pytest.mark.parametrize("length", sorted(chip_smoke.PINNED_VARLEN))
def test_hash_varlen_pins_the_chip_digests(length):
    """JAX re-derives the digests chip_smoke.py checks on the card; the
    port's plain path reproduces the short one here (the long one is 1639
    plain permutations, which the card checks)."""
    x = chip_smoke.varlen_input(length)
    want = jperm.hash_varlen(x)
    assert want.tolist() == chip_smoke.PINNED_VARLEN[length]
    if length <= 1000:
        np.testing.assert_array_equal(tperm.hash_varlen(x, "cpu"), want)


def test_hash_varlen_keeps_leading_axes():
    x = np.random.default_rng(5).integers(0, P, size=(2, 3, 11),
                                          dtype=np.uint64)
    got = tperm.hash_varlen(x, "cpu")
    assert got.shape == (2, 3, 5)
    for idx in np.ndindex(2, 3):
        assert Digest.from_array(got[idx]) == Tip5.hash_varlen(
            [bfe(int(v)) for v in x[idx]])


def test_hash_varlen_ragged_matches_jax_and_pins_the_chip_digests():
    """Lengths 0, 1, 9, 10, 11, 64 in one call: JAX's digests are the pins,
    and the port gives them in every input order."""
    inputs = chip_smoke.ragged_inputs()
    want = jperm.hash_varlen_ragged(inputs)
    assert want.tolist() == chip_smoke.PINNED_RAGGED
    np.testing.assert_array_equal(tperm.hash_varlen_ragged(inputs, "cpu"),
                                  want)
    order = [3, 0, 5, 1, 4, 2]
    np.testing.assert_array_equal(
        tperm.hash_varlen_ragged([inputs[i] for i in order], "cpu"),
        want[order])
    for a, digest in zip(inputs, want):
        assert Digest.from_array(digest) == Tip5.hash_varlen(
            [bfe(int(v)) for v in a])


def test_hash_varlen_ragged_of_nothing():
    assert tperm.hash_varlen_ragged([], "cpu").shape == (0, 5)
