"""The port's Merkle commit (ops/tip5_commit.py and K2's plain twin) against
the JAX package's reduction, exactly, plus the K2 launch plan."""

import numpy as np
import pytest
import torch

from twenty_first_tpu.math import gf as jgf
from twenty_first_tpu.math.b_field_element import P
from twenty_first_tpu.parallel import dist_merkle
from twenty_first_tpu.tip5 import permutation as jperm
from twenty_first_tpu_torch.math import gf
from twenty_first_tpu_torch.ops import tip5_commit, tip5_cuda
from twenty_first_tpu_torch.tip5.permutation import tip5_tables

RNG = np.random.default_rng(31)


def _jax_reduce(values, layers):
    return jgf.from_limbs(dist_merkle._reduce_layers(jgf.to_limbs(values),
                                                     layers))


@pytest.mark.parametrize("rows,layers", [(2, 1), (8, 3), (6, 1), (96, 5),
                                         (40, 3), (384, 7), (64, 0)])
def test_reduce_layers_matches_jax(rows, layers):
    dig = RNG.integers(0, P, size=(rows, 5), dtype=np.uint64)
    got = tip5_commit.reduce_layers(gf.from_u64(dig), layers)
    np.testing.assert_array_equal(gf.to_u64(got), _jax_reduce(dig, layers))


@pytest.mark.parametrize("rows,layers", [(48, 4), (64, 6), (20, 0)])
def test_commit_states_matches_jax(rows, layers):
    states = RNG.integers(0, P, size=(rows, 16), dtype=np.uint64)
    got = tip5_commit.commit_states(gf.from_u64(states), layers)
    leafs = jperm.permutation_values(states)[:, :5]
    np.testing.assert_array_equal(gf.to_u64(got), _jax_reduce(leafs, layers))


def test_merkle_commit_twin_is_one_launch():
    """merkle_commit's twin: leaf mode = permute + `levels` pair levels,
    pair mode = `levels` pair levels; independent of the block size."""
    rc, lut = tip5_tables()
    states = gf.from_u64(RNG.integers(0, P, size=(64, 16), dtype=np.uint64))
    leaf = tip5_cuda.merkle_commit(states, True, 3, 16, rc, lut)
    assert leaf.shape == (8, 5)
    digests = tip5_cuda.tip5_permute(states, rc, lut)[:, :5].contiguous()
    assert torch.equal(leaf, tip5_commit.reduce_layers(digests, 3))
    pair = tip5_cuda.merkle_commit(digests, False, 5, 32, rc, lut)
    assert pair.shape == (2, 5)
    assert torch.equal(pair, tip5_commit.reduce_layers(digests, 5))


@pytest.mark.parametrize("leaf,levels,threads,rows", [
    (True, 0, 3, 12),      # threads not a power of two
    (True, 4, 8, 16),      # 2^levels > block span
    (False, 0, 4, 8),      # pair mode needs a level
    (False, 2, 4, 12),     # rows not a multiple of the span
    (True, 1, 512, 512),   # above the largest block
])
def test_merkle_commit_rejects_bad_launch(leaf, levels, threads, rows):
    rc, lut = tip5_tables()
    x = torch.zeros(rows, 16 if leaf else 5, dtype=torch.int64)
    with pytest.raises(ValueError):
        tip5_cuda.merkle_commit(x, leaf, levels, threads, rc, lut)


def _plan(monkeypatch, fn, x, layers):
    calls = []

    def fake(x, leaf, levels, threads, rc, lut):
        calls.append((x.shape[0], leaf, levels, threads))
        return torch.zeros(x.shape[0] >> levels, 5, dtype=torch.int64)

    monkeypatch.setattr(tip5_cuda, "merkle_commit", fake)
    fn(x, layers)
    return calls


def test_launch_plan_of_the_main_path(monkeypatch):
    """2^22 leaf digests: two full 9-level launches, then one launch for
    the 16-digest layer smaller than a block."""
    x = torch.empty(1 << 22, 5, dtype=torch.int64)
    assert _plan(monkeypatch, tip5_commit.reduce_layers, x, 22) == [
        (1 << 22, False, 9, 256), (1 << 13, False, 9, 256), (16, False, 4, 8)]


def test_launch_plan_of_a_commit(monkeypatch):
    x = torch.empty(3 << 10, 16, dtype=torch.int64)
    assert _plan(monkeypatch, tip5_commit.commit_states, x, 10) == [
        (3 << 10, True, 8, 256), (12, False, 2, 2)]
    x = torch.empty(24, 16, dtype=torch.int64)
    assert _plan(monkeypatch, tip5_commit.commit_states, x, 3) == [
        (24, True, 3, 8)]


def test_rejects_indivisible_layers():
    with pytest.raises(ValueError):
        tip5_commit.reduce_layers(torch.zeros(12, 5, dtype=torch.int64), 3)
    with pytest.raises(ValueError):
        tip5_commit.commit_states(torch.zeros(12, 16, dtype=torch.int64), 3)
