"""The port's Merkle commit (ops/tip5_commit.py and K2's plain twin) against
the JAX package's reduction, exactly, plus the K2 launch plan."""

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
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
    rc, lut = tip5_tables("cpu")
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
    rc, lut = tip5_tables("cpu")
    x = torch.zeros(rows, 16 if leaf else 5, dtype=torch.int64)
    with pytest.raises(ValueError):
        tip5_cuda.merkle_commit(x, leaf, levels, threads, rc, lut)


def _plan(monkeypatch, fn, x, layers, resident):
    """The launches fn makes, recorded by stand-ins for both K2 wrappers."""
    calls = []

    def level(x, leaf, rc, lut):
        calls.append(("level", x.shape[0], leaf))
        return torch.zeros(x.shape[0] if leaf else x.shape[0] // 2, 5,
                           dtype=torch.int64)

    def fused(x, leaf, levels, threads, rc, lut):
        calls.append(("fused", x.shape[0], leaf, levels, threads))
        return torch.zeros(x.shape[0] >> levels, 5, dtype=torch.int64)

    monkeypatch.setattr(tip5_cuda, "merkle_level", level)
    monkeypatch.setattr(tip5_cuda, "merkle_commit", fused)
    fn(x, layers, resident_threads=resident)
    return calls


#: threads of the level kernel an H100 holds: 132 SMs x 4 blocks of 128
#: (124 registers a thread)
H100_RESIDENT = 132 * 4 * 128


def test_launch_plan_of_the_main_path(monkeypatch):
    """2^22 leaf digests on a card holding 67,584 threads: one full-width
    launch for each level down to 2^17 parents, then two fused launches
    for the 17 levels below (the last one block)."""
    x = torch.empty(1 << 22, 5, dtype=torch.int64)
    assert tip5_commit.plan(1 << 22, 22, H100_RESIDENT) == [
        ("level", False)] * 5 + [("fused", False, 9, 256),
                                 ("fused", False, 8, 128)]
    assert _plan(monkeypatch, tip5_commit.reduce_layers, x, 22,
                 H100_RESIDENT) == [
        ("level", 1 << r, False) for r in range(22, 17, -1)] + [
        ("fused", 1 << 17, False, 9, 256), ("fused", 1 << 8, False, 8, 128)]
    # one block fewer per SM moves the switch down one level
    assert tip5_commit.plan(1 << 22, 22, 132 * 3 * 128)[:7] == [
        ("level", False)] * 6 + [("fused", False, 9, 256)]


def test_launch_plan_of_a_commit(monkeypatch):
    x = torch.empty(3 << 10, 16, dtype=torch.int64)
    # a card too small for any level: the fused launches alone
    assert _plan(monkeypatch, tip5_commit.commit_states, x, 10, 1 << 30) == [
        ("fused", 3 << 10, True, 8, 256), ("fused", 12, False, 2, 2)]
    # the leaf hash and one level at full width, then the fused tail
    assert _plan(monkeypatch, tip5_commit.commit_states, x, 10, 1000) == [
        ("level", 3 << 10, True), ("level", 3 << 10, False),
        ("fused", 3 << 9, False, 9, 256)]
    x = torch.empty(24, 16, dtype=torch.int64)
    assert _plan(monkeypatch, tip5_commit.commit_states, x, 3, 64) == [
        ("fused", 24, True, 3, 8)]
    assert _plan(monkeypatch, tip5_commit.commit_states, x, 3, 0) == [
        ("level", 24, True)] + [("level", 24 >> k, False) for k in range(3)]


@pytest.mark.parametrize("rows,layers", [(1 << 12, 12), (3 << 11, 11),
                                         (96, 5), (40, 3), (64, 0), (2, 1)])
@pytest.mark.parametrize("resident", [0, 1, 5, 64, 1000, 1 << 30])
@pytest.mark.parametrize("leaf", [False, True])
def test_plan_reduces_every_layer(rows, layers, resident, leaf):
    """Every plan reduces exactly ``layers`` levels, full-width levels only
    while the parents fill ``resident`` threads, and every fused launch
    fits one block per span."""
    steps = tip5_commit.plan(rows, layers, resident, leaf)
    r, done, hashed = rows, 0, not leaf
    for step in steps:
        if step[0] == "level":
            assert step[1] == (not hashed)
            if step[1]:
                assert r >= resident
                hashed = True
            else:
                assert hashed and r // 2 >= resident
                r, done = r // 2, done + 1
        else:
            _, fleaf, levels, threads = step
            assert fleaf == (not hashed)
            span = threads if fleaf else 2 * threads
            assert r % span == 0 and (1 << levels) <= span
            r, done, hashed = r >> levels, done + levels, True
    assert done == layers and r == rows >> layers and hashed


@pytest.mark.parametrize("rows,layers,resident", [
    (96, 5, 8),       # two full-width levels, then one fused launch
    (384, 7, 48),     # the switch at the second level
    (1536, 9, 200),   # uneven: lowbit 512
    (3 << 10, 10, 0), # every level at full width
])
def test_plan_branches_match_jax(rows, layers, resident):
    dig = RNG.integers(0, P, size=(rows, 5), dtype=np.uint64)
    got = tip5_commit.reduce_layers(gf.from_u64(dig), layers,
                                    resident_threads=resident)
    np.testing.assert_array_equal(gf.to_u64(got), _jax_reduce(dig, layers))


@pytest.mark.parametrize("rows,layers,resident", [(48, 4, 8), (64, 6, 64),
                                                  (40, 3, 0)])
def test_commit_plan_branches_match_jax(rows, layers, resident):
    """The leaf hash at full width (rows >= resident) or fused."""
    states = RNG.integers(0, P, size=(rows, 16), dtype=np.uint64)
    got = tip5_commit.commit_states(gf.from_u64(states), layers,
                                    resident_threads=resident)
    leafs = jperm.permutation_values(states)[:, :5]
    np.testing.assert_array_equal(gf.to_u64(got), _jax_reduce(leafs, layers))


def test_merkle_level_twin():
    """merkle_level's twin: leaf mode hashes each state, pair mode pairs
    neighbours; odd digest counts are refused."""
    rc, lut = tip5_tables("cpu")
    states = gf.from_u64(RNG.integers(0, P, size=(8, 16), dtype=np.uint64))
    leafs = tip5_cuda.merkle_level(states, True, rc, lut)
    assert torch.equal(leafs, tip5_cuda.tip5_permute(states, rc, lut)[:, :5])
    pair = tip5_cuda.merkle_level(leafs, False, rc, lut)
    assert torch.equal(pair, tip5_commit.reduce_layers(leafs, 1))
    with pytest.raises(ValueError):
        tip5_cuda.merkle_level(leafs[:7].contiguous(), False, rc, lut)


def test_every_c_entry_point_has_a_signature():
    """ctypes passes an int argument without a declared type as 32 bits, so
    every entry point the kernels export needs its types in _build."""
    import re
    from pathlib import Path

    from twenty_first_tpu_torch import _build

    names = set()
    for src in Path(_build.CSRC).glob("*.cu"):
        names |= set(re.findall(r'extern "C" int (tf_\w+)', src.read_text()))
    assert "tf_merkle_level" in names
    assert names == set(_build._SIGNATURES)


def test_a_misaligned_view_goes_in_as_an_aligned_copy():
    """The kernels read rows with 16-byte loads: a contiguous view that
    starts 8 bytes off a 16-byte boundary is copied, an aligned tensor is
    passed as it is."""
    flat = torch.arange(16 * 4 + 2, dtype=torch.int64)
    view = flat[1:65].view(4, 16)
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    got = tip5_cuda._aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    aligned = flat[2:].view(4, 16)
    assert tip5_cuda._aligned(aligned) is aligned


def test_resident_threads_of_a_cpu_device_is_zero():
    assert tip5_cuda.resident_threads("cpu") == 0


def test_rejects_indivisible_layers():
    with pytest.raises(ValueError):
        tip5_commit.reduce_layers(torch.zeros(12, 5, dtype=torch.int64), 3)
    with pytest.raises(ValueError):
        tip5_commit.commit_states(torch.zeros(12, 16, dtype=torch.int64), 3)
