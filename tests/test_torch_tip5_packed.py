"""The port's ops/tip5_packed.py against the JAX package's, exactly, on the
CPU: the layout helpers (index moves on uint32 planes), the eligibility
predicate, and the packed commit's entry points (K2's plan on the carrier,
through the twins here) against JAX's packed path in interpret mode at
tile 8, as tests/test_tip5_packed.py runs it.

With tile 8, JAX's packed chain stops at 64 digests and reduces the rest
with its XLA permutation, a jit compile of about 3 s a shape; every case
below shares those shapes (32 states down to 1), and each JAX value is
computed once."""

import functools

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu.math import gf as jgf
from twenty_first_tpu.math.b_field_element import P
from twenty_first_tpu.ops import tip5_packed as jpacked
from twenty_first_tpu_torch.math import gf
from twenty_first_tpu_torch.ops import tip5_packed

TILE = 8
#: (name, digests, tile): eligible (64 states, 8 rows of tile 8, then the
#: tail) and ineligible (32 states: 4 rows, below a tile) sizes
REDUCE_CASES = {"eligible": (128, TILE), "ineligible": (64, TILE),
                "default_tile": (32, tip5_packed.TILE)}
COMMIT_STATES = 64  # eligible at tile 8: the leaf hash packed, then the tail


def _words(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint64)


def _u32(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 1 << 32, size=shape,
                                                dtype=np.uint64).astype(
                                                    np.uint32)


def _port(planes):
    return tuple(torch.from_numpy(np.array(p)) for p in planes)


def _same(got, want):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.uint32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@functools.lru_cache(maxsize=None)
def _jax_reduce(case: str, layers: int):
    b, tile = REDUCE_CASES[case]
    state = jgf.to_limbs(_words(b, (b, 5)))
    out = jpacked.reduce_layers_packed(state, layers, tile=tile,
                                       interpret=True)
    return tuple(np.asarray(v) for v in out)


@functools.lru_cache(maxsize=None)
def _jax_commit(layers: int):
    slo, shi = jgf.to_limbs(_words(7, (COMMIT_STATES, 16)))
    out = jpacked.commit_states_packed(slo, shi, layers, tile=TILE,
                                       interpret=True)
    return tuple(np.asarray(v) for v in out)


def test_the_constants_are_jaxs():
    assert tip5_packed.TILE == jpacked.TILE
    assert tip5_packed.MULTI_LEVELS == jpacked.MULTI_LEVELS


@pytest.mark.parametrize("b", [8, 128])
def test_pack_and_unpack_equal_jax(b):
    lo, hi = _u32(b, (b, 16)), _u32(b + 1, (b, 16))
    packed = tip5_packed.pack_states(*_port((lo, hi)))
    _same(packed, jpacked.pack_states(lo, hi))
    _same(tip5_packed.unpack_states(*packed), jpacked.unpack_states(
        *jpacked.pack_states(lo, hi)))
    _same(tip5_packed.unpack_states(*packed), (lo, hi))
    _same(tip5_packed.unpack_digests(*packed), jpacked.unpack_digests(
        *jpacked.pack_states(lo, hi)))


@pytest.mark.parametrize("rows", [2, 16])
def test_pair_packed_equals_jax(rows):
    ilo, ihi = _u32(rows, (rows, 128)), _u32(rows + 1, (rows, 128))
    got = tip5_packed.pair_packed(*_port((ilo, ihi)))
    want = jpacked.pair_packed(ilo, ihi)
    _same(got, want)
    assert (got[0][:, 80:] == 1).all() and (got[1][:, 80:] == 0).all()


def test_packed_eligible_is_jaxs():
    for tile in (1, 8, 16, jpacked.TILE):
        for n in range(0, 64 * tile + 24, max(1, tile // 2)):
            assert tip5_packed.packed_eligible(n, tile) == \
                jpacked.packed_eligible(n, tile), (n, tile)
    for n in (0, 8 * jpacked.TILE, 8 * jpacked.TILE - 8, 12):
        assert tip5_packed.packed_eligible(n) == jpacked.packed_eligible(n)


def test_the_gate_is_false_off_a_tpu():
    """JAX gives False on a non-TPU backend (these tests' CPU); the port's
    commit has no packed route and always says False."""
    assert jpacked.use_packed_commit() is False
    assert tip5_packed.use_packed_commit() is False


@pytest.mark.parametrize("case,layers", [
    *(("eligible", k) for k in range(8)),
    *(("ineligible", k) for k in range(7)),
    ("default_tile", 5)])
def test_reduce_layers_packed_equals_jax(case, layers):
    b, tile = REDUCE_CASES[case]
    assert tip5_packed.packed_eligible(b // 2, tile) == (case == "eligible")
    lo, hi = gf.to_limbs(_words(b, (b, 5)), device="cpu")
    got = tip5_packed.reduce_layers_packed((lo, hi), layers, tile=tile,
                                           interpret=True)
    assert got[0].shape == (b >> layers, 5)
    _same(got, _jax_reduce(case, layers))


@pytest.mark.parametrize("layers", range(7))
def test_commit_states_packed_equals_jax(layers):
    slo, shi = gf.to_limbs(_words(7, (COMMIT_STATES, 16)), device="cpu")
    got = tip5_packed.commit_states_packed(slo, shi, layers, tile=TILE,
                                           interpret=True)
    assert got[0].shape == (COMMIT_STATES >> layers, 5)
    _same(got, _jax_commit(layers))
