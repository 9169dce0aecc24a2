"""The port's ``math/gf64.py`` and the u32 limb helpers of its ``math/gf.py``
against the JAX package's, on the same random canonical and full-u64
inputs (and edge words), bit for bit: field arithmetic has no tolerance.

The JAX package's lazy forms are deterministic, so each lazy result is
held equal to JAX's representative, not only congruent to it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu.math import gf as jgf
from twenty_first_tpu.math import gf64 as jgf64
from twenty_first_tpu.math.b_field_element import P
from twenty_first_tpu_torch.math import gf, gf64

SIZE = 512
EDGES = np.array([0, 1, 2, P - 1, P, P + 1, (1 << 64) - 1, (1 << 32) - 1,
                  1 << 32, (1 << 63) - 1, 1 << 63, P - (1 << 32)],
                 dtype=np.uint64)


def _words(seed: int, full: bool) -> np.ndarray:
    """SIZE random canonical residues (or any u64 words), EDGES first."""
    rng = np.random.default_rng(seed)
    hi = np.iinfo(np.uint64).max if full else P - 1
    vals = rng.integers(0, hi, size=SIZE, dtype=np.uint64, endpoint=True)
    vals[:len(EDGES)] = EDGES if full else EDGES % np.uint64(P)
    return vals


def _port(v: np.ndarray) -> torch.Tensor:
    return gf.from_u64(v)


def _same(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(gf.to_u64(got), np.asarray(want))


def _planes(v: np.ndarray):
    """u32 limb planes of v: (numpy pair for JAX, uint32 tensors for the
    port)."""
    lo = (v & np.uint64(0xFFFF_FFFF)).astype(np.uint32)
    hi = (v >> np.uint64(32)).astype(np.uint32)
    return (lo, hi), (torch.from_numpy(lo), torch.from_numpy(hi))


def _same_planes(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("full", [False, True])
def test_pack_and_unpack_equal_jax(full):
    v = _words(1, full)
    jplanes, planes = _planes(v)
    packed = gf64.pack(planes)
    assert packed.dtype == torch.int64
    _same(packed, jgf64.pack(tuple(jnp.asarray(p) for p in jplanes)))
    _same_planes(gf64.unpack(packed), jgf64.unpack(jnp.asarray(v)))


@pytest.mark.parametrize("op", ["add_lazy", "sub_lazy", "mul_lazy", "mul",
                                "add", "sub"])
@pytest.mark.parametrize("full", [False, True])
def test_binary_ops_equal_jax(op, full):
    a, b = _words(2, full), _words(3, full)[::-1].copy()
    want = getattr(jgf64, op)(jnp.asarray(a), jnp.asarray(b))
    _same(getattr(gf64, op)(_port(a), _port(b)), want)


@pytest.mark.parametrize("full", [False, True])
def test_reduce128_lazy_and_canon_equal_jax(full):
    lo, hi = _words(4, True), _words(5, full)
    _same(gf64.reduce128_lazy(_port(lo), _port(hi)),
          jgf64.reduce128_lazy(jnp.asarray(lo), jnp.asarray(hi)))
    _same(gf64.canon(_port(lo)), jgf64.canon(jnp.asarray(lo)))


@pytest.mark.parametrize("k", [0, 1, 7, P - 1, P + 5, (1 << 64) + 3])
def test_mul_const_lazy_equals_jax(k):
    a = _words(6, True)
    _same(gf64.mul_const_lazy(_port(a), k),
          jgf64.mul_const_lazy(jnp.asarray(a), k))


@pytest.mark.parametrize("e", [1, 24, 31, 32, 48, 63, 64, 65, 72, 95])
@pytest.mark.parametrize("negate", [False, True])
def test_mul_by_pow2_lazy_equals_jax(e, negate):
    a = _words(7, True)
    _same(gf64.mul_by_pow2_lazy(_port(a), e, negate=negate),
          jgf64.mul_by_pow2_lazy(jnp.asarray(a), e, negate=negate))


@pytest.mark.parametrize("e", [0, 96, 191])
def test_mul_by_pow2_lazy_range_error_is_jaxs(e):
    """JAX asserts 0 < e < 96; the port raises an error that is an
    AssertionError and a ValueError, so callers of either package catch
    it."""
    a = _words(9, True)[:4]
    with pytest.raises(AssertionError):
        jgf64.mul_by_pow2_lazy(jnp.asarray(a), e)
    with pytest.raises(AssertionError) as err:
        gf64.mul_by_pow2_lazy(_port(a), e)
    assert isinstance(err.value, ValueError)


@pytest.mark.parametrize("inverse", [False, True])
def test_mul_by_i_lazy_equals_jax(inverse):
    a = _words(8, True)
    _same(gf64.mul_by_i_lazy(_port(a), inverse),
          jgf64.mul_by_i_lazy(jnp.asarray(a), inverse))


def test_lazy_chain_stays_on_jax_representatives():
    """A chain of lazy ops returns JAX's raw words at every step."""
    a, b = _words(9, True), _words(10, True)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pa, pb = _port(a), _port(b)
    for _ in range(3):
        ja, jb = (jgf64.add_lazy(jgf64.mul_lazy(ja, jb), jb),
                  jgf64.sub_lazy(jgf64.mul_by_i_lazy(ja), ja))
        pa, pb = (gf64.add_lazy(gf64.mul_lazy(pa, pb), pb),
                  gf64.sub_lazy(gf64.mul_by_i_lazy(pa), pa))
        _same(pa, ja)
        _same(pb, jb)


# ---------------------------------------------------------------------------
# The u32 limb helpers of gf.py
# ---------------------------------------------------------------------------


def test_mul32_equals_jax():
    rng = np.random.default_rng(11)
    a = rng.integers(0, 1 << 32, size=SIZE, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, size=SIZE, dtype=np.uint64).astype(np.uint32)
    a[:3] = [0, 1, 0xFFFF_FFFF]
    b[:3] = [0xFFFF_FFFF, 0xFFFF_FFFF, 0xFFFF_FFFF]
    _same_planes(gf.mul32(torch.from_numpy(a), torch.from_numpy(b)),
                 jgf.mul32(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("op", ["add64", "sub64"])
@pytest.mark.parametrize("full", [False, True])
def test_add64_and_sub64_equal_jax(op, full):
    ja, pa = _planes(_words(12, full))
    jb, pb = _planes(_words(13, True))
    (jlo, jhi), jc = getattr(jgf, op)(tuple(map(jnp.asarray, ja)),
                                      tuple(map(jnp.asarray, jb)))
    (lo, hi), c = getattr(gf, op)(pa, pb)
    _same_planes((lo, hi, c), (jlo, jhi, jc))


@pytest.mark.parametrize("op", ["mul64_wide", "mul_u32", "mul_lazy_u32"])
@pytest.mark.parametrize("full", [False, True])
def test_wide_and_u32_products_equal_jax(op, full):
    ja, pa = _planes(_words(14, full))
    jb, pb = _planes(_words(15, full))
    _same_planes(getattr(gf, op)(pa, pb),
                 getattr(jgf, op)(tuple(map(jnp.asarray, ja)),
                                  tuple(map(jnp.asarray, jb))))


def test_u32_ops_is_a_context_that_changes_no_value():
    ja, pa = _planes(_words(16, True))
    want = gf.mul_lazy_u32(pa, pa)
    with gf.u32_ops():
        got = gf.mul_lazy_u32(pa, pa)
        with jgf.u32_ops():
            jwant = jgf.mul_lazy(tuple(map(jnp.asarray, ja)),
                                 tuple(map(jnp.asarray, ja)))
    _same_planes(got, want)
    _same_planes(got, jwant)
