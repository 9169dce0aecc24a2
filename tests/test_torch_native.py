"""The port's loader of the native host core (twenty_first_tpu_torch/
native.py) against the JAX package's (twenty_first_tpu/native.py): a build
into a temporary directory, every wrapper on the same inputs, the
switches, and the host arithmetic's native route against its numpy form."""

from pathlib import Path

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu import native as jnative
from twenty_first_tpu.math import ntt as jntt
from twenty_first_tpu_torch import native as tnative
from twenty_first_tpu_torch.math import gf_numpy as gfn
from twenty_first_tpu_torch.math import ntt as tntt
from twenty_first_tpu_torch.math import xgf_numpy as xgf

P = 0xFFFF_FFFF_0000_0001
REPO = Path(__file__).resolve().parent.parent
EDGES = [0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 63) % P]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The core built by the port's loader into a temporary directory and
    loaded from there; the JAX package's core beside it."""
    if not jnative.available():
        pytest.skip("the JAX package's native core is unavailable")
    before = sorted(p.name for p in (REPO / "native").iterdir())
    path = tnative.build(tmp_path_factory.mktemp("native"))
    assert path.parent.name.startswith("native") and path.exists()
    assert sorted(p.name for p in (REPO / "native").iterdir()) == before
    assert tnative.build(path.parent) == path  # built once, then found
    return tnative.open_library(path)


@pytest.fixture
def port_lib(built, monkeypatch):
    monkeypatch.setattr(tnative, "_LIB", built)
    monkeypatch.setattr(tnative, "_TRIED", True)
    return built


def _rand(rng, shape, low=0):
    x = rng.integers(low, P, size=shape, dtype=np.uint64)
    flat = x.reshape(-1)
    flat[: len(EDGES)] = np.array(EDGES, dtype=np.uint64)[: flat.size]
    if low:
        flat[flat < low] = low
    return x


def test_every_wrapper_matches_jax(port_lib):
    rng = np.random.default_rng(3)
    x = _rand(rng, 300, low=1)
    with_zeros = _rand(rng, 300)
    for name, args in (
            ("batch_inverse", (x,)),
            ("batch_inverse_or_zero", (with_zeros,)),
            ("horner_points", (_rand(rng, 77), _rand(rng, 50))),
            ("lagrange_interpolate", (np.unique(x)[:40], _rand(rng, 40))),
            ("tip5_permute_batch", (_rand(rng, (5, 16)),)),
            ("tip5_hash_pairs", (_rand(rng, (8, 5)),)),
            ("tip5_hash_varlen", (_rand(rng, 23),)),
            ("tip5_hash_varlen", (np.zeros(0, np.uint64),)),
            ("tip5_merkle_root", (_rand(rng, (16, 5)),))):
        got = getattr(tnative, name)(*args)
        np.testing.assert_array_equal(got, getattr(jnative, name)(*args))
    den = _rand(rng, 9)
    den[-1] = 5
    for num in (_rand(rng, 30), _rand(rng, 4), _rand(rng, 9)):
        for g, w in zip(tnative.poly_divmod(num, den),
                        jnative.poly_divmod(num, den)):
            np.testing.assert_array_equal(g, w)
    for log_n in (1, 3, 8):
        n = 1 << log_n
        v = _rand(rng, n)
        root = tntt.PRIMITIVE_ROOTS[n]
        np.testing.assert_array_equal(tnative.ntt_inplace(v, root),
                                      jnative.ntt_inplace(v, root))
        inv = pow(root, P - 2, P)
        np.testing.assert_array_equal(tnative.intt_inplace(v, inv),
                                      jnative.intt_inplace(v, inv))
        for inverse in (False, True):
            rows = _rand(rng, (3, n))
            want = rows.copy()
            n_inv = pow(n, P - 2, P) if inverse else 0
            tnative.ntt_rows_inplace(rows, tntt._host_stage_tw_flat(
                log_n, inverse), n_inv)
            jnative.ntt_rows_inplace(want, jntt._host_stage_tw_flat(
                log_n, inverse), n_inv)
            np.testing.assert_array_equal(rows, want)
    coeffs, shift = _rand(rng, 300), _rand(rng, 64)
    args = (coeffs, shift, 5, tntt._host_stage_tw_flat(6, False),
            tntt._host_stage_tw_flat(6, True), pow(64, P - 2, P))
    np.testing.assert_array_equal(tnative.reduce_by_ntt_modulus(*args),
                                  jnative.reduce_by_ntt_modulus(*args))
    a, b = _rand(rng, 100), _rand(rng, 100)
    for fn in ("gl_mul_arrays", "gl_add_arrays", "gl_sub_arrays"):
        got, want = np.empty_like(a), np.empty_like(a)
        getattr(port_lib, fn)(a.ctypes.data, b.ctypes.data, got.ctypes.data,
                              a.size)
        getattr(jnative._load(), fn)(a.ctypes.data, b.ctypes.data,
                                     want.ctypes.data, a.size)
        np.testing.assert_array_equal(got, want)
    assert port_lib.gl_mul_scalar(P - 1, P - 1) == 1
    assert port_lib.gl_inv_scalar(2) == pow(2, P - 2, P)
    assert port_lib.gl_pow_scalar(7, 5) == pow(7, 5, P)


def test_wrappers_refuse_malformed_input(port_lib):
    with pytest.raises(ValueError):
        tnative.ntt_rows_inplace(np.zeros((2, 8), np.uint64)[:, ::2],
                                 tntt._host_stage_tw_flat(2, False))
    with pytest.raises(ValueError):
        tnative.ntt_rows_inplace(np.zeros((2, 8), np.uint64),
                                 tntt._host_stage_tw_flat(2, False))
    with pytest.raises(ValueError):
        tnative.poly_divmod(np.ones(4, np.uint64),
                            np.array([1, 0], np.uint64))
    with pytest.raises(ValueError):
        tnative.lagrange_interpolate(np.ones(3, np.uint64),
                                     np.ones(2, np.uint64))


def test_library_is_keyed_by_source_flags_and_cpu(tmp_path, monkeypatch):
    path = tnative.library_path(tmp_path)
    assert path.parent == tmp_path and path.name.startswith("native_")
    monkeypatch.setattr(tnative, "CXXFLAGS", tnative.CXXFLAGS + ("-g",))
    assert tnative.library_path(tmp_path) != path
    monkeypatch.setattr(tnative, "_cpu_identity", lambda: b"another cpu")
    assert tnative.library_path(tmp_path) != path


def test_switches_are_the_jax_package_s(port_lib, monkeypatch):
    """TWENTY_FIRST_TPU_NO_NATIVE leaves the core unloaded;
    TWENTY_FIRST_TPU_NATIVE_HOST=0 keeps the host arithmetic and host NTT
    on numpy with the same values; the default build lands in the port's
    .build/."""
    x = np.arange(1, 300, dtype=np.uint64)
    want = (gfn.mul(x, x), tntt.ntt_host(x[:256]))
    assert tnative.host_arithmetic() is port_lib
    monkeypatch.setenv("TWENTY_FIRST_TPU_NATIVE_HOST", "0")
    assert tnative.available() and tnative.host_arithmetic() is None
    assert tntt._ntt_host_native(x[:256], 8, False) is None
    for g, w in zip((gfn.mul(x, x), tntt.ntt_host(x[:256])), want):
        np.testing.assert_array_equal(g, w)
    monkeypatch.setenv("TWENTY_FIRST_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(tnative, "_TRIED", False)
    monkeypatch.setattr(tnative, "_LIB", None)
    assert not tnative.available()
    with pytest.raises(RuntimeError):
        tnative.batch_inverse(x)
    assert tnative.library_path().parent == \
        REPO / "twenty_first_tpu_torch" / ".build"


@pytest.mark.parametrize("shape_a,shape_b", [((40,), (40,)), ((8, 5), (5,)),
                                             ((3,), (3,)), ((6, 7), (6, 7))])
def test_host_arithmetic_native_route_equals_numpy(port_lib, monkeypatch,
                                                   shape_a, shape_b):
    rng = np.random.default_rng(11)
    a, b = _rand(rng, shape_a), _rand(rng, shape_b)
    xa, xb = _rand(rng, shape_a + (3,)), _rand(rng, shape_a + (3,))
    native = [gfn.mul(a, b), gfn.add(a, b), gfn.sub(a, b), gfn.inverse(a),
              xgf.mul(xa, xb), xgf.inverse(xa)]
    monkeypatch.setenv("TWENTY_FIRST_TPU_NATIVE_HOST", "0")
    numpy = [gfn.mul(a, b), gfn.add(a, b), gfn.sub(a, b), gfn.inverse(a),
             xgf.mul(xa, xb), xgf.inverse(xa)]
    for g, w in zip(native, numpy):
        np.testing.assert_array_equal(g, w)
