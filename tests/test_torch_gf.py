"""The port's field layer (twenty_first_tpu_torch.math.gf) against the JAX
package's gf on the same inputs, exactly: integer field arithmetic.

Inputs are made with numpy and cross over through the limb converters."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from twenty_first_tpu.math import b_field_element as jbfe
from twenty_first_tpu.math import gf as jgf
from twenty_first_tpu.math import gf_numpy as jgfn
from twenty_first_tpu_torch.math import b_field_element as tbfe
from twenty_first_tpu_torch.math import gf
from twenty_first_tpu_torch.math import gf_numpy as tgfn

P = jbfe.P
EDGES = [0, 1, 2, P - 2, P - 1, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
         (1 << 63), (1 << 63) - 1, P // 2]
# u64 values at or above p, which mul, canon and from_montgomery must accept
ABOVE_P = [P, P + 1, (1 << 64) - 1, (1 << 64) - 2, P + (1 << 31)]
REPO = Path(__file__).resolve().parent.parent


def _operands(seed: int, extra=()):
    rng = np.random.default_rng(seed)
    edge = np.array(EDGES + list(extra), dtype=np.uint64)
    a = np.concatenate([np.repeat(edge, len(edge)),
                        rng.integers(0, P, size=256, dtype=np.uint64)])
    b = np.concatenate([np.tile(edge, len(edge)),
                        rng.integers(0, P, size=256, dtype=np.uint64)])
    return a, b


def _jax(fn, *args):
    return jgf.from_limbs(fn(*(jgf.to_limbs(a) for a in args)))


def _port(fn, *args):
    return gf.to_u64(fn(*(gf.from_jax_limbs(jgf.to_limbs(a)) for a in args)))


def test_copied_constants_equal_jax():
    assert tbfe.P == jbfe.P
    assert tbfe.GENERATOR == jbfe.GENERATOR == jgf.GENERATOR
    assert tbfe.PRIMITIVE_ROOTS == jbfe.PRIMITIVE_ROOTS
    assert (gf.R, gf.R_INV) == (jgf.R, jgf.R_INV)
    assert gf.EPSILON == int(jgf.EPSILON)


def test_gf_numpy_helpers_equal_jax():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 1 << 64, size=1000, dtype=np.uint64, endpoint=False)
    b = rng.integers(0, 1 << 64, size=1000, dtype=np.uint64, endpoint=False)
    np.testing.assert_array_equal(tgfn.mul(a, b), jgfn.mul(a, b))
    for base, n in ((7, 1), (7, 1000), (jbfe.PRIMITIVE_ROOTS[1 << 10], 1 << 10),
                    (P - 1, 5)):
        np.testing.assert_array_equal(tgfn.powers(base, n),
                                      jgfn.powers(base, n))


def test_carrier_round_trips():
    rng = np.random.default_rng(2)
    v = rng.integers(0, 1 << 64, size=(3, 7), dtype=np.uint64,
                     endpoint=False)
    t = gf.from_jax_limbs(jgf.to_limbs(v))
    assert t.dtype == torch.int64 and t.shape == (3, 7)
    np.testing.assert_array_equal(gf.to_u64(t), v)
    np.testing.assert_array_equal(gf.to_u64(gf.from_u64(v)), v)
    lo, hi = gf.to_jax_limbs(t)
    jlo, jhi = jgf.to_limbs(v)
    np.testing.assert_array_equal(lo, np.asarray(jlo))
    np.testing.assert_array_equal(hi, np.asarray(jhi))


@pytest.mark.parametrize("name", ["add", "sub", "mul"])
def test_binary_ops_match_jax(name):
    a, b = _operands(3)
    want = _jax(getattr(jgf, name), a, b)
    got = _port(getattr(gf, name), a, b)
    np.testing.assert_array_equal(got, want)
    python = {"add": lambda x, y: (x + y) % P, "sub": lambda x, y: (x - y) % P,
              "mul": lambda x, y: x * y % P}[name]
    assert got.tolist() == [python(int(x), int(y)) for x, y in zip(a, b)]


@pytest.mark.parametrize("name", ["neg", "square", "canon", "to_montgomery"])
def test_unary_ops_match_jax(name):
    a, _ = _operands(4)
    np.testing.assert_array_equal(_port(getattr(gf, name), a),
                                  _jax(getattr(jgf, name), a))


def test_mul_accepts_any_u64():
    a, b = _operands(5, ABOVE_P)
    got = _port(gf.mul, a, b)
    assert got.tolist() == [int(x) * int(y) % P for x, y in zip(a, b)]


def test_canon_of_any_u64():
    v = np.array(EDGES + ABOVE_P, dtype=np.uint64)
    got = _port(gf.canon, v)
    np.testing.assert_array_equal(got, _jax(jgf.canon, v))
    assert got.tolist() == [int(x) % P for x in v]


def test_from_montgomery_accepts_any_u64():
    v = np.array(EDGES + ABOVE_P, dtype=np.uint64)
    got = _port(gf.from_montgomery, v)
    np.testing.assert_array_equal(got, _jax(jgf.from_montgomery, v))
    assert got.tolist() == [int(x) * jgf.R_INV % P for x in v]


@pytest.mark.parametrize("k", [0, 1, 7, P - 1, jgf.R, 1 << 40])
def test_mul_const_matches_jax(k):
    a, _ = _operands(6)
    np.testing.assert_array_equal(
        _port(lambda x: gf.mul_const(x, k), a),
        _jax(lambda x: jgf.mul_const(x, k), a))


@pytest.mark.parametrize("e", [0, 1, 2, 7, 64, P - 2])
def test_pow_const_matches_jax(e):
    a, _ = _operands(7)
    np.testing.assert_array_equal(
        _port(lambda x: gf.pow_const(x, e), a),
        _jax(lambda x: jgf.pow_const(x, e), a))


def test_reduce128_matches_jax():
    rng = np.random.default_rng(8)
    words = rng.integers(0, 1 << 32, size=(4, 300), dtype=np.uint64)
    words[:, :4] = 0xFFFF_FFFF  # the all-ones 128-bit value and neighbours
    words[3, 4:8] = 0
    x0, x1, x2, x3 = (w.astype(np.uint32) for w in words)
    want = jgf.from_limbs(jgf.reduce128(x0, x1, x2, x3))
    lo = gf.from_u64(words[0] | (words[1] << np.uint64(32)))
    hi = gf.from_u64(words[2] | (words[3] << np.uint64(32)))
    got = gf.to_u64(gf.reduce128(lo, hi))
    np.testing.assert_array_equal(got, want)
    full = [int(a) | int(b) << 32 | int(c) << 64 | int(d) << 96
            for a, b, c, d in words.T]
    assert got.tolist() == [v % P for v in full]


def test_fixed_mul_golden():
    got = gf.mul(gf.from_u64([2779336007265862836]),
                 gf.from_u64([8146517303801474933]))
    assert gf.to_u64(got).tolist() == [1857758653037316764]


def test_port_never_imports_jax():
    """Importing every module of the port leaves jax out of sys.modules of
    a fresh interpreter, and no source line of the port imports jax."""
    mods = ["twenty_first_tpu_torch", "twenty_first_tpu_torch.entry",
            "twenty_first_tpu_torch.parallel.pipeline",
            "twenty_first_tpu_torch.ops.tip5_commit",
            "twenty_first_tpu_torch.ops.ntt_cuda",
            "twenty_first_tpu_torch.ops.tip5_cuda",
            "twenty_first_tpu_torch._build", "chip_smoke"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' "
              "or m.startswith(('jax.', 'jaxlib', 'twenty_first_tpu.')) "
              "or m == 'twenty_first_tpu')\n"
            + "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for src in (REPO / "twenty_first_tpu_torch").rglob("*.py"):
        for line in src.read_text().splitlines():
            words = line.split()
            assert not (words[:2] == ["import", "jax"]
                        or words[:1] == ["from"] and words[1:2]
                        and words[1].split(".")[0] in ("jax",
                                                       "twenty_first_tpu")
                        ), f"{src}: {line}"
