"""The port's scalar field elements (``BFieldElement``, ``XFieldElement``)
and ``config`` against the JAX package's, exactly, on inputs made with
numpy: every case runs the same operation through both packages."""

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu import config as jconfig
from twenty_first_tpu import errors as jerrors
from twenty_first_tpu.math import b_field_element as jb
from twenty_first_tpu.math import x_field_element as jx
from twenty_first_tpu_torch import config as tconfig
from twenty_first_tpu_torch import errors as terrors
from twenty_first_tpu_torch.math import b_field_element as tb
from twenty_first_tpu_torch.math import x_field_element as tx

P = jb.P
EDGES = [0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1]


def _values(seed: int, count: int = 24) -> list[int]:
    rnd = np.random.default_rng(seed).integers(0, P, size=count,
                                               dtype=np.uint64)
    return EDGES + [int(v) for v in rnd]


def _norm(x):
    """A result of either package as plain python data."""
    if isinstance(x, (jb.BFieldElement, tb.BFieldElement)):
        return ("b", x.value())
    if isinstance(x, (jx.XFieldElement, tx.XFieldElement)):
        return ("x", tuple(c.value() for c in x.coefficients))
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _both(fn):
    """fn(module) on the JAX package's module and the port's."""
    return _norm(fn(jb, jx)), _norm(fn(tb, tx))


def test_copied_constants_equal_jax():
    for name in ("P", "MAX", "GENERATOR", "R", "R_INV"):
        assert getattr(tb, name) == getattr(jb, name), name
    assert tb.PRIMITIVE_ROOTS == jb.PRIMITIVE_ROOTS
    assert (tb.BFieldElement.MINUS_TWO_INVERSE_VALUE
            == jb.BFieldElement.MINUS_TWO_INVERSE_VALUE)
    assert tx.EXTENSION_DEGREE == jx.EXTENSION_DEGREE


def test_fixed_mul_golden():
    got = tb.bfe(2779336007265862836) * tb.bfe(8146517303801474933)
    assert got.value() == 1857758653037316764


BFE_BINARY = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "radd_int": lambda a, b: int(b.value()) + a,
    "rsub_int": lambda a, b: int(b.value()) - a,
    "eq": lambda a, b: a == b,
    "pow": lambda a, b: a ** (b.value() % 1000),
}


@pytest.mark.parametrize("op", sorted(BFE_BINARY))
def test_bfe_binary_ops_match_jax(op):
    a_vals, b_vals = _values(1), _values(2)

    def run(b_mod, x_mod):
        del x_mod
        return [BFE_BINARY[op](b_mod.bfe(a), b_mod.bfe(b))
                for a in a_vals for b in b_vals[:8]]

    want, got = _both(run)
    assert got == want


BFE_UNARY = {
    "neg": lambda a: -a,
    "square": lambda a: a.square(),
    "inverse_or_zero": lambda a: a.inverse_or_zero(),
    "increment": lambda a: a.increment(),
    "decrement": lambda a: a.decrement(),
    "raw_u64": lambda a: a.raw_u64(),
    "raw_u16s": lambda a: a.raw_u16s(),
    "raw_bytes": lambda a: a.raw_bytes(),
    "to_bytes": lambda a: a.to_bytes(),
    "str": str,
    "repr": repr,
    "is_zero_one": lambda a: (a.is_zero(), a.is_one()),
    "lift": lambda a: a.lift(),
    "mod_pow_negative": lambda a: (a.mod_pow(-3) if not a.is_zero()
                                   else a.mod_pow(3)),
    "hash_int_index": lambda a: (hash(a), int(a), [0, 1][a.value() & 1]),
}


@pytest.mark.parametrize("op", sorted(BFE_UNARY))
def test_bfe_unary_ops_match_jax(op):
    vals = _values(3)
    want, got = _both(lambda b_mod, x_mod: [BFE_UNARY[op](b_mod.bfe(v))
                                            for v in vals])
    assert got == want


def test_bfe_conversions_match_jax():
    vals = _values(4)

    def run(b_mod, x_mod):
        cls = b_mod.BFieldElement
        out = []
        for v in vals:
            e = cls(v)
            out += [cls.from_raw_u64(e.raw_u64()), cls.from_raw_bytes(e.raw_bytes()),
                    cls.from_raw_u16s(e.raw_u16s()), cls.from_str(str(e)),
                    cls.from_bytes(e.to_bytes()), cls.from_int(-v),
                    cls.new(v + P), b_mod.bfe(np.uint64(v)), e / cls(7)]
        out.append([cls.primitive_root_of_unity(n) for n in
                    sorted(b_mod.PRIMITIVE_ROOTS) + [3, 12]])
        out.append(b_mod.bfe_vec([-1, 0, 5]) + b_mod.bfe_array([P, 2 * P]))
        out.append([cls.generator(), cls.minus_two_inverse(), cls.zero(),
                    cls.one()])
        return out

    want, got = _both(run)
    assert got == want


def test_bfe_batch_ops_match_jax():
    vals = [v for v in _values(5) if v]

    def run(b_mod, x_mod):
        cls = b_mod.BFieldElement
        elems = [cls(v) for v in vals]
        return [cls.batch_inversion(elems), cls.batch_inversion([]),
                cls(P - 1).get_cyclic_group_elements(),
                cls(cls.primitive_root_of_unity(16).value())
                .get_cyclic_group_elements(),
                cls(7).get_cyclic_group_elements(12),
                cls.power_accumulator(elems[:6], elems[6:12], 5)]

    want, got = _both(run)
    assert got == want


@pytest.mark.parametrize("bad", ["not-a-number", str(P), str(-P), "1.5"])
def test_bfe_parse_errors_match_jax(bad):
    with pytest.raises(jerrors.ParseBFieldElementError):
        jb.BFieldElement.from_str(bad)
    with pytest.raises(terrors.ParseBFieldElementError):
        tb.BFieldElement.from_str(bad)


def test_bfe_raising_cases_match_jax():
    for mod, err in ((jb, jerrors), (tb, terrors)):
        with pytest.raises(err.ParseBFieldElementError):
            mod.BFieldElement.try_new(P)
        with pytest.raises(err.ParseBFieldElementError):
            mod.BFieldElement.from_bytes(P.to_bytes(8, "little"))
        with pytest.raises(ZeroDivisionError):
            mod.bfe(0).inverse()
        with pytest.raises(ZeroDivisionError):
            mod.BFieldElement.batch_inversion([mod.bfe(3), mod.bfe(0)])
        assert mod.bfe(5).__add__("x") is NotImplemented


def _xfes(b_mod, x_mod, seed):
    vals = _values(seed, 30)
    return [x_mod.xfe(tuple(vals[i:i + 3])) for i in range(0, len(vals) - 2, 3)]


XFE_BINARY = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b if not b.is_zero() else a,
    "eq": lambda a, b: a == b,
}


@pytest.mark.parametrize("op", sorted(XFE_BINARY))
def test_xfe_binary_ops_match_jax(op):
    def run(b_mod, x_mod):
        xs, ys = _xfes(b_mod, x_mod, 6), _xfes(b_mod, x_mod, 7)
        return [XFE_BINARY[op](a, b) for a in xs for b in ys]

    want, got = _both(run)
    assert got == want


XFE_UNARY = {
    "neg": lambda a: -a,
    "square": lambda a: a.square(),
    "inverse_or_zero": lambda a: a.inverse_or_zero(),
    "pow": lambda a: a ** 12345,
    "mod_pow_negative": lambda a: a.mod_pow(-2) if not a.is_zero() else a,
    "str": str,
    "repr": repr,
    "unlift": lambda a: a.unlift(),
    "unlift_const": lambda a: type(a).new_const(a.coefficients[0]).unlift(),
    "to_digest": lambda a: [v.value() for v in a.to_digest().values()],
    "digest_round_trip": lambda a: type(a).try_from_digest(a.to_digest()),
    "times_bfe": lambda a: (a * a.coefficients[1], a.coefficients[2] * a,
                            a + 3, 5 - a, a * 2),
    "is_zero_one": lambda a: (a.is_zero(), a.is_one(), hash(a) == hash(a)),
}


@pytest.mark.parametrize("op", sorted(XFE_UNARY))
def test_xfe_unary_ops_match_jax(op):
    def run(b_mod, x_mod):
        xs = _xfes(b_mod, x_mod, 8)
        xs += [x_mod.xfe(0), x_mod.xfe(1), x_mod.xfe(-1), x_mod.xfe((0, 1, 0))]
        return [XFE_UNARY[op](a) for a in xs]

    want, got = _both(run)
    assert got == want


def test_xfe_constructors_and_batches_match_jax():
    def run(b_mod, x_mod):
        cls = x_mod.XFieldElement
        xs = [x for x in _xfes(b_mod, x_mod, 9) if not x.is_zero()]
        inc = cls((1, 2, 3))
        inc.increment(1)
        dec = cls((0, 0, 0))
        dec.decrement(2)
        return [cls.batch_inversion(xs), x_mod.as_flat_list(xs),
                x_mod.as_flat_slice(xs[:2]), inc, dec, cls.zero(), cls.one(),
                cls.new([4, 5, 6]), cls.primitive_root_of_unity(1 << 16),
                cls.primitive_root_of_unity(3), x_mod.xfe_vec([1, (1, 2, 3)]),
                x_mod.xfe_array([-1]), b_mod.bfe(9).lift(),
                cls((2, 1, 0)).get_cyclic_group_elements(10)]

    want, got = _both(run)
    assert got == want


def test_xfe_raising_cases_match_jax():
    for b_mod, x_mod, err in ((jb, jx, jerrors), (tb, tx, terrors)):
        with pytest.raises(ValueError):
            x_mod.XFieldElement((1, 2))
        with pytest.raises(ZeroDivisionError):
            x_mod.xfe(0).inverse()
        digest = x_mod.xfe((1, 2, 3)).to_digest()
        padded = type(digest)(list(digest.values())[:4] + [b_mod.bfe(1)])
        with pytest.raises(err.TryFromXFieldElementError):
            x_mod.XFieldElement.try_from_digest(padded)


@pytest.fixture
def fresh_cutoff(monkeypatch):
    """Both packages' cutoff knobs unset, restored afterwards."""
    monkeypatch.delenv(jconfig._ENV_VAR, raising=False)
    monkeypatch.setattr(jconfig, "_cutoff", None)
    monkeypatch.setattr(tconfig, "_cutoff", None)
    return monkeypatch


@pytest.mark.parametrize("env,setting", [(None, None), (None, 1), (None, 64),
                                         ("7", None), ("1", 64),
                                         ("nonsense", 33)])
def test_config_matches_jax(fresh_cutoff, env, setting):
    assert tconfig._ENV_VAR == jconfig._ENV_VAR
    if env is not None:
        fresh_cutoff.setenv(jconfig._ENV_VAR, env)
    if setting is not None:
        jconfig.set_merkle_tree_parallelization_cutoff(setting)
        tconfig.set_merkle_tree_parallelization_cutoff(setting)
    assert (tconfig.merkle_tree_parallelization_cutoff()
            == jconfig.merkle_tree_parallelization_cutoff())
