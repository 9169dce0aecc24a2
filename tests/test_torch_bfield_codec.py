"""The port's BFieldCodec (``math/bfield_codec.py``) and ``Tip5.hash`` /
``hash_batch`` against the JAX package's, exactly.

Each case of ``tests/test_bfield_codec.py`` (a ``case_*`` function of a
package's namespace) runs through both packages and returns plain data:
encodings as lists of ints, decoded values and errors by type name. The two results must be
equal, and each package must pass the JAX test's own assertions. Random
values come from numpy seeds."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import twenty_first_tpu.math.bfield_codec as jcodec
import twenty_first_tpu.math.b_field_element as jb
import twenty_first_tpu.math.polynomial as jpoly
import twenty_first_tpu.math.x_field_element as jx
import twenty_first_tpu.tip5 as jtip5
import twenty_first_tpu_torch.math.bfield_codec as tcodec
import twenty_first_tpu_torch.math.b_field_element as tb
import twenty_first_tpu_torch.math.polynomial as tpoly
import twenty_first_tpu_torch.math.x_field_element as tx
import twenty_first_tpu_torch.tip5 as ttip5
from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu_torch import native
from twenty_first_tpu_torch.tip5 import tip5 as ttip5_mod

P = tb.P


def _ns(codec, b, x, poly, tip5):
    return SimpleNamespace(
        codec=codec, bfe=b.bfe, BFieldElement=b.BFieldElement, xfe=x.xfe,
        XFieldElement=x.XFieldElement, Polynomial=poly.Polynomial,
        Digest=tip5.Digest, Tip5=tip5.Tip5, Error=codec.BFieldCodecError)


JAX = _ns(jcodec, jb, jx, jpoly, jtip5)
PORT = _ns(tcodec, tb, tx, tpoly, ttip5)


def plain(obj, ns):
    """Scalar objects as ints and tuples, containers recursively."""
    if isinstance(obj, ns.BFieldElement):
        return obj.value()
    if isinstance(obj, ns.XFieldElement):
        return ("xfe",) + tuple(c.value() for c in obj.coefficients)
    if isinstance(obj, ns.Digest):
        return ("digest",) + tuple(v.value() for v in obj.values())
    if isinstance(obj, ns.Polynomial):
        return ("poly", plain(obj.coefficients, ns))
    if isinstance(obj, (list, tuple)):
        return [plain(v, ns) for v in obj]
    return obj


def raises(ns, fn) -> str:
    with pytest.raises(ns.Error) as err:
        fn()
    return type(err.value).__name__


def roundtrip(ns, desc, value):
    enc = desc.encode(value)
    dec = desc.decode(enc)
    assert dec == value, (value, enc, dec)
    return enc


def _words(seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int(v) for v in rng.integers(0, P, n, dtype=np.uint64)]


def case_primitives(ns):
    c, bfe = ns.codec, ns.bfe
    out = [roundtrip(ns, c.BFE, bfe(42)), roundtrip(ns, c.BOOL, True),
           roundtrip(ns, c.U8, 200), roundtrip(ns, c.U32, 1 << 31),
           roundtrip(ns, c.U64, (5 << 32) | 7),
           roundtrip(ns, c.U128, (1 << 100) + 99),
           roundtrip(ns, c.I64, -123456789), roundtrip(ns, c.I32, -1),
           roundtrip(ns, c.I8, -128), roundtrip(ns, c.I16, 32767),
           roundtrip(ns, c.I128, -(1 << 100)), roundtrip(ns, c.U16, 65535)]
    assert out[0] == [bfe(42)] and out[1] == [bfe(1)]
    assert out[4] == [bfe(7), bfe(5)] and len(out[5]) == 4
    assert c.I64.encode(-1) == c.U64.encode((1 << 64) - 1)
    return out


def case_range_checks(ns):
    c, bfe = ns.codec, ns.bfe
    return [raises(ns, lambda: c.U8.decode([bfe(256)])),
            raises(ns, lambda: c.BOOL.decode([bfe(2)])),
            raises(ns, lambda: c.U64.decode([bfe(1 << 33), bfe(0)])),
            raises(ns, lambda: c.U8.encode(256)),
            raises(ns, lambda: c.I8.encode(128)),
            raises(ns, lambda: c.U64.encode(-1))]


def case_exact_consumption(ns):
    c, bfe = ns.codec, ns.bfe
    return [raises(ns, lambda: c.BFE.decode([bfe(1), bfe(2)])),
            raises(ns, lambda: c.BFE.decode([])),
            raises(ns, lambda: c.Vec_(c.BFE).decode([bfe(2), bfe(1)])),
            raises(ns, lambda: c.XFE.decode([bfe(1)] * 4)),
            raises(ns, lambda: c.DIGEST.decode([bfe(1)] * 4)),
            raises(ns, lambda: c.Arr(c.BFE, 2).decode([])),
            raises(ns, lambda: c.Vec_(c.BFE).decode([bfe(1 << 33)]))]


def case_xfe_digest(ns):
    c = ns.codec
    return [roundtrip(ns, c.XFE, ns.xfe((1, 2, 3))),
            roundtrip(ns, c.DIGEST, ns.Digest([9, 8, 7, 6, 5])),
            roundtrip(ns, c.DIGEST, ns.Digest(_words(1, 5)))]


def case_vec_and_array(ns):
    c, bfe = ns.codec, ns.bfe
    v = [bfe(w) for w in _words(5, 7)]
    enc = roundtrip(ns, c.Vec_(c.BFE), v)
    assert enc[0] == bfe(7) and len(enc) == 8
    vv = [[bfe(1)], [bfe(2), bfe(3)], []]
    enc2 = roundtrip(ns, c.Vec_(c.Vec_(c.BFE)), vv)
    assert enc2[0] == bfe(3)
    return [enc, roundtrip(ns, c.Arr(c.BFE, 7), v), enc2,
            roundtrip(ns, c.Vec_(c.U64), [1, 2, 1 << 63]),
            roundtrip(ns, c.Vec_(c.BFE), []),
            roundtrip(ns, c.Arr(c.Vec_(c.U32), 2), [[1, 2], [3]]),
            roundtrip(ns, c.Vec_(c.XFE), [ns.xfe((4, 5, 6)), ns.xfe(7)])]


def case_option(ns):
    c, bfe = ns.codec, ns.bfe
    enc = roundtrip(ns, c.Opt(c.U64), 77)
    assert enc[0] == bfe(1)
    return [roundtrip(ns, c.Opt(c.U64), None), enc,
            roundtrip(ns, c.Opt(c.Vec_(c.BFE)), [bfe(3)]),
            raises(ns, lambda: c.Opt(c.U64).decode([bfe(0), bfe(1)])),
            raises(ns, lambda: c.Opt(c.U64).decode([bfe(2)]))]


def case_tuple_reverse_order(ns):
    c, bfe = ns.codec, ns.bfe
    desc = c.Tup(c.U64, c.Vec_(c.BFE))
    enc = roundtrip(ns, desc, (5, [bfe(1), bfe(2)]))
    assert enc[:4] == [bfe(3), bfe(2), bfe(1), bfe(2)]
    assert enc[4:] == [bfe(5), bfe(0)]
    return [enc, desc.static_length(), c.Tup(c.U64, c.BFE).static_length(),
            raises(ns, lambda: desc.decode(enc + [bfe(0)])),
            raises(ns, lambda: desc.encode((1,)))]


def case_polynomial_codec(ns):
    c, bfe, Poly = ns.codec, ns.bfe, ns.Polynomial
    desc = c.PolyCodec(c.BFE)
    enc = roundtrip(ns, desc, Poly([bfe(3), bfe(0), bfe(5)]))
    bad = enc[:-1] + [bfe(0)]
    return [enc, raises(ns, lambda: desc.decode(bad)),
            roundtrip(ns, desc, Poly.zero()),
            roundtrip(ns, desc, Poly([bfe(w) for w in _words(7, 9)])),
            roundtrip(ns, c.PolyCodec(c.XFE),
                      Poly([ns.xfe((1, 2, 3)), ns.xfe(9)]))]


def case_struct_derive(ns):
    c, bfe = ns.codec, ns.bfe

    @c.bfield_codec(fields=[("count", c.U64), ("items", c.Vec_(c.DIGEST)),
                            ("flag", c.BOOL)])
    class Thing:
        def __init__(self, count, items, flag):
            self.count, self.items, self.flag = count, items, flag

        def __eq__(self, other):
            return (self.count, self.items, self.flag) == \
                (other.count, other.items, other.flag)

    t = Thing(3, [ns.Digest([1, 2, 3, 4, 5])], True)
    enc = t.encode()
    assert enc[:3] == [bfe(1), bfe(6), bfe(1)]
    assert Thing.decode(enc) == t and Thing.static_length() is None

    @c.bfield_codec(fields=[("a", c.BFE), ("b", c.U32)])
    class Static:
        def __init__(self, a, b):
            self.a, self.b = a, b

    return [enc, raises(ns, lambda: Thing.decode(enc + [bfe(0)])),
            Static.static_length(), Static(bfe(9), 4).encode(),
            c.encode(t)]


def case_enum_derive(ns):
    c, bfe = ns.codec, ns.bfe

    @c.bfield_codec(variants=[("A", []), ("B", [("x", c.U64)]),
                              ("C", [("v", c.Vec_(c.BFE))])])
    class E:
        def __init__(self, variant, **kw):
            self.variant = variant
            for k, v in kw.items():
                setattr(self, k, v)

        def __eq__(self, other):
            return self.variant == other.variant and \
                getattr(self, "x", None) == getattr(other, "x", None) and \
                getattr(self, "v", None) == getattr(other, "v", None)

    encs = []
    for e in [E("A"), E("B", x=1 << 40), E("C", v=[bfe(5), bfe(6)])]:
        encs.append(e.encode())
        assert E.decode(encs[-1]) == e
    assert E("B", x=1).encode()[0] == bfe(1)
    return [encs, raises(ns, lambda: E.decode([bfe(3)])),
            raises(ns, lambda: E.decode([])), E.static_length(),
            E("C", v=[]).bfield_codec_discriminant]


def case_generic_encode(ns):
    c, bfe = ns.codec, ns.bfe
    assert c.encode(bfe(3)) == [bfe(3)]
    assert c.encode(7) == [bfe(7), bfe(0)]
    return [c.encode(bfe(3)), c.encode([bfe(1), bfe(2)]), c.encode(7),
            c.encode(True), c.encode(ns.xfe((1, 2, 3))),
            c.encode(ns.Digest(_words(2, 5))),
            c.encode(ns.Polynomial([bfe(1), bfe(2)])),
            c.encode([[bfe(1)], [bfe(2), bfe(3)]]),
            c.decode(c.Vec_(c.U32), c.encode([bfe(1), bfe(2)])),
            raises(ns, lambda: c.encode(object())),
            raises(ns, lambda: c.encode([]))]


def case_decorator_rejects_bad_specs(ns):
    c = ns.codec
    specs = [dict(fields=[("a", int)]),
             dict(fields=[("a", c.BFE)], ignore=["b", "b"]),
             dict(fields=[("a", c.BFE), ("a", c.U64)]),
             dict(fields=[("a", c.BFE)], ignore=["a"]),
             dict(variants=[("A", []), ("A", [])]),
             dict(variants=[("A", [("x", int)])])]
    out = []
    for spec in specs:
        def decorate(spec=spec):
            @c.bfield_codec(**spec)
            class Bad:
                b = 0
        out.append(raises(ns, decorate))

    @c.bfield_codec(fields=[("a", c.BFE)])
    class Good:
        def __init__(self, a):
            self.a = a

    return out + [Good.static_length()]


def case_hash_of_encodable(ns):
    bfe = ns.bfe
    v = [bfe(4), bfe(5)]
    assert ns.Tip5.hash(v) == ns.Tip5.hash_varlen(ns.codec.encode(v))
    return [ns.Tip5.hash(v), ns.Tip5.hash(ns.Digest(_words(3, 5))),
            ns.Tip5.hash(ns.Polynomial([bfe(w) for w in _words(4, 12)]))]


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_codec_case_matches_jax(case):
    assert plain(CASES[case](PORT), PORT) == plain(CASES[case](JAX), JAX)


@pytest.mark.parametrize("seed", range(4))
def test_random_values_encode_as_jax(seed):
    """Random values of every codec type: the same words from both
    packages, and each decodes back."""
    rng = np.random.default_rng(100 + seed)

    def sample(ns):
        c, bfe = ns.codec, ns.bfe
        w = [int(v) for v in rng.integers(0, P, 40, dtype=np.uint64)]
        k = int(rng.integers(0, 6))
        return [(c.BFE, bfe(w[0])), (c.XFE, ns.xfe(tuple(w[1:4]))),
                (c.DIGEST, ns.Digest(w[4:9])), (c.U64, w[9] >> 1),
                (c.I64, (w[10] >> 1) - (1 << 62)), (c.BOOL, bool(w[11] & 1)),
                (c.Vec_(c.BFE), [bfe(v) for v in w[12:12 + k]]),
                (c.Arr(c.U32, 3), [v & 0xFFFFFFFF for v in w[20:23]]),
                (c.Opt(c.XFE), None if k % 2 else ns.xfe(w[23])),
                (c.Tup(c.BFE, c.Vec_(c.U8)), (bfe(w[24]), [v & 0xFF for v
                                                           in w[25:25 + k]])),
                (c.PolyCodec(c.BFE), ns.Polynomial([bfe(v) for v
                                                    in w[30:30 + k]]))]

    state = rng.bit_generator.state
    results = {}
    for name, ns in (("port", PORT), ("jax", JAX)):
        rng.bit_generator.state = state
        results[name] = [plain(roundtrip(ns, d, v), ns) for d, v in sample(ns)]
    assert results["port"] == results["jax"]


def _objects(ns, count: int, seed: int) -> list:
    """``count`` objects of every codec type in turn, from a seed."""
    rng = np.random.default_rng(seed)
    c, bfe = ns.codec, ns.bfe
    out = []
    for i in range(count):
        w = [int(v) for v in rng.integers(0, P, 12, dtype=np.uint64)]
        k = int(rng.integers(0, 12))
        out.append([bfe(w[0]), ns.xfe(tuple(w[:3])), ns.Digest(w[:5]),
                    w[1], bool(w[2] & 1), [bfe(v) for v in w[:k]],
                    ns.Polynomial([bfe(v) for v in w[:k]]),
                    [ns.Digest(w[:5]), ns.Digest(w[5:10])]][i % 8])
    return out


def test_hash_and_hash_batch_match_jax():
    """Tip5.hash of objects of every codec type equals the JAX package's,
    and hash_batch on the CPU equals hash of each; hash_batch's default
    device, the card, raises on a machine without one."""
    port = _objects(PORT, 24, 7)
    want = [plain(JAX.Tip5.hash(v), JAX) for v in _objects(JAX, 24, 7)]
    assert [plain(PORT.Tip5.hash(v), PORT) for v in port] == want
    assert [plain(d, PORT) for d in
            PORT.Tip5.hash_batch(port, device="cpu")] == want
    assert PORT.Tip5.hash_batch([], device="cpu") == []
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            PORT.Tip5.hash_batch(port[:2])


def test_scalar_hashing_equals_the_python_rounds(monkeypatch):
    """The native dispatch of the scalar permutation and hash_varlen gives
    the pure-Python rounds' values (the oracle, reached with the core
    switched off)."""
    rng = np.random.default_rng(11)
    state = [int(v) for v in rng.integers(0, P, 16, dtype=np.uint64)]
    inputs = [[int(v) for v in rng.integers(0, P, n, dtype=np.uint64)]
              for n in (0, 1, 9, 10, 11, 31)]
    objs = _objects(PORT, 8, 3)
    fast = (ttip5_mod._permute_values(state),
            [ttip5.Tip5.hash_varlen(x) for x in inputs],
            [ttip5.Tip5.hash(v) for v in objs])
    assert fast[0] == ttip5_mod._permute_rounds(state)
    monkeypatch.setattr(native, "available", lambda: False)
    assert ttip5_mod._permute_values(state) == fast[0]
    assert [ttip5.Tip5.hash_varlen(x) for x in inputs] == fast[1]
    assert [ttip5.Tip5.hash(v) for v in objs] == fast[2]
