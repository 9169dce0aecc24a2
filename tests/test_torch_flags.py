"""Every defaulted parameter of the JAX package's public functions and
methods, held at values other than its default against the port.

The list of (module, qualname, parameter) triples is derived from the JAX
package, walked as ``test_torch_surface.py`` walks it (the same
``NOT_COMPARED``), one triple for each function, so a re-export is the
triple of the module that defines it. Each triple is in one of three
tables:

* ``CASES``: non-default values, one parametrised case each. A case builds
  a small seeded input (lengths 0 and 1 among them where the JAX function
  takes them), calls the JAX function on the CPU as the JAX package's
  tests call it and the port's with ``device="cpu"``, and compares plain
  data: field words canonical, element by element. Where JAX raises, the
  port must raise an instance of JAX's class (of the port's class of that
  name, for the packages' own error classes).
* ``COVERED_BY``: the node id of a port test that already sets the
  parameter to a non-default value against JAX (where a second JAX
  compile here would cost tens of seconds).
* ``EXEMPT``: why no value comparison can hold the parameter.

``test_every_triple_is_held`` fails on a triple in none of them and on an
entry that names no triple. The port's own parameters (``plain``,
``device``, ``out``) are not swept: ``chip_smoke.py`` holds each kernel
against its twin on the card. Distributed cases run on a world of one
(gloo, this process), against JAX's mesh of one CPU device, with an
explicit ``a2a_chunks`` (JAX caches its environment default)."""

import ast
import importlib
import inspect
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_dist_launch import world_of_one  # noqa: F401 (the fixture)
from test_torch_surface import MODULES, NOT_COMPARED, _defined, _public
from torch_threads import one_torch_thread  # noqa: F401

P = (1 << 64) - (1 << 32) + 1
TESTS = Path(__file__).resolve().parent


def _triples() -> set:
    """(module, qualname, parameter) of every public JAX function and
    method with a defaulted parameter, by the module that defines it."""
    found = set()
    for module in MODULES:
        jmod = importlib.import_module(f"twenty_first_tpu.{module}")
        names, classes = _defined(jmod)
        for name in names:
            obj = getattr(jmod, name, None)
            funcs = [obj]
            if name in classes:
                funcs += [getattr(v, "__func__", v) for v in (
                    inspect.getattr_static(obj, m) for m in _public(obj))]
            for f in funcs:
                home = getattr(f, "__module__", None) or ""
                if not (inspect.isfunction(f)
                        and home.startswith("twenty_first_tpu.")):
                    continue  # not a function, or inherited from outside
                home = home[len("twenty_first_tpu."):]
                if home in NOT_COMPARED:
                    continue
                found |= {(home, f.__qualname__, k) for k, p
                          in inspect.signature(f).parameters.items()
                          if p.default is not p.empty}
    return found


def _function(package: str, module: str, qualname: str):
    obj = importlib.import_module(f"{package}.{module}")
    for part in qualname.split("."):
        obj = inspect.getattr_static(obj, part)
    return getattr(obj, "__func__", obj)


# ---------------------------------------------------------------------------
# The two packages, as the cases call them
# ---------------------------------------------------------------------------


def _namespace(package: str, **kw):
    return SimpleNamespace(
        port=package.endswith("_torch"),
        mod=lambda m: importlib.import_module(f"{package}.{m}"), **kw)


def _jax_ns():
    import jax.numpy as jnp

    from twenty_first_tpu.math import gf, gf_ext

    return _namespace(
        "twenty_first_tpu", cpu={}, base=lambda v: gf.to_limbs(_u64(v)),
        xfe=lambda v: gf_ext.to_limbs(_u64(v)),
        words=lambda v: jnp.asarray(_u64(v)),
        limbs=lambda v: gf.to_limbs(_u64(v)))


def _port_ns():
    from twenty_first_tpu_torch.math import gf, gf_ext

    return _namespace(
        "twenty_first_tpu_torch", cpu={"device": "cpu"},
        base=lambda v: gf.from_u64(_u64(v)),
        xfe=lambda v: gf_ext.from_u64(_u64(v)),
        words=lambda v: gf.from_u64(_u64(v)),
        limbs=lambda v: gf.to_limbs(_u64(v), device="cpu"))


def _u64(v) -> np.ndarray:
    return np.asarray(v, dtype=np.uint64)


def _words(seed: int, shape, full: bool = False) -> np.ndarray:
    """Random field words (any u64 words with ``full``), the edge words
    0, 1, p - 1 first."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, (1 << 64) - 1 if full else P - 1, size=shape,
                     dtype=np.uint64, endpoint=True)
    flat = v.reshape(-1)
    edges = [0, 1, P - 1]
    flat[:min(flat.size, 3)] = edges[:min(flat.size, 3)]
    return v


def _plain(x):
    """A result of either package as package-free data: field words
    canonical, with their shape; field objects as ints; containers
    recursively."""
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], Exception):
        return x  # an _outcome's error, compared by _same_errors
    if isinstance(x, tuple) and len(x) == 2 and all(
            str(getattr(v, "dtype", "")) in ("uint32", "torch.uint32")
            for v in x):  # u32 limb planes (lo, hi)
        lo, hi = (np.asarray(v).astype(np.uint64) if not isinstance(
            v, torch.Tensor) else v.numpy().astype(np.uint64) for v in x)
        return _plain(lo | (hi << np.uint64(32)))
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
        x = x.view(np.uint64) if x.dtype == np.int64 else x
    if type(x).__module__.startswith("jax"):
        x = np.asarray(x)
    if isinstance(x, np.ndarray):
        if x.dtype == np.uint64:
            return ("words", x.shape, [int(v) % P for v in x.reshape(-1)])
        return ("array", x.shape, str(x.dtype), x.tolist())
    kind = type(x).__name__
    if kind == "BFieldElement":
        return x.value()
    if kind == "XFieldElement":
        return ("xfe",) + tuple(c.value() for c in x.coefficients)
    if kind == "Digest":
        return ("digest",) + tuple(v.value() for v in x.values())
    if kind == "Polynomial":
        return ("poly", x.is_extension, _plain(x.to_array()))
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _outcome(fn):
    """("value", plain data) or ("raised", the exception)."""
    try:
        return "value", _plain(fn())
    except Exception as e:  # the class is what the case compares
        return "raised", e


def _without_errors(x):
    """A result with each ("raised", error) as ("raised",): the errors'
    classes are compared on their own (``_same_errors``)."""
    if isinstance(x, tuple) and len(x) == 2 and x[0] == "raised" \
            and isinstance(x[1], Exception):
        return ("raised",)
    if isinstance(x, (list, tuple)):
        return type(x)(map(_without_errors, x))
    return x


def _same_errors(got, want) -> None:
    """Every ("raised", error) of JAX's result has the port's error at its
    place, an instance of JAX's class."""
    if isinstance(want, tuple) and len(want) == 2 and want[0] == "raised" \
            and isinstance(want[1], Exception):
        assert isinstance(got[1], _port_class(type(want[1]))), (got, want)
    elif isinstance(want, (list, tuple)):
        for g, w in zip(got, want):
            _same_errors(g, w)


def _port_class(cls):
    """The port's counterpart of a JAX package's exception class; any
    other class is itself."""
    if not cls.__module__.startswith("twenty_first_tpu."):
        return cls
    module = importlib.import_module(cls.__module__.replace(
        "twenty_first_tpu", "twenty_first_tpu_torch", 1))
    return getattr(module, cls.__name__)


# ---------------------------------------------------------------------------
# The cases: run(k, value) computes a case through package k
# ---------------------------------------------------------------------------


def _cyclic(module: str, cls: str):
    def run(k, max_elements):
        C = getattr(k.mod(module), cls)
        lift = (lambda v: C((v, 0, 0))) if cls == "XFieldElement" else C
        gens = [lift(1), lift(P - 1), lift(pow(7, (P - 1) // 16, P)),
                C((2, 1, 0)) if cls == "XFieldElement" else C(7)]
        return [g.get_cyclic_group_elements(max_elements) for g in gens]
    return run


def _codec_class(c, spec: str):
    """A class derived through ``bfield_codec`` for one of the specs."""
    if spec == "fields":
        @c.bfield_codec(fields=[("a", c.BFE), ("v", c.Vec_(c.U32)),
                                ("x", c.XFE), ("d", c.DIGEST)])
        class Struct:
            def __init__(self, a, v, x, d):
                self.a, self.v, self.x, self.d = a, v, x, d
        return Struct
    if spec == "ignore":
        @c.bfield_codec(fields=[("a", c.U64), ("w", c.Vec_(c.BFE))],
                        ignore=["cache"])
        class Ignoring:
            cache = "default"

            def __init__(self, a, w):
                self.a, self.w, self.cache = a, w, "set"
        return Ignoring

    @c.bfield_codec(variants=[("A", []), ("B", [("x", c.U64)]),
                              ("C", [("v", c.Vec_(c.BFE)), ("b", c.BOOL)])])
    class Enum:
        def __init__(self, variant, **kw):
            self.variant = variant
            self.__dict__.update(kw)
    return Enum


def _codec(k, spec):
    c, b = k.mod("math.bfield_codec"), k.mod("math.b_field_element")
    x, d = k.mod("math.x_field_element"), k.mod("tip5")
    cls = _codec_class(c, spec)
    if spec == "fields":
        objs = [cls(b.bfe(5), [], x.xfe((1, 2, 3)), d.Digest([9] * 5)),
                cls(b.bfe(P - 1), [1, 1 << 31],
                    x.xfe(4), d.Digest([0, 1, 2, 3, 4]))]
    elif spec == "ignore":
        objs = [cls(1 << 63, []), cls(3, [b.bfe(1), b.bfe(2)])]
    else:
        objs = [cls("A"), cls("B", x=(1 << 64) - 1),
                cls("C", v=[b.bfe(1)], b=True), cls("C", v=[], b=False)]
    out = [cls.static_length()]
    for obj in objs:
        enc = obj.encode()
        out.append(enc)
        for seq in (enc, enc[:-1], enc + [b.bfe(0)]):
            out.append(_outcome(lambda: vars(cls.decode(seq))))
    return out


def _batch_inversion(module: str, xfe: bool):
    def run(k, axis):
        f = k.mod(module).batch_inversion
        shapes = [(3, 5), (1, 1)]
        out = []
        for i, shape in enumerate(shapes):
            v = _words(10 + i, shape + ((3,) if xfe else ()))
            if shape == (3, 5):
                v[1, 2] = 0  # a zero element: its row (or column) is 0
            conv = k.xfe(v) if xfe else k.base(v)
            out.append(_outcome(lambda: f(conv, axis=axis)))
        return out
    return run


POW2_SHIFTS = (1, 24, 31, 32, 48, 64, 72, 95)


def _pow2(module: str, param: str):
    def run(k, value):
        m = k.mod(module)
        conv = k.words if module == "math.gf64" else k.base
        out = []
        for n in (0, 1, 16):
            a = conv(_words(20 + n, (n,), full=True))
            if param == "negate":
                out += [m.mul_by_pow2_lazy(a, e, negate=value)
                        for e in POW2_SHIFTS]
                out.append(_outcome(lambda: m.mul_by_pow2_lazy(
                    a, 96, negate=value)))
            else:
                out.append(m.mul_by_i_lazy(a, inverse=value))
        return out
    return run


def _conv(name: str, param: str):
    """conv_values, conv_table_prepare or conv_table_values at lengths 1
    and 8, batched, on base and xfe operands and tables, and on operands
    of fewer axes than their field needs. An xfe operand has 3 components:
    JAX's host route reads the last axis unchecked (another count gives
    values or an IndexError by operation), the port refuses it."""
    def run(k, value):
        n = k.mod("math.ntt")
        out = []
        for log_n in (0, 3):
            a_b, b_b = (_words(30 + i + log_n, (2, 1 << log_n))
                        for i in (0, 1))
            a_x, b_x = (_words(32 + i + log_n, (2, 1 << log_n, 3))
                        for i in (0, 1))
            t_b = _words(34 + log_n, (1 << log_n,))
            t_x = _words(35 + log_n, (1 << log_n, 3))
            if name == "conv_values" and param == "xfield":
                for a, b in ((a_x, b_x), (a_b[0], b_b[0]), (a_x, b_b[0])):
                    out.append(_outcome(lambda: n.conv_values(
                        a, b, xfield=True, **k.cpu)))
            elif name == "conv_values":
                out.append(_outcome(lambda: n.conv_values(
                    a_b, b_b, divide=value, **k.cpu)))
                out.append(_outcome(lambda: n.conv_values(
                    a_x, b_x, xfield=True, divide=value, **k.cpu)))
            elif name == "conv_table_prepare":
                out.append(_outcome(lambda: n.conv_table_values(
                    a_x, n.conv_table_prepare(t_x, xfield=value, **k.cpu),
                    xfield=True, table_xfield=True)))
                out.append(_outcome(lambda: n.conv_table_prepare(
                    t_b, xfield=value, **k.cpu)))
            else:  # conv_table_values' xfield or table_xfield
                for tv, tx in ((t_b, False), (t_x, True)):
                    table = n.conv_table_prepare(tv, xfield=tx, **k.cpu)
                    ops = [(a_x, True), (a_b[0], True)]
                    if param == "table_xfield":
                        ops.append((a_b, False))
                    for a, ax in ops:
                        kw = {"xfield": ax, param: value}
                        out.append(_outcome(lambda: n.conv_table_values(
                            a, table, **kw)))
        return out
    return run


def _ntt(name: str):
    """The transforms' ``inverse`` at lengths 0, 1 and 8, and a length that
    is not a power of two."""
    def run(k, inverse):
        f = getattr(k.mod("math.ntt"), name)
        out = []
        for i, shape in enumerate([(0,), (1,), (2, 8), (6,)]):
            v = _words(40 + i, shape)
            if name == "ntt":
                b = k.mod("math.b_field_element").BFieldElement
                x = k.mod("math.x_field_element").XFieldElement
                out.append(_outcome(lambda: f([b(int(w)) for w in v.reshape(
                    -1)[:shape[-1]]], inverse)))
                out.append(_outcome(lambda: f([x(tuple(int(c) for c in row))
                                               for row in v.reshape(-1, 1)
                                               .repeat(3, 1)[:shape[-1]]],
                                              inverse)))
            elif name in ("ntt_limbs", "ntt_limbs_traceable"):
                out.append(_outcome(lambda: f(k.limbs(v), inverse)))
            elif name == "ntt_values":
                out.append(_outcome(lambda: f(v, inverse, **k.cpu)))
            else:
                out.append(_outcome(lambda: f(v, inverse)))
        return out
    return run


def _random_elements(param: str):
    def run(k, value):
        other = k.mod("math.other")
        kind = {"default": other.BFieldElement, "int": int,
                "XFieldElement": other.XFieldElement,
                "Digest": other.Digest}[value if param == "kind" else
                                        "default"]
        return [_outcome(lambda: other.random_elements(
            n, kind, np.random.default_rng(50 + n))) for n in (0, 1, 5)]
    return run


def _batch_ntt(k, inverse):
    pb = k.mod("math.poly_batch")
    return [_outcome(lambda: pb.batch_ntt(_words(60 + i, s), inverse,
                                          **k.cpu))
            for i, s in enumerate([(2, 0), (1, 1), (3, 8), (2, 6)])]


def _coset(name: str):
    def run(k, offset):
        pb = k.mod("math.poly_batch")
        out = []
        for i, (shape, order) in enumerate([((2, 3), 8), ((1, 1), 1),
                                            ((2, 0), 4), ((3, 16), 16)]):
            v = _words(70 + i, shape)
            if name == "batch_coset_evaluate":
                out.append(_outcome(lambda: pb.batch_coset_evaluate(
                    v, order, offset, **k.cpu)))
            else:
                out.append(_outcome(lambda: pb.batch_coset_interpolate(
                    v, offset, **k.cpu)))
        return out
    return run


def _extrapolate(k, point_chunk):
    pb = k.mod("math.poly_batch")
    cw, pts = _words(80, (2, 8)), _words(81, (5,))
    cw[1] = 0
    return [_outcome(lambda: pb.batch_coset_extrapolate(
        cw, 7, p, point_chunk, **k.cpu)) for p in (pts, pts[:1])]


def _from_array(k, extension):
    poly = k.mod("math.polynomial").Polynomial
    out = []
    for i, shape in enumerate([(0,), (1,), (4,), (0, 3), (1, 3), (4, 3)]):
        v = _words(90 + i, shape)
        if len(shape) == 1 and shape[0] == 4:
            v[-1] = 0  # a trailing zero: trimmed
        p = poly.from_array(v, extension)
        out += [p.is_extension, _plain(p.to_array()), p.degree(),
                _outcome(lambda: p.evaluate(k.mod("math.b_field_element")
                                            .bfe(3)))]
    return out


def _packed_eligible(k, tile):
    f = k.mod("ops.tip5_packed").packed_eligible
    return [f(n, tile) for n in range(0, 64 * tile + 3 * tile + 2)]


def _distributed(name: str, param: str):
    """At world 1: the transform of a 2^4 vector (its (n2, n1) matrix for
    ``distributed_ntt``), and of (2^4, 3) xfe values."""
    def run(k, value):
        dn = k.mod("parallel.dist_ntt")
        mesh = k.mesh()
        chunks = value if param == "a2a_chunks" else 4
        inverse = value if param == "inverse" else False
        v = _words(100, (16,))
        if name == "distributed_ntt_xfe_values":
            return dn.distributed_ntt_xfe_values(
                _words(101, (16, 3)), mesh, inverse)
        if name == "distributed_ntt_values":
            return dn.distributed_ntt_values(v, mesh, inverse, chunks)
        n1, n2 = dn._split_sizes(4)
        x = v.reshape(n2, n1)
        x = k.base(x) if k.port else k.limbs(x)
        return dn.distributed_ntt(x, mesh, inverse,
                                  value if param == "natural_output"
                                  else False, chunks)
    return run


def _make_mesh(k, n_devices):
    k.mesh()  # the port's world of one is made first
    mesh = k.mod("parallel.mesh").make_mesh(n_devices, **k.cpu)
    return dict(mesh.shape), mesh.size


def _scrambled_tables(param: str):
    def run(k, value):
        f = k.mod("parallel.pipeline").lde_scrambled_tables
        kw = dict(k.cpu, **{param: value})
        return [_outcome(lambda: f(n, **kw)) for n in (2, 8, 32)]
    return run


def _scrambled_commit(k, expansion):
    f = k.mod("parallel.pipeline").trace_lde_commit_scrambled
    trace = _words(110, (2, 4))
    if k.port:
        return f(k.base(trace), expansion)
    import jax

    return jax.jit(lambda lo, hi: f((lo, hi), expansion))(*k.limbs(trace))


#: (module, qualname, parameter): (non-default values, run(k, value))
CASES = {
    ("math.b_field_element", "BFieldElement.get_cyclic_group_elements",
     "max_elements"): ([0, 1, 3, 20, -1],
                       _cyclic("math.b_field_element", "BFieldElement")),
    ("math.x_field_element", "XFieldElement.get_cyclic_group_elements",
     "max_elements"): ([0, 1, 3, 20, -1],
                       _cyclic("math.x_field_element", "XFieldElement")),
    ("math.bfield_codec", "bfield_codec", "fields"):
        (["fields"], _codec),
    ("math.bfield_codec", "bfield_codec", "ignore"):
        (["ignore"], _codec),
    ("math.bfield_codec", "bfield_codec", "variants"):
        (["variants"], _codec),
    ("math.gf", "batch_inversion", "axis"):
        ([0, -2, 1], _batch_inversion("math.gf", False)),
    ("math.gf_ext", "batch_inversion", "axis"):
        ([0], _batch_inversion("math.gf_ext", True)),
    ("math.gf", "mul_by_pow2_lazy", "negate"):
        ([True], _pow2("math.gf", "negate")),
    ("math.gf", "mul_by_i_lazy", "inverse"):
        ([True], _pow2("math.gf", "inverse")),
    ("math.gf64", "mul_by_pow2_lazy", "negate"):
        ([True], _pow2("math.gf64", "negate")),
    ("math.gf64", "mul_by_i_lazy", "inverse"):
        ([True], _pow2("math.gf64", "inverse")),
    ("math.ntt", "conv_values", "xfield"):
        ([True], _conv("conv_values", "xfield")),
    ("math.ntt", "conv_values", "divide"):
        ([True], _conv("conv_values", "divide")),
    ("math.ntt", "conv_table_prepare", "xfield"):
        ([True], _conv("conv_table_prepare", "xfield")),
    ("math.ntt", "conv_table_values", "xfield"):
        ([True], _conv("conv_table_values", "xfield")),
    ("math.ntt", "conv_table_values", "table_xfield"):
        ([True], _conv("conv_table_values", "table_xfield")),
    ("math.ntt", "ntt", "inverse"): ([True], _ntt("ntt")),
    ("math.ntt", "ntt_host", "inverse"): ([True], _ntt("ntt_host")),
    ("math.ntt", "ntt_values", "inverse"): ([True], _ntt("ntt_values")),
    ("math.ntt", "ntt_limbs", "inverse"): ([True], _ntt("ntt_limbs")),
    ("math.ntt", "ntt_limbs_traceable", "inverse"):
        ([True], _ntt("ntt_limbs_traceable")),
    ("math.other", "random_elements", "kind"):
        (["XFieldElement", "Digest", "int"], _random_elements("kind")),
    ("math.other", "random_elements", "rng"):
        (["seeded"], _random_elements("rng")),
    ("math.poly_batch", "batch_ntt", "inverse"): ([True], _batch_ntt),
    ("math.poly_batch", "batch_coset_evaluate", "offset"):
        ([0, 1, 2, 3 ** 5, P - 1, P + 3], _coset("batch_coset_evaluate")),
    ("math.poly_batch", "batch_coset_interpolate", "offset"):
        ([0, 1, 2, 3 ** 5, P - 1, P + 3], _coset("batch_coset_interpolate")),
    ("math.poly_batch", "batch_coset_extrapolate", "point_chunk"):
        ([1, 3], _extrapolate),
    ("math.polynomial", "Polynomial.from_array", "extension"):
        ([True], _from_array),
    ("ops.tip5_packed", "packed_eligible", "tile"):
        ([1, 3, 8, 16], _packed_eligible),
    ("parallel.dist_ntt", "distributed_ntt", "inverse"):
        ([True], _distributed("distributed_ntt", "inverse")),
    ("parallel.dist_ntt", "distributed_ntt", "natural_output"):
        ([True], _distributed("distributed_ntt", "natural_output")),
    ("parallel.dist_ntt", "distributed_ntt", "a2a_chunks"):
        ([1, 2], _distributed("distributed_ntt", "a2a_chunks")),
    ("parallel.dist_ntt", "distributed_ntt_values", "inverse"):
        ([True], _distributed("distributed_ntt_values", "inverse")),
    ("parallel.dist_ntt", "distributed_ntt_values", "a2a_chunks"):
        ([1, 2], _distributed("distributed_ntt_values", "a2a_chunks")),
    ("parallel.dist_ntt", "distributed_ntt_xfe_values", "inverse"):
        ([True], _distributed("distributed_ntt_xfe_values", "inverse")),
    ("parallel.mesh", "make_mesh", "n_devices"): ([1, 9], _make_mesh),
    ("parallel.pipeline", "lde_scrambled_tables", "expansion"):
        ([1, 2, 8], _scrambled_tables("expansion")),
    ("parallel.pipeline", "lde_scrambled_tables", "offset"):
        ([1, 3, P - 1], _scrambled_tables("offset")),
    ("parallel.pipeline", "trace_lde_commit_scrambled", "expansion"):
        ([2], _scrambled_commit),
}

_SCRAMBLED = "tests/test_torch_scrambled.py::"
_GENERAL = _SCRAMBLED + "test_general_four_steps_equal_jax"
_PACKED = "tests/test_torch_tip5_packed.py::"
_REDUCE = _PACKED + "test_reduce_layers_packed_equals_jax"
_COMMIT = _PACKED + "test_commit_states_packed_equals_jax"
_ROOT = "tests/test_torch_pipeline.py::test_root_matches_host_oracle"
#: (module, qualname, parameter): a port test that sets it to a non-default
#: value against JAX
COVERED_BY = {
    ("math.ntt", "ntt_limbs_traceable", "four_step_diag"):
        _SCRAMBLED + "test_ntt_limbs_traceable_equals_ntt_host",
    ("math.ntt", "four_step_dif_general", "split"): _GENERAL,
    ("math.ntt", "four_step_dif_general", "post_diag"): _GENERAL,
    ("math.ntt", "four_step_dif_general", "post_const"): _GENERAL,
    ("math.ntt", "four_step_norev_general", "split"): _GENERAL,
    ("math.ntt", "four_step_norev_general", "post_const"): _GENERAL,
    ("math.poly_batch", "batch_coset_extrapolate_xfe", "point_chunk"):
        "tests/test_torch_poly_batch.py::"
        "test_extrapolate_xfe_codewords_with_a_zero_row_match_jax",
    ("math.polynomial", "Polynomial.fast_modular_coset_interpolate",
     "preprocessed"):
        "tests/test_torch_polynomial_interp.py::"
        "test_modular_coset_interpolation_matches_jax",
    ("native", "ntt_rows_inplace", "n_inv"):
        "tests/test_torch_native.py::test_every_wrapper_matches_jax",
    ("ops.tip5_packed", "reduce_layers_packed", "tile"): _REDUCE,
    ("ops.tip5_packed", "reduce_layers_packed", "interpret"): _REDUCE,
    ("ops.tip5_packed", "commit_states_packed", "tile"): _COMMIT,
    ("ops.tip5_packed", "commit_states_packed", "interpret"): _COMMIT,
    ("parallel.pipeline", "lde_commit_diags", "expansion"):
        _SCRAMBLED + "test_lde_commit_diags_equal_jax",
    ("parallel.pipeline", "trace_lde_commit", "expansion"): _ROOT,
    ("parallel.pipeline", "trace_lde_commit", "offset"): _ROOT,
    ("parallel.pipeline", "trace_lde_commit", "ntt_diags"):
        _SCRAMBLED + "test_trace_lde_commit_with_lde_commit_diags_"
        "keeps_the_root",
    ("parallel.pipeline", "trace_lde_commit_scrambled", "tables"):
        _SCRAMBLED + "test_scrambled_commit_equals_jax_and_the_natural_route",
    ("util_types.mmr.mmr_accumulator", "mmra_with_mps", "rng"):
        "tests/test_torch_mmr.py::test_mmra_with_mps_matches_jax",
}

_GROUP = ("process-group setup: the port joins torch.distributed from "
          "the launcher's store, JAX calls jax.distributed.initialize; "
          "no value to compare")
#: (module, qualname, parameter): why no value comparison holds it
EXEMPT = {
    ("math.poly_batch", "batch_coset_extrapolate", "use_jit"):
        "JAX's jit switch; the port has no JIT (SIGNATURE_EXCEPTIONS)",
    ("math.poly_batch", "batch_coset_extrapolate_xfe", "use_jit"):
        "JAX's jit switch; the port has no JIT (SIGNATURE_EXCEPTIONS)",
    ("parallel.mesh", "make_mesh", "devices"):
        "a list of JAX device objects; the port's mesh spans its "
        "torch.distributed ranks",
    ("parallel.mesh", "initialize_distributed", "coordinator_address"):
        _GROUP,
    ("parallel.mesh", "initialize_distributed", "num_processes"): _GROUP,
    ("parallel.mesh", "initialize_distributed", "process_id"): _GROUP,
    ("parallel.scaling", "scaling_report", "log_n"):
        "the report is host-clock times, which no two runs share",
    ("parallel.scaling", "scaling_report", "mesh_sizes"):
        "the report is host-clock times, which no two runs share",
}

SWEEP = [pytest.param(triple, value, id="{}.{}-{}={!r}".format(*triple, value))
         for triple, (values, _) in sorted(CASES.items())
         for value in values]


@pytest.mark.parametrize("triple,value", SWEEP)
def test_the_port_takes_the_flag_as_jax_does(triple, value, request):
    from twenty_first_tpu.parallel import mesh as jmesh

    run = CASES[triple][1]
    jax_side = _jax_ns()
    jax_side.mesh = lambda: jmesh.make_mesh(1)
    port_side = _port_ns()
    port_side.mesh = lambda: request.getfixturevalue("world_of_one")
    want = _outcome(lambda: run(jax_side, value))
    got = _outcome(lambda: run(port_side, value))
    assert _without_errors(got) == _without_errors(want), (got, want)
    _same_errors(got, want)


def test_every_triple_is_held():
    """Each triple of the JAX package is in exactly one table; no entry
    names a triple that is gone; the port's function takes each swept
    parameter."""
    from test_torch_surface import SIGNATURE_EXCEPTIONS

    triples = _triples()
    tables = {"CASES": set(CASES), "COVERED_BY": set(COVERED_BY),
              "EXEMPT": set(EXEMPT)}
    held = set().union(*tables.values())
    assert not triples - held, sorted(triples - held)
    assert not held - triples, sorted(held - triples)
    assert sum(map(len, tables.values())) == len(held), "a triple twice"
    no_jit = {(m, f, k) for (m, f), (renamed, _) in
              SIGNATURE_EXCEPTIONS.items()
              for k, v in renamed.items() if v is None}
    for module, qualname, param in sorted(triples):
        jf = _function("twenty_first_tpu", module, qualname)
        pf = _function("twenty_first_tpu_torch", module, qualname)
        assert param in inspect.signature(jf).parameters
        if (module, qualname, param) in no_jit:
            assert (module, qualname, param) in EXEMPT
            continue
        assert param in inspect.signature(pf).parameters, \
            (module, qualname, param)
    for why in EXEMPT.values():
        assert why


def test_the_covering_tests_exist_and_set_their_parameter():
    """Each COVERED_BY node id names a test function of that file whose
    source (its decorators too) names the JAX function and the
    parameter."""
    sources = {}
    for (_, qualname, param), node in COVERED_BY.items():
        path, name = node.split("::")
        if path not in sources:
            text = (TESTS.parent / path).read_text()
            sources[path] = {
                f.name: ast.get_source_segment(text, f) + "".join(
                    ast.get_source_segment(text, d) for d in f.decorator_list)
                for f in ast.parse(text).body
                if isinstance(f, ast.FunctionDef)}
        assert name in sources[path], node
        src = sources[path][name]
        assert qualname.split(".")[-1] in src and param in src, \
            (node, qualname, param)
