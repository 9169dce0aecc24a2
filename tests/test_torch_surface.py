"""Every module of the JAX package has its counterpart in the port, with
every public name the JAX module defines and every public member of each
class it defines, and every public function and method of both accepts
the JAX one's parameters.

A module "defines" the names it assigns, its functions and classes, and,
in a package ``__init__`` or the prelude (the re-export modules), the names
it imports from the package itself. ``NOT_PORTED`` (ROADMAP A.8) lists the
names left out by decision: none, since the port has the JAX package's
whole public surface. The JAX package's ``ops/*_pallas.py`` are not
compared: the port's counterparts of those kernels (``ops/tip5_cuda.py``,
``ops/tip5_batch.py``, ``ops/ntt_cuda.py``, ``ops/probe_cuda.py``) have
their own names. ``ops/tip5_mxu.py`` and ``ops/tip5_packed.py`` are
compared like every other module."""

import ast
import importlib
import inspect
import pkgutil
import types

import pytest

import twenty_first_tpu
from torch_threads import one_torch_thread  # noqa: F401

#: Parameters of a JAX function that its port does not accept, by (module,
#: function): {JAX name: the port's parameter in its place, or None}, and
#: why. Every other public function and method must accept every parameter
#: of the JAX one, in its position, and may add only parameters with
#: defaults (``plain``, ``device``, ``out``, ...).
SIGNATURE_EXCEPTIONS = {
    ("math.gf", "reduce128"): (
        {"x0": "lo", "x1": "lo", "x2": "hi", "x3": "hi"},
        "the carrier form: two u64 words (lo, hi) for JAX's four u32 words"),
    ("math.gf", "reduce128_lazy"): (
        {"x0": "lo", "x1": "lo", "x2": "hi", "x3": "hi"},
        "the carrier form: two u64 words (lo, hi) for JAX's four u32 words"),
    ("math.ntt", "ntt"): (
        {"elements": "x"}, "a carrier tensor or a list of field elements"),
    ("math.ntt", "intt"): (
        {"elements": "x"}, "a carrier tensor or a list of field elements"),
    ("math.poly_batch", "batch_coset_extrapolate"): (
        {"use_jit": None}, "no JIT in the port"),
    ("math.poly_batch", "batch_coset_extrapolate_xfe"): (
        {"use_jit": None}, "no JIT in the port"),
}

#: ROADMAP A.8: not ported, by decision; None is the whole module. Empty:
#: kept so that a name left out again must be listed here with its reason
NOT_PORTED: dict = {}
NOT_COMPARED = ("ops.tip5_pallas", "ops.ntt_pallas")
MODULES = sorted(
    m.name[len("twenty_first_tpu."):]
    for m in pkgutil.walk_packages(twenty_first_tpu.__path__,
                                   "twenty_first_tpu.")
    if m.name[len("twenty_first_tpu."):] not in NOT_COMPARED)


def _excepted(module: str) -> set | None:
    """The names left out of ``module`` (None: the whole module)."""
    if module not in NOT_PORTED:
        return set()
    return NOT_PORTED[module]


def _defined(mod) -> tuple[set, set]:
    """(public names, public class names) the module defines."""
    reexports = (mod.__file__.endswith("__init__.py")
                 or mod.__name__.endswith(".prelude"))
    names, classes = set(), set()
    for node in ast.parse(inspect.getsource(mod)).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                classes.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names |= {n.id for t in targets for n in ast.walk(t)
                      if isinstance(n, ast.Name)}
        elif (isinstance(node, ast.ImportFrom) and node.level > 0
              and reexports):
            names |= {a.asname or a.name for a in node.names}
    names = {n for n in names if not n.startswith("_")
             and not isinstance(getattr(mod, n, None), types.ModuleType)}
    return names, {c for c in classes if not c.startswith("_")}


def _public(cls) -> set:
    return {n for n in dir(cls) if not n.startswith("_")}


def test_the_exceptions_are_the_roadmaps():
    """Every listed exception is a real JAX module or name that the port
    lacks, so the list cannot hide a port that has caught up."""
    for module, names in NOT_PORTED.items():
        assert module in MODULES, module
        try:
            port = importlib.import_module(f"twenty_first_tpu_torch.{module}")
        except ModuleNotFoundError:
            assert names is None, module
            continue
        jmod = importlib.import_module(f"twenty_first_tpu.{module}")
        assert names is not None, module
        for name in names:
            assert hasattr(jmod, name) and not hasattr(port, name), \
                (module, name)


@pytest.mark.parametrize("module", MODULES)
def test_the_port_has_the_public_surface_of_the_jax_module(module):
    excepted = _excepted(module)
    if excepted is None:  # listed above: not in the port yet
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(f"twenty_first_tpu_torch.{module}")
        return
    jmod = importlib.import_module(f"twenty_first_tpu.{module}")
    port = importlib.import_module(f"twenty_first_tpu_torch.{module}")
    names, classes = _defined(jmod)
    missing = sorted(n for n in names - excepted if not hasattr(port, n))
    assert not missing, missing
    for name in sorted(classes - excepted):
        lacking = sorted(_public(getattr(jmod, name))
                         - _public(getattr(port, name)))
        assert not lacking, (name, lacking)


def _functions(jmod, port) -> list:
    """(name, JAX function, port function) for every public function and
    public class method the module defines in both packages."""
    names, classes = _defined(jmod)
    found = []
    for name in sorted(names):
        jf, pf = getattr(jmod, name, None), getattr(port, name, None)
        if inspect.isfunction(jf) and callable(pf):
            found.append((name, jf, pf))
        if name in classes and inspect.isclass(pf):
            for member in sorted(_public(jf)):
                a = inspect.getattr_static(jf, member, None)
                b = inspect.getattr_static(pf, member, None)
                a, b = (getattr(v, "__func__", v) for v in (a, b))
                if inspect.isfunction(a) and inspect.isfunction(b):
                    found.append((f"{name}.{member}", a, b))
    return found


def _positional(sig) -> list:
    return [k for k, p in sig.parameters.items()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def _signature_faults(jf, pf, renamed: dict) -> list:
    """What keeps a call written for the JAX function from working on the
    port: a parameter it lacks, one in another position, or a parameter of
    its own without a default; ``renamed`` maps JAX names to the port's."""
    js, ps = inspect.signature(jf), inspect.signature(pf)
    faults = []
    takes_kwargs = any(p.kind == p.VAR_KEYWORD
                       for p in ps.parameters.values())
    for k, p in js.parameters.items():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD) or k in renamed:
            continue
        if k not in ps.parameters and not takes_kwargs:
            faults.append(f"lacks {k}")
    jpos = [renamed.get(k, k) for k in _positional(js)]
    jpos = [k for k in dict.fromkeys(jpos) if k is not None]
    if _positional(ps)[:len(jpos)] != jpos:
        faults.append(f"positions {_positional(ps)} for JAX's {jpos}")
    own = set(ps.parameters) - set(js.parameters) - set(renamed.values())
    faults += [f"{k} has no default" for k in sorted(own)
               if ps.parameters[k].default is inspect.Parameter.empty
               and ps.parameters[k].kind not in (inspect.Parameter.VAR_POSITIONAL,
                                                 inspect.Parameter.VAR_KEYWORD)]
    return faults


@pytest.mark.parametrize("module", [m for m in MODULES
                                    if _excepted(m) is not None])
def test_the_port_accepts_the_jax_functions_parameters(module):
    """A call written for the JAX package's function works on the port's:
    every JAX parameter is accepted, by name and in its position, and the
    port's own parameters have defaults. ``SIGNATURE_EXCEPTIONS`` are the
    only differences."""
    jmod = importlib.import_module(f"twenty_first_tpu.{module}")
    port = importlib.import_module(f"twenty_first_tpu_torch.{module}")
    faults = {}
    for name, jf, pf in _functions(jmod, port):
        renamed = SIGNATURE_EXCEPTIONS.get((module, name), ({}, ""))[0]
        found = _signature_faults(jf, pf, renamed)
        if found:
            faults[name] = found
    assert not faults, faults


def test_the_signature_exceptions_are_real():
    """Each listed exception names a JAX parameter that the port's function
    really lacks, and the port parameter said to stand in its place."""
    for (module, name), (renamed, why) in SIGNATURE_EXCEPTIONS.items():
        assert why
        jf = getattr(importlib.import_module(f"twenty_first_tpu.{module}"),
                     name)
        pf = getattr(importlib.import_module(
            f"twenty_first_tpu_torch.{module}"), name)
        js, ps = inspect.signature(jf), inspect.signature(pf)
        for jax_name, port_name in renamed.items():
            assert jax_name in js.parameters and \
                jax_name not in ps.parameters, (module, name, jax_name)
            assert port_name is None or port_name in ps.parameters, \
                (module, name, port_name)
