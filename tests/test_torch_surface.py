"""Every module of the JAX package has its counterpart in the port, with
every public name the JAX module defines and every public member of each
class it defines.

A module "defines" the names it assigns, its functions and classes, and,
in a package ``__init__`` or the prelude (the re-export modules), the names
it imports from the package itself. The only exceptions are listed below:
ROADMAP A.8, not ported by decision. The JAX package's ``ops/*_pallas.py``,
``ops/tip5_mxu.py`` and ``ops/tip5_packed.py`` are not compared: the port's
``ops/`` counterparts of its kernels have their own names."""

import ast
import importlib
import inspect
import pkgutil
import types

import pytest

import twenty_first_tpu

#: ROADMAP A.8: not ported, by decision (the same values by another route,
#: or answers to TPU limits); None is the whole module
NOT_PORTED = {
    "math.gf64": None,
    "math.gf": {"mul32", "mul_u32", "add64", "sub64", "mul64_wide",
                "mul_lazy_u32", "u32_ops"},
    "math.ntt": {"FOUR_STEP_THRESHOLD_LOG2", "THREE_STEP_THRESHOLD_LOG2",
                 "four_step_dif_general", "four_step_norev_general",
                 "four_step_ntt_scrambled", "four_step_ntt_traceable",
                 "four_step_ntt_w64", "three_step_ntt_traceable",
                 "ntt_limbs_traceable", "scrambled_index"},
    "parallel.pipeline": {"lde_commit_diags", "lde_scrambled_tables",
                          "trace_lde_commit_scrambled"},
}
NOT_COMPARED = ("ops.tip5_pallas", "ops.ntt_pallas", "ops.tip5_mxu",
                "ops.tip5_packed")
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
