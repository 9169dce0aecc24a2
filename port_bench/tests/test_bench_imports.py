"""The import rule: no file of the benchmark imports JAX, jaxlib, flax or
the JAX package, by top-level name compared whole (the port's name begins
with the JAX package's), and the reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "twenty_first_tpu"}
PORT = "twenty_first_tpu_torch"
SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_the_rule_compares_whole_names():
    assert PORT.startswith("twenty_first_tpu")
    assert PORT not in FORBIDDEN and "twenty_first_tpu" in FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "numpy", "torch"}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A small run of the harness's whole path (the port's plain twins on
    the CPU) in a fresh interpreter, then sys.modules by whole names."""
    code = f"""
import json, sys, time
sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}]
import harness
bench = json.loads(open({str(BENCH.parent / 'BENCHMARK.json')!r}).read())
cell = harness.Cell(bench, "lde_commit.n21")
cell = harness.Cell(bench, "lde_commit.n21", config=dict(cell.config, log_rows=5))
res = harness.run_cell(cell, 11, 0.2, False, time.perf_counter(), device="cpu")
assert res["correct"], res
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
