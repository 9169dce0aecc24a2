"""Every port test module runs its torch work on one intra-op thread,
through the one fixture of ``torch_threads.py``."""

import ast
from pathlib import Path

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

HERE = Path(__file__).resolve().parent
PORT_TEST_MODULES = sorted(p.name for p in HERE.glob("test_torch_*.py"))


def _sets_threads(tree: ast.Module) -> bool:
    return any(isinstance(node, ast.Attribute)
               and node.attr == "set_num_threads" for node in ast.walk(tree))


def _imports_the_fixture(tree: ast.Module) -> bool:
    return any(isinstance(node, ast.ImportFrom)
               and node.module == "torch_threads"
               and [(a.name, a.asname) for a in node.names]
               == [("one_torch_thread", None)]
               for node in tree.body)


@pytest.mark.parametrize("name", PORT_TEST_MODULES)
def test_port_test_module_runs_one_torch_thread(name):
    """The module imports the shared fixture at its top level, under its
    own name (pytest then runs it for every test of the module), and sets
    torch's thread count nowhere else; this module's own torch work runs
    on one thread."""
    tree = ast.parse((HERE / name).read_text())
    assert _imports_the_fixture(tree), \
        f"{name} lacks 'from torch_threads import one_torch_thread'"
    assert not _sets_threads(tree), f"{name} sets torch's thread count itself"
    assert torch.get_num_threads() == 1
