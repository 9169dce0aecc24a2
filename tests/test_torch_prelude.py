"""The port's ``prelude``, package imports and ``math/other.py`` against
the JAX package's: the prelude has the JAX prelude's names, each the port's
own object; ``import twenty_first_tpu_torch`` exposes the subpackages the
JAX package's ``__init__`` imports, building nothing (no nvcc, no g++) and
importing no JAX; ``random_elements`` draws the JAX package's values from
the same generator."""

import subprocess
import sys
from pathlib import Path

import pytest

import numpy as np

import twenty_first_tpu.math.other as jother
import twenty_first_tpu.prelude as jprelude
import twenty_first_tpu_torch
import twenty_first_tpu_torch.math.other as tother
import twenty_first_tpu_torch.prelude as tprelude
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
SUBPACKAGES = ("errors", "math", "tip5", "util_types", "config", "prelude")


def _public(mod) -> set:
    return {n for n in vars(mod) if not n.startswith("_")
            and n != "annotations"}


def test_prelude_has_the_jax_names():
    assert _public(tprelude) == _public(jprelude)


@pytest.mark.parametrize("name", sorted(_public(jprelude)))
def test_prelude_name_is_the_ports_own(name):
    obj = getattr(tprelude, name)
    assert obj.__module__.startswith("twenty_first_tpu_torch.")
    assert obj.__name__ == getattr(jprelude, name).__name__


def test_the_package_exposes_its_subpackages():
    for name in SUBPACKAGES:
        assert getattr(twenty_first_tpu_torch, name).__name__ == \
            f"twenty_first_tpu_torch.{name}"
    assert twenty_first_tpu_torch.tip5.InverseTip5 is \
        twenty_first_tpu_torch.tip5.inverse.InverseTip5
    assert twenty_first_tpu_torch.math.polynomial.Polynomial is \
        tprelude.Polynomial


def test_import_builds_nothing():
    """In a fresh interpreter with no nvcc and no g++ on the path, importing
    the package and reaching every subpackage builds neither the kernels
    nor the native core, and imports no JAX."""
    code = (
        "import sys\n"
        "import twenty_first_tpu_torch as t\n"
        f"mods = [getattr(t, n) for n in {SUBPACKAGES!r}]\n"
        "t.prelude.Tip5, t.tip5.InverseTip5, t.math.ntt\n"
        "from twenty_first_tpu_torch import _build, native\n"
        "assert _build._lib is None and not native._TRIED\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'twenty_first_tpu.')) or m == 'twenty_first_tpu']\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={"PATH": "/nonexistent",
                               "PYTHONPATH": str(REPO)},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("kind", ["BFieldElement", "XFieldElement", "Digest"])
def test_random_elements_match_jax(kind):
    tkind = getattr(tprelude, kind)
    got = tother.random_elements(5, tkind, rng=np.random.default_rng(3))
    want = jother.random_elements(5, getattr(jprelude, kind),
                                  rng=np.random.default_rng(3))
    assert all(type(g) is tkind for g in got)
    assert [str(g) for g in got] == [str(w) for w in want]
    with pytest.raises(TypeError):
        tother.random_elements(1, int)
