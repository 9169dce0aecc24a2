"""The check must fail what it exists to catch. Each test skips the
harness's look for a card and drives the rest of a run on the CPU at a
small size (the port's plain twins), with the timed path broken
underneath, and sees ``correct`` come out false: the control (the plain
reference in the program's place, its MDS in float32), a step that
returns its state unchanged, half of the batch left out, and an answer
altered where it is produced. One card runs these cells, so no exchange
between chips exists to leave out."""

import json
import time
from pathlib import Path

import pytest
import torch

import harness
from control import Control, readings
from reference import goldilocks as gl
from small import small_cell

SPEC = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json")
                  .read_text())
MIX = {"log_rows": 5, "pool": 2}
CELLS = [w["name"] for w in SPEC["workloads"]]


def small_run(workload, seed=2**32 + 3):
    cell = small_cell(SPEC, workload, **MIX)
    return harness.run_cell(cell, seed, 0.2, False, time.perf_counter(),
                            device="cpu")


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 1, 2**40 + 3])
def test_control_fails_the_check(workload, seed):
    cell = small_cell(SPEC, workload, **MIX)
    program = cell.operation.Operation(cell.config, cell.mix, "cpu")
    control = Control(cell, "cpu", torch.float32, program.shape)
    lower = readings(cell, program, seed, "cpu")
    upper = readings(cell, control, seed, "cpu")
    assert lower["root_mismatches"]["value"] == 0
    assert upper["root_mismatches"]["value"] == MIX["pool"]
    if "node_mismatches" in upper:
        assert lower["node_mismatches"]["value"] == 0
        assert upper["node_mismatches"]["value"] > 0


def _unchanged(monkeypatch, workload):
    """Every call after the first gives the first call's answer back."""
    if workload.startswith("lde"):
        from twenty_first_tpu_torch.parallel import pipeline
        cls, name = pipeline.TraceLdeCommit, "forward"
    else:
        from twenty_first_tpu_torch.util_types import merkle_tree
        cls, name = merkle_tree.MerkleTree, "new"
    real, first = getattr(cls, name), []

    def stale(*args, **kwargs):
        if not first:
            first.append(real(*args, **kwargs))
        return first[0]
    monkeypatch.setattr(cls, name, stale)


def _half_batch(monkeypatch, workload):
    """The second half of the rows never hashed: their digests stay 0."""
    if workload.startswith("lde"):
        from twenty_first_tpu_torch.parallel import pipeline as module
        name = "hash_rows"
    else:
        from twenty_first_tpu_torch.tip5 import permutation as module
        name = "hash_varlen_padded"
    real = getattr(module, name)

    def half(x, **kwargs):
        out = real(x, **kwargs).clone()
        out[out.shape[0] // 2:] = 0
        return out
    monkeypatch.setattr(module, name, half)


def _altered(monkeypatch, workload):
    """One bit of the root flipped where it is produced."""
    if workload.startswith("lde"):
        from twenty_first_tpu_torch.parallel import pipeline
        real = pipeline.TraceLdeCommit.forward

        def flipped(self, trace, plain=False):
            return real(self, trace, plain) ^ 1
        monkeypatch.setattr(pipeline.TraceLdeCommit, "forward", flipped)
    else:
        from twenty_first_tpu_torch.util_types import merkle_tree
        real = merkle_tree.MerkleTree.new.__func__

        def flipped(cls, leafs, device="cuda", plain=False):
            tree = real(cls, leafs, device, plain)
            tree._nodes[1, 0] ^= 1
            return tree
        monkeypatch.setattr(merkle_tree.MerkleTree, "new", classmethod(flipped))


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    assert small_run(workload)["correct"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
def test_a_fault_fails_the_run(monkeypatch, workload, fault):
    fault(monkeypatch, workload)
    res = small_run(workload)
    assert res["failed"] == 0 and not res["correct"]
    assert res["checks"]["root_mismatches"]["value"] > 0


def test_canonical_inputs_reach_the_whole_field():
    x = gl.random_elements((1 << 16,), torch.Generator().manual_seed(9), "cpu")
    u = gl.to_u64(x)
    assert u.max() > (1 << 63) and u.min() < (1 << 48)
