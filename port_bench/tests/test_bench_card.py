"""The harness's whole path on the card at a small size: the port's
kernels, the traced window with its completeness check and every reader,
and the control failing the check. Marked ``cuda``; each test decides in
its fixture whether a card is there, and skips without one. Run on the
machine with the card:

    python -m pytest port_bench/tests/test_bench_card.py -q -m cuda
"""

import json
import time
from pathlib import Path

import pytest
import torch

import harness
from control import Control, readings
from small import small_cell

SPEC = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json")
                  .read_text())
MIX = {"log_rows": 12, "pool": 2}
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_traced_small_run_on_the_card(card, workload):
    cell = small_cell(SPEC, workload, **MIX)
    res = harness.run_cell(cell, 2**31 + 5, 0.5, True, time.perf_counter(),
                           device=card)
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {m["name"] for m in cell.metrics("per_layer")}
    for name, metric in res["metrics"].items():
        assert metric["value"] > 0, name
        if metric["unit"] == "%":
            assert metric["value"] <= 100, name
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"] * 1.05


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_card(card, workload):
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = small_cell(SPEC, workload, **MIX)
    program = cell.operation.Operation(cell.config, cell.mix, card)
    control = Control(cell, card, torch.float32, program.shape)
    assert readings(cell, program, 7, card)["root_mismatches"]["value"] == 0
    assert readings(cell, control, 7, card)["root_mismatches"]["value"] == 2
