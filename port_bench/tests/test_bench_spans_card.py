"""The program's spans in a traced window on the card, at a small size:
every record of a csrc/ kernel attributed to the span of the layer that
launched it, the records outside every span only the root's read, and
every reader of spans reporting. Marked ``cuda``; skips without a card.
Run on the machine with the card:

    python -m pytest port_bench/tests/test_bench_spans_card.py -q -m cuda
"""

import json
import re
from pathlib import Path

import pytest
import torch

import devtrace
import generator
import spantrace
from small import small_cell

SPEC = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json")
                  .read_text())
MIX = {"log_rows": 12, "pool": 2}
#: kernel name pattern -> the span that launches it, by cell
LAUNCHED_IN = {
    "lde_commit.n21": {r"ntt_local_pass_kernel<": "tft.ntt",
                       r"tip5_permute_kernel<0>": "tft.leaf_hash",
                       r"tip5_permute_kernel<[23]>": "tft.tree",
                       r"merkle_commit_kernel": "tft.tree"},
    "table_commit.r17_l16384": {r"tip5_permute_kernel<0>": "tft.sponge",
                                r"tip5_permute_kernel<2>": "tft.tree"},
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(LAUNCHED_IN))
def test_every_kernel_of_the_program_has_its_span(card, workload):
    from twenty_first_tpu_torch import _build

    cell = small_cell(SPEC, workload, **MIX)
    readers = cell.readers()
    op = cell.operation.Operation(cell.config, cell.mix, card)
    pool = generator.make_pool(op.shape, cell.mix, 2**31 + 17, card)
    loop = cell.loop.Loop(op, pool, cell.mix)
    loop.run(cell.mix["pool"])
    torch.cuda.synchronize()
    patterns = {p: ref for r in readers.values() for p, ref in r.KERNELS.items()}
    window, parts = devtrace.trace_window(
        loop.run, 3, op.work(), patterns, devtrace.own_kernel_names(_build.CSRC))

    own = [r for r in window.records if window.is_own(r.name)]
    assert own
    for r in own:
        want = [s for p, s in LAUNCHED_IN[workload].items()
                if re.search(p, r.name)]
        assert want and r.span is not None and r.span.name == want[0], (
            r.name, r.span and r.span.name)
    outside = {r.name for r in window.records if r.span is None}
    assert all(name.startswith("Memcpy DtoH") for name in outside), outside
    assert not any(r.name.startswith(spantrace.PREFIX)
                   for r in window.records)
    assert {s.name for s in window.spans if s.parent is None} <= {
        "tft.trace_commit", "tft.pad", "tft.sponge", "tft.tree"}

    read = {m["name"]: readers[m["name"]].read(window)
            for m in cell.metrics("per_layer")}
    assert all(value is not None for value in read.values()), read
    glue = [v for k, v in read.items() if k.startswith("glue.")
            and k != "glue.ms_per_op"]
    assert sum(glue) <= read["glue.ms_per_op"] * (1 + 1e-9)
    assert 0 <= read["device.idle_in_program_ms_per_op"] <= (
        1e3 * (window.span_s - window.busy_s) / window.ops)
    if "sponge.launches_per_absorb" in read:
        assert window.counts[spantrace.ABSORBS] == 3 * (25 // 10 + 1)
