"""The opening's spans and counters in a traced window on the card, at a
small size: K1's absorb mode (the verifier's sponge over the revealed
rows) recorded under ``tft.sponge``, K2 under ``tft.verify`` only, the
opening's gather under ``tft.open``, and the cell's three new metrics
above 0, with at most 3 device records a level of the partial tree.
Marked ``cuda``; skips without a card. Run on the machine with the card:

    python -m pytest port_bench/tests/test_bench_open_card.py -q -m cuda
"""

import json
import re
from pathlib import Path

import pytest
import torch

import devtrace
import generator
from small import small_cell

SPEC = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json")
                  .read_text())
CELL = "table_open.r17_l16384_q80"
NEW = ("open.ms_per_op", "verify.ms_per_op", "verify.launches_per_level")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
def test_the_opening_on_the_card_is_traced_by_layer(card):
    from twenty_first_tpu_torch import _build

    cell = small_cell(SPEC, CELL, log_rows=12, pool=2)
    readers = cell.readers()
    op = cell.operation.Operation(cell.config, cell.mix, card)
    pool = generator.make_pool(op.shape, cell.mix, 2**31 + 21, card)
    loop = cell.loop.Loop(op, pool, cell.mix)
    loop.run(cell.mix["pool"])  # the commitments: set-up
    torch.cuda.synchronize()
    patterns = {p: ref for r in readers.values() for p, ref in r.KERNELS.items()}
    window, _ = devtrace.trace_window(
        loop.run, 3, op.work(), patterns, devtrace.own_kernel_names(_build.CSRC))

    k1 = [r for r in window.records if re.search(r"tip5_permute_kernel<0>", r.name)]
    k2 = [r for r in window.records if re.search(r"tip5_permute_kernel<[23]>", r.name)]
    assert len(k1) == 3 and len(k2) == 3 * 2 * 12
    assert all(r.span is not None and r.span.name == "tft.sponge" for r in k1)
    assert all(r.span is not None and r.span.name == "tft.verify" for r in k2)
    assert any(r.span is not None and r.span.name == "tft.open"
               for r in window.records)
    assert not any(re.search(r"merkle_commit_kernel", r.name)
                   for r in window.records)

    read = {m["name"]: readers[m["name"]].read(window)
            for m in cell.metrics("per_layer")}
    for name in NEW:
        assert read[name] is not None and read[name] > 0, (name, read)
    assert read["verify.launches_per_level"] <= 3
    assert all(v is not None and v > 0 for v in read.values()), read
