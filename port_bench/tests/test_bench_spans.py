"""The program's spans and counters in the traced window, on the CPU with
synthetic profiles and windows: each device record attributed to the
innermost span open at its launch by correlation id, the glue split by
span adding up to the whole, the spans' device-side mirrors kept out of
the records, gaps named by the span the host was in, the counters read
over the window, and every reader of spans None where the program opened
none."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

import devtrace
import harness
import spantrace

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
OWN = devtrace.own_kernel_names(ROOT / "twenty_first_tpu_torch" / "csrc")
K1 = "void (anonymous namespace)::tip5_permute_kernel<0>(unsigned long const*)"
K2 = "void (anonymous namespace)::tip5_permute_kernel<2>(unsigned long const*)"
K3 = "void (anonymous namespace)::ntt_local_pass_kernel<4, false, 0>(Pass)"
COPY = "void at::native::elementwise_kernel<128, 2>()"
FILL = "void at::native::vectorized_elementwise_kernel<2, FillFunctor<long>>()"
GLUE_READERS = ["glue.lde.ms_per_op", "glue.leaf_hash.ms_per_op",
                "glue.pad.ms_per_op", "glue.sponge.ms_per_op",
                "glue.tree.ms_per_op"]
SPAN_READERS = GLUE_READERS + ["host.dispatch_ms_per_op",
                               "device.idle_in_program_ms_per_op",
                               "sponge.launches_per_absorb"]


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py")


def _event(name, start, end, device, corr=0):
    return SimpleNamespace(name=name, device_type=device, id=corr,
                           time_range=SimpleNamespace(start=start, end=end))


class _Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _host(name, start, end, corr=0):
    return _event(name, start, end, DeviceType.CPU, corr)


def _device(name, start, end, corr):
    return _event(name, start, end, DeviceType.CUDA, corr)


def _records(prof):
    return [devtrace.Record(e.name, float(e.time_range.start),
                            float(e.time_range.end))
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def test_records_take_the_innermost_span_of_their_launch():
    prof = _Profile([
        _host("tft.trace_commit", 0, 100), _host("tft.lde", 10, 40),
        _host("tft.ntt", 12, 20), _host("cudaLaunchKernel", 15, 16, 7),
        _host("cudaMemsetAsync", 45, 46, 8),
        _host("aten::copy_", 50, 60, 9),  # an operator, not the runtime
        # the device runs behind the host: both after every span closed
        _device(K3, 200, 210, 7), _device("Memset (Device)", 300, 301, 8),
        _device(COPY, 310, 320, 9),  # its runtime call was not recorded
        _device(COPY, 330, 340, 0),
    ])
    records = _records(prof)
    spans = spantrace.read_profile(prof, records)
    assert [s.name for s in spans] == ["tft.trace_commit", "tft.lde",
                                       "tft.ntt"]
    assert records[0].span.name == "tft.ntt"
    assert records[0].span.parent.name == "tft.lde"
    assert records[0].span.within("tft.trace_commit")
    assert not records[0].span.within("tft.tree")
    assert records[1].span.name == "tft.trace_commit"
    assert records[2].span is None and records[3].span is None


def test_spans_nest_as_they_were_opened():
    spans = spantrace.nest([spantrace.Span("tft.tree", 50, 60),
                            spantrace.Span("tft.trace_commit", 0, 60),
                            spantrace.Span("tft.lde", 0, 30),
                            spantrace.Span("tft.ntt", 31, 40)])
    assert [(s.name, s.parent and s.parent.name) for s in spans] == [
        ("tft.trace_commit", None), ("tft.lde", "tft.trace_commit"),
        ("tft.ntt", "tft.trace_commit"), ("tft.tree", "tft.trace_commit")]


def _window(spans, rows, ops=2, span_s=1e-3):
    """A window of records (name, start, end, span name or None) under the
    nested spans (name, start, end)."""
    nested = spantrace.nest([spantrace.Span(*s) for s in spans])
    by_name = {s.name: s for s in nested}
    records = []
    for name, start, end, span in rows:
        r = devtrace.Record(name, start, end)
        r.span = by_name.get(span)
        records.append(r)
    window = devtrace.Window(ops, {}, records, span_s, OWN)
    window.spans, window.counts = nested, {}
    return window


SPANS = [("tft.trace_commit", 0, 100), ("tft.lde", 0, 30),
         ("tft.ntt", 5, 10), ("tft.leaf_hash", 30, 60), ("tft.tree", 60, 100),
         ("tft.pad", 100, 110), ("tft.sponge", 110, 200),
         ("tft.tree", 200, 210)]
ROWS = [(FILL, 0, 3, "tft.lde"), (K3, 6, 9, "tft.ntt"),
        (COPY, 11, 12, "tft.ntt"), (FILL, 31, 33, "tft.leaf_hash"),
        (COPY, 33, 36, "tft.leaf_hash"), (K1, 36, 50, "tft.leaf_hash"),
        (K2, 61, 70, "tft.tree"), (FILL, 100, 105, "tft.pad"),
        (COPY, 105, 109, "tft.pad"), (COPY, 111, 120, "tft.sponge"),
        (K1, 120, 150, "tft.sponge"), (FILL, 200, 201, "tft.tree"),
        (COPY, 201, 204, "tft.tree"), ("Memcpy DtoH (Device -> Pageable)",
                                       215, 216, None)]


def test_glue_by_span_and_the_remainder_add_up_to_the_glue():
    window = _window(SPANS, ROWS)
    parts = {name: reader(name).read(window) for name in GLUE_READERS}
    assert parts == pytest.approx({
        "glue.lde.ms_per_op": 1e-3 * (3 + 1) / 2,
        "glue.leaf_hash.ms_per_op": 1e-3 * (2 + 3) / 2,
        "glue.pad.ms_per_op": 1e-3 * (5 + 4) / 2,
        "glue.sponge.ms_per_op": 1e-3 * 9 / 2,
        "glue.tree.ms_per_op": 1e-3 * (1 + 3) / 2})
    remainder = 1e-3 * 1 / 2  # the root's copy, outside every span
    whole = reader("glue.ms_per_op").read(window)
    assert sum(parts.values()) + remainder == pytest.approx(whole)


def test_dispatch_sums_the_outermost_spans():
    window = _window(SPANS, ROWS)
    # trace_commit 100 us, pad 10, sponge 90, tree 10; two operations
    assert reader("host.dispatch_ms_per_op").read(window) == pytest.approx(
        1e-3 * 210 / 2)


def test_idle_in_the_program_is_the_gaps_inside_its_spans():
    window = _window([("tft.trace_commit", 0, 100), ("tft.lde", 0, 30),
                      ("tft.tree", 200, 300)],
                     [(FILL, 0, 10, "tft.lde"), (COPY, 20, 30, "tft.lde"),
                      (K1, 110, 120, "tft.trace_commit"),
                      (K2, 180, 190, "tft.trace_commit"),
                      (K2, 230, 240, "tft.tree"),
                      (COPY, 250, 260, None)])
    # gaps 10-20 (middle 15, in trace_commit), 30-110 (70, in it),
    # 120-180 (150, in no span), 190-230 (210, in tree), 240-250 (245)
    assert reader("device.idle_in_program_ms_per_op").read(
        window) == pytest.approx(1e-3 * (10 + 80 + 40 + 10) / 2)


def test_launches_per_absorb_reads_the_counter():
    window = _window(SPANS, ROWS)
    assert reader("sponge.launches_per_absorb").read(window) is None
    window.counts = {spantrace.ABSORBS: 4}
    assert reader("sponge.launches_per_absorb").read(window) == 2 / 4


@pytest.mark.parametrize("name", SPAN_READERS)
def test_readers_of_spans_are_none_where_the_program_opened_none(name):
    window = devtrace.Window(2, {}, [devtrace.Record(K1, 0, 5),
                                     devtrace.Record(COPY, 6, 9)], 1e-4, OWN)
    assert reader(name).read(window) is None  # devtrace's own window
    window.spans, window.counts = [], {spantrace.ABSORBS: 3}
    assert reader(name).read(window) is None  # the wrapper's, no spans


def test_every_span_reader_is_in_the_benchmark():
    declared = {m["name"]: m for m in SPEC["per_layer"]}
    for name in SPAN_READERS:
        assert declared[name]["source"] in ("program_span", "program_counter")
        assert declared[name]["moves"] == "op_ms"
        assert "tft." in declared[name]["layer"]


class _FakeEvent:
    def __init__(self, enable_timing=True):
        pass

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1.0


def _traced(monkeypatch, device, host, spans=(), absorbs=0):
    """The wrapped trace_window on the CPU: devtrace's reading of the
    profile handed in, and the spans read from it patched in."""
    import twenty_first_tpu_torch.ops.tip5_cuda as tip5_cuda
    import twenty_first_tpu_torch.tip5.permutation as perm

    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(devtrace, "_device_and_host",
                        lambda prof: (list(device), list(host)))

    def read_profile(prof, records):
        nested = spantrace.nest([spantrace.Span(*s) for s in spans])
        spantrace.attribute(records, nested, {})
        return nested
    monkeypatch.setattr(spantrace, "read_profile", read_profile)
    spantrace.watch([spantrace.ABSORBS])

    def run_ops(count):
        tip5_cuda.tip5_permute.launches += 1
        perm.hash_varlen_padded.absorbs += absorbs

    patterns = {r"\btip5_permute_kernel<0>":
                "twenty_first_tpu_torch.ops.tip5_cuda:tip5_permute"}
    return devtrace.trace_window(run_ops, 1, {}, patterns, OWN)


def test_span_mirrors_on_the_device_are_not_records(monkeypatch):
    plain = [devtrace.Record(K1, 10, 20), devtrace.Record(COPY, 21, 30)]
    mirror = devtrace.Record("tft.sponge", 5, 31)
    window, _ = _traced(monkeypatch, plain + [mirror], [],
                        spans=[("tft.sponge", 0, 40)], absorbs=3)
    assert [r.name for r in window.records] == [K1, COPY]
    assert reader("device.launches_per_op").read(window) == 2
    assert window.busy_s == pytest.approx(19e-6)
    assert window.counts[spantrace.ABSORBS] == 3
    assert [s.name for s in window.spans] == ["tft.sponge"]


def test_a_gap_inside_a_span_is_named_by_it(monkeypatch):
    device = [devtrace.Record(K1, 0, 10), devtrace.Record(COPY, 20, 30),
              devtrace.Record(COPY, 40, 50)]
    host = [devtrace.Record(devtrace.OWN_SPAN, 0, 60),
            devtrace.Record("tft.sponge", 1, 32)]
    _, parts = _traced(monkeypatch, device, host)
    assert [row[0] for row in parts["idle_gaps"]] == [
        "python in tft.sponge", f"python in {devtrace.OWN_SPAN}"]
    assert parts["idle_gaps"][0][1] == pytest.approx(10e-6)


def test_the_wrapper_is_installed_once():
    assert devtrace.trace_window.reads_spans
    before = devtrace.trace_window
    spantrace._install()
    assert devtrace.trace_window is before
