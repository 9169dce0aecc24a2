"""The harness on the CPU: discovery by name from BENCHMARK.json, the
contract's names and units, the frozen counts against hand arithmetic,
the traced window's completeness check and its readers, and a small run
of the whole path on the port's plain twins."""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import devtrace
import generator
import harness
import roofline
from small import small_cell

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["port_bench"]
    assert SPEC["command"] == ["python3", "port_bench/run.py"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_names_and_units(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for entry in SPEC[section]:
        assert set(entry) - {"workloads"} == KEYS[section], entry["name"]
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in entry:
                assert 1 <= len(entry[text]) <= 200
                assert "\n" not in entry[text] and "\t" not in entry[text]
        for key in entry.get("reduced", []):
            assert NAME.match(key)
        if section in ("workloads",):
            assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])


def test_bounds_and_sources():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_is_found_by_name(workload):
    cell = harness.Cell.load(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.config["reduced"] == next(
        c["reduced"] for c in SPEC["configs"] if c["name"] == cell.config["name"])
    assert callable(cell.operation.reference)
    assert callable(cell.loop.Loop) and isinstance(cell.loop.KEYS, frozenset)
    assert cell.workload["chips"] == 1
    e2e = {m["name"] for m in cell.metrics("end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    readers = cell.readers()
    assert readers, "every cell reports a per-layer metric"
    for name, reader in readers.items():
        assert callable(reader.read) and isinstance(reader.KERNELS, dict), name


def test_a_mix_takes_only_the_keys_its_loop_reads():
    mix = {"pool": 2, "loop": "closed", "in_flight": 8}
    with pytest.raises(ValueError, match="in_flight"):
        generator.check_mix(mix)
    generator.check_mix(mix, frozenset({"in_flight"}))
    with pytest.raises(ValueError, match="sizes"):
        generator.check_mix({**mix, "pool": 0}, frozenset({"in_flight"}))


def test_every_config_file_and_metric_reader_exists():
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("port_bench/")
    for m in SPEC["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in SPEC["workloads"]}


def _work(workload):
    cell = harness.Cell.load(workload)
    op = object.__new__(cell.operation.Operation)  # sizes only, no program
    if cell.config["operation"] == "lde_commit":
        op.w, op.n = cell.config["columns"], 1 << cell.config["log_rows"]
        op.expansion = cell.config["expansion"]
    else:
        op.columns, op.n = cell.config["columns"], 1 << cell.config["log_rows"]
    return op.work()


def test_frozen_counts_of_the_trace_commitment():
    work = _work("lde_commit.n21")
    nbytes, imads = roofline.ntt_work(work)
    # 10 x 2^21 and 10 x 2^23, read once, written once
    assert nbytes == 1_677_721_600 == 2 * 8 * 10 * (2**21 + 2**23)
    assert imads == 4 * (10 * (2**20 * 21 + 2**21) + 10 * 2**22 * 23)
    assert roofline.hash_work(work) == (2**23 * 256, 2**23 * 1250)
    assert roofline.tree_work(work) == (40 * (2**23 + 1), (2**23 - 1) * 1250)
    least, bound = roofline.least_seconds(*roofline.hash_work(work))
    assert bound == "bytes" and least == pytest.approx(2**31 / 3.35e12)
    assert roofline.least_seconds(*roofline.tree_work(work))[1] == "products"


def test_frozen_counts_of_the_table_commitment():
    work = _work("table_commit.r17_l16384")
    # 16,384 columns + padding: 1,639 absorbs
    assert work["hash_perms"] == 1639 * 2**17
    assert roofline.tree_work(work) == (40 * (2**17 + 2**17 - 1),
                                        (2**17 - 1) * 1250)
    assert roofline.ntt_work(work) == (0, 0)


def test_permutation_imad_count():
    assert roofline.IMAD_PER_PERM == 5 * 12 * 2 * (3 + 4) + 5 * 2 * 41 == 1250
    assert roofline.IMAD_PER_S == pytest.approx(132 * 64 * 1.98e9)


K1 = "void (anonymous namespace)::tip5_permute_kernel<0>(unsigned long const*)"
K2 = "void (anonymous namespace)::tip5_permute_kernel<2>(unsigned long const*)"
TAIL = "(anonymous namespace)::merkle_commit_kernel(unsigned long const*, int)"
K3 = "void (anonymous namespace)::ntt_local_pass_kernel<4, false, 0>(Pass)"
GLUE = "void at::native::vectorized_elementwise_kernel<2, FillFunctor<long>>()"
PATTERNS = {p: ref for name in ("k1.roofline", "k2.roofline", "k3.roofline")
            for p, ref in harness.load_module(
                BENCH / "metrics" / f"{name}.py").KERNELS.items()}
OWN = devtrace.own_kernel_names(ROOT / "twenty_first_tpu_torch" / "csrc")


def _records(names, step=10.0):
    return [devtrace.Record(n, i * step, i * step + step / 2)
            for i, n in enumerate(names)]


def test_own_kernels_are_read_from_the_program_sources():
    for name in ("tip5_permute_kernel", "merkle_commit_kernel",
                 "ntt_local_pass_kernel", "tip5_permute_mma_kernel",
                 "gf_pointwise_kernel"):
        assert name in OWN


def test_completeness_refuses_a_trace_short_of_the_counters():
    refs = sorted(set(PATTERNS.values()))
    deltas = dict.fromkeys(refs, 0)
    deltas["twenty_first_tpu_torch.ops.tip5_cuda:tip5_permute"] = 2
    deltas["twenty_first_tpu_torch.ops.tip5_cuda:merkle_level"] = 1
    full = _records([K1, K1, K2, GLUE])
    assert devtrace.check_complete(full, PATTERNS, deltas) == []
    short = devtrace.check_complete(_records([K1, K2, GLUE]), PATTERNS, deltas)
    assert short == [("twenty_first_tpu_torch.ops.tip5_cuda:tip5_permute", 2, 1)]


def test_unknown_kernels_of_the_program_are_named():
    mma = "void (anonymous namespace)::tip5_permute_mma_kernel(unsigned long*)"
    trace_mode = "void (anonymous namespace)::tip5_permute_kernel<1>(long)"
    found = devtrace.unknown_kernels(_records([K1, GLUE, mma, trace_mode, K3]),
                                     OWN, PATTERNS)
    assert found == sorted([mma, trace_mode])


class _FakeEvent:
    def __init__(self, enable_timing=True):
        pass

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1.0


def _fake_window(monkeypatch, devices, launches):
    """trace_window on the CPU: the profiler's records and the counters'
    launches handed in, one list a try."""
    import twenty_first_tpu_torch.ops.tip5_cuda as tip5_cuda

    tries = iter(devices)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(devtrace, "_device_and_host",
                        lambda prof: (next(tries), []))

    def run_ops(count):
        tip5_cuda.tip5_permute.launches += launches

    patterns = {p: r for p, r in PATTERNS.items() if "tip5_permute_kernel<0>" in p}
    return devtrace.trace_window(run_ops, 1, {}, patterns, OWN)


def test_trace_window_never_reads_a_short_trace(monkeypatch):
    with pytest.raises(devtrace.IncompleteTrace):
        _fake_window(monkeypatch, [_records([K1])] * 3, 2)


def test_trace_window_retries_until_complete(monkeypatch):
    window, parts = _fake_window(
        monkeypatch, [_records([K1]), _records([K1, K1, GLUE])], 2)
    assert window.ops == 1 and len(window.records) == 3
    assert [row[0] for row in parts["device_ops"]][:1] == [
        "tip5_permute_kernel<0>"]


def test_trace_window_fails_on_a_kernel_no_metric_claims(monkeypatch):
    mma = "void (anonymous namespace)::tip5_permute_mma_kernel(unsigned long*)"
    with pytest.raises(devtrace.UnknownKernel):
        _fake_window(monkeypatch, [_records([K1, mma])], 1)


def test_readers_on_a_window():
    records = _records([K1, K2, TAIL, K3, K3, GLUE, "Memcpy DtoH (Device -> Pageable)"])
    work = {"hash_perms": 2**22, "tree_leafs": 2**22, "tree_nodes_out": 1,
            "ntt": [[8, 2**20], [8, 2**22]], "ntt_scaled": 8 * 2**20}
    window = devtrace.Window(2, work, records, 100e-6, OWN)
    assert window.busy_s == pytest.approx(7 * 5e-6)
    read = {m["name"]: harness.load_module(
        BENCH / "metrics" / f"{m['name']}.py").read(window)
        for m in SPEC["per_layer"]}
    assert read["device.launches_per_op"] == 3.5
    assert read["glue.ms_per_op"] == pytest.approx(1e3 * 2 * 5e-6 / 2)
    assert read["device.idle_share"] == pytest.approx(100 * (1 - 35 / 100))
    least_k1 = 2 * 2**22 * 256 / 3.35e12
    assert read["k1.roofline"] == pytest.approx(100 * least_k1 / 5e-6)
    assert read["k3.roofline"] == pytest.approx(
        100 * 2 * 671_088_640 / 3.35e12 / 10e-6)


def test_gaps_are_named_by_the_host():
    device = [devtrace.Record("a", 0, 10), devtrace.Record("b", 20, 30),
              devtrace.Record("c", 31, 40)]
    host = [devtrace.Record(devtrace.OWN_SPAN, 0, 40),
            devtrace.Record("cudaMemcpyAsync", 12, 19)]
    parts = devtrace.breakdown(device, host)
    assert parts["idle_gaps"][0] == ["cudaMemcpyAsync", pytest.approx(10e-6)]
    assert parts["idle_gaps"][1][0] == f"python in {devtrace.OWN_SPAN}"


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_a_small_run_of_the_whole_path(workload):
    cell = small_cell(SPEC, workload, log_rows=5, pool=3)
    res = harness.run_cell(cell, 2**31 + 99, 0.3, False, time.perf_counter(),
                           device="cpu")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in cell.metrics("end_to_end")}
    assert res["checks"]["roots_compared"] >= 1


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "lde_commit.n21", "--seed", str(2**33), "--seconds",
                          "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode != 0 and out.stdout == ""


def test_run_refuses_an_unknown_workload():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "no.such.cell", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
