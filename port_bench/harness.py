"""One run of one cell: set-up, the closed loop, the traced window, the
check against the plain reference, and the result line.

Everything particular to a cell is found by name from BENCHMARK.json:
the configuration's file, the traffic mix ``traffic/<mix>.json`` and the
loop it names, ``loops/<loop>.py``, the configuration's operation
``operations/<operation>.py`` (its program entry and its reference), and
each per-layer metric's reader ``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import devtrace
import generator
from reference.tip5 import Tip5

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "twenty_first_tpu")
#: the traced window holds about this much work, between these many ops
TRACE_SECONDS, TRACE_MIN_OPS, TRACE_MAX_OPS = 0.1, 3, 32


class Refused(RuntimeError):
    """A run that must print no result."""


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A workload of BENCHMARK.json with its configuration, mix and loop;
    the tests hand in a configuration, or keys of the mix (sizes at a
    CPU's scale), of their own."""

    def __init__(self, bench: dict, name: str, config: dict | None = None,
                 mix: dict | None = None):
        self.bench = bench
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise Refused(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        entry = next(c for c in bench["configs"]
                     if c["name"] == self.workload["config"])
        self.config = config or json.loads((ROOT / entry["file"]).read_text())
        self.mix = json.loads(
            (HERE / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.mix.update(mix or {})
        self.loop = load_module(HERE / "loops" / f"{self.mix['loop']}.py")
        generator.check_mix(self.mix, self.loop.KEYS)
        self.operation = load_module(
            HERE / "operations" / f"{self.config['operation']}.py")

    @classmethod
    def load(cls, name: str) -> "Cell":
        return cls(json.loads((ROOT / "BENCHMARK.json").read_text()), name)

    def metrics(self, section: str) -> list:
        name = self.workload["name"]
        return [m for m in self.bench[section]
                if name in m.get("workloads", [name])]

    def readers(self) -> dict:
        return {m["name"]: load_module(HERE / "metrics" / f"{m['name']}.py")
                for m in self.metrics("per_layer")}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return out or "not read"


def check(cell: Cell, loop, device, mds_dtype=torch.float64) -> dict:
    """The numbers compared, each {"value", "limit"}: the operations whose
    root differs from the reference's for their input, and, where the
    operation keeps its tree, the nodes of the newest tree of each input
    that differ from the reference's node array. Every answer of the run is
    compared: the reference works out each input of the pool once, all in
    one call. Exact: each limit is 0."""
    tip5 = Tip5(device, mds_dtype=mds_dtype)
    root_bad = node_bad = compared = 0
    keys = sorted({k for k, _ in loop.roots})
    wanted = cell.operation.reference(cell.config, [loop.pool[k] for k in keys],
                                      tip5)
    for k, (want_root, want_nodes) in zip(keys, wanted):
        roots = [root for j, root in loop.roots if j == k]
        compared += len(roots)
        root_bad += sum(1 for root in roots
                        if not np.array_equal(root, want_root))
        if k in loop.nodes:
            got = np.asarray(loop.nodes[k])
            node_bad += int((got[1:] != want_nodes[1:]).any(axis=1).sum())
    out = {"root_mismatches": {"value": root_bad, "limit": 0},
           "roots_compared": compared}
    if cell.operation.Operation.keeps_nodes:
        out["node_mismatches"] = {"value": node_bad, "limit": 0}
    return out


def trace_ops(latencies: list) -> int:
    med = float(np.median(latencies)) if latencies else TRACE_SECONDS
    return int(min(TRACE_MAX_OPS, max(TRACE_MIN_OPS, round(TRACE_SECONDS / med))))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
             device="cuda") -> dict:
    """One run; returns the result line's object. ``device`` other than the
    card is for the tests' small runs of the same path, and never timed."""
    from twenty_first_tpu_torch import _build

    on_card = torch.device(device).type == "cuda"
    phases = [("imports", time.perf_counter())]
    if on_card:
        _build.load()  # builds into the checkout's own cache on a first run
        phases.append(("kernels", time.perf_counter()))
    op = cell.operation.Operation(cell.config, cell.mix, device)
    phases.append(("tables", time.perf_counter()))
    pool = generator.make_pool(op.shape, cell.mix, seed, device)
    sync(device)
    phases.append(("pool", time.perf_counter()))
    loop = cell.loop.Loop(op, pool, cell.mix)
    loop.run(cell.mix["pool"])
    sync(device)
    phases.append(("warm-up", time.perf_counter()))
    setup_s = phases[-1][1] - t0
    log(f"setup {setup_s:.3f} s (" + ", ".join(
        f"{name} {end - start:.3f}" for (name, end), (_, start)
        in zip(phases, [("", t0)] + phases[:-1])) + f"); window of {seconds} s")
    win = loop.window(seconds, log)
    lat = win["latencies"]
    log(f"{len(lat)} operations in {win['wall_s']:.3f} s")
    traced, readers = None, cell.readers()
    if trace:
        patterns = {p: ref for r in readers.values()
                    for p, ref in r.KERNELS.items()}
        own = devtrace.own_kernel_names(_build.CSRC)
        traced = devtrace.trace_window(loop.run, trace_ops(lat), op.work(),
                                       patterns, own)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    loop.host_answers()
    op.release()
    del op
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check(cell, loop, device)
    log(f"check against the reference took {time.perf_counter() - t_check:.3f} s")
    numbers = {k: v for k, v in checks.items() if isinstance(v, dict)}
    correct = (win["failed"] == 0 and bool(lat)
               and all(v["value"] <= v["limit"] for v in numbers.values()))
    if trace:
        window, parts = traced
        metrics = {}
        for m in cell.metrics("per_layer"):
            value = readers[m["name"]].read(window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    elif lat:
        e2e = {"setup_s": {"value": setup_s, "unit": "s"},
               "op_ms": {"value": 1e3 * win["wall_s"] / len(lat), "unit": "ms"},
               "op_p95_ms": {"value": 1e3 * float(np.percentile(lat, 95)),
                             "unit": "ms"}}
        metrics = {m["name"]: e2e[m["name"]] for m in cell.metrics("end_to_end")}
    else:
        metrics = {}
    result = {"correct": correct, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics,
              "device": device_info(device, peak)}
    if trace:
        result["device"].update(busy_s=traced[0].busy_s,
                                window_s=traced[0].span_s)
        result["breakdown"] = traced[1]
    result["power_limit"] = power_limit() if on_card else None
    result["checks"] = checks
    return result


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_info(device, peak: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}


def report(result: dict) -> None:
    """The numbers compared beside their limits as the last lines on
    standard error, then the result as the last line on standard output."""
    for name, v in result["checks"].items():
        if isinstance(v, dict):
            log(f"check {name} = {v['value']} (limit {v['limit']})")
        else:
            log(f"check {name} = {v}")
    print(json.dumps(result), flush=True)
