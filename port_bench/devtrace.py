"""The traced window: a few whole operations under torch.profiler, read
into device records, checked for completeness against the port's own
launch counters, and handed to the per-layer metrics' readers.

The harness records its own spans (``bench.op``, one an operation) around
its calls into the program; the program records none yet.
"""

from __future__ import annotations

import importlib
import re
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from functools import lru_cache
from pathlib import Path

TRIES = 3
OWN_SPAN = "bench.op"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")


class IncompleteTrace(RuntimeError):
    """No try recorded every launch the port's counters counted."""


class UnknownKernel(RuntimeError):
    """A kernel of the port's csrc/ that no per-layer metric claims."""


@dataclass
class Record:
    name: str
    start_us: float
    end_us: float

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) * 1e-6


@dataclass
class Window:
    """What the readers read: ``ops`` operations traced, ``work`` one
    operation's frozen work (the operation's ``work()``), the device
    ``records``, the span by CUDA events and the device's busy time."""
    ops: int
    work: dict
    records: list
    span_s: float
    own_kernels: tuple
    busy_s: float = field(init=False)

    def __post_init__(self):
        self.busy_s = union_seconds(self.records)

    def is_own(self, name: str) -> bool:
        return _matches(name, tuple(rf"\b{k}\b" for k in self.own_kernels))

    def device_seconds(self, kernels: dict) -> float:
        patterns = tuple(kernels)
        return sum(r.seconds for r in self.records
                   if _matches(r.name, patterns))


@lru_cache(maxsize=None)
def _matches(name: str, patterns: tuple) -> bool:
    """Whether any pattern is found in ``name``; a window holds tens of
    thousands of records and a few dozen names, so each name is searched
    once."""
    return any(re.search(p, name) for p in patterns)


def own_kernel_names(csrc: Path) -> tuple:
    """The names of the device kernels (``__global__``) in the port's csrc/."""
    names = set()
    for src in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(src.read_text()))
    return tuple(sorted(names))


def union_seconds(records) -> float:
    total, reach = 0.0, None
    for r in sorted(records, key=lambda r: r.start_us):
        if reach is None or r.start_us >= reach:
            total += r.end_us - r.start_us
            reach = r.end_us
        elif r.end_us > reach:
            total += r.end_us - reach
            reach = r.end_us
    return total * 1e-6


def counter(ref: str):
    """'module:wrapper' -> the wrapper, whose ``launches`` the port counts."""
    module, name = ref.split(":")
    return getattr(importlib.import_module(module), name)


def check_complete(records, patterns: dict, deltas: dict) -> list:
    """The counters whose launches the records fall short of (or exceed):
    [(counter, counted, recorded)]. ``patterns`` maps a kernel name pattern
    to its counter; ``deltas`` each counter's launches over the window."""
    seen = defaultdict(int)
    for r in records:
        for pattern, ref in patterns.items():
            if re.search(pattern, r.name):
                seen[ref] += 1
                break
    return [(ref, deltas[ref], seen[ref]) for ref in sorted(deltas)
            if seen[ref] != deltas[ref]]


def unknown_kernels(records, own: tuple, patterns: dict) -> list:
    own_patterns = tuple(rf"\b{k}\b" for k in own)
    return sorted(name for name in {r.name for r in records}
                  if _matches(name, own_patterns)
                  and not _matches(name, tuple(patterns)))


def _device_and_host(prof):
    """The profile's device records (kernels, copies, memsets; not the
    spans that ``record_function`` mirrors onto the device's timeline) and
    its host events."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        rec = Record(e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False)
                    or e.name == OWN_SPAN):
                device.append(rec)
        elif e.device_type == DeviceType.CPU:
            host.append(rec)
    return device, host


def breakdown(device, host) -> dict:
    """The device operations that took most time, and the idle gaps between
    device records summed by what the host was doing: the innermost host
    event that spans the gap's middle, or "python" where none does."""
    by_op = defaultdict(float)
    for r in device:
        by_op[_short(r.name)] += r.seconds
    gaps = []  # (middle, seconds)
    ordered = sorted(device, key=lambda r: r.start_us)
    reach = ordered[0].end_us if ordered else 0.0
    for r in ordered[1:]:
        if r.start_us > reach:
            gaps.append((0.5 * (reach + r.start_us),
                         (r.start_us - reach) * 1e-6))
        reach = max(reach, r.end_us)
    by_host = defaultdict(float)
    for (_, seconds), name in zip(gaps, _innermost(host, [m for m, _ in gaps])):
        if name is None:
            name = "python"
        elif name == OWN_SPAN:  # inside an operation, between the calls
            name = f"python in {OWN_SPAN}"
        by_host[_short(name)] += seconds

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def _innermost(host, points: list) -> list:
    """For each point in increasing order, the name of the host event that
    spans it and started last (the innermost of nested events), or None.
    One sweep: events are pushed as they start, and dropped from the top
    once they have ended."""
    events = sorted(host, key=lambda h: h.start_us)
    names, stack, i = [], [], 0
    for p in points:
        while i < len(events) and events[i].start_us <= p:
            stack.append(events[i])
            i += 1
        while stack and stack[-1].end_us < p:
            stack.pop()
        names.append(stack[-1].name if stack else None)
    return names


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    if name.startswith("Mem"):
        return name[:80]
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0][:80]


def trace_window(run_ops, ops: int, work: dict, patterns: dict, own: tuple):
    """Trace ``run_ops(ops)`` until a try records every launch the
    counters named in ``patterns`` counted: (Window, breakdown)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    refs = sorted(set(patterns.values()))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # CUPTI's first profile: set-up, unread
        run_ops(1)
        torch.cuda.synchronize()
    shortfalls = []
    for attempt in range(1, TRIES + 1):
        before = {ref: counter(ref).launches for ref in refs}
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            start.record()
            run_ops(ops)
            end.record()
            end.synchronize()
        deltas = {ref: counter(ref).launches - before[ref] for ref in refs}
        device, host = _device_and_host(prof)
        shortfalls = check_complete(device, patterns, deltas)
        if device and not shortfalls:
            unknown = unknown_kernels(device, own, patterns)
            if unknown:
                raise UnknownKernel(f"kernels of csrc/ that no per-layer "
                                    f"metric claims: {unknown}")
            window = Window(ops, work, device, start.elapsed_time(end) * 1e-3,
                            own)
            return window, breakdown(device, host)
        print(f"traced window {attempt} of {TRIES} incomplete: "
              f"{shortfalls or 'no device records'}", file=sys.stderr,
              flush=True)
    raise IncompleteTrace(f"{TRIES} traced windows fell short of the launch "
                          f"counters: {shortfalls or 'no device records'}")
