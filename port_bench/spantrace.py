"""The program's own spans and counters in the traced window.

The port opens one ``torch.profiler.record_function`` span, ``tft.<layer>``,
a call at each of its layer boundaries (``twenty_first_tpu_torch/spans.py``:
``tft.trace_commit``, ``tft.lde``, ``tft.ntt``, ``tft.leaf_hash``,
``tft.pad``, ``tft.sponge``, ``tft.tree``), and counts a loop's iterations
on the function that runs it (``hash_varlen_padded.absorbs``), as its
kernel wrappers count their ``.launches``.

devtrace hands the readers the device records alone. Importing this module
wraps ``devtrace.trace_window`` so that the window it returns carries, from
the same profile and the same operations:

- ``window.spans``: the window's ``tft.*`` host spans (``Span``: name,
  start, end, and the span it opened inside, ``parent``);
- ``record.span`` on each device record: the innermost span open when the
  host made the runtime call (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
  ``cudaMemsetAsync``, ...) that enqueued it, matched by the profiler's
  correlation id; not by the record's own time, as the device runs behind
  the host;
- ``window.counts``: each counter that a reader's ``COUNTERS`` names
  (``watch``), its growth over the traced operations.

The wrapper keeps the device-side mirrors of ``tft.*`` spans out of the
records, as devtrace keeps ``bench.op``'s, and names an idle gap whose
innermost host event is a ``tft.*`` span ``python in tft.<span>``, as
devtrace names ``bench.op``'s; all else it returns as devtrace gave it. A
program that opens no spans gives a window with none, and every reader of
them returns None.
"""

from __future__ import annotations

import bisect
import importlib
import re
from dataclasses import dataclass

import devtrace

PREFIX = "tft."
ABSORBS = "twenty_first_tpu_torch.tip5.permutation:hash_varlen_padded.absorbs"
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")  # cudaLaunchKernel, cuLaunchKernel, ...
_WATCHED: set = set()


@dataclass(eq=False)
class Span:
    name: str
    start_us: float
    end_us: float
    parent: "Span | None" = None

    def within(self, name: str) -> bool:
        """Whether this span or one it opened inside is ``name``."""
        span = self
        while span is not None:
            if span.name == name:
                return True
            span = span.parent
        return False


def watch(refs) -> None:
    """Count these counters ('module:function.attribute') over the traced
    window, into ``window.counts``."""
    _WATCHED.update(refs)


def read_counter(ref: str):
    """The counter's value, or None where the program has none."""
    module, path = ref.split(":")
    try:
        value = importlib.import_module(module)
    except ImportError:
        return None
    for attr in path.split("."):
        value = getattr(value, attr, None)
    return value if isinstance(value, int) else None


def nest(spans: list) -> list:
    """The spans in the order they opened, each with its ``parent``: the
    innermost span that holds it (the port's spans nest on one thread)."""
    ordered = sorted(spans, key=lambda s: (s.start_us, -s.end_us))
    stack = []
    for s in ordered:
        while stack and stack[-1].end_us < s.end_us:
            stack.pop()
        s.parent = stack[-1] if stack else None
        stack.append(s)
    return ordered


def innermost(spans: list, points: list) -> list:
    """For each point in increasing order, the innermost span open there,
    or None: one sweep over the nested spans, as devtrace's ``_innermost``."""
    found, stack, i = [], [], 0
    for p in points:
        while i < len(spans) and spans[i].start_us <= p:
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].end_us < p:
            stack.pop()
        found.append(stack[-1] if stack else None)
    return found


def attribute(records: list, spans: list, launched: dict) -> None:
    """Set ``record.span`` on each record: the innermost of the nested
    ``spans`` open at ``launched[record]``, the host's time of the runtime
    call that enqueued it (None where that call is unknown)."""
    timed = sorted(((launched[id(r)], r) for r in records
                    if launched.get(id(r)) is not None), key=lambda tr: tr[0])
    for r in records:
        r.span = None
    for (_, r), span in zip(timed, innermost(spans, [t for t, _ in timed])):
        r.span = span


def read_profile(prof, records: list) -> list:
    """The profile's ``tft.*`` host spans, nested; sets ``record.span`` on
    each of ``records``, the profile's device records as devtrace read
    them."""
    from torch.autograd import DeviceType

    spans, runtime, device = [], {}, {}
    for e in prof.events():
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CPU:
            if e.name.startswith(PREFIX):
                spans.append(Span(e.name, start, end))
            elif e.id and _RUNTIME.match(e.name):
                runtime[e.id] = start
        elif e.device_type == DeviceType.CUDA and e.id:
            device[(e.name, start, end)] = e.id
    spans = nest(spans)
    launched = {id(r): runtime.get(device.get((r.name, r.start_us, r.end_us)))
                for r in records}
    attribute(records, spans, launched)
    return spans


def _rename_gaps(parts: dict) -> dict:
    parts["idle_gaps"] = [[f"python in {name}" if name.startswith(PREFIX)
                           else name, seconds]
                          for name, seconds in parts["idle_gaps"]]
    return parts


def _install() -> None:
    if getattr(devtrace.trace_window, "reads_spans", False):
        return
    plain = devtrace.trace_window

    def trace_window(run_ops, ops, work, patterns, own):
        seen = {}
        refs = sorted(_WATCHED)

        def counted(count):
            before = {ref: read_counter(ref) for ref in refs}
            run_ops(count)
            seen["counts"] = {ref: read_counter(ref) - before[ref]
                              for ref in refs if before[ref] is not None}

        read = devtrace._device_and_host

        def observed(prof):
            device, host = read(prof)
            device = [r for r in device if not r.name.startswith(PREFIX)]
            seen["last"] = (device, read_profile(prof, device),
                            seen.get("counts", {}))
            return device, host

        devtrace._device_and_host = observed
        try:
            window, parts = plain(counted, ops, work, patterns, own)
        finally:
            devtrace._device_and_host = read
        device, spans, counts = seen.get("last", (None, [], {}))
        window.spans = spans if device is window.records else []
        window.counts = counts
        return window, _rename_gaps(parts)

    trace_window.reads_spans = True
    devtrace.trace_window = trace_window


_install()


# -- what the readers read ----------------------------------------------------


def spans_of(window) -> list:
    return getattr(window, "spans", None) or []


def under(record, name: str) -> bool:
    span = getattr(record, "span", None)
    return span is not None and span.within(name)


def glue_ms_per_op(window, name: str):
    """The device time of the glue (records of no csrc/ kernel) launched
    while span ``name`` or one inside it was open, an operation; None where
    the window has no such span."""
    if not any(s.name == name for s in spans_of(window)):
        return None
    glue = sum(r.seconds for r in window.records
               if not window.is_own(r.name) and under(r, name))
    return 1e3 * glue / window.ops


def dispatch_ms_per_op(window):
    """The host's time inside the program, an operation: the summed
    durations of the outermost spans."""
    spans = spans_of(window)
    if not spans:
        return None
    return 1e-3 * sum(s.end_us - s.start_us for s in spans
                      if s.parent is None) / window.ops


def idle_in_program_ms_per_op(window):
    """The device's idle time an operation in the gaps between its records
    (as devtrace's breakdown finds them) whose middle falls inside an
    outermost span: idle the program's own host code caused."""
    spans = spans_of(window)
    if not spans:
        return None
    outer = [s for s in spans if s.parent is None]  # in the order they opened
    starts = [s.start_us for s in outer]
    idle_us = 0.0
    ordered = sorted(window.records, key=lambda r: r.start_us)
    reach = ordered[0].end_us if ordered else 0.0
    for r in ordered[1:]:
        if r.start_us > reach:
            middle = 0.5 * (reach + r.start_us)
            k = bisect.bisect_right(starts, middle) - 1
            if k >= 0 and outer[k].end_us >= middle:
                idle_us += r.start_us - reach
        reach = max(reach, r.end_us)
    return 1e-3 * idle_us / window.ops


def launches_per_absorb(window):
    """Device records launched under ``tft.sponge`` over the chunks the
    sponge absorbed in the window."""
    absorbs = getattr(window, "counts", {}).get(ABSORBS)
    if not absorbs or not any(s.name == "tft.sponge" for s in spans_of(window)):
        return None
    return sum(1 for r in window.records if under(r, "tft.sponge")) / absorbs
