"""CUDA-event timing and the card's identity and rates, shared by the
probes and chip_smoke.py."""

from __future__ import annotations

import functools
import statistics
import subprocess
import time

import torch

#: the H100's device-memory rate (NVIDIA's data sheet, SXM part)
MEMORY_BYTES_PER_S = 3.35e12
#: IMAD lanes of one SM: 32-bit integer multiply(-add) results per clock on
#: compute capability 9.0 (CUDA C++ Programming Guide, throughput of the
#: arithmetic instructions); integer adds, compares and selects have lanes
#: of their own beside these
IMAD_LANES_PER_SM = 64
#: an SM's four schedulers each issue one warp instruction (32 lanes) per
#: clock, whatever its pipe: the ceiling of all instructions together
DISPATCH_LANES_PER_SM = 4 * 32


def require_card() -> str:
    """The card's name and power limit as nvidia-smi reports them; raises
    SystemExit where there is no CUDA device (a probe never times a CPU)."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the probes time the card only")
    return nvidia_smi("name,power.limit")


def nvidia_smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def sm_clock_mhz() -> tuple[float, float]:
    """(current, maximum) SM clock in MHz, as nvidia-smi reports them."""
    cur, top = nvidia_smi("clocks.sm,clocks.max.sm").split(",")
    return float(cur.split()[0]), float(top.split()[0])


@functools.lru_cache(maxsize=None)
def _max_clock_mhz() -> float:
    return sm_clock_mhz()[1]


def lane_rate(lanes_per_sm: int, clock_mhz: float) -> float:
    """Lane operations per second of the whole card: SMs x lanes x clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * lanes_per_sm * clock_mhz * 1e6


def wall_times(fn, reps: int, warmup: int = 1) -> list[float]:
    """Host milliseconds of each of ``reps`` fn() calls up to the device's
    end (launch overheads included), after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def wall_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median of ``wall_times``."""
    return statistics.median(wall_times(fn, reps, warmup))


def cuda_times(fn, reps: int, warmup: int = 1) -> list[float]:
    """Device milliseconds of each of ``reps`` fn() calls by CUDA events,
    after warm-up.

    A spin kernel (``torch.cuda._sleep``, which counts SM clock cycles)
    holds the stream for twice the time the host takes to queue one call
    before the start event, so the host has queued the whole call when the
    device reaches it: the events then bracket the device's work, not the
    host's launch overheads (``wall_times`` has those). The spin's cycles
    come from the maximum SM clock, so a slower clock only lengthens it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    queue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(max(2 * queue_ms, 1.0) * _max_clock_mhz() * 1e3)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median of ``cuda_times``: device milliseconds of one fn()."""
    return statistics.median(cuda_times(fn, reps, warmup))
