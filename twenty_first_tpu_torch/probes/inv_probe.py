"""K7, the batch inversion, launch by launch at the polynomial batch path's
shapes.

At (1, 2^20) and (8, 2^20) (one and eight rows of 2^20 determinants, one
of them with a 0 in row 3, as ``chip_smoke.py`` times them) it checks K7
against its plain twin and prints one JSON line: the call's device time
(``timing.cuda_ms``, median of 10), its host-inclusive time, and each
device kernel of the call by name with its device time a launch, from
``torch.profiler`` over 10 calls. First, the registers and spills the
build reports for K7's kernels.

    python -m twenty_first_tpu_torch.probes.inv_probe
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import _build
from ..math import gf
from ..ops import poly_cuda
from .timing import cuda_ms, require_card, wall_ms
from .tip5_probe import ptxas_report

SHAPES = ((1, 1 << 20), (8, 1 << 20))


def operands(rows: int, n: int, seed: int = 0):
    """Random nonzero field words on the card; row 3 (where there is one)
    holds a 0 at element 7."""
    v = np.random.default_rng(seed).integers(1, gf.P, size=(rows, n),
                                             dtype=np.uint64)
    if rows > 3:
        v[3, 7] = 0
    return gf.from_u64(v).cuda()


def launch_profile(fn, reps: int = 10) -> list[dict]:
    """Each device kernel of fn() by name: its device ms a launch and the
    launches the profiler recorded a call, from torch.profiler over
    ``reps`` calls after one warm-up (the profiler may drop a launch's
    record, so a kernel launched once a call can show fewer)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [{"name": e.key[:90], "launches_per_call": e.count / reps,
             "device_ms_per_launch": e.self_device_time_total / e.count / 1e3}
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]


def case(x, reps: int = 10) -> dict:
    """K7 on x against the twin, its device and host times, by launch."""
    def fn():
        return poly_cuda.batch_inversion(x)

    if not torch.equal(fn(), poly_cuda.batch_inversion_plain(x)):
        raise AssertionError(f"K7 at {tuple(x.shape)} differs from the twin")
    return {"shape": list(x.shape), "ms": cuda_ms(fn, reps),
            "wall_ms": wall_ms(fn, reps),
            "launches": launch_profile(fn, reps)}


def kernel_stats() -> dict[str, dict]:
    """Registers, shared memory and spills of K7's kernels by mangled name
    (``-Xptxas -v``)."""
    return {k: v for k, v in ptxas_report(_build.build_log()).items()
            if "inv_" in k}


def main() -> None:
    print(require_card(), flush=True)
    _build.load()
    print(json.dumps({"probe": "ptxas", **kernel_stats()}), flush=True)
    for rows, n in SHAPES:
        print(json.dumps({"probe": "k7", **case(operands(rows, n))}),
              flush=True)


if __name__ == "__main__":
    main()
