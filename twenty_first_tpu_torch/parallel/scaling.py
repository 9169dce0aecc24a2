"""Scaling harness: the distributed NTT and LDE commit across mesh sizes.

The counterpart of ``twenty_first_tpu/parallel/scaling.py``. Measures one
problem size on meshes of 1, 2, 4, ... ranks, one rank a card (world 1 in
this process, larger worlds spawned by ``mesh.launch``), and reports the
time of one call, throughput and scaling efficiency (speedup / ideal),
with the bit-exactness of the distributed NTT against the host oracle. On
the card a call's time is taken with CUDA events over back-to-back calls
after a barrier, the slowest rank's; on the CPU with the host clock.

Usage: python -m twenty_first_tpu_torch.parallel.scaling [--log-n 22] [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from . import dist_ntt
from .mesh import (AXIS, Mesh, initialize_distributed, launch, make_mesh,
                   shard_host_array)
from .pipeline import make_dist_lde_commit

P = (1 << 64) - (1 << 32) + 1
#: calls timed back to back, after one warm-up call
REPS = 5


def seconds_per_call(fn, mesh: Mesh, reps: int = REPS) -> float:
    """Seconds of one fn() on this rank: CUDA events around ``reps`` calls
    on the card, the host clock on the CPU, after a warm-up and a
    barrier."""
    fn()
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
    mesh.all_gather(torch.zeros(1, device=mesh.device))  # a barrier
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def column_block(mesh: Mesh, log_n: int, seed: int):
    """This rank's (n2, n1/d) column block of a random 2^log_n vector made
    from ``seed``, on its device."""
    n1, n2 = dist_ntt._split_sizes(log_n)
    x = np.random.default_rng(seed).integers(0, P, size=(n2, n1),
                                             dtype=np.uint64)
    return shard_host_array(mesh, (None, AXIS), x)


def measure_dist_ntt(mesh: Mesh, log_n: int) -> float:
    """Seconds per distributed NTT of 2^log_n elements on this rank."""
    x = column_block(mesh, log_n, 0)
    return seconds_per_call(lambda: dist_ntt.distributed_ntt(x, mesh), mesh)


def measure_lde_commit(mesh: Mesh, log_n: int) -> float:
    """Seconds per distributed LDE + commit of 2^log_n elements."""
    x = column_block(mesh, log_n, 1)
    step = make_dist_lde_commit(mesh, log_n)
    return seconds_per_call(lambda: step(x), mesh)


def verify_dist_ntt(mesh: Mesh, log_n: int) -> bool:
    """Bit-exactness of the distributed NTT on this mesh vs the host
    oracle (``ntt_host``)."""
    from ..math import ntt as ntt_mod

    x = np.random.default_rng(3).integers(0, P, size=1 << log_n,
                                          dtype=np.uint64)
    got = dist_ntt.distributed_ntt_values(x, mesh)
    return bool(np.array_equal(got, ntt_mod.ntt_host(x)))


def _measure(mesh: Mesh, log_n: int) -> dict:
    """One rank's measurements."""
    return {"ntt_s": measure_dist_ntt(mesh, log_n),
            "lde_s": measure_lde_commit(mesh, log_n),
            "bit_exact": verify_dist_ntt(mesh, log_n)}


def scaling_report(log_n: int = 20, mesh_sizes=None, *, device="cuda",
                   backend: str | None = None) -> dict:
    """The scaling report over ``mesh_sizes`` (default 1, 2, 4, ... up to
    the cards, or the CPU's cores for ``device="cpu"``). In a process group
    of several processes (``initialize_distributed``) every process takes
    part and only the whole group is measured."""
    device = torch.device(device)
    multi = dist.is_initialized() and dist.get_world_size() > 1
    n_devices = (dist.get_world_size() if multi
                 else torch.cuda.device_count() if device.type == "cuda"
                 else os.cpu_count())
    if mesh_sizes is None:
        mesh_sizes = [n_devices] if multi else [
            d for d in (1, 2, 4, 8, 16, 32) if d <= n_devices]
    report = {"log_n": log_n, "devices_available": n_devices,
              "device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
              "timer": ("cuda events, the slowest rank"
                        if device.type == "cuda" else "host clock"),
              "ntt": {}, "lde_commit": {}}
    if device.type == "cpu":
        report["environment_note"] = (
            "CPU ranks: every mesh size shares ONE host's cores, so "
            "wall-clock 'scaling efficiency' measures oversubscription, not "
            "parallel hardware, and is expected to fall with mesh size. "
            "What this run does validate: the ranks meet, the collectives "
            "(the all-to-all transpose and the root all-gather) run at every "
            "mesh size, and the result is bit-exact vs the host oracle "
            "(ntt_bit_exact per row). Real scaling needs one card a rank.")
    base_ntt = base_lde = None
    for d in mesh_sizes:
        if multi or d == 1:
            ranks = [_measure(make_mesh(d, device=device, backend=backend),
                              log_n)]
        else:
            ranks = launch(_measure, d, backend=backend, device=device.type,
                           args=(log_n,))
        t_ntt = max(r["ntt_s"] for r in ranks)
        t_lde = max(r["lde_s"] for r in ranks)
        if base_ntt is None:
            base_ntt, base_lde = t_ntt, t_lde
        report["ntt"][d] = {
            "seconds": t_ntt,
            "elems_per_s": (1 << log_n) / t_ntt,
            "scaling_efficiency": base_ntt / (t_ntt * d),
            "ntt_bit_exact": all(r["bit_exact"] for r in ranks),
        }
        report["lde_commit"][d] = {
            "seconds": t_lde,
            "scaling_efficiency": base_lde / (t_lde * d),
        }
    return report


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--log-n", type=int, default=18)
    parser.add_argument("--json", action="store_true")
    # several hosts: each runs this script with its process id
    parser.add_argument("--coordinator", default=None,
                        help="host:port of process 0 (multi-host runs)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    args = parser.parse_args()
    initialize_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    report = scaling_report(args.log_n)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if dist.is_initialized():
        dist.destroy_process_group()
    if rank != 0:
        return
    if args.json:
        print(json.dumps(report))
        return
    print(f"devices: {report['devices_available']} ({report['device']}), "
          f"n = 2^{report['log_n']}")
    for kind in ("ntt", "lde_commit"):
        print(f"-- {kind} --")
        for d, row in report[kind].items():
            eff = row["scaling_efficiency"]
            print(f"  {d:3d} ranks: {row['seconds']*1e3:9.3f} ms   "
                  f"eff {eff*100:5.1f}%")


if __name__ == "__main__":
    main()
