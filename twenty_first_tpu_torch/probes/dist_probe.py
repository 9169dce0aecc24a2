"""The distributed NTT across cards, piece by piece.

For each world size (one rank a card, NCCL), every rank transforms its
column block of one 2^log_n vector (``dist_ntt.distributed_ntt``, the Z
layout) and prints, from rank 0, one JSON line: the call's time with one
and with four all-to-alls (CUDA events over back-to-back calls after a
barrier, the slowest rank's: ``scaling.seconds_per_call``), and each
device kernel of the four-all-to-all call by name with its device time a
launch (``torch.profiler`` over 10 calls: K3's passes, NCCL's send/receive
kernel, whose time includes its wait for the other ranks, and the copies
around the collective). The card's name and power limit come first.

    python -m twenty_first_tpu_torch.probes.dist_probe [--log-n 24] [--worlds 1 2 4]
"""

from __future__ import annotations

import argparse
import json

import torch

from ..parallel import dist_ntt, mesh as mesh_mod, scaling
from .inv_probe import launch_profile
from .timing import require_card

REPS = 10


def measure(mesh, log_n: int) -> dict:
    """One rank's times of the 2^log_n distributed NTT, and its kernels."""
    x = scaling.column_block(mesh, log_n, 0)
    times = {f"chunks{c}_ms": scaling.seconds_per_call(
        lambda c=c: dist_ntt.distributed_ntt(x, mesh, a2a_chunks=c), mesh,
        REPS) * 1e3 for c in (1, 4)}
    # NCCL's "nccl:..." records are ranges around its kernels, not kernels
    kernels = [k for k in launch_profile(lambda: dist_ntt.distributed_ntt(
        x, mesh, a2a_chunks=4), REPS) if not k["name"].startswith("nccl:")]
    return {"world": mesh.size, "rank": mesh.rank, **times,
            "kernel_ms_per_call": sum(k["launches_per_call"]
                                      * k["device_ms_per_launch"]
                                      for k in kernels),
            "kernels": kernels}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--log-n", type=int, default=24)
    parser.add_argument("--worlds", type=int, nargs="+", default=[1, 2, 4])
    args = parser.parse_args()
    print(require_card(), flush=True)
    from .. import _build

    _build.load()  # built here, so that no rank runs nvcc
    for world in args.worlds:
        if world > torch.cuda.device_count():
            print(json.dumps({"world": world, "not run": "too few cards"}))
            continue
        ranks = mesh_mod.launch(measure, world, device="cuda",
                                args=(args.log_n,), timeout=600)
        slowest = max(ranks, key=lambda r: r["chunks4_ms"])
        print(json.dumps({"log_n": args.log_n, **ranks[0],
                          "slowest_rank": slowest["rank"],
                          "slowest_chunks1_ms": max(r["chunks1_ms"]
                                                    for r in ranks),
                          "slowest_chunks4_ms": slowest["chunks4_ms"]}),
              flush=True)


if __name__ == "__main__":
    main()
