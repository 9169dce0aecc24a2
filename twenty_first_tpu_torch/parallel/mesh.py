"""The device mesh of the distributed layer, on ``torch.distributed``.

The counterpart of ``twenty_first_tpu/parallel/mesh.py``. The JAX package
drives every device of a host from one process (``shard_map`` over a named
1-D mesh); here each rank of the mesh is a process of its own that drives
one device, in SPMD style: every rank calls the same function on its own
block, and the collectives (``all_to_all_single``, an all-gather) go
through the process group. The group's backend is NCCL on the card, or
gloo where the caller asks for it (the CPU, or several ranks sharing one
card, which NCCL refuses).

``launch`` starts the ranks of a mesh on this machine: one process each,
spawned, meeting through a ``file://`` store in a temporary directory (no
port is bound), each with a deadline on its group and the whole launch
with a deadline on its ranks, so a hung rank fails the launch instead of
stalling it.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..math import gf

AXIS = "shard"

#: seconds a launch waits for its ranks, and each rank's group for a
#: collective, unless the caller gives another limit
LAUNCH_TIMEOUT_S = 600.0


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the process group, its size, this process's rank in it,
    the group's backend and this rank's device. Hashable, so tables can be
    cached per mesh."""

    group: object
    size: int
    rank: int
    backend: str
    device: torch.device

    @property
    def shape(self) -> dict:
        """``{AXIS: size}``, as JAX code reads a mesh's size."""
        return {AXIS: self.size}

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """Block p of ``send`` (split along dim 0 into ``size`` blocks)
        goes to rank p; block q of the result came from rank q."""
        send = send.contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        return recv

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): row q is rank q's ``t``."""
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return torch.stack(out)


@dataclass(frozen=True)
class Sharding:
    """Which axes of an array are cut over the mesh: ``spec[i] == AXIS``
    cuts axis i into ``mesh.size`` blocks, rank r holding block r."""

    mesh: Mesh
    spec: tuple


def _default_device(rank: int) -> torch.device:
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def _default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(n_devices: int | None = None, devices=None, *, device=None,
              backend: str | None = None) -> Mesh:
    """A 1-D mesh over every rank of the process group; ``n_devices``, if
    given, must be the group's size.

    ``devices``, one per rank, or ``device`` name this rank's device; by
    default ``cuda:{rank % device_count}``. Where no group exists and n is
    None or 1, a world of one is made in this process (the backend NCCL
    for a CUDA device, gloo otherwise), so a single process needs no
    setup; several ranks need their processes started first (``launch``,
    or ``initialize_distributed`` in each)."""
    if devices is not None:
        n_devices = len(devices) if n_devices is None else n_devices
    if not dist.is_initialized():
        if n_devices is not None and n_devices > 1:
            raise RuntimeError(
                f"a mesh of {n_devices} ranks needs one process per rank: "
                "start them with parallel.mesh.launch, or call "
                "initialize_distributed in each before make_mesh")
        device = torch.device(device if device is not None else (
            devices[0] if devices is not None else _default_device(0)))
        dist.init_process_group(backend or _default_backend(device),
                                store=dist.HashStore(), rank=0, world_size=1)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(
            f"requested {n_devices} devices, only {world} available")
    if n_devices < world:
        raise ValueError(f"a mesh spans all {world} ranks of the process "
                         f"group, not {n_devices}")
    group_backend = dist.get_backend()
    if backend is not None and backend != group_backend:
        raise ValueError(f"the process group's backend is {group_backend}, "
                         f"not {backend}")
    if device is None:
        device = devices[rank] if devices is not None else _default_device(rank)
    return Mesh(dist.group.WORLD, world, rank, group_backend,
                torch.device(device))


def sharded(mesh: Mesh, *spec) -> Sharding:
    return Sharding(mesh, spec)


def shard_host_array(mesh: Mesh, spec, arr) -> torch.Tensor:
    """This rank's block of a host uint64 array as a carrier on
    ``mesh.device``: every rank passes the whole array, as in the JAX
    package, and keeps the block its rank indexes on each axis that
    ``spec`` cuts over the mesh."""
    arr = np.asarray(arr, dtype=np.uint64)
    index = []
    for axis, name in enumerate(tuple(spec) + (None,) * (arr.ndim - len(spec))):
        if name != AXIS:
            index.append(slice(None))
            continue
        size = arr.shape[axis]
        if size % mesh.size:
            raise ValueError(f"axis {axis} of {size} does not divide over "
                             f"{mesh.size} ranks")
        block = size // mesh.size
        index.append(slice(mesh.rank * block, (mesh.rank + 1) * block))
    return gf.from_u64(arr[tuple(index)]).to(mesh.device)


def local_checksum(a: torch.Tensor) -> int:
    """u32 sum of this rank's block: a readback that forces and fences the
    device's work, as in timing loops."""
    return int(a.sum()) & 0xFFFF_FFFF


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None):
    """Join an NCCL group of ``num_processes`` ranks that meet at
    ``coordinator_address`` (host:port of rank 0), with a deadline on
    every collective. A no-op for one process."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(
        "nccl", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=LAUNCH_TIMEOUT_S))


# ---------------------------------------------------------------------------
# Launching the ranks of a mesh on this machine
# ---------------------------------------------------------------------------


def _rank_device(device, rank: int) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return _default_device(rank)
    return device


def _rank_main(target, args, rank: int, world: int, backend: str, device,
               init_file: str, timeout: float, threads, results) -> None:
    """One rank: join the group, run ``target(mesh, *args)``, report."""
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        device = _rank_device(device, rank)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout))
        try:
            value = target(make_mesh(world, device=device), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except Exception:  # the boundary of the rank: report it to the launcher
        results.put((rank, False, traceback.format_exc()))


def launch(target, world: int, *, backend: str | None = None,
           device="cuda", args=(), timeout: float = LAUNCH_TIMEOUT_S,
           threads: int | None = None, workdir=None) -> list:
    """Run ``target(mesh, *args)`` on ``world`` spawned ranks and return
    their results in rank order.

    ``target`` is a module-level function (it is pickled by name) and its
    result is picklable. ``device`` is every rank's device ("cuda": rank
    r on ``cuda:{r % device_count}``; "cuda:0": every rank on that card;
    "cpu"). ``backend`` defaults to NCCL for CUDA devices and gloo
    for the CPU; ranks that share a card need gloo. ``threads`` sets each
    rank's torch threads. The rendezvous file lies in a new temporary
    directory (under ``workdir`` if given). Raises if a rank fails, with
    its traceback, or when ``timeout`` seconds pass before every rank has
    reported and exited; every rank still running is killed."""
    first = _rank_device(device, 0)
    backend = backend or _default_backend(first)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="tf_mesh_", dir=workdir) as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(target, args, rank, world, backend, device, init_file,
                  timeout, threads, results)) for rank in range(world)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            values = _collect(procs, results, deadline)
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
            if any(p.is_alive() for p in procs):
                raise TimeoutError(f"ranks did not exit within {timeout} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
            results.close()
    return [values[r] for r in range(world)]


def _collect(procs, results, deadline: float) -> dict:
    """Each rank's value, read off the queue before any rank is joined."""
    values = {}
    while len(values) < len(procs):
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(f"ranks {sorted(set(range(len(procs))) - set(values))} "
                               "did not report in time")
        try:
            rank, ok, value = results.get(timeout=min(left, 1.0))
        except queue_mod.Empty:
            dead = [r for r, p in enumerate(procs)
                    if r not in values and p.exitcode not in (None, 0)]
            if dead:
                raise RuntimeError(f"ranks {dead} exited without a result "
                                   f"(exit codes {[procs[r].exitcode for r in dead]})")
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} of {len(procs)} failed:\n{value}")
        values[rank] = value
    return values
