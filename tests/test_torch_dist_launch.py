"""The distributed layer's process handling on the CPU: ``make_mesh`` in
one process and without started ranks, ``mesh.launch`` with a failing
and a hanging rank (each within its deadline), ``dryrun_multichip`` at 1
and 2 ranks (checked inside against the host oracle), and
``scaling_report`` on one rank. The distributed functions themselves are
held against the JAX package in ``test_torch_dist.py``."""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu_torch.math import gf
from twenty_first_tpu_torch.parallel import mesh as mesh_mod, scaling

REPO = Path(__file__).resolve().parent.parent
P = (1 << 64) - (1 << 32) + 1


def _fail_on_rank_one(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank one fails")
    return mesh.rank


def _hang(mesh):
    time.sleep(600)


@pytest.fixture(scope="module")
def world_of_one():
    """A world-1 gloo group in this process for the module's tests,
    destroyed at the end when this fixture made it."""
    import torch.distributed as dist

    made = not dist.is_initialized()
    yield mesh_mod.make_mesh(1, device="cpu")
    if made and dist.is_initialized():
        dist.destroy_process_group()


def test_a_mesh_of_several_ranks_needs_their_processes():
    code = ("from twenty_first_tpu_torch.parallel.mesh import make_mesh\n"
            "try:\n    make_mesh(2, device='cpu')\n"
            "except RuntimeError as e:\n    print('launch' in str(e))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.stdout.strip() == "True", proc.stderr


def test_a_world_of_one_is_made_in_this_process(world_of_one):
    """One process: a world of one made in place, the JAX error for more
    devices than the world, ``shape`` as JAX reads it."""
    mesh = world_of_one
    assert mesh.shape == {mesh_mod.AXIS: 1} and mesh.rank == 0
    assert mesh == mesh_mod.make_mesh(device="cpu") and hash(mesh)
    with pytest.raises(ValueError, match="only 1 available"):
        mesh_mod.make_mesh(2)
    spec = mesh_mod.sharded(mesh, None, mesh_mod.AXIS)
    assert spec.mesh is mesh and spec.spec == (None, mesh_mod.AXIS)
    arr = np.random.default_rng(0).integers(0, P, size=(4, 5),
                                            dtype=np.uint64)
    block = mesh_mod.shard_host_array(mesh, (mesh_mod.AXIS, None), arr)
    np.testing.assert_array_equal(gf.to_u64(block), arr)
    assert mesh_mod.local_checksum(block) == int(arr.sum()) & 0xFFFF_FFFF
    mesh_mod.initialize_distributed()  # one process: nothing to join


def test_launch_raises_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        mesh_mod.launch(_fail_on_rank_one, 2, device="cpu", threads=1,
                        timeout=60, workdir=str(tmp_path))


def test_launch_kills_ranks_past_its_deadline(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        mesh_mod.launch(_hang, 2, device="cpu", threads=1, timeout=4,
                        workdir=str(tmp_path))
    assert time.monotonic() - t0 < 30


@pytest.mark.parametrize("d", [1, 2])
def test_dryrun_multichip_on_the_cpu(world_of_one, d):
    from twenty_first_tpu_torch.entry import dryrun_multichip

    ranks = dryrun_multichip(d, device="cpu", backend="gloo")
    assert len(ranks) == d
    assert {r["backend"] for r in ranks} == {"gloo"}


def test_scaling_report_on_one_rank(world_of_one):
    report = scaling.scaling_report(8, [1], device="cpu")
    assert report["ntt"][1]["ntt_bit_exact"] is True
    assert report["ntt"][1]["seconds"] > 0
    assert report["lde_commit"][1]["scaling_efficiency"] == 1.0
    assert report["timer"] == "host clock" and "environment_note" in report
