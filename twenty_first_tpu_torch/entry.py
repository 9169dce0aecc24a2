"""Entry points: the flagship step at ``__graft_entry__.entry``'s shape,
and the multi-rank dry run of ``__graft_entry__.dryrun_multichip``.

``entry`` returns the step (``lde_commit``) and its example arguments, a
(16, 64) trace made from a numpy seed. ``dryrun_multichip(n)`` runs one
step of the whole distributed pipeline (the four-step NTT with its
all-to-all, the rows hashed on each rank, the Merkle root over the mesh)
on n ranks, and the MMR and KEM legs, each checked against the host
oracle.
"""

from __future__ import annotations

import numpy as np

from .math import gf
from .parallel.pipeline import lde_commit

P = (1 << 64) - (1 << 32) + 1


def entry(device="cuda"):
    """(step, args): ``step(*args)`` is the (1, 5) root of a (16, 64) trace
    drawn from ``np.random.default_rng(0)``, on ``device`` (the card unless
    the caller asks for another; a machine without one raises)."""
    rows, n = 16, 64
    rng = np.random.default_rng(0)
    data = rng.integers(0, P, size=(rows, n), dtype=np.uint64)
    return lde_commit, (gf.from_u64(data).to(device),)


def _dryrun_inputs(n_devices: int):
    """(log_n, (n2, n1) coefficients, MMR leafs, appended leafs), from
    ``np.random.default_rng(1)`` as in ``__graft_entry__``: 2^16 or more
    coefficients, so the run has real four-step blocks and a deep subtree
    on each rank."""
    from .parallel.dist_ntt import _split_sizes

    log_n = 16
    while True:
        n1, n2 = _split_sizes(log_n)
        if n1 % n_devices == 0 and n2 % n_devices == 0:
            break
        log_n += 1
    rng = np.random.default_rng(1)
    data = rng.integers(0, P, size=(n2, n1), dtype=np.uint64)
    n_mmr = 8 * n_devices + 3  # spans the mesh, with tail peaks
    mmr_leafs = rng.integers(0, P, size=(n_mmr, 5), dtype=np.uint64)
    batch = rng.integers(0, P, size=(4 * n_devices + 1, 5), dtype=np.uint64)
    return log_n, data, mmr_leafs, batch


def _dryrun_rank(mesh) -> dict:
    """One rank's part of the dry run: the LDE commit's root, the MMR's
    peaks and the peaks after a batch append."""
    from .parallel import mesh as mesh_mod
    from .parallel.dist_mmr import (distributed_batch_append,
                                    distributed_peaks_from_leafs)
    from .parallel.pipeline import make_dist_lde_commit
    from .tip5.digest import Digest

    log_n, data, mmr_leafs, batch = _dryrun_inputs(mesh.size)
    block = mesh_mod.shard_host_array(mesh, (None, mesh_mod.AXIS), data)
    root = make_dist_lde_commit(mesh, log_n)(block)
    peaks = distributed_peaks_from_leafs(mmr_leafs, mesh)
    new_peaks, new_count = distributed_batch_append(
        peaks, mmr_leafs.shape[0], batch, mesh)
    return {"root": Digest.from_array(gf.to_u64(root)[0]), "peaks": peaks,
            "new_peaks": new_peaks, "new_count": new_count,
            "backend": mesh.backend, "device": str(mesh.device)}


def dryrun_multichip(n_devices: int, device="cuda",
                     backend: str | None = None) -> list:
    """One step of the distributed pipeline on ``n_devices`` ranks, checked
    against the host oracle (``ntt_host``, ``Tip5.hash_varlen``,
    ``MerkleTree``, ``MmrAccumulator``), then the lattice KEM's round trip.

    One rank runs in this process (``make_mesh(1)``); more are spawned
    (``parallel.mesh.launch``), each on ``device`` ("cuda": rank r on
    ``cuda:{r % device_count}``) with ``backend`` (NCCL for CUDA by
    default; ranks that share a card need "gloo"). Raises on any mismatch;
    returns each rank's results."""
    from .math import lattice
    from .math import ntt as ntt_mod
    from .parallel import mesh as mesh_mod
    from .tip5.tip5 import Tip5
    from .util_types.merkle_tree import MerkleTree
    from .util_types.mmr.mmr_accumulator import MmrAccumulator

    if n_devices == 1:
        ranks = [_dryrun_rank(mesh_mod.make_mesh(1, device=device,
                                                 backend=backend))]
    else:
        ranks = mesh_mod.launch(_dryrun_rank, n_devices, backend=backend,
                                device=device)
    log_n, data, mmr_leafs, batch = _dryrun_inputs(n_devices)
    # the pipeline commits to the Z layout (Z[k2, k1] = X[k2 + n2*k1]), so
    # leaf k2 is the hash of the stride-n2 slice X[k2::n2]
    n2, n1 = data.shape
    z_rows = ntt_mod.ntt_host(data.reshape(-1)).reshape(n1, n2).T
    leafs = np.array([Tip5.hash_varlen(row.tolist()).to_array()
                      for row in z_rows], dtype=np.uint64)
    want_root = MerkleTree.new(leafs, device="cpu").root()
    want_peaks = MmrAccumulator.peaks_from_leafs(mmr_leafs, device="cpu")
    want_new = MmrAccumulator.peaks_from_leafs(
        np.concatenate([mmr_leafs, batch]), device="cpu")
    for rank, got in enumerate(ranks):
        if got["root"] != want_root:
            raise AssertionError(f"rank {rank}: distributed LDE+commit root "
                                 f"{got['root']} != host oracle {want_root}")
        if got["peaks"] != want_peaks or got["new_peaks"] != want_new or \
                got["new_count"] != len(mmr_leafs) + len(batch):
            raise AssertionError(f"rank {rank}: MMR peaks differ from the "
                                 "host accumulator")
    seed = bytes(range(32))
    sk, pk = lattice.keygen(seed)
    shared, ct = lattice.enc(pk, bytes(reversed(seed)))
    if lattice.dec(sk, ct) != shared:
        raise AssertionError("lattice KEM round trip failed")
    return ranks
