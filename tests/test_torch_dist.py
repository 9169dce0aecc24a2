"""The port's distributed layer (``twenty_first_tpu_torch/parallel``: the
distributed NTT, Merkle root, MMR and LDE commit over a mesh) against the
JAX package, exactly, on the CPU (the launcher, ``make_mesh``,
``dryrun_multichip`` and ``scaling``: ``test_torch_dist_launch.py``).

World 1 runs in this process. Worlds 2 and 4, and 3 for the MMR, are each
spawned once (gloo, a ``file://`` rendezvous under the test's temporary
directory, one torch thread a rank, a deadline on the group and on the
launch) by the module's fixture, which runs every case of that world and
hands back the results. The ranks run ``_rank_cases``, which asserts that
neither JAX nor the JAX package was imported: this file's top level
imports neither, and the JAX side is computed in the test functions. The
JAX side runs on ``make_mesh(d)`` of the 8 virtual CPU devices where its
compiles are cheap enough for this file's budget (the world-4 chunked
NTT, a world-2 Merkle root and LDE commit, every world-3 MMR case, the
errors), and is its host path (``ntt_host``, ``MerkleTree``,
``MmrAccumulator``, ``Tip5.hash_varlen``) elsewhere, which the JAX
package's own tests hold equal to its mesh.
"""

import contextlib
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu_torch.math import gf, ntt
from twenty_first_tpu_torch.parallel import (dist_merkle, dist_mmr, dist_ntt,
                                             mesh as mesh_mod, pipeline)

P = (1 << 64) - (1 << 32) + 1
NTT_LOG_N = (8, 12)
TWO_PASS_LOG_N, TWO_PASS_CUT = 10, 3
XFE_LOG_N, LDE_LOG_N = 10, 10
ROOT_LOG_N = (3, 7)
# tests/test_dist_mmr.py's leaf counts and (count, batch) pairs
MMR_PEAKS = (0, 1, 2, 3, 8, 37, (1 << 8) + 19, (1 << 10) + (1 << 7) + 1)
MMR_APPENDS = ((0, 1), (0, 100), (1, 1), (5, 3), (37, 91),
               ((1 << 9) + 3, (1 << 8) + 17), ((1 << 10) - 1, (1 << 10) + 1),
               (21, 43))
CHUNKS = (1, 2, 4)
ERROR_CASES = ("ntt_indivisible", "ntt_shape", "xfe_shape",
               "root_not_power_of_two", "tree_smaller_than_mesh",
               "mesh_too_large")
WORLDS = (1, 2, 4)
MMR_WORLDS = (1, 2, 3, 4)
SPAWNED = (2, 3, 4)
LAUNCH_TIMEOUT_S = 180


def _vec(log_n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed * 100 + log_n).integers(
        0, P, size=1 << log_n, dtype=np.uint64)


def _leafs(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(0xD157 + seed).integers(
        0, P, size=(n, 5), dtype=np.uint64)


def _values(digests) -> list:
    return [[int(v) for v in d.to_array()] for d in digests]


def _error(fn) -> str | None:
    """The name of the exception type fn() raises (None: none)."""
    try:
        fn()
    except Exception as e:  # the type is the result compared
        return type(e).__name__
    return None


@contextlib.contextmanager
def _two_pass_cut():
    """``ntt.ONE_PASS_MAX_LOG_N`` lowered to TWO_PASS_CUT, the tables built
    meanwhile dropped after, so that each pass of a 2^TWO_PASS_LOG_N
    distributed transform takes the two-pass route of ``ntt_columns``."""
    cut = ntt.ONE_PASS_MAX_LOG_N
    ntt.ONE_PASS_MAX_LOG_N = TWO_PASS_CUT
    ntt._cached_tables.cache_clear()
    try:
        yield
    finally:
        ntt.ONE_PASS_MAX_LOG_N = cut
        ntt._cached_tables.cache_clear()


# ---------------------------------------------------------------------------
# What every rank of a world runs
# ---------------------------------------------------------------------------


def _ntt_cases(mesh) -> dict:
    out = {}
    for log_n in NTT_LOG_N:
        x = _vec(log_n)
        n1, n2 = dist_ntt._split_sizes(log_n)
        block = mesh_mod.shard_host_array(mesh, (None, mesh_mod.AXIS),
                                          x.reshape(n2, n1))
        for inverse in (False, True):
            out[("ntt", log_n, inverse, "natural")] = \
                dist_ntt.distributed_ntt_values(x, mesh, inverse)
            z = dist_ntt.distributed_ntt(block, mesh, inverse)
            out[("ntt", log_n, inverse, "z")] = gf.to_u64(
                mesh.all_gather(z)).reshape(n2, n1)
    if mesh.size == 4:
        for chunks in CHUNKS:
            out[("chunks", chunks)] = dist_ntt.distributed_ntt_values(
                chip_smoke.dist_pin_input(12), mesh, a2a_chunks=chunks)
    with _two_pass_cut():
        for inverse in (False, True):
            out[("two_pass", inverse)] = dist_ntt.distributed_ntt_values(
                _vec(TWO_PASS_LOG_N, 1), mesh, inverse)
    vals = _vec(XFE_LOG_N + 2, 2)[: 3 << XFE_LOG_N].reshape(-1, 3)
    for inverse in (False, True):
        out[("xfe", inverse)] = dist_ntt.distributed_ntt_xfe_values(
            vals, mesh, inverse)
    return out


def _commit_cases(mesh) -> dict:
    out = {}
    for log_n in ROOT_LOG_N:
        out[("root", log_n)] = _values([dist_merkle.distributed_merkle_root(
            _leafs(1 << log_n, log_n), mesh)])
    leafs = _leafs(1 << ROOT_LOG_N[-1], ROOT_LOG_N[-1])
    block = mesh_mod.shard_host_array(mesh, (mesh_mod.AXIS, None), leafs)
    out["root_limbs"] = gf.from_limbs(dist_merkle.distributed_merkle_root_limbs(
        gf.limbs_of(block), mesh, ROOT_LOG_N[-1])).tolist()
    out["lde"] = _values([pipeline.dist_lde_commit_values(
        _vec(LDE_LOG_N, 3), mesh)])
    out["pins"] = chip_smoke.dist_pins(mesh)
    return out


def _mmr_cases(mesh) -> dict:
    out = {}
    for n in MMR_PEAKS:
        out[("peaks", n)] = _values(dist_mmr.distributed_peaks_from_leafs(
            _leafs(n, 1), mesh))
    for c0, m in MMR_APPENDS:
        base, batch = _leafs(c0, 2), _leafs(m, 3)
        peaks0 = dist_mmr.distributed_peaks_from_leafs(base, mesh)
        peaks, count = dist_mmr.distributed_batch_append(peaks0, c0, batch,
                                                         mesh)
        out[("append", c0, m)] = (_values(peaks), count)
    return out


def _error_cases(mesh) -> dict:
    d = mesh.size
    return {
        # n1 = 2 columns do not divide over 4 ranks, nor 1 over 2 or 3
        "ntt_indivisible": _error(lambda: dist_ntt.distributed_ntt_values(
            _vec(2 if d == 4 else 1), mesh)),
        "ntt_shape": _error(lambda: dist_ntt.distributed_ntt(
            torch.zeros((8, 3), dtype=torch.int64), mesh)),
        "xfe_shape": _error(lambda: dist_ntt.distributed_ntt_xfe_values(
            _vec(4).reshape(8, 2), mesh)),
        "root_not_power_of_two": _error(
            lambda: dist_merkle.distributed_merkle_root(_leafs(6, 0), mesh)),
        "tree_smaller_than_mesh": _error(
            lambda: dist_merkle.distributed_merkle_root(_leafs(1, 0), mesh)),
        "mesh_too_large": _error(lambda: mesh_mod.make_mesh(d + 1)),
    }


def _cases(mesh) -> dict:
    """Every case of this world: the MMR's on a mesh of 3, all of them on
    a power-of-two mesh."""
    out = {"errors": _error_cases(mesh), "rank": mesh.rank,
           "backend": mesh.backend, "device": str(mesh.device),
           # a mesh spans every rank of its group
           "mesh_of_fewer": _error(lambda: mesh_mod.make_mesh(mesh.size - 1))}
    if mesh.size & (mesh.size - 1) == 0:
        out.update(_ntt_cases(mesh))
        out.update(_commit_cases(mesh))
    out.update(_mmr_cases(mesh))
    return out


def _rank_cases(mesh) -> dict:
    """The target of a spawned rank: no JAX in it, then every case."""
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "twenty_first_tpu"))
    assert not foreign, foreign
    return _cases(mesh)


# ---------------------------------------------------------------------------
# The ranks, each world once
# ---------------------------------------------------------------------------


def _jax_mesh_calls() -> dict:
    """The JAX package's mesh calls, each once: the 4-device chunked NTT of
    the pin input and the 2-device Merkle root of 2^3 leafs (the shapes of
    tests/test_parallel.py, so that they share its compiles), the 2-device
    LDE commit of the small pin input."""
    from twenty_first_tpu.parallel import (distributed_merkle_root,
                                           distributed_ntt_values, make_mesh)
    from twenty_first_tpu.parallel.pipeline import dist_lde_commit_values

    return {
        "ntt_2^12": distributed_ntt_values(chip_smoke.dist_pin_input(12),
                                           make_mesh(4), a2a_chunks=4),
        "lde_commit_2^4": dist_lde_commit_values(chip_smoke.dist_pin_input(4),
                                                 make_mesh(2)),
        "root_2^3": distributed_merkle_root(
            _leafs(1 << ROOT_LOG_N[0], ROOT_LOG_N[0]), make_mesh(2)),
    }


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Starts, together and in threads that wait on them, the spawned
    worlds and the JAX package's mesh calls, so that they run beside each
    other and beside world 1 in this process; yields their futures."""
    with ThreadPoolExecutor(max_workers=len(SPAWNED) + 1) as pool:
        futures = {k: pool.submit(
            mesh_mod.launch, _rank_cases, k, backend="gloo", device="cpu",
            threads=1, timeout=LAUNCH_TIMEOUT_S,
            workdir=str(tmp_path_factory.mktemp(f"world{k}")))
            for k in SPAWNED}
        futures["jax"] = pool.submit(_jax_mesh_calls)
        yield futures
        for future in futures.values():
            future.exception()  # read, so that no failure is lost


@pytest.fixture(scope="module")
def world(started):
    """world(d) -> every rank's results of a d-rank mesh, run once."""
    import torch.distributed as dist

    made = not dist.is_initialized()
    results = {}

    def get(d: int) -> list:
        if d not in results:
            results[d] = ([_cases(mesh_mod.make_mesh(1, device="cpu"))]
                          if d == 1 else started[d].result())
        return results[d]

    yield get
    if made and dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_side(started):
    return started["jax"].result()


def _every_rank(ranks, key):
    """The value of ``key``, the same on every rank."""
    first = ranks[0][key]
    for r in ranks[1:]:
        np.testing.assert_equal(r[key], first)
    return first


def _jax_ntt(x, inverse: bool) -> np.ndarray:
    from twenty_first_tpu.math import ntt as jntt

    return jntt.ntt_host(x, inverse=inverse)


def _jax_peaks(leafs, d: int) -> list:
    """The JAX package's peaks: its mesh of 3 (every chunk by the host
    branch), its accumulator otherwise."""
    from twenty_first_tpu.parallel import make_mesh
    from twenty_first_tpu.parallel.dist_mmr import distributed_peaks_from_leafs
    from twenty_first_tpu.util_types.mmr.mmr_accumulator import MmrAccumulator

    if d == 3:
        return distributed_peaks_from_leafs(leafs, make_mesh(3))
    return MmrAccumulator.peaks_from_leafs(leafs)


def _jax_append(c0: int, m: int, d: int) -> tuple:
    from twenty_first_tpu.parallel import make_mesh
    from twenty_first_tpu.parallel.dist_mmr import distributed_batch_append
    from twenty_first_tpu.util_types.mmr.mmr_accumulator import MmrAccumulator

    base, batch = _leafs(c0, 2), _leafs(m, 3)
    if d == 3:
        peaks, count = distributed_batch_append(
            MmrAccumulator.peaks_from_leafs(base), c0, batch, make_mesh(3))
        return _values(peaks), count
    return (_values(MmrAccumulator.peaks_from_leafs(
        np.concatenate([base, batch]))), c0 + m)


def _jax_lde_root(x) -> list:
    """The JAX package's host composition of the LDE commit: leaf k2 is the
    hash of X[k2::n2] (the Z layout's row k2)."""
    from twenty_first_tpu.tip5.tip5 import Tip5
    from twenty_first_tpu.util_types.merkle_tree import MerkleTree

    n1, n2 = dist_ntt._split_sizes(x.size.bit_length() - 1)
    rows = _jax_ntt(x, False).reshape(n1, n2).T
    leafs = np.array([Tip5.hash_varlen([int(v) for v in row]).to_array()
                      for row in rows], dtype=np.uint64)
    return _values([MerkleTree.new(leafs).root()])


def _expected(key, d: int):
    """The JAX package's value of a case of ``_cases`` on a d-rank mesh."""
    from twenty_first_tpu.util_types.merkle_tree import MerkleTree

    kind = key[0] if isinstance(key, tuple) else key
    if kind == "ntt":
        _, log_n, inverse, layout = key
        want = _jax_ntt(_vec(log_n), inverse)
        n1, n2 = dist_ntt._split_sizes(log_n)
        return want.reshape(n1, n2).T if layout == "z" else want
    if kind == "chunks":
        return _jax_ntt(chip_smoke.dist_pin_input(12), False)
    if kind == "two_pass":
        return _jax_ntt(_vec(TWO_PASS_LOG_N, 1), key[1])
    if kind == "xfe":
        vals = _vec(XFE_LOG_N + 2, 2)[: 3 << XFE_LOG_N].reshape(-1, 3)
        return _jax_ntt(vals.T, key[1]).T
    if kind in ("root", "root_limbs"):
        log_n = key[1] if kind == "root" else ROOT_LOG_N[-1]
        return _values([MerkleTree.new(_leafs(1 << log_n, log_n)).root()])
    if kind == "lde":
        return _jax_lde_root(_vec(LDE_LOG_N, 3))
    if kind == "pins":
        return chip_smoke.PINNED_DIST
    if kind == "peaks":
        return _values(_jax_peaks(_leafs(key[1], 1), d))
    if kind == "append":
        return _jax_append(key[1], key[2], d)
    if kind == "mesh_of_fewer":
        return "ValueError"
    if kind == "errors":
        # a single rank divides every transform and holds every tree
        return {case: None if d == 1 and case in (
                    "ntt_indivisible", "tree_smaller_than_mesh")
                else "ValueError" for case in ERROR_CASES}
    raise KeyError(key)


def _check(world, d: int, key) -> None:
    np.testing.assert_equal(_every_rank(world(d), key), _expected(key, d))


# ---------------------------------------------------------------------------
# The distributed NTT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["natural", "z"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", NTT_LOG_N)
@pytest.mark.parametrize("d", WORLDS)
def test_distributed_ntt_matches_jax(world, d, log_n, inverse, layout):
    """Z layout: Z[k2, k1] = X[k2 + n2 k1], the ranks' row blocks in
    order."""
    _check(world, d, ("ntt", log_n, inverse, layout))


@pytest.mark.parametrize("chunks", CHUNKS)
def test_chunked_all_to_all_matches_the_jax_mesh(world, jax_side, chunks):
    np.testing.assert_array_equal(_every_rank(world(4), ("chunks", chunks)),
                                  jax_side["ntt_2^12"])
    _check(world, 4, ("chunks", chunks))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("d", WORLDS)
def test_two_pass_columns_and_rows_match_jax(world, d, inverse):
    """With the one-pass cut lowered to 2^3, the 2^10 transform's columns
    and rows (2^5 each) take two passes of K3's twin."""
    _check(world, d, ("two_pass", inverse))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("d", WORLDS)
def test_distributed_xfe_ntt_matches_jax(world, d, inverse):
    _check(world, d, ("xfe", inverse))


def test_the_two_pass_route_is_the_one_pass_route_in_process():
    """At world 1, lowering the cut changes the passes, not the values."""
    mesh = mesh_mod.make_mesh(1, device="cpu")
    x = _vec(TWO_PASS_LOG_N, 1)
    want = dist_ntt.distributed_ntt_values(x, mesh, a2a_chunks=1)
    with _two_pass_cut():
        got = dist_ntt.distributed_ntt_values(x, mesh, a2a_chunks=1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["rows", "columns"])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_columns_two_pass_route_matches_one_pass(layout, inverse):
    """``ntt_columns`` at 2^7 in both of its two-pass layouts (three rows;
    one batch of three strided columns), with a diagonal and a scale,
    against its one-pass route on the same views, and a column of it
    against ``ntt()``."""
    rng = np.random.default_rng(7)
    t = 1 << 7
    if layout == "rows":
        x = gf.from_u64(rng.integers(0, P, size=(3, t), dtype=np.uint64))
        x = x.unsqueeze(-1)
        diag = gf.from_u64(rng.integers(0, P, size=(t, 1), dtype=np.uint64))
    else:
        x = gf.from_u64(rng.integers(0, P, size=(t, 6), dtype=np.uint64))
        x = x[:, ::2].unsqueeze(0)
        diag = gf.from_u64(rng.integers(0, P, size=(t, 3), dtype=np.uint64))
    want = ntt.ntt_columns(x, torch.empty(x.shape, dtype=torch.int64),
                           inverse, diag=diag, scale=5)
    with _two_pass_cut():
        got = torch.empty(x.shape, dtype=torch.int64)
        ntt.ntt_columns(x, got, inverse, diag=diag, scale=5)
    np.testing.assert_array_equal(gf.to_u64(got), gf.to_u64(want))
    unscaled = t if inverse else 1  # ntt() scales its inverse by 1/t
    np.testing.assert_array_equal(
        gf.to_u64(want[0, :, 0]), gf.to_u64(gf.mul_const(gf.mul(
            ntt.ntt(x[0, :, 0], inverse), diag[:, 0]), 5 * unscaled)))


def test_ntt_columns_refuses_what_k3_cannot_view(monkeypatch):
    """Two passes over several batches and several columns at once, and a
    column that needs three passes (that route's cut lowered to 2^5),
    raise ValueError."""
    x = torch.zeros((2, 1 << 4, 2), dtype=torch.int64)
    with _two_pass_cut(), pytest.raises(ValueError):
        ntt.ntt_columns(x, torch.empty_like(x))
    monkeypatch.setattr(ntt, "THREE_PASS_LOG_N", 5)
    x = torch.zeros((1, 1 << 5, 1), dtype=torch.int64)
    with pytest.raises(ValueError):
        ntt.ntt_columns(x, torch.empty_like(x))


# ---------------------------------------------------------------------------
# Errors: the same types as the JAX package's
# ---------------------------------------------------------------------------


def _jax_errors(d: int) -> dict:
    from twenty_first_tpu.parallel import (distributed_merkle_root,
                                           distributed_ntt,
                                           distributed_ntt_values,
                                           distributed_ntt_xfe_values,
                                           make_mesh)

    mesh = make_mesh(d)
    zeros = np.zeros((8, 3 * d), dtype=np.uint32)
    return {
        "ntt_indivisible": _error(lambda: distributed_ntt_values(
            _vec(2 if d == 4 else 1), mesh)),
        "ntt_shape": _error(lambda: distributed_ntt((zeros, zeros), mesh)),
        "xfe_shape": _error(lambda: distributed_ntt_xfe_values(
            _vec(4).reshape(8, 2), mesh)),
        "root_not_power_of_two": _error(
            lambda: distributed_merkle_root(_leafs(6, 0), mesh)),
        "tree_smaller_than_mesh": _error(
            lambda: distributed_merkle_root(_leafs(1, 0), mesh)),
        "mesh_too_large": _error(lambda: make_mesh(9)),
    }


@pytest.mark.parametrize("case", ERROR_CASES)
@pytest.mark.parametrize("d", MMR_WORLDS)
def test_errors_match_jax(world, d, case):
    want = _expected("errors", d)[case]
    assert _jax_errors(d)[case] == want
    assert _every_rank(world(d), "errors")[case] == want


@pytest.mark.parametrize("d", MMR_WORLDS)
def test_a_mesh_spans_every_rank(world, d):
    _check(world, d, "mesh_of_fewer")


# ---------------------------------------------------------------------------
# Merkle roots, the LDE commit, the pins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log_n", ROOT_LOG_N)
@pytest.mark.parametrize("d", WORLDS)
def test_distributed_merkle_root_matches_jax(world, d, log_n):
    _check(world, d, ("root", log_n))


def test_distributed_merkle_root_matches_the_jax_mesh(world, jax_side):
    assert _every_rank(world(2), ("root", ROOT_LOG_N[0])) == \
        _values([jax_side["root_2^3"]])


@pytest.mark.parametrize("d", WORLDS)
def test_distributed_merkle_root_limbs_matches_jax(world, d):
    _check(world, d, "root_limbs")


@pytest.mark.parametrize("d", WORLDS)
def test_dist_lde_commit_matches_jax(world, d):
    _check(world, d, "lde")


@pytest.mark.parametrize("d", WORLDS)
def test_pinned_dist_on_every_world(world, d):
    _check(world, d, "pins")


def test_pinned_dist_is_jax_s(jax_side):
    assert chip_smoke.pin_of(jax_side["ntt_2^12"]) == \
        chip_smoke.PINNED_DIST["ntt_2^12"]
    assert _values([jax_side["lde_commit_2^4"]])[0] == \
        chip_smoke.PINNED_DIST["lde_commit_2^4"]


# ---------------------------------------------------------------------------
# The MMR (tests/test_dist_mmr.py's cases)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", MMR_PEAKS)
@pytest.mark.parametrize("d", MMR_WORLDS)
def test_distributed_peaks_match_jax(world, d, n):
    _check(world, d, ("peaks", n))


@pytest.mark.parametrize("c0,m", MMR_APPENDS)
@pytest.mark.parametrize("d", MMR_WORLDS)
def test_distributed_batch_append_matches_jax(world, d, c0, m):
    _check(world, d, ("append", c0, m))


# ---------------------------------------------------------------------------
# The spawned ranks
# ---------------------------------------------------------------------------


def test_every_rank_reports_its_backend_and_device(world):
    for d in (2, 4):
        ranks = world(d)
        assert [r["rank"] for r in ranks] == list(range(d))
        assert {(r["backend"], r["device"]) for r in ranks} == {("gloo", "cpu")}
