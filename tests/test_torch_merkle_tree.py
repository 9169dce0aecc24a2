"""The port's Merkle tree (``util_types/merkle_tree.py``) against the JAX
package's, exactly, on inputs made with numpy: node arrays, roots,
authentication structures, inclusion proofs and their verdicts. On the CPU
the port builds its trees on the host route (host leafs up to
``HOST_MERKLE_MAX_LEAFS``: the native core) or with the plain twins of K2
(tensors, and host leafs above the cut); the JAX package with its host
path. The fixed cases of ``tests/test_merkle_parity.py`` run here through
both packages."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu import config as jconfig
from twenty_first_tpu import errors as jerrors
from twenty_first_tpu.math import b_field_element as jb
from twenty_first_tpu.tip5 import digest as jdigest
from twenty_first_tpu.tip5 import tip5 as jtip5
from twenty_first_tpu.util_types import merkle_tree as jmt
from twenty_first_tpu_torch import config as tconfig
from twenty_first_tpu_torch import errors as terrors
from twenty_first_tpu_torch import native
from twenty_first_tpu_torch.math import b_field_element as tb
from twenty_first_tpu_torch.math import gf
from twenty_first_tpu_torch.ops import tip5_cuda
from twenty_first_tpu_torch.tip5 import digest as tdigest
from twenty_first_tpu_torch.tip5 import tip5 as ttip5
from twenty_first_tpu_torch.tip5.permutation import tip5_tables
from twenty_first_tpu_torch.util_types import merkle_tree as tmt

P = jb.P
RNG = np.random.default_rng(23)

JAX = SimpleNamespace(name="jax", mt=jmt, Tip5=jtip5.Tip5,
                      Digest=jdigest.Digest, bfe=jb.bfe,
                      Error=jerrors.MerkleTreeError, config=jconfig, kw={})
PORT = SimpleNamespace(name="port", mt=tmt, Tip5=ttip5.Tip5,
                       Digest=tdigest.Digest, bfe=tb.bfe,
                       Error=terrors.MerkleTreeError, config=tconfig,
                       kw={"device": "cpu"})


def _leafs(n: int) -> np.ndarray:
    return RNG.integers(0, P, size=(n, 5), dtype=np.uint64)


def _norm(x):
    """A result of either package as plain python data."""
    if isinstance(x, (jdigest.Digest, tdigest.Digest)):
        return tuple(v.value() for v in x.values())
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def _both(case, *args):
    """case(package, *args) through both packages: (JAX's, the port's)."""
    return _norm(case(JAX, *args)), _norm(case(PORT, *args))


def _new(m, leafs):
    return m.mt.MerkleTree.new(leafs, **m.kw)


# --- trees -------------------------------------------------------------------


@pytest.mark.parametrize("height", range(11))
def test_tree_nodes_match_jax(height):
    leafs = _leafs(1 << height)
    jtree = jmt.MerkleTree.new(leafs)
    tree = tmt.MerkleTree.new(leafs, device="cpu")
    np.testing.assert_array_equal(tree.node_array(), jtree.node_array())
    assert tree.node_array().dtype == np.uint64
    assert _norm(tree.root()) == _norm(jtree.root())
    assert (tree.height(), tree.num_leafs()) == (height, 1 << height)
    assert _norm(tmt.MerkleTree.frugal_root(leafs, device="cpu")) == \
        _norm(jmt.MerkleTree.frugal_root(leafs))


@pytest.mark.parametrize("form", ["array", "digests", "tensor"])
def test_leaf_forms_give_the_same_tree(form):
    leafs = _leafs(32)
    given = {"array": leafs,
             "digests": [tdigest.Digest.from_array(r) for r in leafs],
             "tensor": gf.from_u64(leafs)}[form]
    tree = tmt.MerkleTree.new(given, device="cpu")
    np.testing.assert_array_equal(tree.node_array(),
                                  jmt.MerkleTree.new(leafs).node_array())
    assert tree == tmt.MerkleTree.par_new(leafs, device="cpu")
    assert tree != tmt.MerkleTree.new(_leafs(32), device="cpu")


def test_plain_flag_on_cpu_gives_the_same_tree():
    leafs = _leafs(64)
    assert tmt.MerkleTree.new(leafs, device="cpu", plain=True) == \
        tmt.MerkleTree.new(leafs, device="cpu")
    assert tmt.MerkleTree.frugal_root(leafs, device="cpu", plain=True) == \
        tmt.MerkleTree.frugal_root(leafs, device="cpu")


def test_accessors_match_jax():
    def case(m):
        leafs = np.arange(80, dtype=np.uint64).reshape(16, 5) * 977
        tree = _new(m, leafs)
        return [tree.node(0), tree.node(32), [tree.node(i) for i in range(1, 32)],
                tree.leaf(-1), tree.leaf(16), [tree.leaf(i) for i in range(16)],
                tree.leafs(), tree.indexed_leafs([3, 0, 3])]

    want, got = _both(case)
    assert got == want


@pytest.mark.parametrize("bad", ["three leafs", "no leafs", "too high",
                                 "bad leaf index", "bad shape"])
def test_tree_errors_match_jax(bad, monkeypatch):
    for m in (JAX, PORT):
        with pytest.raises(m.Error):
            if bad == "three leafs":
                _new(m, _leafs(3))
            elif bad == "no leafs":
                _new(m, [])
            elif bad == "too high":
                monkeypatch.setattr(m.mt, "MAX_TREE_HEIGHT", 3)
                _new(m, _leafs(16))
            elif bad == "bad leaf index":
                _new(m, _leafs(4)).indexed_leafs([4])
            else:
                _new(m, _leafs(4)[:, :4])


def test_jax_tree_carries_in_through_its_node_array():
    leafs = _leafs(128)
    jtree = jmt.MerkleTree.new(leafs)
    tree = tmt.MerkleTree(jtree.node_array(), device="cpu")
    assert tree == tmt.MerkleTree.new(leafs, device="cpu")
    indices = [5, 77, 5, 127]
    assert _norm(tree.authentication_structure(indices)) == \
        _norm(jtree.authentication_structure(indices))
    proof = tree.inclusion_proof_for_leaf_indices(indices)
    assert proof.verify(tmt.MerkleTree(gf.from_u64(jtree.node_array())).root(),
                        device="cpu")
    with pytest.raises(terrors.MerkleTreeError):
        tmt.MerkleTree(jtree.node_array()[:6], device="cpu")


# --- authentication structures and proofs ------------------------------------


INDEX_SETS = {"none": [], "first": [0], "last": [127], "pair": [0, 2],
              "repeats": [3, 3, 5, 3], "siblings": [10, 11],
              "random": [int(i) for i in RNG.integers(0, 128, 12)],
              "all": list(range(128))}


@pytest.mark.parametrize("name", sorted(INDEX_SETS))
def test_authentication_structures_match_jax(name):
    leafs, indices = _leafs(128), INDEX_SETS[name]
    jtree = jmt.MerkleTree.new(leafs)
    tree = tmt.MerkleTree.new(leafs, device="cpu")
    want = _norm(jtree.authentication_structure(indices))
    assert tmt.MerkleTree.authentication_structure_node_indices(
        128, indices) == jmt.MerkleTree.authentication_structure_node_indices(
        128, indices)
    assert _norm(tree.authentication_structure(indices)) == want
    assert _norm(tmt.MerkleTree.authentication_structure_from_leafs(
        leafs, indices, device="cpu")) == want
    assert _norm(jmt.MerkleTree.authentication_structure_from_leafs(
        leafs, indices)) == want


@pytest.mark.parametrize("height", [0, 1, 2, 5])
def test_authentication_structure_from_leafs_small_trees(height):
    leafs = _leafs(1 << height)
    for indices in ([0], [(1 << height) - 1], list(range(1 << height))):
        assert _norm(tmt.MerkleTree.authentication_structure_from_leafs(
            gf.from_u64(leafs), indices, device="cpu")) == _norm(
            jmt.MerkleTree.authentication_structure_from_leafs(leafs, indices))


TAMPERS = ["none", "leaf", "auth node", "height up", "height down",
           "drop auth node", "extra auth node", "leaf index", "empty"]


def _tampered(m, name):
    """An inclusion proof over a height-6 tree, tampered as ``name``."""
    leafs = np.arange(64 * 5, dtype=np.uint64).reshape(64, 5) * 7919
    tree = _new(m, leafs)
    proof = tree.inclusion_proof_for_leaf_indices([1, 17, 17, 40, 63])
    leafs_, auth = list(proof.indexed_leafs), list(proof.authentication_structure)
    height = proof.tree_height
    bump = lambda d: m.Digest([d.values()[0] + m.bfe(1)] + list(d.values())[1:])  # noqa: E731
    if name == "leaf":
        leafs_[2] = (leafs_[2][0], bump(leafs_[2][1]))
    elif name == "auth node":
        auth[3] = bump(auth[3])
    elif name == "height up":
        height += 1
    elif name == "height down":
        height -= 1
    elif name == "drop auth node":
        auth = auth[:-1]
    elif name == "extra auth node":
        auth = auth + [auth[0]]
    elif name == "leaf index":
        leafs_[0] = (64, leafs_[0][1])
    elif name == "empty":
        leafs_, auth = [], []
    return tree.root(), m.mt.MerkleTreeInclusionProof(height, leafs_, auth)


@pytest.mark.parametrize("name", TAMPERS)
def test_verify_and_try_verify_match_jax(name):
    def case(m):
        root, proof = _tampered(m, name)
        try:
            proof.try_verify(root, **m.kw)
            raised = None
        except m.Error as e:
            raised = str(e)
        return [proof.verify(root, **m.kw), raised, proof.is_trivial(),
                proof.leaf_indices()]

    want, got = _both(case)
    assert got == want
    assert got[0] is (name in ("none", "empty"))


def test_into_authentication_paths_match_jax():
    def case(m):
        _, proof = _tampered(m, "none")
        return proof.into_authentication_paths(**m.kw)

    want, got = _both(case)
    assert got == want and len(got) == 5


def test_merkle_level_out_on_cpu():
    tables = tip5_tables("cpu")
    children = gf.from_u64(_leafs(16))
    want = tip5_cuda.merkle_level_plain(children, False, *tables)
    nodes = torch.zeros((16, 5), dtype=torch.int64)
    for lo in (8, 1):  # an even row and an odd one
        dst = nodes[lo: lo + 8]
        got = tip5_cuda.merkle_level(children, False, *tables, out=dst)
        assert got.data_ptr() == dst.data_ptr() and torch.equal(dst, want)
    with pytest.raises(ValueError):
        tip5_cuda.merkle_level(children, False, *tables, out=nodes[:7])
    with pytest.raises(ValueError):
        tip5_cuda.merkle_level(children, False, *tables,
                               out=nodes[:8].to(torch.int32))
    with pytest.raises(ValueError):  # strided: every other row
        tip5_cuda.merkle_level(children, False, *tables, out=nodes[::2])


# --- the host route below HOST_MERKLE_MAX_LEAFS ---------------------------


def _count_routes(monkeypatch) -> dict:
    """Counts of the host route's native calls and of K2's twin levels."""
    counts = {"host": 0, "twin": 0}

    def counted(fn, key):
        def wrapper(*args, **kwargs):
            counts[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in ("tip5_hash_pairs", "tip5_merkle_root"):
        monkeypatch.setattr(native, name, counted(getattr(native, name),
                                                  "host"))
    monkeypatch.setattr(tip5_cuda, "merkle_level_plain",
                        counted(tip5_cuda.merkle_level_plain, "twin"))
    return counts


@pytest.mark.parametrize("log_cut", [3, 5])
@pytest.mark.parametrize("form", ["array", "digests"])
def test_host_route_at_and_around_the_cut(log_cut, form, monkeypatch):
    """Host leafs at and below the cut take the native core, above it K2's
    twin; either way the tree, its frugal root and the authentication
    structure from the leafs equal JAX's and the twin's over the same
    leafs as a tensor, and the nodes lie on the named device."""
    monkeypatch.setattr(tmt, "HOST_MERKLE_MAX_LEAFS", 1 << log_cut)
    counts = _count_routes(monkeypatch)
    for n in (1 << (log_cut - 1), 1 << log_cut, 1 << (log_cut + 1)):
        leafs = _leafs(n)
        given = leafs if form == "array" else [
            tdigest.Digest.from_array(r) for r in leafs]
        indices = [0, n // 2, n - 1]
        jtree = jmt.MerkleTree.new(leafs)
        twin = tmt.MerkleTree.new(gf.from_u64(leafs))
        counts.update(host=0, twin=0)
        tree = tmt.MerkleTree.new(given, device="cpu")
        root = tmt.MerkleTree.frugal_root(given, device="cpu")
        auth = tmt.MerkleTree.authentication_structure_from_leafs(
            given, indices, device="cpu")
        host = n <= 1 << log_cut
        assert (counts["host"] > 0, counts["twin"] > 0) == (host, not host)
        assert tree._nodes.device.type == "cpu"
        np.testing.assert_array_equal(tree.node_array(), jtree.node_array())
        assert tree == twin
        assert _norm(root) == _norm(jtree.root()) == _norm(twin.root())
        assert _norm(auth) == _norm(jtree.authentication_structure(indices))


@pytest.mark.parametrize("form", ["array", "digests"])
def test_host_leafs_without_the_native_core(form, monkeypatch):
    """Without the native core, host leafs below the cut go to the named
    device and take K2's twin there; the tree, its frugal root and the
    authentication structure from the leafs still equal JAX's."""
    monkeypatch.setattr(native, "_load", lambda: None)  # no core
    counts = _count_routes(monkeypatch)
    for n in (1, 2, 16):
        assert n <= tmt.HOST_MERKLE_MAX_LEAFS
        leafs = _leafs(n)
        given = leafs if form == "array" else [
            tdigest.Digest.from_array(r) for r in leafs]
        indices = [0, n - 1]
        jtree = jmt.MerkleTree.new(leafs)
        tree = tmt.MerkleTree.new(given, device="cpu")
        root = tmt.MerkleTree.frugal_root(given, device="cpu")
        auth = tmt.MerkleTree.authentication_structure_from_leafs(
            given, indices, device="cpu")
        assert tree._nodes.device.type == "cpu"
        np.testing.assert_array_equal(tree.node_array(), jtree.node_array())
        assert _norm(root) == _norm(jtree.root())
        assert _norm(auth) == _norm(jtree.authentication_structure(indices))
    assert counts["host"] == 0 and counts["twin"] > 0


def test_tensor_leafs_never_leave_their_device(monkeypatch):
    """A CPU tensor of leafs, below the cut too, is reduced by K2's twin on
    its device: the host route is never taken."""
    counts = _count_routes(monkeypatch)
    for n in (1, 2, 16):
        leafs = _leafs(n)
        t = gf.from_u64(leafs)
        tree = tmt.MerkleTree.new(t, device="cuda")  # the tensor's device wins
        root = tmt.MerkleTree.frugal_root(t, device="cuda")
        auth = tmt.MerkleTree.authentication_structure_from_leafs(
            t, [0], device="cuda")
        assert tree._nodes.device.type == "cpu"
        np.testing.assert_array_equal(tree.node_array(),
                                      jmt.MerkleTree.new(leafs).node_array())
        assert _norm(root) == _norm(tree.root())
        assert _norm(auth) == _norm(tree.authentication_structure([0]))
    assert counts["host"] == 0 and counts["twin"] > 0


def test_host_route_nodes_go_to_the_named_device():
    """The host route hashes on the host, then places the nodes on the
    named device: the card by default, which raises on a machine without
    one (the route never looks for a card)."""
    leafs = _leafs(4)
    assert tmt.HOST_MERKLE_MAX_LEAFS >= 4
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            tmt.MerkleTree.new(leafs)
    assert tmt.MerkleTree.new(leafs, device="cpu")._nodes.device.type == "cpu"


def test_host_cut_reads_the_jax_environment_variable():
    import subprocess
    import sys
    from pathlib import Path

    code = ("from twenty_first_tpu_torch.util_types import merkle_tree\n"
            "print(merkle_tree.HOST_MERKLE_MAX_LEAFS)\n")
    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=repo, capture_output=True,
        text=True, timeout=300,
        env={"PYTHONPATH": str(repo),
             "TWENTY_FIRST_TPU_HOST_MERKLE_MAX_LEAFS": "123"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "123"


# --- the fixed cases of tests/test_merkle_parity.py, through both packages ---


def _tree_of_height(m, h):
    leafs = [m.Tip5.hash_varlen([m.bfe(i)]) for i in range(1 << h)]
    return _new(m, leafs), leafs


def _parity_empty_list(m):
    with pytest.raises(m.Error):
        _new(m, [])


def _parity_one_leaf(m):
    leaf = m.Tip5.hash_varlen([m.bfe(7)])
    tree = _new(m, [leaf])
    assert (tree.height(), tree.num_leafs(), tree.root()) == (0, 1, leaf)
    return tree.root()


def _parity_auth_paths(expect, h):
    def case(m):
        tree, _ = _tree_of_height(m, h)
        out = {}
        for leaf_index, node_indices in expect.items():
            path = tree.authentication_structure([leaf_index])
            assert path == [tree.node(i) for i in node_indices]
            out[leaf_index] = path
        return out
    return case


def _parity_duplicate_leafs(m):
    tree, _ = _tree_of_height(m, 3)
    proof = tree.inclusion_proof_for_leaf_indices([2, 2, 5])
    assert proof.verify(tree.root(), **m.kw)
    return proof.authentication_structure


def _parity_incorrect_height(m):
    tree, _ = _tree_of_height(m, 3)
    proof = tree.inclusion_proof_for_leaf_indices([2])
    bad = m.mt.MerkleTreeInclusionProof(
        tree_height=4, indexed_leafs=proof.indexed_leafs,
        authentication_structure=proof.authentication_structure)
    verdicts = [bad.verify(tree.root(), **m.kw)]
    bad.tree_height = 2
    verdicts.append(bad.verify(tree.root(), **m.kw))
    assert verdicts == [False, False]


def _parity_all_leafs(m):
    tree, _ = _tree_of_height(m, 3)
    proof = tree.inclusion_proof_for_leaf_indices(list(range(8)))
    assert proof.authentication_structure == []
    assert proof.verify(tree.root(), **m.kw)


def _parity_removed_leafs(m):
    tree, _ = _tree_of_height(m, 3)
    proof = tree.inclusion_proof_for_leaf_indices([1, 4])
    pruned = m.mt.MerkleTreeInclusionProof(
        tree_height=proof.tree_height, indexed_leafs=proof.indexed_leafs[:1],
        authentication_structure=proof.authentication_structure)
    assert not pruned.verify(tree.root(), **m.kw)


def _parity_items_not_in_set(m):
    tree, _ = _tree_of_height(m, 3)
    proof = tree.inclusion_proof_for_leaf_indices([1, 4])
    forged = m.mt.MerkleTreeInclusionProof(
        tree_height=proof.tree_height,
        indexed_leafs=[(proof.indexed_leafs[0][0],
                        m.Tip5.hash_varlen([m.bfe(999)])),
                       proof.indexed_leafs[1]],
        authentication_structure=proof.authentication_structure)
    assert not forged.verify(tree.root(), **m.kw)


def _parity_partial_nodes(m):
    tree, _ = _tree_of_height(m, 3)
    partial = m.mt.PartialMerkleTree.from_proof(
        tree.inclusion_proof_for_leaf_indices([0, 2]), **m.kw)
    assert sorted(partial.nodes) == [1, 2, 3, 4, 5, 8, 9, 10, 11]
    return partial.nodes


def _parity_partial_bad(present, message):
    def case(m):
        dummy = {i: m.Digest([i, 0, 0, 0, 0]) for i in present}
        with pytest.raises(m.Error, match=message):
            m.mt.PartialMerkleTree(3, [0, 2], dummy, **m.kw).fill()
    return case


def _parity_manual_partial(m):
    tree, _ = _tree_of_height(m, 3)
    partial = m.mt.PartialMerkleTree(3, [0, 2], {i: tree.node(i) for i in
                                                 (3, 8, 9, 10, 11)},
                                      **m.kw)
    partial.fill()
    assert partial.root() == tree.root()
    return partial.nodes


def _parity_into_paths(m):
    tree, _ = _tree_of_height(m, 3)
    paths = tree.inclusion_proof_for_leaf_indices([0, 2]) \
        .into_authentication_paths(**m.kw)
    assert paths[0] == [tree.node(9), tree.node(5), tree.node(3)]
    assert paths[1] == [tree.node(11), tree.node(4), tree.node(3)]
    return paths


def _parity_each_leaf(m):
    tree, leafs = _tree_of_height(m, 3)
    for i, leaf in enumerate(leafs):
        proof = tree.inclusion_proof_for_leaf_indices([i])
        assert proof.verify(tree.root(), **m.kw)
        assert proof.indexed_leafs == [(i, leaf)]
    return tree.root()


def _parity_cutoff(m):
    leafs = [m.Tip5.hash_varlen([m.bfe(i)]) for i in range(16)]
    baseline = _new(m, leafs).root()
    old = m.config.merkle_tree_parallelization_cutoff()
    try:
        for cutoff in (2, 4, 512):
            m.config.set_merkle_tree_parallelization_cutoff(cutoff)
            assert _new(m, leafs).root() == baseline
    finally:
        m.config.set_merkle_tree_parallelization_cutoff(old)
    return baseline


def _parity_doc_example(m):
    assert m.mt.MerkleTree.authentication_structure_node_indices(
        8, [0, 2]) == [11, 9, 3]


PARITY = {
    "empty_list_fails": _parity_empty_list,
    "one_leaf": _parity_one_leaf,
    "auth_paths_extremely_small": _parity_auth_paths(
        {0: [5, 3], 1: [4, 3], 2: [7, 2], 3: [6, 2]}, 2),
    "auth_paths_very_small": _parity_auth_paths(
        {0: [9, 5, 3], 3: [10, 4, 3], 7: [14, 6, 2]}, 3),
    "duplicate_leafs": _parity_duplicate_leafs,
    "incorrect_height": _parity_incorrect_height,
    "all_leafs_revealed": _parity_all_leafs,
    "removed_leafs": _parity_removed_leafs,
    "items_not_in_set": _parity_items_not_in_set,
    "partial_tree_nodes": _parity_partial_nodes,
    "partial_missing_node": _parity_partial_bad((8, 9, 10, 11),
                                                "missing node index 3"),
    "partial_redundant_node": _parity_partial_bad((2, 3, 8, 9, 10, 11),
                                                  "spurious node index 2"),
    "manual_partial_fill": _parity_manual_partial,
    "into_authentication_paths": _parity_into_paths,
    "each_leaf_individually": _parity_each_leaf,
    "independent_of_cutoff": _parity_cutoff,
    "doc_example_indices": _parity_doc_example,
}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_merkle_parity_table_through_both_packages(name):
    want, got = _both(PARITY[name])
    assert got == want
