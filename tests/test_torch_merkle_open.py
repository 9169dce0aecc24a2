"""Openings of a Merkle tree and their verification on the CPU: the port's
inclusion proofs, and its partial tree filled level by level
(``util_types/merkle_tree.py::PartialMerkleTree.fill``, K2's twin a
level), held against the JAX package's node-at-a-time host loop and
against the benchmark's plain reference verifier
(``port_bench/reference/opening.py``): verdicts, error causes and
authentication paths on seeded trees of 2^1..2^10 leafs, and one
``merkle_level`` call a level."""

import sys
from pathlib import Path

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu import errors as jerrors
from twenty_first_tpu.util_types import merkle_tree as jmt
from twenty_first_tpu_torch import errors as terrors
from twenty_first_tpu_torch.ops import tip5_cuda
from twenty_first_tpu_torch.tip5.digest import Digest
from twenty_first_tpu_torch.util_types import merkle_tree as tmt

BENCH = Path(__file__).resolve().parents[1] / "port_bench"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from reference import goldilocks as gl  # noqa: E402
from reference import opening  # noqa: E402
from reference.tip5 import Tip5 as RefTip5  # noqa: E402

P = gl.P
REF = RefTip5("cpu")
#: (tree height, indices opened): 1 to 80 indices, drawn with repeats
CASES = [(1, 1), (2, 3), (3, 80), (4, 2), (5, 7), (6, 16), (7, 80),
         (8, 33), (9, 1), (10, 80)]


def _tree(height: int, seed: int):
    leafs = np.random.default_rng(seed).integers(
        0, P, size=(1 << height, 5), dtype=np.uint64)
    return jmt.MerkleTree.new(leafs), tmt.MerkleTree.new(leafs, device="cpu")


def _indices(height: int, count: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed + 1)
    indices = [int(i) for i in rng.integers(0, 1 << height, count)]
    return indices + indices[:1] if count > 1 else indices  # a repeat


def _words(x):
    """Digests of either package, nested in lists and tuples, as words."""
    if isinstance(x, (list, tuple)):
        return [_words(v) for v in x]
    if hasattr(x, "values") and not isinstance(x, dict):
        return [v.value() for v in x.values()]
    return x


def _ref_verdict(proof, root) -> bool:
    """reference/opening.py's verdict on a port proof."""
    leafs = [(i, gl.from_u64(np.asarray(_words(d), dtype=np.uint64)))
             for i, d in proof.indexed_leafs]
    structure = gl.from_u64(np.asarray(
        _words(proof.authentication_structure), dtype=np.uint64).reshape(-1, 5))
    return opening.verify(REF, proof.tree_height, leafs, structure,
                          gl.from_u64(np.asarray(_words(root), dtype=np.uint64)))


def _outcome(proof, root, kw) -> list:
    """verify's verdict and try_verify's error message (None: accepted)."""
    try:
        proof.try_verify(root, **kw)
        raised = None
    except (jerrors.MerkleTreeError, terrors.MerkleTreeError) as err:
        raised = str(err)
    return [proof.verify(root, **kw), raised]


@pytest.mark.parametrize("height,count", CASES)
def test_level_fill_matches_jax_and_the_reference(height, count):
    jtree, tree = _tree(height, height)
    indices = _indices(height, count, height)
    jproof = jtree.inclusion_proof_for_leaf_indices(indices)
    proof = tree.inclusion_proof_for_leaf_indices(indices)
    assert _words(proof.indexed_leafs) == _words(jproof.indexed_leafs)
    assert _words(proof.authentication_structure) == _words(
        jproof.authentication_structure)
    assert opening.structure_indices(1 << height, indices) == \
        tmt.MerkleTree.authentication_structure_node_indices(1 << height,
                                                             indices)

    root = tree.root()
    want = _outcome(jproof, jtree.root(), {})
    assert want == [True, None]
    assert _outcome(proof, root, {"device": "cpu"}) == want
    assert _outcome(proof, root, {"device": "cpu", "plain": True}) == want
    assert _ref_verdict(proof, root)
    assert _words(proof.into_authentication_paths(device="cpu")) == _words(
        jproof.into_authentication_paths())
    partial = tmt.PartialMerkleTree.from_proof(proof, device="cpu")
    jpartial = jmt.PartialMerkleTree.from_proof(jproof)
    assert {k: _words(v) for k, v in partial.nodes.items()} == {
        k: _words(v) for k, v in jpartial.nodes.items()}


def _raised(d):
    """A digest of the same package with word 0 raised by 1 mod p."""
    words = list(d.values())
    return type(d)([words[0] + 1] + words[1:])


def _refused(name, tree, indices):
    """A proof of ``tree``'s leafs at ``indices`` and a root, tampered as
    ``name``."""
    proof = tree.inclusion_proof_for_leaf_indices(indices)
    leafs = list(proof.indexed_leafs)
    structure = list(proof.authentication_structure)
    height, root = proof.tree_height, tree.root()
    if name == "structure_word":
        structure[2] = _raised(structure[2])
    elif name == "leaf_word":
        leafs[1] = (leafs[1][0], _raised(leafs[1][1]))
    elif name == "wrong_root":
        root = _raised(root)
    elif name == "repeat_two_digests":
        leafs[-1] = (leafs[-1][0], _raised(leafs[-1][1]))
    elif name == "short_structure":
        structure = structure[:-1]
    elif name == "long_structure":
        structure = structure + [structure[0]]
    elif name == "index_out_of_range":
        leafs[0] = (1 << height, leafs[0][1])
    elif name == "height_over_62":
        height = 63
    return type(proof)(height, leafs, structure), root


REFUSALS = ["structure_word", "leaf_word", "wrong_root", "repeat_two_digests",
            "short_structure", "long_structure", "index_out_of_range",
            "height_over_62"]


@pytest.mark.parametrize("name", REFUSALS)
def test_refusals_match_jax_and_the_reference(name):
    jtree, tree = _tree(6, 60)
    indices = [1, 17, 40, 63, 1]  # the last repeats the first
    want = _outcome(*_refused(name, jtree, indices), {})
    proof, root = _refused(name, tree, indices)
    got = _outcome(proof, root, {"device": "cpu"})
    assert got == want and got[0] is False and got[1]
    assert not _ref_verdict(proof, root)


def test_one_merkle_level_call_a_level(monkeypatch):
    """The fill reduces each level with one ``merkle_level`` call (the
    twin's path on a CPU tensor) and counts the levels; the proof takes
    one gather and one copy."""
    _, tree = _tree(7, 70)
    indices = _indices(7, 12, 70)
    copies, widths = [], []
    real_digests, real_level = tmt._digests, tip5_cuda.merkle_level

    def digests(rows):
        copies.append(rows.shape[0])
        return real_digests(rows)

    def level(x, leaf, *args, **kwargs):
        widths.append(x.shape[0] // 2)
        return real_level(x, leaf, *args, **kwargs)

    monkeypatch.setattr(tmt, "_digests", digests)
    proof = tree.inclusion_proof_for_leaf_indices(indices)
    assert copies == [len(indices) + len(proof.authentication_structure)]
    monkeypatch.setattr(tip5_cuda, "merkle_level", level)
    before = tmt.PartialMerkleTree.fill.levels
    assert proof.verify(tree.root(), device="cpu")
    assert tmt.PartialMerkleTree.fill.levels - before == 7
    node = {128 + i for i in indices}
    for w in widths:  # each level's distinct parents
        node = {i // 2 for i in node}
        assert w == len(node)
    assert len(widths) == 7 and node == {1}


def test_a_partial_tree_by_hand_fills_on_the_cpu():
    """Nodes given by hand: the fill's results reach ``nodes``, and a
    second fill finds its parents there (spurious), as the JAX loop."""
    jtree, tree = _tree(3, 3)
    given = {i: tree.node(i) for i in (3, 8, 9, 10, 11)}
    partial = tmt.PartialMerkleTree(3, [0, 2], dict(given), device="cpu")
    partial.fill()
    assert partial.root() == tree.root()
    assert sorted(partial.nodes) == [1, 2, 3, 4, 5, 8, 9, 10, 11]
    with pytest.raises(terrors.MerkleTreeError, match="spurious node index 4"):
        partial.fill()
    jpartial = jmt.PartialMerkleTree(3, [0, 2], {
        i: jtree.node(i) for i in given})
    jpartial.fill()
    with pytest.raises(jerrors.MerkleTreeError, match="spurious node index 4"):
        jpartial.fill()
    assert isinstance(partial.node(4), Digest)
