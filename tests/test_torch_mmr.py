"""The port's MMR (``util_types/mmr/``) against the JAX package's, exactly,
on inputs made with numpy: peaks on both sides of the parallelization
cutoff, ``bag_peaks``, appends, leaf mutations, membership and successor
proofs, the archival MMR. Every case runs through both packages; the fixed
tables of ``tests/test_mmr_parity.py`` among them."""

from types import SimpleNamespace

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu import config as jconfig
from twenty_first_tpu.math import b_field_element as jb
from twenty_first_tpu.tip5 import digest as jdigest
from twenty_first_tpu.tip5 import tip5 as jtip5
from twenty_first_tpu.util_types import mmr as jmmr
from twenty_first_tpu.util_types.mmr import mmr_accumulator as jacc
from twenty_first_tpu_torch import config as tconfig
from twenty_first_tpu_torch.math import b_field_element as tb
from twenty_first_tpu_torch.math import gf
from twenty_first_tpu_torch.tip5 import digest as tdigest
from twenty_first_tpu_torch.tip5 import tip5 as ttip5
from twenty_first_tpu_torch.util_types import mmr as tmmr
from twenty_first_tpu_torch.util_types.mmr import mmr_accumulator as tacc

P = jb.P
JAX = SimpleNamespace(mmr=jmmr, acc=jacc, Digest=jdigest.Digest,
                      Tip5=jtip5.Tip5, bfe=jb.bfe, config=jconfig, kw={})
PORT = SimpleNamespace(mmr=tmmr, acc=tacc, Digest=tdigest.Digest,
                       Tip5=ttip5.Tip5, bfe=tb.bfe, config=tconfig,
                       kw={"device": "cpu"})


def _words(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, P, size=(n, 5),
                                                dtype=np.uint64)


def _digests(m, seed: int, n: int) -> list:
    return [m.Digest.from_array(row) for row in _words(seed, n)]


def _norm(x):
    """A result of either package as plain python data."""
    if isinstance(x, (jdigest.Digest, tdigest.Digest)):
        return tuple(v.value() for v in x.values())
    if isinstance(x, (jmmr.MmrMembershipProof, tmmr.MmrMembershipProof)):
        return ("mp", _norm(x.authentication_path))
    if isinstance(x, (jmmr.MmrSuccessorProof, tmmr.MmrSuccessorProof)):
        return ("sp", _norm(x.paths))
    if isinstance(x, (jmmr.MmrAccumulator, tmmr.MmrAccumulator)):
        return ("acc", x.num_leafs(), _norm(x.peaks()))
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _both(case, *args):
    """case(package, *args) through both packages: (JAX's, the port's)."""
    return _norm(case(JAX, *args)), _norm(case(PORT, *args))


def _acc(m, leafs):
    return m.mmr.MmrAccumulator.new_from_leafs(leafs, **m.kw)


# --- peaks from leafs -----------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 8, 11, 32, 57, 511, 512, 513,
                               1200])
def test_accumulator_from_leafs_matches_jax(n):
    """Both sides of the cutoff (512): the host sweep below it, the batched
    peaks (the plain twins of K2 on the CPU) from it up."""
    def case(m):
        acc = _acc(m, _digests(m, n, n))
        return [acc, acc.bag_peaks(), acc.is_empty(), acc.is_consistent()]

    want, got = _both(case)
    assert got == want


@pytest.mark.parametrize("n", [57, 1200])
def test_leaf_forms_give_the_same_peaks(n):
    words = _words(n, n)
    want = _norm(jmmr.MmrAccumulator.new_from_leafs(words))
    for leafs in (words, gf.from_u64(words), _digests(PORT, n, n)):
        got = tmmr.MmrAccumulator.new_from_leafs(leafs, device="cpu")
        assert _norm(got) == want
    assert _norm(tmmr.MmrAccumulator.peaks_from_leafs(
        words, device="cpu", plain=True)) == want[2]


def test_batched_peaks_equal_the_host_sweep(monkeypatch):
    leafs = _digests(PORT, 5, 1200)
    batched = tmmr.MmrAccumulator.peaks_from_leafs(leafs, device="cpu")
    monkeypatch.setattr(tconfig, "_cutoff", 10 ** 9)
    assert tmmr.MmrAccumulator.peaks_from_leafs(leafs, device="cpu") == batched


@pytest.mark.parametrize("form", ["tensor", "numpy", "digests"])
def test_peaks_below_the_cutoff_stay_on_the_named_device(monkeypatch, form):
    """Below the cutoff a tensor is still reduced in batches on its own
    device, one launch plan a peak; only host leafs reduced on the CPU take
    the scalar sweep."""
    n = 57  # peaks of heights 5, 4, 3 and 0
    words = _words(n, n)
    leafs = {"tensor": gf.from_u64(words), "numpy": words,
             "digests": _digests(PORT, n, n)}[form]
    heights, real = [], tacc.tip5_commit.reduce_layers

    def spy(digests, height, **kw):
        heights.append(height)
        return real(digests, height, **kw)

    monkeypatch.setattr(tacc.tip5_commit, "reduce_layers", spy)
    got = tmmr.MmrAccumulator.peaks_from_leafs(leafs, device="cpu")
    assert _norm(got) == _norm(jmmr.MmrAccumulator.peaks_from_leafs(words))
    assert heights == ([5, 4, 3, 0] if form == "tensor" else [])


# --- the accumulator's updates ----------------------------------------------------


def test_appends_match_jax():
    def case(m):
        acc, arch = _acc(m, []), m.mmr.ArchivalMmr()
        out = []
        for i, leaf in enumerate(_digests(m, 6, 20)):
            mp = acc.append(leaf)
            assert mp == arch.append(leaf)
            assert mp.verify(i, leaf, acc.peaks(), acc.num_leafs())
            out += [mp, acc.peaks()]
        return out

    want, got = _both(case)
    assert got == want


def test_mutate_leaf_matches_jax():
    def case(m):
        leafs = _digests(m, 7, 13)
        acc, arch = _acc(m, leafs), m.mmr.ArchivalMmr(leafs)
        out = []
        for target, leaf in zip([0, 5, 12], _digests(m, 8, 3)):
            mutation = m.mmr.LeafMutation(target, leaf,
                                          arch.prove_membership(target))
            out.append(mutation.affected_node_indices())
            acc.mutate_leaf(mutation)
            arch.mutate_leaf(mutation)
            assert acc.peaks() == arch.peaks()
            out.append(acc.peaks())
        return out

    want, got = _both(case)
    assert got == want


def _mutations(m, leafs, targets, seed):
    arch = m.mmr.ArchivalMmr(leafs)
    return [m.mmr.LeafMutation(t, d, arch.prove_membership(t))
            for t, d in zip(targets, _digests(m, seed, len(targets)))]


@pytest.mark.parametrize("archival", [False, True])
def test_batch_mutate_leaf_and_update_mps_matches_jax(archival):
    def case(m):
        leafs = _digests(m, 9, 19)
        mmr = (m.mmr.ArchivalMmr(leafs) if archival else _acc(m, leafs))
        arch = m.mmr.ArchivalMmr(leafs)
        tracked_indices = [0, 5, 7, 18]
        tracked = [arch.prove_membership(i) for i in tracked_indices]
        mutations = _mutations(m, leafs, [2, 7, 16], 10)
        modified = mmr.batch_mutate_leaf_and_update_mps(
            tracked, tracked_indices, list(mutations))
        for mu in mutations:
            leafs[mu.leaf_index] = mu.new_leaf
        for mp, i in zip(tracked, tracked_indices):
            assert mp.verify(i, leafs[i], mmr.peaks(), 19)
        return [modified, tracked, mmr.peaks(), mmr.bag_peaks()]

    want, got = _both(case)
    assert got == want


def test_verify_batch_update_matches_jax():
    def case(m):
        leafs, appended = _digests(m, 11, 10), _digests(m, 12, 3)
        acc = _acc(m, leafs)
        mutation, = _mutations(m, leafs, [4], 13)
        leafs2 = list(leafs)
        leafs2[4] = mutation.new_leaf
        new2 = _acc(m, leafs2 + appended)
        dup, = _mutations(m, leafs, [4], 14)
        return [acc.verify_batch_update(_acc(m, leafs + appended).peaks(),
                                        appended, []),
                acc.verify_batch_update(new2.peaks(), appended, [mutation]),
                acc.verify_batch_update(acc.peaks(), appended, []),
                acc.verify_batch_update(new2.peaks(), [], [mutation, dup]),
                m.mmr.ArchivalMmr(leafs).verify_batch_update(
                    new2.peaks(), appended, [mutation])]

    want, got = _both(case)
    assert got == want == [True, True, False, False, True]


# --- membership proofs ------------------------------------------------------------


def test_membership_proof_updates_from_appends_match_jax():
    def case(m):
        n = 11
        leafs, new_leaf = _digests(m, 15, n), _digests(m, 16, 1)[0]
        arch = m.mmr.ArchivalMmr(leafs)
        single = [arch.prove_membership(i) for i in range(n)]
        batch = [arch.prove_membership(i) for i in range(n)]
        old_peaks = arch.peaks()
        arch.append(new_leaf)
        changed = [mp.update_from_append(i, n, new_leaf, old_peaks)
                   for i, mp in enumerate(single)]
        modified = m.mmr.MmrMembershipProof.batch_update_from_append(
            batch, list(range(n)), n, new_leaf, old_peaks)
        for i in range(n):
            assert single[i].verify(i, leafs[i], arch.peaks(), n + 1)
        assert single == batch
        return [changed, modified, single,
                [mp.get_node_indices(i) for i, mp in enumerate(single)],
                [mp.get_peak_index_and_height(i) for i, mp in enumerate(single)]]

    want, got = _both(case)
    assert got == want


def test_membership_proof_updates_from_mutations_match_jax():
    def case(m):
        n = 14
        leafs = _digests(m, 17, n)
        arch = m.mmr.ArchivalMmr(leafs)
        mutation, = _mutations(m, leafs, [3], 18)
        single = [arch.prove_membership(i) for i in range(n)]
        batch = [mp.clone() for mp in single]
        multi = [mp.clone() for mp in single]
        others = _mutations(m, leafs, [9], 19)
        changed = [mp.update_from_leaf_mutation(i, mutation)
                   for i, mp in enumerate(single) if i != 3]
        modified = m.mmr.MmrMembershipProof.batch_update_from_leaf_mutation(
            batch, list(range(n)), mutation)
        modified_multi = \
            m.mmr.MmrMembershipProof.batch_update_from_batch_leaf_mutation(
                multi, list(range(n)), [mutation] + others)
        return [changed, modified, modified_multi, single, batch, multi]

    want, got = _both(case)
    assert got == want


def test_archival_mmr_matches_jax():
    def case(m):
        leafs = _digests(m, 20, 23)
        arch = m.mmr.ArchivalMmr.new_from_leafs(leafs)
        proofs = [arch.prove_membership(i) for i in range(23)]
        verdicts = [mp.verify(i, leafs[i], arch.peaks(), 23)
                    for i, mp in enumerate(proofs)]
        wrong = [mp.verify((i + 1) % 23, leafs[i], arch.peaks(), 23)
                 for i, mp in enumerate(proofs)]
        return [arch.num_leafs(), arch.num_nodes(), arch.is_empty(),
                arch.peaks(), arch.get_peaks_with_heights(),
                arch.get_digest(17), arch.get_leaf(22), arch.bag_peaks(),
                arch.to_accumulator(), proofs, verdicts, wrong]

    want, got = _both(case)
    assert got == want


@pytest.mark.parametrize("leaf_count,specified", [
    (1, [0]), (2, [0, 1]), (13, [0, 12, 7]), (1 << 10, [3, 1000, 511]),
    (37, [])])
def test_mmra_with_mps_matches_jax(leaf_count, specified):
    def case(m):
        leafs = _digests(m, 21, len(specified))
        acc, mps = m.acc.mmra_with_mps(
            leaf_count, list(zip(specified, leafs)),
            rng=np.random.default_rng(22))
        for i, leaf, mp in zip(specified, leafs, mps):
            assert mp.verify(i, leaf, acc.peaks(), leaf_count)
        return [acc, mps, repr(acc)]

    want, got = _both(case)
    assert got == want


# --- successor proofs ------------------------------------------------------


@pytest.mark.parametrize("old_n,appended_n", [
    (0, 0), (0, 3), (1, 1), (4, 4), (5, 3), (6, 2), (10, 22), (11, 1), (3, 1),
    (600, 70)])
def test_successor_proofs_match_jax(old_n, appended_n):
    def case(m):
        old_leafs = _digests(m, 23, old_n)
        new_leafs = _digests(m, 24, appended_n)
        old = _acc(m, old_leafs)
        new = _acc(m, old_leafs + new_leafs)
        proof = m.mmr.MmrSuccessorProof.new_from_batch_append(
            old, new_leafs, **m.kw)
        other = _acc(m, _digests(m, 25, old_n + appended_n))
        return [proof, proof.verify(old, new), proof.verify(old, other),
                proof.verify(new, old),
                m.mmr.MmrSuccessorProof([]).verify(old, old)]

    want, got = _both(case)
    assert got == want
    assert got[1] is True


def test_successor_proofs_without_the_native_core(monkeypatch):
    """The small trees over host leafs that a successor proof builds take
    the device route when the native core is not loaded, with JAX's
    values."""
    from twenty_first_tpu_torch import native
    monkeypatch.setattr(native, "_load", lambda: None)  # no core
    for old_n, appended_n in ((4, 4), (10, 22), (600, 70)):
        words_old, words_new = _words(28, old_n), _words(29, appended_n)
        old = tmmr.MmrAccumulator.new_from_leafs(words_old, device="cpu")
        new = tmmr.MmrAccumulator.new_from_leafs(
            np.concatenate([words_old, words_new]), device="cpu")
        proof = tmmr.MmrSuccessorProof.new_from_batch_append(
            old, [tdigest.Digest.from_array(r) for r in words_new],
            device="cpu")
        assert proof.verify(old, new)
        want = jmmr.MmrSuccessorProof.new_from_batch_append(
            jmmr.MmrAccumulator.new_from_leafs(words_old),
            [jdigest.Digest.from_array(r) for r in words_new])
        assert _norm(proof) == _norm(want)


def test_successor_proof_takes_leaf_tensors():
    words_old, words_new = _words(26, 21), _words(27, 40)
    old = tmmr.MmrAccumulator.new_from_leafs(words_old, device="cpu")
    new = tmmr.MmrAccumulator.new_from_leafs(
        np.concatenate([words_old, words_new]), device="cpu")
    for leafs in (words_new, gf.from_u64(words_new)):
        proof = tmmr.MmrSuccessorProof.new_from_batch_append(old, leafs,
                                                             device="cpu")
        assert proof.verify(old, new)
        want = jmmr.MmrSuccessorProof.new_from_batch_append(
            jmmr.MmrAccumulator.new_from_leafs(words_old),
            [jdigest.Digest.from_array(r) for r in words_new])
        assert _norm(proof) == _norm(want)


# --- index math ------------------------------------------------------------


INDEX_FNS = {
    "leaf_index_to_node_index": lambda m, i: m.mmr.shared_advanced
    .leaf_index_to_node_index(i),
    "node_index_to_leaf_index": lambda m, i: m.mmr.shared_advanced
    .node_index_to_leaf_index(i + 1),
    "right_lineage_and_height": lambda m, i: m.mmr.shared_advanced
    .right_lineage_length_and_own_height(i + 1),
    "right_lineage_from_node": lambda m, i: m.mmr.shared_advanced
    .right_lineage_length_from_node_index(i + 1),
    "parent": lambda m, i: m.mmr.shared_advanced.parent(i + 1),
    "num_leafs_to_num_nodes": lambda m, i: m.mmr.shared_advanced
    .num_leafs_to_num_nodes(i),
    "node_indices_added_by_append": lambda m, i: m.mmr.shared_advanced
    .node_indices_added_by_append(i),
    "peak_heights_and_indices": lambda m, i: m.mmr.shared_advanced
    .get_peak_heights_and_peak_node_indices(i),
    "auth_path_node_indices": lambda m, i: [
        m.mmr.shared_advanced.auth_path_node_indices(i + 1, j)
        for j in range(0, i + 1, 7)],
    "mt_index_and_peak_index": lambda m, i: [
        m.mmr.shared_basic.leaf_index_to_mt_index_and_peak_index(j, i + 1)
        for j in range(0, i + 1, 5)],
    "right_lineage_from_leaf": lambda m, i: m.mmr.shared_basic
    .right_lineage_length_from_leaf_index(i),
    "authentication_path_node_indices": lambda m, i: m.mmr.shared_advanced
    .get_authentication_path_node_indices(i + 1, 63, 200),
}


@pytest.mark.parametrize("name", sorted(INDEX_FNS))
def test_index_math_matches_jax(name):
    want, got = _both(lambda m: [INDEX_FNS[name](m, i) for i in range(150)])
    assert got == want


# --- the fixed tables of tests/test_mmr_parity.py, through both packages ------


def _sa(m):
    return m.mmr.shared_advanced


def _parity_mt_index_table(m):
    f = m.mmr.shared_basic.leaf_index_to_mt_index_and_peak_index
    assert f(0, 1) == (1, 0)
    assert f(0, 2) == (2, 0) and f(1, 2) == (3, 0)
    assert f(0, 3) == (2, 0) and f(1, 3) == (3, 0) and f(2, 3) == (1, 1)
    assert [f(i, 4) for i in range(4)] == [(4, 0), (5, 0), (6, 0), (7, 0)]
    assert [f(i, 14) for i in range(8)] == [(8 + i, 0) for i in range(8)]
    assert [f(8 + i, 14) for i in range(4)] == [(4 + i, 1) for i in range(4)]
    assert f(0, 23) == (16, 0) and f(15, 23) == (31, 0)
    assert f(16, 23) == (4, 1) and f(19, 23) == (7, 1)
    assert f(20, 23) == (2, 2)


def _parity_added_by_append(m):
    expected = {0: [1], 1: [2, 3], 2: [4], 3: [5, 6, 7], 4: [8],
                5: [9, 10], 6: [11], 7: [12, 13, 14, 15], 8: [16],
                9: [17, 18], 10: [19], 11: [20, 21, 22], 12: [23],
                13: [24, 25], 14: [26], 15: [27, 28, 29, 30, 31],
                16: [32], 17: [33, 34], 18: [35], 19: [36, 37, 38],
                31: [58, 59, 60, 61, 62, 63], 32: [64]}
    for old_count, want in expected.items():
        assert _sa(m).node_indices_added_by_append(old_count) == want


def _parity_leftmost_ancestor(m):
    for node, want in [(1, (1, 0)), (2, (3, 1)), (3, (3, 1)), (4, (7, 2)),
                       (7, (7, 2)), (8, (15, 3)), (15, (15, 3)),
                       (16, (31, 4))]:
        assert _sa(m).leftmost_ancestor(node) == want


def _parity_left_sibling(m):
    ls = _sa(m).left_sibling
    assert [ls(6, 1), ls(2, 0), ls(5, 0), ls(30, 3), ls(29, 2),
            ls(14, 2)] == [3, 1, 4, 15, 22, 7]


def _parity_node_to_leaf(m):
    expected = {1: 0, 2: 1, 3: None, 4: 2, 5: 3, 6: None, 7: None,
                8: 4, 9: 5, 10: None, 11: 6, 12: 7, 13: None, 14: None,
                15: None, 16: 8, 17: 9, 18: None, 19: 10, 20: 11,
                21: None, 22: None}
    for node, want in expected.items():
        assert _sa(m).node_index_to_leaf_index(node) == want


def _parity_leaf_to_node_count(m):
    counts = [0, 1, 3, 4, 7, 8, 10, 11, 15, 16, 18, 19, 22, 23, 25, 26, 31,
              32, 34, 35, 38, 39, 41, 42, 46, 47, 49, 50, 53, 54, 56, 57,
              63, 64]
    assert [_sa(m).num_leafs_to_num_nodes(i) for i in range(34)] == counts


def _parity_peak_heights(m):
    expected = [
        (0, ([], [])), (1, ([0], [1])), (2, ([1], [3])),
        (3, ([1, 0], [3, 4])), (4, ([2], [7])), (5, ([2, 0], [7, 8])),
        (6, ([2, 1], [7, 10])), (7, ([2, 1, 0], [7, 10, 11])),
        (8, ([3], [15])), (9, ([3, 0], [15, 16])),
        (10, ([3, 1], [15, 18])), (11, ([3, 1, 0], [15, 18, 19])),
        (12, ([3, 2], [15, 22])), (13, ([3, 2, 0], [15, 22, 23])),
        (14, ([3, 2, 1], [15, 22, 25])),
        (15, ([3, 2, 1, 0], [15, 22, 25, 26])),
        (16, ([4], [31])), (17, ([4, 0], [31, 32])),
        (18, ([4, 1], [31, 34])), (19, ([4, 1, 0], [31, 34, 35]))]
    for leaf_count, (heights, indices) in expected:
        assert _sa(m).get_peak_heights_and_peak_node_indices(leaf_count) == \
            (heights, indices)
        assert _sa(m).get_peak_heights(leaf_count) == heights


def _parity_auth_path_indices(m):
    f = _sa(m).auth_path_node_indices
    expected_16 = [
        [2, 6, 14, 30], [1, 6, 14, 30], [5, 3, 14, 30], [4, 3, 14, 30],
        [9, 13, 7, 30], [8, 13, 7, 30], [12, 10, 7, 30], [11, 10, 7, 30],
        [17, 21, 29, 15], [16, 21, 29, 15], [20, 18, 29, 15],
        [19, 18, 29, 15], [24, 28, 22, 15], [23, 28, 22, 15],
        [27, 25, 22, 15], [26, 25, 22, 15]]
    assert [f(16, i) for i in range(16)] == expected_16
    assert (f(1, 0), f(2, 0), f(2, 1)) == ([], [2], [1])
    expected = []
    for i in range(1, 20):
        expected.append((1 << (i + 1)) - 2)
        assert f(1 << i, 0) == expected


def _parity_bag_peaks_empty(m):
    bagged = _acc(m, []).bag_peaks()
    assert bagged.to_hex() == (
        "cd65052100640f0d27e5654f97c47e49899add2f265967ccbefee7264e9"
        "bc08f588542d9dc3d5ac5")
    return bagged


def _parity_leafs(m, n, start=0):
    return [m.Tip5.hash_varlen([m.bfe(i + start)]) for i in range(n)]


def _parity_out_of_bounds(m):
    ls = _parity_leafs(m, 5)
    acc = _acc(m, ls)
    proof = m.mmr.ArchivalMmr.new_from_leafs(ls).prove_membership(0)
    assert not proof.verify(5, ls[0], acc.peaks(), 5)
    assert not proof.verify(1 << 40, ls[0], acc.peaks(), 5)


def _parity_wrong_peak_list(m):
    ls = _parity_leafs(m, 5)
    peaks = _acc(m, ls).peaks()
    proof = m.mmr.ArchivalMmr.new_from_leafs(ls).prove_membership(0)
    return [proof.verify(0, ls[0], peaks, 5),
            proof.verify(0, ls[0], peaks[:-1], 5),
            proof.verify(0, ls[0], peaks + [peaks[0]], 5),
            proof.verify(0, ls[0], [], 5)]


def _parity_proof_equality(m):
    a = m.mmr.MmrMembershipProof([m.Digest([1, 2, 3, 4, 5])])
    b = m.mmr.MmrMembershipProof([m.Digest([1, 2, 3, 4, 5])])
    c = m.mmr.MmrMembershipProof([m.Digest([5, 4, 3, 2, 1])])
    assert a == b and a != c


def _parity_successor(old_n, appended_n, tamper):
    def case(m):
        old_leafs = _parity_leafs(m, old_n)
        appended = _parity_leafs(m, appended_n, start=500)
        old = _acc(m, old_leafs)
        new = _acc(m, old_leafs + appended)
        proof = m.mmr.MmrSuccessorProof.new_from_batch_append(
            old, appended, **m.kw)
        sp = m.mmr.MmrSuccessorProof
        if tamper == "none":
            return [proof.verify(old, new)]
        if tamper == "swap":
            return [proof.verify(new, old)]
        if tamper == "old peaks":
            peaks = old.peaks()
            return [proof.verify(m.mmr.MmrAccumulator.init(
                [peaks[1], peaks[0]] + peaks[2:], old.num_leafs()), new)]
        if tamper == "first new peak":
            bad = list(new.peaks())
            bad[0] = m.Digest([9, 9, 9, 9, 9])
            return [proof.verify(old, m.mmr.MmrAccumulator.init(
                bad, new.num_leafs()))]
        return [proof.verify(old, new),
                sp([m.Digest([8] * 5)] + proof.paths[1:]).verify(old, new),
                sp(proof.paths[:-1]).verify(old, new),
                sp(proof.paths + [m.Digest([7] * 5)]).verify(old, new)]
    return case


MMR_PARITY = {
    "mt_index_table": _parity_mt_index_table,
    "added_by_append_table": _parity_added_by_append,
    "leftmost_ancestor_table": _parity_leftmost_ancestor,
    "left_sibling_table": _parity_left_sibling,
    "node_to_leaf_table": _parity_node_to_leaf,
    "leaf_to_node_count_table": _parity_leaf_to_node_count,
    "peak_heights_table": _parity_peak_heights,
    "auth_path_indices_table": _parity_auth_path_indices,
    "bag_peaks_empty_snapshot": _parity_bag_peaks_empty,
    "membership_out_of_bounds": _parity_out_of_bounds,
    "membership_wrong_peak_list": _parity_wrong_peak_list,
    "membership_proof_equality": _parity_proof_equality,
    "append_nothing_to_empty": _parity_successor(0, 0, "none"),
    "append_one_to_empty": _parity_successor(0, 1, "none"),
    "append_8_to_42": _parity_successor(42, 8, "none"),
    "old_has_more_leafs": _parity_successor(10, 3, "swap"),
    "swapped_old_peaks": _parity_successor(10, 3, "old peaks"),
    "first_new_peak_swapped": _parity_successor(10, 3, "first new peak"),
    "corrupt_auth_path": _parity_successor(10, 3, "paths"),
}


@pytest.mark.parametrize("name", sorted(MMR_PARITY))
def test_mmr_parity_table_through_both_packages(name):
    want, got = _both(MMR_PARITY[name])
    assert got == want
