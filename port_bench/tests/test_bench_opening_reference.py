"""The reference of the query phase (reference/opening.py): its structure
indices and its verifier on trees of 4 and 8 leafs worked out by hand,
its Fiat-Shamir sampling against the port's scalar sponge, and the whole
answer of ``operations/table_open.py`` against the port on the CPU at
small sizes."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import generator
import harness
from reference import goldilocks as gl
from reference import opening
from reference.tip5 import Tip5

SPEC = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json")
                  .read_text())
CELL = "table_open.r17_l16384_q80"

#: leaf indices opened -> the nodes revealed, largest first, by hand:
#: 4 leafs are nodes 4..7 under 2 and 3; 8 leafs are nodes 8..15
BY_HAND = {
    (4, (0,)): [5, 3], (4, (1,)): [4, 3], (4, (3,)): [6, 2],
    (4, (0, 1)): [3], (4, (0, 3)): [6, 5], (4, (1, 1)): [4, 3],
    (4, (0, 1, 2, 3)): [],
    (8, (0,)): [9, 5, 3], (8, (3,)): [10, 4, 3], (8, (7,)): [14, 6, 2],
    (8, (0, 2)): [11, 9, 3], (8, (5, 4)): [7, 2], (8, (1, 6)): [15, 8, 6, 5],
}


@pytest.fixture(scope="module")
def tip5():
    return Tip5("cpu")


@pytest.mark.parametrize("n,indices", sorted(BY_HAND))
def test_structure_indices_by_hand(n, indices):
    assert opening.structure_indices(n, indices) == BY_HAND[(n, indices)]


def _leafs(n: int, seed: int) -> torch.Tensor:
    return gl.random_elements((n, 5), torch.Generator().manual_seed(seed), "cpu")


@pytest.mark.parametrize("indices", [(0,), (2,), (1, 3), (0, 1, 2, 3), (3, 3)])
def test_verifier_on_four_leafs_by_hand(tip5, indices):
    leafs = _leafs(4, 4)
    left, right = tip5.hash_pairs(leafs)  # nodes 2 and 3
    root = tip5.hash_pairs(torch.stack([left, right]))[0]
    nodes = {1: root, 2: left, 3: right, **{4 + i: leafs[i] for i in range(4)}}
    structure = torch.stack([nodes[i] for i in
                             opening.structure_indices(4, indices)] or
                            [torch.zeros(0, 5, dtype=torch.int64)]).reshape(-1, 5)
    opened = [(i, leafs[i]) for i in indices]
    assert opening.verify(tip5, 2, opened, structure, root)
    other = leafs[(indices[0] + 1) % 4]
    assert not opening.verify(tip5, 2, [(indices[0], other)] + opened[1:],
                              structure, root)
    assert not opening.verify(tip5, 3, opened, structure, root)
    assert not opening.verify(tip5, 2, opened + [(4, leafs[0])], structure, root)
    if structure.shape[0]:
        forged = structure.clone()
        forged[-1, 4] = gl.add(forged[-1, 4], gl.scalar(1, forged))
        assert not opening.verify(tip5, 2, opened, forged, root)
        assert not opening.verify(tip5, 2, opened, structure[1:], root)


def test_verifier_on_eight_leafs_by_hand(tip5):
    leafs = _leafs(8, 8)
    nodes = tip5.merkle_nodes(leafs)
    level1 = tip5.hash_pairs(leafs)
    level2 = tip5.hash_pairs(level1)
    assert torch.equal(nodes[1], tip5.hash_pairs(level2)[0])
    opened = [(0, leafs[0]), (2, leafs[2])]
    structure = torch.stack([leafs[3], leafs[1], level2[1]])  # nodes 11, 9, 3
    assert opening.verify(tip5, 3, opened, structure, nodes[1])
    assert not opening.verify(tip5, 3, opened, structure[[1, 0, 2]], nodes[1])
    twice = opened + [(2, leafs[3])]  # index 2 with a second digest
    assert not opening.verify(tip5, 3, twice, structure, nodes[1])
    assert not opening.verify(tip5, 63, opened, structure, nodes[1])


@pytest.mark.parametrize("seed", [1, 2**31 + 7, 2**40 + 9])
def test_sampling_matches_the_port(tip5, seed):
    from twenty_first_tpu_torch.tip5.tip5 import Tip5 as PortTip5

    root = _leafs(1, seed)[0]
    for upper, count in ((1 << 17, 80), (1 << 3, 23), (1, 5)):
        sponge = PortTip5.init()
        sponge.pad_and_absorb_all([int(v) for v in gl.to_u64(root)])
        assert opening.sample_indices(tip5, root, upper, count) == \
            sponge.sample_indices(upper, count)


@pytest.mark.parametrize("log_rows,columns", [(3, 9), (6, 25)])
def test_the_answer_is_the_ports_on_the_cpu(tip5, log_rows, columns):
    cell = harness.Cell(SPEC, CELL)
    config = dict(cell.config, log_rows=log_rows, columns=columns)
    cell = harness.Cell(SPEC, CELL, config=config, mix={"pool": 2})
    op = cell.operation.Operation(cell.config, cell.mix, "cpu")
    pool = generator.make_pool(op.shape, cell.mix, 2**33 + log_rows, "cpu")
    got = [op.run(table)[0] for table in pool]
    want = [a for a, _ in cell.operation.reference(cell.config, pool, tip5)]
    for g, w in zip(got, want):
        assert np.array_equal(g, w) and g[:2].tolist() == [1, 0]
        assert len(g) > 2 + config["queries"]
