"""The plain reference held to values copied as literals: the program's
pinned roots of the JAX package (W = 8, expansion 4, seed 0), the
variable-length sponge's pins, the Tip5 snapshot on raw Montgomery words,
and field arithmetic against Python's integers."""

import numpy as np
import pytest
import torch

from reference import goldilocks as gl
from reference import ntt
from reference.tip5 import Tip5

P = gl.P
R, R_INV = (1 << 64) % P, pow(1 << 64, -1, P)
PINNED_ROOTS = {
    1 << 6: [7212400738294442629, 4786144134398700650, 11416967223783225047,
             9494336110101299495, 13113325513619585193],
    1 << 10: [8422239226348898290, 10027258591245203499, 3115357317289785295,
              7829678549101749663, 13746998341487405660],
}
PINNED_VARLEN = {
    10: [17699434666236764568, 3320238358685627466, 14670388502778114617,
         15124640580562242493, 13459616508061126303],
    16384: [16886452508315667902, 83234472127536013, 9722233246858496946,
            1244537966940540853, 6289475567411222966],
}
RAW_SNAPSHOT_IN = [
    0x0000_000F_FFFF_FFF0, 0x0000_0000_FFFF_FFFF, 0x0000_0000_FFFF_FFFF,
    0x0000_0028_FFFF_FFD7, 0x0000_0006_FFFF_FFF9, 0x0000_0002_FFFF_FFFD,
    0x0000_0000_FFFF_FFFF, 0x0000_0030_FFFF_FFCF, 0x0000_0397_FFFF_FC68,
    0x0000_000F_FFFF_FFF0, 0x316B_FB72_3638_2123, 0x216F_521B_66EF_83F5,
    0x5689_D7B3_63F5_2DF0, 0xEB2F_59E3_AEAE_25FC, 0xB082_99D2_77CB_B4DC,
    0xCBE3_D9FD_C534_9140,
]
RAW_SNAPSHOT_OUT5 = [
    0x15D3_8EA9_29F6_632A, 0xF988_E509_FF73_8BB4, 0x48BC_DFAE_88A2_E9F3,
    0x8733_9E83_2DAA_C02A, 0x511E_4126_8150_FDAC,
]
EDGES = [0, 1, 2, P - 2, P - 1, P, P + 1, 1 << 32, (1 << 32) - 1, 1 << 63,
         (1 << 64) - 1]


@pytest.fixture(scope="module")
def tip5():
    return Tip5("cpu")


@pytest.mark.parametrize("n", sorted(PINNED_ROOTS))
def test_pinned_roots(tip5, n):
    trace = gl.from_u64(np.random.default_rng(0).integers(
        0, P, size=(8, n), dtype=np.uint64))
    evals = ntt.coset_lde(trace, 4, gl.GENERATOR)
    leafs = tip5.hash_fixed(evals.t())
    assert gl.to_u64(tip5.merkle_root(leafs)).tolist() == PINNED_ROOTS[n]
    nodes = tip5.merkle_nodes(leafs)
    assert gl.to_u64(nodes[1]).tolist() == PINNED_ROOTS[n]
    assert not nodes[0].any()


@pytest.mark.parametrize("length", sorted(PINNED_VARLEN))
def test_pinned_varlen(tip5, length):
    x = gl.from_u64(np.random.default_rng(length).integers(
        0, P, size=length, dtype=np.uint64))[None]
    assert gl.to_u64(tip5.hash_varlen(x))[0].tolist() == PINNED_VARLEN[length]


@pytest.mark.parametrize("length", [0, 9, 10, 11, 25])
def test_varlen_of_tables_side_by_side_is_each_alone(tip5, length):
    gen = torch.Generator().manual_seed(length)
    a = gl.random_elements((3, length), gen, "cpu")
    b = gl.random_elements((5, length), gen, "cpu")
    both = tip5.hash_varlen(a, b)
    assert torch.equal(both, torch.cat([tip5.hash_varlen(a),
                                        tip5.hash_varlen(b)]))
    one = gl.to_u64(a[:1])[0].tolist() + [1]
    one += [0] * (-len(one) % 10)
    state = [0] * 16
    for c in range(0, len(one), 10):
        state = gl.to_u64(tip5.permutation(gl.from_u64(
            [one[c:c + 10] + state[10:]])))[0].tolist()
    assert gl.to_u64(both[0]).tolist() == state[:5]


def test_random_elements_in_blocks_are_canonical_and_whole():
    gen = torch.Generator().manual_seed(3)
    x = gl.random_elements((7, 100), gen, "cpu", block=64)
    u = gl.to_u64(x)
    assert (u < np.uint64(P)).all() and len(np.unique(u)) == 700


def test_raw_snapshot(tip5):
    state = gl.from_u64([[(raw * R_INV) % P for raw in RAW_SNAPSHOT_IN]])
    out = gl.to_u64(tip5.permutation(state))[0]
    assert [(int(v) * R) % P for v in out[:5]] == RAW_SNAPSHOT_OUT5


def test_field_arithmetic_matches_integers():
    rng = np.random.default_rng(7)
    words = [int(v) for v in rng.integers(0, 1 << 64, size=300,
                                          dtype=np.uint64)] + EDGES
    a = [x for x in words for _ in EDGES] + words
    b = [y for _ in words for y in EDGES] + words[::-1]
    ta, tb = gl.from_u64(a), gl.from_u64(b)
    assert gl.to_u64(gl.mul(ta, tb)).tolist() == [x * y % P
                                                  for x, y in zip(a, b)]
    assert gl.to_u64(gl.canonical(ta)).tolist() == [x % P for x in a]
    ca, cb = [x % P for x in a], [y % P for y in b]
    tca, tcb = gl.from_u64(ca), gl.from_u64(cb)
    assert gl.to_u64(gl.add(tca, tcb)).tolist() == [(x + y) % P
                                                    for x, y in zip(ca, cb)]
    assert gl.to_u64(gl.sub(tca, tcb)).tolist() == [(x - y) % P
                                                    for x, y in zip(ca, cb)]


@pytest.mark.parametrize("n", [1, 2, 4, 16, 64])
def test_ntt_is_the_transform(n):
    rng = np.random.default_rng(n)
    x = [int(v) for v in rng.integers(0, P, size=n, dtype=np.uint64)]
    w = ntt.root_of_unity(n)
    want = [sum(xj * pow(w, j * k, P) for j, xj in enumerate(x)) % P
            for k in range(n)]
    got = ntt.ntt(gl.from_u64(x))
    assert gl.to_u64(got).tolist() == want
    assert gl.to_u64(ntt.intt(got)).tolist() == x


def test_size_four_anchor():
    assert gl.to_u64(ntt.ntt(gl.from_u64([1, 4, 0, 0]))).tolist() == [
        5, 1125899906842625, 18446744069414584318, 18445618169507741698]


def test_powers_and_random_elements():
    assert gl.to_u64(gl.powers(7, 37, "cpu")).tolist() == [
        pow(7, i, P) for i in range(37)]
    draw = [gl.random_elements((3, 1000), torch.Generator().manual_seed(s),
                               "cpu") for s in (2**33 + 1, 2**33 + 1, 5)]
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])
    assert (gl.to_u64(draw[0]) < np.uint64(P)).all()


def test_float32_control_breaks_the_mds():
    """The control's MDS in float32 rounds its sums: another permutation."""
    state = gl.random_elements((64, 16), torch.Generator().manual_seed(1),
                               "cpu")
    exact = Tip5("cpu").permutation(state)
    assert not torch.equal(exact, Tip5("cpu", torch.float32).permutation(state))
