"""The port's Tip5 (constants, permutation, hash entry points) against the
JAX package's, exactly, on inputs made with numpy."""

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu.math import gf as jgf
from twenty_first_tpu.math.b_field_element import P, R, R_INV, bfe
from twenty_first_tpu.tip5 import Digest, Tip5
from twenty_first_tpu.tip5 import constants as jconst
from twenty_first_tpu.tip5 import permutation as jperm
from twenty_first_tpu_torch.math import gf
from twenty_first_tpu_torch.ops import tip5_cuda
from twenty_first_tpu_torch.tip5 import constants as tconst
from twenty_first_tpu_torch.tip5 import permutation as tperm
from twenty_first_tpu_torch.tip5.constants import RATE

RNG = np.random.default_rng(11)
EDGES = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, (1 << 32) + 1]


def _to_port(values):
    return gf.from_jax_limbs(jgf.to_limbs(np.asarray(values, dtype=np.uint64)))


def _states(batch: int):
    rnd = RNG.integers(0, P, size=(batch, 16), dtype=np.uint64)
    edge = np.array([[e] * 16 for e in EDGES]
                    + [[EDGES[(i + j) % len(EDGES)] for j in range(16)]
                       for i in range(len(EDGES))], dtype=np.uint64)
    return np.concatenate([rnd, edge])


def test_copied_constants_equal_jax():
    for name in ("STATE_SIZE", "NUM_SPLIT_AND_LOOKUP", "CAPACITY", "RATE",
                 "NUM_ROUNDS"):
        assert getattr(tconst, name) == getattr(jconst, name), name
    np.testing.assert_array_equal(tconst.LOOKUP_TABLE, jconst.LOOKUP_TABLE)
    np.testing.assert_array_equal(tconst.MDS_MATRIX_FIRST_COLUMN,
                                  jconst.MDS_MATRIX_FIRST_COLUMN)
    np.testing.assert_array_equal(tconst.ROUND_CONSTANTS,
                                  jconst.ROUND_CONSTANTS)
    assert tconst.DIGEST_LENGTH == Digest.LEN


def test_tables_hold_the_constants():
    rc, lut = tperm.tip5_tables("cpu")
    assert rc.dtype == torch.int64 and lut.dtype == torch.uint8
    np.testing.assert_array_equal(gf.to_u64(rc), jconst.ROUND_CONSTANTS)
    np.testing.assert_array_equal(lut.numpy(), jconst.LOOKUP_TABLE)


@pytest.mark.parametrize("batch", [1, 37, 256])
def test_permutation_matches_jax(batch):
    states = _states(batch)
    want = jperm.permutation_values(states)
    got = tperm.permutation(_to_port(states))
    np.testing.assert_array_equal(gf.to_u64(got), want)
    plain = tperm.permutation(_to_port(states), plain=True)
    np.testing.assert_array_equal(gf.to_u64(plain), want)


def test_permutation_keeps_leading_axes():
    states = _states(8).reshape(2, 10, 16)
    got = tperm.permutation(_to_port(states))
    assert got.shape == (2, 10, 16)
    np.testing.assert_array_equal(gf.to_u64(got),
                                  jperm.permutation_values(states))


def test_raw_state_permutation_snapshot():
    raw_in = [
        0x0000_000F_FFFF_FFF0, 0x0000_0000_FFFF_FFFF, 0x0000_0000_FFFF_FFFF,
        0x0000_0028_FFFF_FFD7, 0x0000_0006_FFFF_FFF9, 0x0000_0002_FFFF_FFFD,
        0x0000_0000_FFFF_FFFF, 0x0000_0030_FFFF_FFCF, 0x0000_0397_FFFF_FC68,
        0x0000_000F_FFFF_FFF0, 0x316B_FB72_3638_2123, 0x216F_521B_66EF_83F5,
        0x5689_D7B3_63F5_2DF0, 0xEB2F_59E3_AEAE_25FC, 0xB082_99D2_77CB_B4DC,
        0xCBE3_D9FD_C534_9140,
    ]
    raw_out5 = [
        0x15D3_8EA9_29F6_632A, 0xF988_E509_FF73_8BB4, 0x48BC_DFAE_88A2_E9F3,
        0x8733_9E83_2DAA_C02A, 0x511E_4126_8150_FDAC,
    ]
    state = gf.from_u64([[(raw * R_INV) % P for raw in raw_in]])
    out = gf.to_u64(tperm.permutation(state))[0, :5]
    assert [(int(v) * R) % P for v in out] == raw_out5


def test_hash10_chained_snapshot():
    """The reference's chained hash_10 snapshot (tests/test_tip5.py)."""
    preimage = torch.zeros(1, 10, dtype=torch.int64)
    jpre = [bfe(0)] * 10
    for i in range(6):
        digest = tperm.hash_10(preimage)
        preimage[:, i:i + 5] = digest
        jpre[i:i + 5] = Tip5.hash_10(jpre)
        np.testing.assert_array_equal(
            gf.to_u64(preimage)[0], [v.value() for v in jpre])
    final = Digest.from_array(gf.to_u64(tperm.hash_10(preimage))[0])
    assert final.to_hex() == ("109cc2fe453bd9962f754b96d8f5b919"
                              "b60af030940a275f5540da195fef65ee651c1b6fa19b2c6a")


def test_hash_10_and_hash_pair_match_jax():
    rate = RNG.integers(0, P, size=(33, 10), dtype=np.uint64)
    got = tperm.hash_10(_to_port(rate))
    want = jgf.from_limbs(jperm.hash_10(jgf.to_limbs(rate)))
    np.testing.assert_array_equal(gf.to_u64(got), want)
    left, right = rate[:, :5].copy(), rate[:, 5:].copy()
    got = tperm.hash_pair(_to_port(left), _to_port(right))
    want = jgf.from_limbs(jperm.hash_pair(jgf.to_limbs(left),
                                          jgf.to_limbs(right)))
    np.testing.assert_array_equal(gf.to_u64(got), want)


@pytest.mark.parametrize("length", [0, 1, 9, 10, 19, 64, 11, 20])
def test_varlen_hash_matches_jax(length):
    x = RNG.integers(0, P, size=(4, length), dtype=np.uint64)
    padded = tperm.pad_for_varlen(_to_port(x))
    jpadded = jperm.pad_for_varlen(jgf.to_limbs(x))
    np.testing.assert_array_equal(gf.to_u64(padded), jgf.from_limbs(jpadded))
    np.testing.assert_array_equal(tperm.pad_for_varlen(x),
                                  jgf.from_limbs(jpadded))
    got = tperm.hash_varlen_padded(padded)
    np.testing.assert_array_equal(gf.to_u64(got), jperm.hash_varlen(x))
    assert Digest.from_array(gf.to_u64(got)[0]) == Tip5.hash_varlen(
        [bfe(int(v)) for v in x[0]])
    # the absorb wrapper on a CPU tensor: the plain twin, no launch
    launches = tip5_cuda.tip5_permute.launches
    absorbed = tip5_cuda.tip5_absorb(padded, *tperm.tip5_tables("cpu"))
    assert tip5_cuda.tip5_permute.launches == launches
    np.testing.assert_array_equal(
        gf.to_u64(absorbed), jgf.from_limbs(jperm.hash_varlen_padded(jpadded)))


@pytest.mark.parametrize("rows,offset,width", [(1, 0, 10), (3, 7, 40),
                                               (5, 1, 21)])
def test_tip5_absorb_reads_row_views_of_a_wider_tensor(rows, offset, width):
    """Rows at a stride above their k * 10 words, from any word offset: the
    twin on the view equals JAX's sponge of the rows."""
    x = RNG.integers(0, P, size=(rows, 2 * RATE - 1), dtype=np.uint64)
    padded = tperm.pad_for_varlen(_to_port(x))
    wide = torch.zeros((rows, offset + 2 * RATE + width), dtype=torch.int64)
    view = wide[:, offset:offset + 2 * RATE]
    view.copy_(padded)
    assert view.stride(0) > view.shape[1] and view.stride(1) == 1
    got = tip5_cuda.tip5_absorb(view, *tperm.tip5_tables("cpu"))
    np.testing.assert_array_equal(gf.to_u64(got), jperm.hash_varlen(x))


#: the thread-a-row absorb mode's resident threads on an H100: 132 SMs x
#: 16 one-warp blocks
H100_RESIDENT = 132 * 16 * 32
#: the fewest rows that take K1's absorb mode a thread a row on an H100
H100_LANE_ROWS = 13516


@pytest.mark.parametrize("rows,lanes", [
    (0, False), (1, True), (80, True), (H100_LANE_ROWS - 1, True),
    (H100_LANE_ROWS, False), (H100_LANE_ROWS + 1, False), (1 << 17, False)])
def test_lane_mode_is_chosen_by_rows_and_resident_threads(rows, lanes):
    """K1's absorb mode spreads a row over 16 lanes below the measured
    share of the card's resident threads, and keeps a thread a row from
    there up (the table commit's 2^17 rows); without a card (0 resident
    threads) nothing takes the lane mode."""
    assert tip5_cuda.lane_mode(rows, H100_RESIDENT) is lanes
    assert tip5_cuda.lane_mode(rows, 0) is False


@pytest.mark.parametrize("rows", [1, 80])
def test_tip5_absorb_on_a_cpu_tensor_counts_no_launch(rows):
    """Row counts the lane mode takes on a card: a CPU tensor takes the
    plain twin, and neither launch counter moves."""
    x = RNG.integers(0, P, size=(rows, 2 * RATE - 1), dtype=np.uint64)
    padded = tperm.pad_for_varlen(_to_port(x))
    before = (tip5_cuda.tip5_permute.launches,
              tip5_cuda.tip5_absorb.lane_launches)
    got = tip5_cuda.tip5_absorb(padded, *tperm.tip5_tables("cpu"))
    assert (tip5_cuda.tip5_permute.launches,
            tip5_cuda.tip5_absorb.lane_launches) == before
    np.testing.assert_array_equal(gf.to_u64(got), jperm.hash_varlen(x))


@pytest.mark.parametrize("shape,transposed", [
    ((2 * RATE,), False), ((2, 3, RATE), False), ((0, RATE), False),
    ((3, 2 * RATE), True),  # a view whose words are not contiguous
])
def test_hash_varlen_padded_keeps_the_leading_dims(shape, transposed):
    x = RNG.integers(0, P, size=shape, dtype=np.uint64)
    padded = _to_port(x)
    if transposed:
        padded = padded.t().contiguous().t()
        assert padded.stride(-1) != 1
    got = tperm.hash_varlen_padded(padded)
    assert got.shape == shape[:-1] + (5,)
    if x.size:
        want = jgf.from_limbs(jperm.hash_varlen_padded(jgf.to_limbs(x)))
        np.testing.assert_array_equal(gf.to_u64(got), want)


@pytest.mark.parametrize("bad", ["width", "dtype", "stride", "dim", "rc",
                                 "lut"])
def test_tip5_absorb_rejects_bad_input(bad):
    padded = _to_port(RNG.integers(0, P, size=(4, 2 * RATE), dtype=np.uint64))
    rc, lut = tperm.tip5_tables("cpu")
    if bad == "width":
        padded = padded[:, :2 * RATE - 1].contiguous()
    elif bad == "dtype":
        padded = padded.to(torch.int32)
    elif bad == "stride":
        padded = torch.cat([padded, padded], 1)[:, ::2]
    elif bad == "dim":
        padded = padded.reshape(2, 2, 2 * RATE)
    elif bad == "rc":
        rc = rc[:79]
    else:
        lut = lut.to(torch.int64)
    with pytest.raises(ValueError):
        tip5_cuda.tip5_absorb(padded, rc, lut)


def test_tip5_permute_wrapper_on_cpu_is_the_plain_twin():
    states = _to_port(_states(16))
    rc, lut = tperm.tip5_tables("cpu")
    launches = tip5_cuda.tip5_permute.launches
    got = tip5_cuda.tip5_permute(states, rc, lut)
    assert tip5_cuda.tip5_permute.launches == launches  # no kernel on a CPU
    assert torch.equal(got, tip5_cuda.tip5_permute_plain(states, rc, lut))


@pytest.mark.parametrize("bad", ["shape", "dtype", "contiguous", "rc", "lut"])
def test_tip5_permute_rejects_bad_input(bad):
    states = _to_port(_states(4))
    rc, lut = tperm.tip5_tables("cpu")
    if bad == "shape":
        states = states[:, :15].contiguous()
    elif bad == "dtype":
        states = states.to(torch.int32)
    elif bad == "contiguous":
        states = torch.cat([states, states], 1)[:, ::2]
    elif bad == "rc":
        rc = rc[:79]
    else:
        lut = lut.to(torch.int64)
    with pytest.raises(ValueError):
        tip5_cuda.tip5_permute(states, rc, lut)
