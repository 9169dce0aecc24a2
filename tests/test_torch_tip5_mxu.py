"""The port's ops/tip5_mxu.py against the JAX package's, exactly, on the
CPU: ``permutation``, ``permutation_dense`` and ``permutation_values`` (K9's
plain twin here), the byte-plane MDS alone on words of any u64, and the
circulant's byte blocks. A numpy model of K9's warp (csrc/tip5_mma.cu: the
byte permutes, the B fragments, the mma fragment layouts of the PTX ISA)
holds the kernel's data layout against the exact MDS.

JAX's ``permutation`` is jitted (about 5 s a shape here), so every JAX
value comes from one module fixture at one batch."""

import numpy as np
import pytest
import torch

from twenty_first_tpu.math import gf as jgf
from twenty_first_tpu.math.b_field_element import P
from twenty_first_tpu.ops import tip5_mxu as jmxu
from twenty_first_tpu_torch.math import gf
from twenty_first_tpu_torch.ops import tip5_mxu
from twenty_first_tpu_torch.tip5 import permutation as tperm
from twenty_first_tpu_torch.tip5.constants import MDS_MATRIX_FIRST_COLUMN
from twenty_first_tpu_torch.tip5.permutation import tip5_tables

#: canonical words at the edges: 0, p - 1, and words whose bytes are all
#: 0xFF below p (p - 2 = 0xFFFFFFFE_FFFFFFFF, 2^32 - 1, one 0xFF byte)
EDGE_WORDS = [0, 1, P - 1, P - 2, (1 << 32) - 1, 1 << 32,
              *(0xFF << (8 * k) for k in range(8))]


def _edge_states() -> np.ndarray:
    rows = [[w] * 16 for w in (0, P - 1, P - 2, (1 << 32) - 1)]
    rows += [[EDGE_WORDS[(i + w) % len(EDGE_WORDS)] for w in range(16)]
             for i in range(12)]
    return np.array(rows, dtype=np.uint64)


@pytest.fixture(scope="module")
def jax_values():
    """80 states (64 seeded random, 16 at the edges) and JAX's tip5_mxu
    outputs: permutation_values, permutation's limb planes, and
    permutation_dense on the lane-dense planes."""
    states = np.concatenate([
        np.random.default_rng(14).integers(0, P, size=(64, 16),
                                           dtype=np.uint64),
        _edge_states()])
    lo, hi = jgf.to_limbs(states)
    dlo, dhi = jmxu._interleave(lo), jmxu._interleave(hi)
    dense = jmxu.permutation_dense((dlo, dhi))
    return {"states": states, "values": jmxu.permutation_values(states),
            "limbs": tuple(np.asarray(v) for v in jmxu.permutation(lo, hi)),
            "dense_in": (np.asarray(dlo), np.asarray(dhi)),
            "dense": tuple(np.asarray(v) for v in dense)}


def _planes(arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def test_permutation_values_equals_jax(jax_values):
    got = tip5_mxu.permutation_values(jax_values["states"], device="cpu")
    np.testing.assert_array_equal(got, jax_values["values"])
    np.testing.assert_array_equal(
        tip5_mxu.permutation_values(jax_values["states"], device="cpu",
                                    plain=True), jax_values["values"])


def test_permutation_limb_planes_equal_jax(jax_values):
    lo, hi = gf.to_limbs(jax_values["states"], device="cpu")
    got = tip5_mxu.permutation(lo, hi)
    assert all(v.dtype == torch.uint32 for v in got)
    for g, w in zip(got, jax_values["limbs"]):
        np.testing.assert_array_equal(g.numpy(), w)


def test_permutation_dense_equals_jax(jax_values):
    got = tip5_mxu.permutation_dense(_planes(jax_values["dense_in"]))
    assert got[0].shape == (10, 128)
    for g, w in zip(got, jax_values["dense"]):
        np.testing.assert_array_equal(g.numpy(), w)


def test_the_lane_interleave_is_jaxs():
    x = np.arange(16 * 16, dtype=np.uint32).reshape(16, 16)
    dense = tip5_mxu._interleave(torch.from_numpy(x))
    np.testing.assert_array_equal(dense.numpy(),
                                  np.asarray(jmxu._interleave(x)))
    np.testing.assert_array_equal(tip5_mxu._deinterleave(dense).numpy(), x)


@pytest.mark.parametrize("batch", [1, 15, 16, 17, 37])
def test_any_batch_equals_the_k1_twin(batch):
    """K9 takes any B (a warp's 16 states masked at the tail), and its
    twin equals K1's twin."""
    states = np.random.default_rng(batch).integers(0, P, size=(batch, 16),
                                                   dtype=np.uint64)
    np.testing.assert_array_equal(
        tip5_mxu.permutation_values(states, device="cpu"),
        tperm.permutation_values(states, device="cpu"))


def test_mds_alone_equals_jax_on_words_of_any_u64():
    """mds_bytes against _mds_mxu on non-canonical words: above p, 2^64 - 1
    (every byte 0xFF), p, and random u64."""
    x = np.random.default_rng(5).integers(0, 1 << 64, size=(32, 16),
                                          dtype=np.uint64, endpoint=False)
    x[0] = (1 << 64) - 1
    x[1] = P
    x[2, ::2] = (1 << 64) - 1
    x[3] = np.array([P + k for k in range(16)], dtype=np.uint64)
    lo = (x & np.uint64(0xFFFF_FFFF)).astype(np.uint32)
    hi = (x >> np.uint64(32)).astype(np.uint32)
    jlo, jhi = jmxu._mds_mxu(jmxu._interleave(lo), jmxu._interleave(hi))
    want = (np.asarray(jmxu._deinterleave(jlo)).astype(np.uint64)
            | (np.asarray(jmxu._deinterleave(jhi)).astype(np.uint64)
               << np.uint64(32)))
    got = gf.to_u64(tip5_mxu.mds_bytes(gf.from_u64(x)))
    np.testing.assert_array_equal(got, want)
    assert (got < np.uint64(P)).all()


def test_byte_blocks_are_jaxs_deinterleaved():
    """_M_LO/_M_HI are 128 x 128 with M[w*8 + s, w'*8 + s'] = byte(C[w, w'])
    when s == s' and 0 elsewhere: de-interleaved, the port's blocks."""
    for e, big in enumerate((jmxu._M_LO, jmxu._M_HI)):
        m = np.asarray(big).astype(np.float32).reshape(16, 8, 16, 8)
        for s in range(8):
            np.testing.assert_array_equal(m[:, s, :, s],
                                          tip5_mxu.MDS_BYTE_BLOCKS[e])
        off = m.copy()
        for s in range(8):
            off[:, s, :, s] = 0
        assert not off.any()
    col = MDS_MATRIX_FIRST_COLUMN.astype(np.int64)
    blocks = tip5_mxu.MDS_BYTE_BLOCKS
    assert blocks.max() <= 255
    np.testing.assert_array_equal(blocks[0, 0] + 256 * blocks[1, 0], col)


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    rc, lut = tip5_tables("cpu")
    states = gf.from_u64(np.random.default_rng(3).integers(
        0, P, size=(20, 16), dtype=np.uint64))
    before = tip5_mxu.tip5_permute_mma.launches
    got = tip5_mxu.tip5_permute_mma(states, rc, lut)
    assert tip5_mxu.tip5_permute_mma.launches == before
    assert torch.equal(got, tip5_mxu.tip5_permute_mma_plain(states, rc, lut))
    assert torch.equal(got, tperm.permutation_plain(states, rc, lut))
    with pytest.raises(ValueError):
        tip5_mxu.tip5_permute_mma(states[:, :15].contiguous(), rc, lut)


# ---------------------------------------------------------------------------
# A numpy model of K9's warp: 16 states, 32 lanes, 18 mma a round
# ---------------------------------------------------------------------------


def _byte_perm(x: int, y: int, sel: int) -> int:
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the 8 bytes y:x."""
    pool = x | (y << 32)
    return sum(((pool >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def _byte_planes(w: list) -> list:
    """tip5_mma.cu's byte_planes: p[k] byte j = byte k of w[j]."""
    t0, t1 = _byte_perm(w[0], w[1], 0x5140), _byte_perm(w[0], w[1], 0x7362)
    t2, t3 = _byte_perm(w[2], w[3], 0x5140), _byte_perm(w[2], w[3], 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def _b_fragment(e: int, g: int, t: int, n: int) -> int:
    """tip5_mma.cu's b_fragment."""
    col = [int(c) for c in MDS_MATRIX_FIRST_COLUMN]
    out = (g >> 1) + 4 * (2 * n + (g & 1))
    return sum(((col[(out - t - 4 * j) & 15] >> (8 * e)) & 0xFF) << (8 * j)
               for j in range(4))


def _mma_m16n8k32(a_regs: list, b_regs: list) -> list:
    """mma.sync.m16n8k32.row.col.s32.u8.u8.s32 with a zero C, through the
    fragment layouts of the PTX ISA: lane (g, t) holds A's bytes i = 0..15
    (four to a register) at row g (i < 4 or 8 <= i < 12) or g + 8, column
    4t + (i & 3) (+ 16 for i >= 8); B's bytes i = 0..7 at row 4t + (i & 3)
    (+ 16 for i >= 4), column g; D's c0..c3 at row g (i < 2) or g + 8,
    column 2t + (i & 1)."""
    a = np.zeros((16, 32), dtype=np.int64)
    b = np.zeros((32, 8), dtype=np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(16):
            row = g if (i < 4 or 8 <= i < 12) else g + 8
            a[row, 4 * t + (i & 3) + (16 if i >= 8 else 0)] = (
                a_regs[lane][i >> 2] >> (8 * (i & 3))) & 0xFF
        for i in range(8):
            b[4 * t + (i & 3) + (16 if i >= 4 else 0), g] = (
                b_regs[lane][i >> 2] >> (8 * (i & 3))) & 0xFF
    d = a @ b
    assert d.max() < 1 << 31
    return [[int(d[(lane >> 2) + 8 * (i >> 1), 2 * (lane & 3) + (i & 1)])
             for i in range(4)] for lane in range(32)]


def _k9_mds(x: np.ndarray) -> np.ndarray:
    """One warp's MDS as tip5_mma.cu's mds_mma computes it (round constant
    0): (16, 16) words of any u64 -> the exact integer sums, by state and
    word, from each lane's h sums."""
    words = [[int(v) for v in row] for row in x]
    s = {lane: [[words[(lane >> 2) + 8 * q][(lane & 3) + 4 * j]
                 for j in range(4)] for q in range(2)] for lane in range(32)}
    plane = {}
    for lane in range(32):
        plane[lane] = [[0, 0] for _ in range(8)]
        for q in range(2):
            lo = _byte_planes([w & 0xFFFF_FFFF for w in s[lane][q]])
            hi = _byte_planes([w >> 32 for w in s[lane][q]])
            for k in range(4):
                plane[lane][k][q], plane[lane][4 + k][q] = lo[k], hi[k]
    h = {lane: [[[0] * 4 for _ in range(2)] for _ in range(5)]
         for lane in range(32)}
    for sh in range(9):
        a_regs = [[plane[lane][sh - 1][0] if sh > 0 else 0,
                   plane[lane][sh - 1][1] if sh > 0 else 0,
                   plane[lane][sh][0] if sh < 8 else 0,
                   plane[lane][sh][1] if sh < 8 else 0] for lane in range(32)]
        for n in range(2):
            b_regs = [[_b_fragment(1, lane >> 2, lane & 3, n),
                       _b_fragment(0, lane >> 2, lane & 3, n)]
                      for lane in range(32)]
            d = _mma_m16n8k32(a_regs, b_regs)
            for lane in range(32):
                for i in range(4):
                    q, j = i >> 1, 2 * n + (i & 1)
                    cell = h[lane][sh >> 1][q]
                    cell[j] = cell[j] + (d[lane][i] << 8) if sh & 1 \
                        else d[lane][i]
                    assert cell[j] < 1 << 30
    out = np.zeros((16, 16), dtype=object)
    for lane in range(32):
        for q in range(2):
            for j in range(4):
                hs = [h[lane][u][q][j] for u in range(5)]
                lo = hs[0] + (hs[1] << 16)
                hi = hs[2] + (hs[3] << 16) + (hs[4] << 32)
                assert lo < 1 << 47 and hi < 1 << 54
                out[(lane >> 2) + 8 * q, (lane & 3) + 4 * j] = lo + (hi << 32)
    return out


def test_k9_warp_model_gives_the_exact_mds():
    """The warp model's sums are the circulant's exact integer sums,
    sum_j col[(i - j) mod 16] x[j], for words of any u64."""
    rng = np.random.default_rng(9)
    x = rng.integers(0, 1 << 64, size=(16, 16), dtype=np.uint64,
                     endpoint=False)
    x[0] = (1 << 64) - 1
    x[9] = 0
    col = [int(c) for c in MDS_MATRIX_FIRST_COLUMN]
    want = [[sum(col[(i - j) % 16] * int(row[j]) for j in range(16))
             for i in range(16)] for row in x]
    assert _k9_mds(x).tolist() == want
