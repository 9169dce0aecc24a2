"""The port's ops/tip5_mxu.py against the JAX package's, exactly, on the
CPU: ``permutation``, ``permutation_dense`` and ``permutation_values`` (K9's
plain twin here), the byte-plane MDS alone on words of any u64, and the
circulant's byte blocks. A model of K9's warp (csrc/tip5_mma.cu: the
byte permutes, the B fragments, the k16 and k32 mma fragment layouts of the
PTX ISA, the round constant in the accumulators, the 32-bit regroup carry
by carry) holds the kernel's data layout and bounds against the exact MDS
on words of any u64, and a model of its lazy x^7 against x^7 mod p.

JAX's ``permutation`` is jitted (about 5 s a shape here), so every JAX
value comes from one module fixture at one batch."""

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu.math import gf as jgf
from twenty_first_tpu.math.b_field_element import P
from twenty_first_tpu.ops import tip5_mxu as jmxu
from twenty_first_tpu_torch.math import gf
from twenty_first_tpu_torch.ops import tip5_mxu
from twenty_first_tpu_torch.tip5 import permutation as tperm
from twenty_first_tpu_torch.tip5.constants import (LOOKUP_TABLE,
                                                   MDS_MATRIX_FIRST_COLUMN)
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
# A model of K9's warp (csrc/tip5_mma.cu): 32 states as two tiles of 16
# sharing B's fragments, 32 lanes, 24 mma a tile and round; the round
# constant in the even shifts' accumulators, the 32-bit regroup carry by
# carry, the lookup's bytes by one byte permute, and x^7 on lazy residues
# with one-fix products
# ---------------------------------------------------------------------------

M32 = 0xFFFF_FFFF
#: words of any u64 where the bounds bite: p - 1, p and above it, every
#: byte 0xFF (2^64 - 1), a half of 0xFF bytes, 2^32 - 1, a top byte
LAZY_EDGES = [0, 1, P - 1, P, P + 1, (1 << 64) - 1, M32 << 32, M32,
              (1 << 32) + 1, 0xFF << 56, 0x8000_0000_8000_0000]


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


def _mma(a_regs: list, b_regs: list, c_regs: list | None = None) -> list:
    """mma.sync.m16n8k16 (two A registers, one B) or m16n8k32 (four, two)
    .row.col.s32.u8.u8.s32 through the PTX ISA's fragment layouts: lane
    (g, t) holds A's register r (four bytes i) at row g + 8 (r & 1), column
    16 (r >> 1) + 4t + i; B's register r at row 16 r + 4t + i, column g;
    C's and D's c0..c3 at row g + 8 (i >> 1), column 2t + (i & 1)."""
    k = 16 * len(b_regs[0])
    assert len(a_regs[0]) == k // 8
    a = np.zeros((16, k), dtype=np.int64)
    b = np.zeros((k, 8), dtype=np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for r, reg in enumerate(a_regs[lane]):
            for i in range(4):
                a[g + 8 * (r & 1), 16 * (r >> 1) + 4 * t + i] = \
                    (reg >> (8 * i)) & 0xFF
        for r, reg in enumerate(b_regs[lane]):
            for i in range(4):
                b[16 * r + 4 * t + i, g] = (reg >> (8 * i)) & 0xFF
    d = a @ b
    out = [[int(d[(lane >> 2) + 8 * (i >> 1), 2 * (lane & 3) + (i & 1)])
            + (c_regs[lane][i] if c_regs else 0) for i in range(4)]
           for lane in range(32)]
    assert max(max(v) for v in out) < 1 << 31  # the s32 accumulators
    return out


def _rc_quad(rc: list, t: int, n: int, u: int) -> list:
    """The accumulator of even shift 2u, n-tile n, lane t: 16-bit piece u
    of the constants of D's cells (words t + 8n and t + 8n + 4, rows g and
    g + 8), as the kernel loads it."""
    x, y = ((rc[t + 8 * n + 4 * c] >> (16 * u)) & 0xFFFF for c in (0, 1))
    return [x, y, x, y]


def _add_cc(x: int, y: int, c: int = 0) -> tuple[int, int]:
    """add.cc / addc.cc: the 32-bit sum and its carry."""
    s = x + y + c
    return s & M32, s >> 32


def _regroup(h0: int, h1: int, h2: int, h3: int, s8: int) -> int:
    """tip5_mma.cu's regroup, carry by carry: v = (v2, v1, v0) =
    h0 + 2^16 h1 + 2^32 h2 + 2^48 h3 + 2^64 s8 by two carries, then
    (v1, v0) + v2 (2^32 - 1) with its one wrap folded back."""
    assert max(h0, h1, h2, h3) < 1 << 30 and s8 < 1 << 21
    v0, c = _add_cc(h0, (h1 << 16) & M32)
    v1 = h2 + (h1 >> 16) + c  # addc.u32: no carry out
    assert v1 <= M32
    v1, c = _add_cc(v1, (h3 << 16) & M32)
    v2 = s8 + (h3 >> 16) + c
    assert v2 < 1 << 21
    m0, m1 = (-v2) & M32, v2 - (v2 != 0)  # m = v2 2^32 - v2
    v0, c = _add_cc(v0, m0)
    v1, k = _add_cc(v1, m1, c)
    r0, c = _add_cc(v0, (-k) & M32)
    r1, c = _add_cc(v1, 0, c)
    assert c == 0, "the fold wrapped twice"
    return r0 | (r1 << 32)


def _k9_mds(x: np.ndarray, rc: list) -> np.ndarray:
    """One warp's MDS plus the round constant as tip5_mma.cu's mds_mma
    computes it, tile by tile: (32, 16) words of any u64 -> lazy words, by
    state and word. Lane (g, t) holds slots t + 4j of states g + 8q, q =
    0..3; tile m takes q = 2m, 2m + 1 as its rows g, g + 8 and the same B
    fragments. a[u] are the A quads of plane pairs (planes 2u, 2u + 1; rows
    g, g + 8): odd shift 2u + 1 is one k32 product with [C1; C0], even
    shift 2u two chained k16 (plane 2u - 1 by C1 from the constant's piece
    u, then plane 2u by C0), shift 8 one k16."""
    words = [[int(v) for v in row] for row in x]
    out = np.zeros((32, 16), dtype=object)
    for m in range(2):
        _k9_tile_mds(words[16 * m:16 * m + 16], rc, out[16 * m:16 * m + 16])
    return out


def _k9_tile_mds(words: list, rc: list, out: np.ndarray) -> None:
    """``_k9_mds`` of one tile's 16 states, into ``out``."""
    a = {}
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        a[lane] = [[0] * 4 for _ in range(4)]
        for q in range(2):
            s = [words[g + 8 * q][t + 4 * j] for j in range(4)]
            lo = _byte_planes([w & M32 for w in s])
            hi = _byte_planes([w >> 32 for w in s])
            for k in range(4):
                a[lane][k >> 1][2 * (k & 1) + q] = lo[k]
                a[lane][2 + (k >> 1)][2 * (k & 1) + q] = hi[k]
    for n in range(2):
        c1 = [[_b_fragment(1, ln >> 2, ln & 3, n)] for ln in range(32)]
        c0 = [[_b_fragment(0, ln >> 2, ln & 3, n)] for ln in range(32)]
        h = []
        for u in range(4):
            acc = [_rc_quad(rc, ln & 3, n, u) for ln in range(32)]
            if u:
                acc = _mma([a[ln][u - 1][2:] for ln in range(32)], c1, acc)
            e = _mma([a[ln][u][:2] for ln in range(32)], c0, acc)
            o = _mma([a[ln][u] for ln in range(32)],
                     [c1[ln] + c0[ln] for ln in range(32)])
            h.append([[e[ln][i] + (o[ln][i] << 8) for i in range(4)]
                      for ln in range(32)])
        s8 = _mma([a[ln][3][2:] for ln in range(32)], c1)
        for ln in range(32):
            for i in range(4):
                state = (ln >> 2) + 8 * (i >> 1)
                word = (ln & 3) + 4 * (2 * n + (i & 1))
                out[state, word] = _regroup(
                    *(h[u][ln][i] for u in range(4)), s8[ln][i])


def _mds_plus_rc(x: np.ndarray, rc: list) -> list:
    col = [int(c) for c in MDS_MATRIX_FIRST_COLUMN]
    return [[(sum(col[(i - j) % 16] * int(row[j]) for j in range(16))
              + rc[i]) % P for i in range(16)] for row in x]


def _check_lazy(got: np.ndarray, want: list) -> None:
    assert all(0 <= int(v) < 1 << 64 for v in got.reshape(-1))
    assert [[int(v) % P for v in row] for row in got] == want


def test_k9_warp_model_gives_the_exact_mds():
    """The warp model's words are residues of the circulant's exact sums
    plus the round constant, sum_j col[(i - j) mod 16] x[j] + rc[i], for
    words of any u64."""
    rng = np.random.default_rng(9)
    x = rng.integers(0, 1 << 64, size=(32, 16), dtype=np.uint64,
                     endpoint=False)
    x[0] = x[25] = (1 << 64) - 1
    x[9] = x[16] = 0
    x[3] = x[30] = np.array([LAZY_EDGES[i % len(LAZY_EDGES)]
                             for i in range(16)], dtype=np.uint64)
    rc = [int(v) for v in rng.integers(0, P, size=16, dtype=np.uint64)]
    _check_lazy(_k9_mds(x, rc), _mds_plus_rc(x, rc))


@pytest.mark.parametrize("word", LAZY_EDGES)
def test_k9_warp_model_on_edge_words(word):
    """Every word of every state the same edge word, with the largest
    constants (p - 1) and with none: the shift sums, the accumulators and
    the regroup stay inside their bounds (the model asserts them)."""
    x = np.full((32, 16), word, dtype=np.uint64)
    for rc in ([P - 1] * 16, [0] * 16):
        _check_lazy(_k9_mds(x, rc), _mds_plus_rc(x, rc))


def test_k9_regroup_bounds():
    """The largest sums the mma can give (16 taps of 255 x 255 a k16 block,
    plus a 16-bit piece of the constant) keep h below 2^30 and shift 8
    below 2^21; the regroup at those bounds and at zero is exact mod p."""
    tap = 16 * 255 * 255
    e_max, o_max = 2 * tap + 0xFFFF, 2 * tap
    h_max = e_max + (o_max << 8)
    assert h_max < 1 << 30 and tap < 1 << 21
    for h in ((h_max,) * 4, (0,) * 4, (h_max, 0, h_max, 0), (0, h_max, 0,
                                                             h_max)):
        for s8 in (0, tap):
            v = h[0] + (h[1] << 16) + (h[2] << 32) + (h[3] << 48) + (s8 << 64)
            assert _regroup(*h, s8) % P == v % P


def test_k9_round_constant_quads_rebuild_the_constants():
    rc = [int(v) for v in np.random.default_rng(2).integers(
        0, P, size=16, dtype=np.uint64)]
    rc[0], rc[5] = P - 1, M32 << 32
    for t in range(4):
        for n in range(2):
            quads = [_rc_quad(rc, t, n, u) for u in range(4)]
            for i in range(4):
                word = t + 4 * (2 * n + (i & 1))
                assert sum(q[i] << (16 * u) for u, q in enumerate(quads)) \
                    == rc[word]


def _lookup_model(x: int) -> int:
    """tip5_mma.cu's sbox_lookup_k9 on a word of any u64: its canonical
    Montgomery form (x 2^64 mod p), each byte of each half taken out by
    one byte permute (selector 0x4440 + k: byte k, zero-extended), looked
    up, and the result out of Montgomery form (mod p)."""
    m = x % P * (1 << 64) % P
    out = 0
    for half in range(2):
        w = (m >> (32 * half)) & M32
        for k in range(4):
            byte = _byte_perm(w, 0, 0x4440 + k)
            assert byte == (w >> (8 * k)) & 0xFF
            out |= int(LOOKUP_TABLE[byte]) << (32 * half + 8 * k)
    return out * pow(1 << 64, -1, P) % P


@pytest.mark.parametrize("word", LAZY_EDGES)
def test_k9_lookup_bytes_by_one_byte_permute(word):
    """The lookup's bytes by one byte permute give the package's S-box
    lookup (``_split_and_lookup``, K1's) on words of any u64, beside a
    seeded random word."""
    rng = np.random.default_rng(word % 1000)
    words = [word, int(rng.integers(0, 1 << 64, dtype=np.uint64))]
    want = tperm._split_and_lookup(
        gf.from_u64(np.array([w % P for w in words], dtype=np.uint64)),
        tip5_tables("cpu")[1])
    assert [_lookup_model(w) for w in words] == \
        [int(v) % P for v in gf.to_u64(want).tolist()]


def _one_fix(p0: int, p1: int, p2: int, p3: int) -> int:
    """tip5_mma.cu's one-fix reduction of a 128-bit product (p3, p2, p1,
    p0) (gl::sqr_red's): V = (p1, p0) + p2 2^32 - (p2 + p3) in (-2^33,
    2^65), r = V mod 2^64, d = carry - borrow, r + d (2^32 - 1) without a
    second wrap."""
    t1, c = _add_cc(p1, p2)
    q = p2 + p3
    lo = p0 | (t1 << 32)
    r = (lo - q) % (1 << 64)
    d = c - (lo < q)
    fixed = r + d * M32
    assert 0 <= fixed < 1 << 64, "the fix-up wrapped"
    return fixed


def _product_words(a: int, b: int) -> tuple:
    p = a * b
    return tuple((p >> (32 * i)) & M32 for i in range(4))


def _pow7_model(x: int) -> int:
    """K9's x^7 on a lazy residue: x^2 squared and multiplied by x side by
    side (x^4, x^3), then x^4 x^3, each product one-fix reduced."""
    x2 = _one_fix(*_product_words(x, x))
    x3 = _one_fix(*_product_words(x2, x))
    x4 = _one_fix(*_product_words(x2, x2))
    return _one_fix(*_product_words(x4, x3))


@pytest.mark.parametrize("word", LAZY_EDGES)
def test_k9_lazy_pow7_canonicalises_to_x7(word):
    """On the edge words and on random u64: the lazy x^7 is a u64 whose
    canonical form (one subtraction of p) is x^7 mod p."""
    rng = np.random.default_rng(word % 1000)
    for x in (word, *(int(v) for v in rng.integers(
            0, 1 << 64, size=8, dtype=np.uint64, endpoint=False))):
        got = _pow7_model(x)
        assert 0 <= got < 1 << 64
        assert (got - P if got >= P else got) == pow(x, 7, P)


def test_k9_one_fix_products_on_edge_pairs():
    """Every pair of edge words: a residue of the product, never wrapped
    (p3 and p2 at their largest, V negative and above 2^64)."""
    for a in LAZY_EDGES:
        for b in LAZY_EDGES:
            assert _one_fix(*_product_words(a, b)) % P == a * b % P
