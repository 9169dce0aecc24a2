"""The port's CUDA kernels on the card against the JAX reference (on the
CPU) and against their plain twins, exactly.

Marked ``cuda``: without a CUDA device every test skips. On a GPU machine:
    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

import chip_smoke
import test_torch_dist as tdist
from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu.math import gf as jgf
from twenty_first_tpu.math import ntt as jntt
from twenty_first_tpu.math.b_field_element import P
from twenty_first_tpu.parallel import dist_merkle
from twenty_first_tpu.tip5 import permutation as jperm
from twenty_first_tpu_torch.math import gf, ntt
from twenty_first_tpu_torch.ops import (ntt_cuda, poly_cuda, probe_cuda,
                                        tip5_batch, tip5_commit, tip5_cuda,
                                        tip5_mxu, tip5_packed)
from twenty_first_tpu_torch.parallel import pipeline
from twenty_first_tpu_torch.probes import pass_probe
from twenty_first_tpu_torch.tip5 import permutation as tperm
from twenty_first_tpu_torch.tip5.permutation import tip5_tables

pytestmark = pytest.mark.cuda
RNG = np.random.default_rng(41)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(shape):
    return RNG.integers(0, P, size=shape, dtype=np.uint64)


def test_k1_matches_jax(cuda):
    states = _rand((1000, 16))
    before = tip5_cuda.tip5_permute.launches
    got = tip5_cuda.tip5_permute(gf.from_u64(states).to(cuda),
                                 *tip5_tables(cuda))
    assert tip5_cuda.tip5_permute.launches == before + 1
    np.testing.assert_array_equal(gf.to_u64(got),
                                  jperm.permutation_values(states))


@pytest.mark.parametrize("rows,layers", [(2, 1), (96, 5), (1536, 9),
                                         (3 << 10, 10)])
def test_k2_reduce_matches_jax(cuda, rows, layers):
    dig = _rand((rows, 5))
    got = tip5_commit.reduce_layers(gf.from_u64(dig).to(cuda), layers)
    want = jgf.from_limbs(dist_merkle._reduce_layers(jgf.to_limbs(dig),
                                                     layers))
    np.testing.assert_array_equal(gf.to_u64(got), want)


def test_k2_switch_to_the_tail_matches_jax(cuda):
    """The first level below the card's resident threads: the smallest tree
    whose first level runs at full width and whose second goes fused."""
    resident = tip5_cuda.resident_threads(cuda)
    log_rows = max(resident - 1, 1).bit_length() + 1
    assert tip5_commit.plan(1 << log_rows, log_rows, resident)[:2] == [
        ("level", False), ("fused", False, 9, 256)]
    dig = _rand((1 << log_rows, 5))
    got = tip5_commit.reduce_layers(gf.from_u64(dig).to(cuda), log_rows)
    want = jgf.from_limbs(dist_merkle._reduce_layers(jgf.to_limbs(dig),
                                                     log_rows))
    np.testing.assert_array_equal(gf.to_u64(got), want)


@pytest.mark.parametrize("rows,layers,resident", [
    (1024, 10, 300),  # one full-width level, then a one-block fused launch
    (96, 5, 0),       # every level at full width
    (1536, 9, 200),   # uneven rows through both kernels
])
def test_k2_forced_plan_matches_jax(cuda, rows, layers, resident):
    dig = _rand((rows, 5))
    got = tip5_commit.reduce_layers(gf.from_u64(dig).to(cuda), layers,
                                    resident_threads=resident)
    want = jgf.from_limbs(dist_merkle._reduce_layers(jgf.to_limbs(dig),
                                                     layers))
    np.testing.assert_array_equal(gf.to_u64(got), want)


def test_k2_leaf_level_matches_jax(cuda):
    states = _rand((64, 16))
    got = tip5_commit.commit_states(gf.from_u64(states).to(cuda), 6,
                                    resident_threads=16)
    leafs = jperm.permutation_values(states)[:, :5]
    want = jgf.from_limbs(dist_merkle._reduce_layers(jgf.to_limbs(leafs), 6))
    np.testing.assert_array_equal(gf.to_u64(got), want)


def _misaligned(values, cuda):
    """values as a contiguous view that starts 8 bytes off a 16-byte
    boundary: rows cut from a flat buffer at an odd word offset."""
    flat = torch.zeros(values.size + 1, dtype=torch.int64, device=cuda)
    flat[1:] = gf.from_u64(values.ravel()).to(cuda)
    view = flat[1:].view(values.shape)
    assert view.is_contiguous() and view.data_ptr() % 16 == 8
    return view


def test_misaligned_views_match_jax(cuda):
    """The kernels read rows with 16-byte loads; each wrapper takes a
    misaligned view through an aligned copy."""
    rc, lut = tip5_tables(cuda)
    states = _rand((300, 16))
    view = _misaligned(states, cuda)
    want = jperm.permutation_values(states)
    np.testing.assert_array_equal(
        gf.to_u64(tip5_cuda.tip5_permute(view, rc, lut)), want)
    np.testing.assert_array_equal(gf.to_u64(tperm.permutation(view)), want)
    assert torch.equal(tip5_cuda.tip5_trace(view, rc, lut),
                       tip5_cuda.tip5_trace_plain(view, rc, lut))
    assert torch.equal(tip5_cuda.merkle_level(view, True, rc, lut),
                       tip5_cuda.merkle_level_plain(view, True, rc, lut))
    dig = _rand((256, 5))
    dview = _misaligned(dig, cuda)
    for launch in (lambda: tip5_cuda.merkle_level(dview, False, rc, lut),
                   lambda: tip5_cuda.merkle_commit(dview, False, 1, 128, rc,
                                                   lut)):
        np.testing.assert_array_equal(
            gf.to_u64(launch()),
            jgf.from_limbs(dist_merkle._reduce_layers(jgf.to_limbs(dig), 1)))


def test_k2_commit_matches_plain(cuda):
    states = gf.from_u64(_rand((1 << 12, 16))).to(cuda)
    got = tip5_commit.commit_states(states, 12)
    assert torch.equal(got, tip5_commit.commit_states(states, 12, plain=True))


@pytest.mark.parametrize("log_n", [1, 5, 12, 13, 17])
def test_k3_ntt_matches_jax(cuda, log_n):
    x = _rand((3, 1 << log_n))
    y = ntt.ntt(gf.from_u64(x).to(cuda))
    np.testing.assert_array_equal(gf.to_u64(y), jntt.ntt_values(x))
    np.testing.assert_array_equal(gf.to_u64(ntt.intt(y)), x)


def test_k3_pass_matches_plain(cuda):
    x = gf.from_u64(_rand((2, 37, 1 << 11))).to(cuda).transpose(1, 2)
    tw = gf.from_u64(ntt.stage_twiddles(11, True)).to(cuda)
    diag = gf.from_u64(_rand((1 << 11, 37))).to(cuda)
    assert torch.equal(
        ntt_cuda.ntt_local_pass(x, tw, diag=diag, scale=5),
        ntt_cuda.ntt_local_pass_plain(x, tw, diag=diag, scale=5))


@pytest.mark.parametrize("inverse", [False, True])
def test_k3_four_step_post_out_matches_jax(cuda, inverse):
    """The four-step transform scaling output k by post[k] in pass 2's
    epilogue and writing into the head of wider planes."""
    from twenty_first_tpu.math import gf_numpy as jgfn

    n = 1 << 15
    x, post = _rand((3, n)), _rand(n)
    planes = torch.zeros((3, 4 * n), dtype=torch.int64, device=cuda)
    ntt.ntt(gf.from_u64(x).to(cuda), inverse,
            post=gf.from_u64(post).to(cuda), out=planes[:, :n])
    want = jntt.intt_values(x) if inverse else jntt.ntt_values(x)
    np.testing.assert_array_equal(gf.to_u64(planes[:, :n]),
                                  jgfn.mul(want, post[None, :]))
    assert not bool(planes[:, n:].any())


def test_pipeline_root_matches_pinned_jax_root(cuda):
    trace = np.random.default_rng(0).integers(0, P, size=(8, 64),
                                              dtype=np.uint64)
    got = pipeline.trace_lde_commit(gf.from_u64(trace).to(cuda))
    assert gf.to_u64(got).tolist() == [chip_smoke.PINNED_ROOTS[64]]


@pytest.mark.parametrize("rows", [1, 15, 16, 17, 31, 32, 33, 1000,
                                  (1 << 16) + 9, 1 << 22])
def test_k9_matches_its_twin_and_k1(cuda, rows):
    """K9 (the MDS on the integer tensor cores) against its plain twin on
    the card and K1, at the edges of a warp's two tiles of 16 states, at
    ragged tails (1000 = 31 warps of 32 and 8; 2^16 + 9) and at the step's
    2^22, with edge words in every input."""
    states = _rand((rows, 16))
    states.reshape(-1)[::7] = np.resize(np.array(
        [0, 1, P - 1, P - 2, (1 << 32) - 1], dtype=np.uint64),
        states.reshape(-1)[::7].shape)
    x = gf.from_u64(states).to(cuda)
    tables = tip5_tables(cuda)
    before = tip5_mxu.tip5_permute_mma.launches
    got = tip5_mxu.tip5_permute_mma(x, *tables)
    assert tip5_mxu.tip5_permute_mma.launches == before + 1
    assert torch.equal(got, tip5_mxu.tip5_permute_mma_plain(x, *tables))
    assert torch.equal(got, tip5_cuda.tip5_permute(x, *tables))


def test_k9_entry_points_match_jax(cuda):
    states = _rand((1024, 16))
    want = jperm.permutation_values(states)
    np.testing.assert_array_equal(tip5_mxu.permutation_values(states), want)
    lo, hi = gf.to_limbs(states, cuda)
    got = tip5_mxu.permutation(lo, hi)
    assert got[0].is_cuda
    np.testing.assert_array_equal(gf.from_limbs(got), want)
    dense = tip5_mxu.permutation_dense(
        (tip5_mxu._interleave(lo), tip5_mxu._interleave(hi)))
    np.testing.assert_array_equal(
        gf.from_limbs(tuple(tip5_mxu._deinterleave(v) for v in dense)), want)


@pytest.mark.parametrize("rows,layers", [(1 << 12, 12), (3 << 10, 10)])
def test_packed_commit_matches_jax(cuda, rows, layers):
    """tip5_packed's entry points on the card (K2's plan) against JAX's
    XLA reduction."""
    dig = _rand((rows, 5))
    got = tip5_packed.reduce_layers_packed(gf.to_limbs(dig, cuda), layers)
    want = dist_merkle._reduce_layers(jgf.to_limbs(dig), layers)
    np.testing.assert_array_equal(gf.from_limbs(got), jgf.from_limbs(want))
    states = _rand((rows, 16))
    got = tip5_packed.commit_states_packed(*gf.to_limbs(states, cuda), layers)
    leafs = jperm.permutation_values(states)[:, :5]
    want = dist_merkle._reduce_layers(jgf.to_limbs(leafs), layers)
    np.testing.assert_array_equal(gf.from_limbs(got), jgf.from_limbs(want))


def test_k1_trace_mode_matches_jax(cuda):
    states = _rand((300, 16))
    before = tip5_cuda.tip5_trace.launches
    got = tperm.trace_values(states)
    assert tip5_cuda.tip5_trace.launches == before + 1
    np.testing.assert_array_equal(got, jperm.trace_values(states))


def test_batch_entry_points_match_jax(cuda):
    states = _rand((4096, 16))
    want = jperm.permutation_values(states)
    np.testing.assert_array_equal(tperm.permutation_batch_values(states), want)
    np.testing.assert_array_equal(tip5_batch.permutation_values(states), want)
    np.testing.assert_array_equal(tip5_batch.permutation_dense_values(states),
                                  want)


def test_hash_varlen_ragged_matches_jax(cuda):
    inputs = [_rand(n) for n in (0, 1, 9, 10, 11, 64, 200)]
    before = tip5_cuda.tip5_permute.launches
    got = tperm.hash_varlen_ragged(inputs)
    assert tip5_cuda.tip5_permute.launches - before == 21  # 201 words + pad
    np.testing.assert_array_equal(got, jperm.hash_varlen_ragged(inputs))
    np.testing.assert_array_equal(tperm.hash_varlen(inputs[-1]),
                                  jperm.hash_varlen(inputs[-1]))


@functools.lru_cache(maxsize=None)
def _varlen_rows(length: int):
    """1,000 inputs of ``length`` words and JAX's digests of them (rows
    hash independently, so a test of fewer rows takes the first ones)."""
    x = np.random.default_rng(length).integers(0, P, size=(1000, length),
                                                dtype=np.uint64)
    return x, jperm.hash_varlen(x)


@pytest.mark.parametrize("rows", [1, 3, 129, 1000])
@pytest.mark.parametrize("length", [0, 1, 9, 10, 11, 19, 20, 16384])
def test_k1_absorb_matches_jax(cuda, length, rows):
    """K1's absorb mode through ``hash_varlen_padded``: one launch for all
    the chunks of all the rows, counted as k absorbs."""
    x, want = _varlen_rows(length)
    padded = tperm.pad_for_varlen(gf.from_u64(x[:rows]).to(cuda))
    launches = tip5_cuda.tip5_permute.launches
    absorbs = tperm.hash_varlen_padded.absorbs
    got = tperm.hash_varlen_padded(padded)
    assert tip5_cuda.tip5_permute.launches == launches + 1
    assert tperm.hash_varlen_padded.absorbs == absorbs + padded.shape[1] // 10
    np.testing.assert_array_equal(gf.to_u64(got), want[:rows])


@pytest.mark.parametrize("rows", [1 << 15, 1 << 17])
def test_k1_absorb_matches_jax_at_the_tables_rows(cuda, rows):
    """Many full blocks of the launch: 2^15 rows, and the table commit's
    2^17, of three chunks each."""
    x = np.random.default_rng(rows).integers(0, P, size=(rows, 20),
                                             dtype=np.uint64)
    padded = tperm.pad_for_varlen(gf.from_u64(x).to(cuda))
    launches = tip5_cuda.tip5_permute.launches
    got = tperm.hash_varlen_padded(padded)
    assert tip5_cuda.tip5_permute.launches == launches + 1
    np.testing.assert_array_equal(gf.to_u64(got), jperm.hash_varlen(x))


def _lane_rows(device) -> int:
    """The fewest rows that K1's absorb mode runs a thread a row on this
    card."""
    resident = tip5_cuda.resident_threads(device, "tip5_absorb")
    rows = resident // tip5_cuda.LANE_ROWS_DIVISOR
    assert tip5_cuda.lane_mode(rows - 1, resident)
    assert not tip5_cuda.lane_mode(rows, resident)
    return rows


@functools.lru_cache(maxsize=None)
def _threshold_table(rows: int):
    """``rows`` + 1 inputs of 19 words (two chunks) and JAX's digests."""
    x = np.random.default_rng(rows).integers(0, P, size=(rows + 1, 19),
                                             dtype=np.uint64)
    return x, jperm.hash_varlen(x)


def _absorb_counted(padded, rc, lut):
    """``tip5_absorb`` and how far it moved (K1's launches, lane-mode
    launches)."""
    before = (tip5_cuda.tip5_permute.launches,
              tip5_cuda.tip5_absorb.lane_launches)
    got = tip5_cuda.tip5_absorb(padded, rc, lut)
    return got, (tip5_cuda.tip5_permute.launches - before[0],
                 tip5_cuda.tip5_absorb.lane_launches - before[1])


@pytest.mark.parametrize("rows", [1, 3, 80])
@pytest.mark.parametrize("length", [0, 1, 9, 10, 11, 19, 20, 16384])
def test_k1_lane_mode_matches_jax(cuda, length, rows):
    """K1's lane mode (16 lanes a row) at the opening's ~80 rows and
    fewer: one launch, counted both as K1's and as a lane-mode launch."""
    x, want = _varlen_rows(length)
    padded = tperm.pad_for_varlen(gf.from_u64(x[:rows]).to(cuda))
    got, moved = _absorb_counted(padded, *tip5_tables(cuda))
    assert moved == (1, 1)
    np.testing.assert_array_equal(gf.to_u64(got), want[:rows])


@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_k1_absorb_modes_meet_at_the_lane_threshold(cuda, offset):
    """One table at the lane mode's last row count (lanes) and at the next
    two (a thread a row): both modes give JAX's digests."""
    threshold = _lane_rows(cuda)
    x, want = _threshold_table(threshold)
    rows = threshold + offset
    padded = tperm.pad_for_varlen(gf.from_u64(x[:rows]).to(cuda))
    got, moved = _absorb_counted(padded, *tip5_tables(cuda))
    assert moved == (1, int(offset < 0))
    np.testing.assert_array_equal(gf.to_u64(got), want[:rows])


@pytest.mark.parametrize("mode", ["lanes", "threads"])
def test_k1_absorb_reads_rows_in_place(cuda, mode):
    """Rows read at their stride by each design of the absorb mode (129
    rows take the lane mode; the lane mode's threshold, a thread a row): a
    row view of a wider tensor (a stride above k * 10 words, starting 8
    bytes off a 16-byte boundary), and rows that sit beyond 2^32 bytes
    (64-bit offsets)."""
    if mode == "lanes":
        rows, (x, want) = 129, _varlen_rows(19)
    else:
        rows = _lane_rows(cuda)
        x, want = _threshold_table(rows)
    rc, lut = tip5_tables(cuda)
    padded = tperm.pad_for_varlen(gf.from_u64(x[:rows]).to(cuda))
    wide = torch.zeros((rows, 37), dtype=torch.int64, device=cuda)
    view = wide[:, 5:25]
    view.copy_(padded)
    assert view.stride(0) == 37 and view.data_ptr() % 16 == 8
    got, moved = _absorb_counted(view, rc, lut)
    assert moved == (1, int(mode == "lanes"))
    np.testing.assert_array_equal(gf.to_u64(got), want[:rows])
    del wide, view
    far_rows = 3 if mode == "lanes" else rows
    stride = (1 << 29) // (far_rows - 1) + 3  # the last row past 2^32 bytes
    far = torch.zeros((far_rows - 1) * stride + 20, dtype=torch.int64,
                      device=cuda)
    spread = far.as_strided((far_rows, 20), (stride, 1))
    spread.copy_(padded[:far_rows])
    assert (far_rows - 1) * stride * 8 > 1 << 32
    got, moved = _absorb_counted(spread, rc, lut)
    assert moved == (1, int(mode == "lanes"))
    np.testing.assert_array_equal(gf.to_u64(got), want[:far_rows])


@pytest.mark.parametrize("variant", pass_probe.VARIANTS)
def test_pass_probe_matches_jax_local_pass(cuda, variant):
    x = _rand((1 << 8, 64))
    tw = gf.from_u64(ntt.stage_twiddles(8, False)).to(cuda)
    got = pass_probe.run_pass(gf.from_u64(x).to(cuda), tw, variant, tc=16)
    want = jgf.from_limbs(jntt._local_pass(
        tuple(np.asarray(v) for v in jgf.to_limbs(x)), 8, False))
    np.testing.assert_array_equal(gf.to_u64(got), want)


@pytest.mark.parametrize("form", sorted(probe_cuda.CHAIN_FORMS))
@pytest.mark.parametrize("op", sorted(probe_cuda.CHAIN_OPS))
def test_k5_matches_jax_probe(cuda, op, form):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / \
        "pallas_alu_probe.py"
    spec = importlib.util.spec_from_file_location("pallas_alu_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    a = RNG.integers(0, 1 << 64, size=(64, 128), dtype=np.uint64,
                     endpoint=False)
    b = RNG.integers(0, 1 << 64, size=(64, 128), dtype=np.uint64,
                     endpoint=False)
    want = jgf.from_limbs(probe.make_xla(getattr(jgf, op), 7)(
        *jgf.to_limbs(a), *jgf.to_limbs(b)))
    got = probe_cuda.gf_chain(gf.from_u64(a).to(cuda), gf.from_u64(b).to(cuda),
                              op, 7, form)
    np.testing.assert_array_equal(gf.to_u64(got), want)


def test_k8_ops_match_jax(cuda):
    """K8's four ops on the card against the JAX package's field layer."""
    from twenty_first_tpu.math import gf_ext as jgfe
    from twenty_first_tpu_torch.math import gf_ext
    from twenty_first_tpu_torch.ops import poly_cuda

    a, b = _rand((3, 500)), _rand((3, 500))
    a[0, :5] = [0, 1, P - 1, 1 << 32, (1 << 32) - 1]
    ta, tb = gf.from_u64(a).to(cuda), gf.from_u64(b).to(cuda)
    before = poly_cuda.gf_pointwise.launches
    np.testing.assert_array_equal(
        gf.to_u64(poly_cuda.gf_pointwise(ta, tb, "mul")),
        jgf.from_limbs(jgf.mul(jgf.to_limbs(a), jgf.to_limbs(b))))
    np.testing.assert_array_equal(
        gf.to_u64(gf.inverse_or_zero(ta)),
        jgf.from_limbs(jgf.inverse_or_zero(jgf.to_limbs(a))))
    xa, xb = _rand((2, 100, 3)), _rand((2, 100, 3))
    txa, txb = (gf_ext.from_u64(v).to(cuda) for v in (xa, xb))
    np.testing.assert_array_equal(
        gf_ext.to_u64(gf_ext.mul(txa, txb)),
        jgfe.from_limbs(jgfe.mul(jgfe.to_limbs(xa), jgfe.to_limbs(xb))))
    base = _rand((2, 100))
    np.testing.assert_array_equal(
        gf_ext.to_u64(gf_ext.mul_base(txa, gf.from_u64(base).to(cuda))),
        jgfe.from_limbs(jgfe.mul_base(jgfe.to_limbs(xa),
                                      jgf.to_limbs(base))))
    assert poly_cuda.gf_pointwise.launches == before + 4


@pytest.mark.parametrize("rows,n,zero_at", [
    (1, 1 << 12, 1 << 11), (3, 5000, 2500),
    (2, 2 * poly_cuda.INV_SEGMENT + 3, 2 * poly_cuda.INV_SEGMENT + 1)])
def test_k7_matches_jax(cuda, rows, n, zero_at):
    """A row holding a 0 comes out all zeros, as in JAX (the last case: a 0
    in the row's last, part segment only). A call runs K7's two device
    kernels and no other, each at most once (the profiler may drop an
    event, never add one, so the counts are bounds over five calls)."""
    from torch.profiler import ProfilerActivity, profile

    x = _rand((rows, n))
    x[x == 0] = 1
    x[-1, zero_at] = 0
    tx = gf.from_u64(x).to(cuda)
    gf.batch_inversion(tx)
    torch.cuda.synchronize()
    before = poly_cuda.batch_inversion.launches
    calls = 5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            got = gf.batch_inversion(tx)
        torch.cuda.synchronize()
    assert poly_cuda.batch_inversion.launches == before + calls
    counts = {e.key: e.count for e in prof.key_averages() if "inv_" in e.key}
    assert len(poly_cuda.INV_KERNELS) == 2
    assert sorted(next((k for k in poly_cuda.INV_KERNELS if k in name), name)
                  for name in counts) == sorted(poly_cuda.INV_KERNELS), counts
    assert all(1 <= c <= calls for c in counts.values()), counts
    np.testing.assert_array_equal(
        gf.to_u64(got), jgf.from_limbs(jgf.batch_inversion(jgf.to_limbs(x))))
    assert not gf.to_u64(got)[-1].any()


@pytest.mark.parametrize("name", sorted(chip_smoke.PINNED_EXTRAPOLATE))
def test_k6_extrapolation_matches_jax_pins(cuda, name):
    """The extrapolations through K3 and K6 reproduce the JAX pins; the
    barycentric evaluation (K7, K8) and a convolution (K3, K8) equal JAX."""
    from twenty_first_tpu.math import poly_batch as jpb
    from twenty_first_tpu_torch.math import poly_batch
    from twenty_first_tpu_torch.ops import poly_cuda

    cw, pts = chip_smoke.extrapolate_pin_inputs()[name]
    before = poly_cuda.coset_extrapolate_fold.launches
    fn = (poly_batch.batch_coset_extrapolate if name == "base"
          else poly_batch.batch_coset_extrapolate_xfe)
    got = fn(cw, 7, pts, device=cuda)
    assert poly_cuda.coset_extrapolate_fold.launches == before + 1
    assert chip_smoke.pin_of(got) == tuple(chip_smoke.PINNED_EXTRAPOLATE[name])
    if name == "base":
        np.testing.assert_array_equal(
            poly_batch.batch_evaluate_barycentric(cw, 12345, device=cuda),
            jpb.batch_evaluate_barycentric(cw, 12345))
        np.testing.assert_array_equal(
            ntt.conv_values(cw, cw[::-1].copy(), divide=True, device=cuda),
            jntt.conv_values(cw, cw[::-1].copy(), divide=True))


def _vals(digest) -> list[int]:
    return [v.value() for v in digest.values()]


def test_merkle_level_out_into_aligned_and_misaligned_views(cuda):
    """``merkle_level(out=)`` writes a level straight into a tree's node
    rows: an even row starts on a 16-byte boundary, an odd row (the
    root's) does not, and both take the kernel's output; a strided ``out``
    is refused."""
    rc, lut = tip5_tables(cuda)
    children = gf.from_u64(_rand((256, 5))).to(cuda)
    want = tip5_cuda.merkle_level_plain(children, False, rc, lut)
    nodes = torch.zeros((512, 5), dtype=torch.int64, device=cuda)
    for row in (128, 1):
        out = nodes[row: row + 128]
        assert (out.data_ptr() % 16 == 0) == (row % 2 == 0)
        before = tip5_cuda.merkle_level.launches
        got = tip5_cuda.merkle_level(children, False, rc, lut, out=out)
        assert tip5_cuda.merkle_level.launches == before + 1
        assert got.data_ptr() == out.data_ptr()
        assert torch.equal(out, want)
    with pytest.raises(ValueError):
        tip5_cuda.merkle_level(children, False, rc, lut, out=nodes[::4])


@pytest.mark.parametrize("height", [0, 1, 2, 3, 12])
def test_merkle_tree_on_the_card_matches_twin_and_jax(cuda, height):
    from twenty_first_tpu.util_types import merkle_tree as jmt
    from twenty_first_tpu_torch.util_types import merkle_tree as tmt

    leafs = _rand((1 << height, 5))
    before = tip5_cuda.merkle_level.launches
    tree = tmt.MerkleTree.new(gf.from_u64(leafs).to(cuda))
    assert tip5_cuda.merkle_level.launches == before + height
    assert tree == tmt.MerkleTree.new(leafs, device=cuda, plain=True)
    jtree = jmt.MerkleTree.new(leafs)
    np.testing.assert_array_equal(tree.node_array(), jtree.node_array())
    assert _vals(tmt.MerkleTree.frugal_root(leafs, device=cuda)) == \
        _vals(jtree.root())


def test_authentication_structure_from_leafs_on_the_card(cuda):
    from twenty_first_tpu.util_types import merkle_tree as jmt
    from twenty_first_tpu_torch.util_types import merkle_tree as tmt

    leafs = _rand((1 << 11, 5))
    indices = [int(i) for i in RNG.integers(0, 1 << 11, 40)] + [0, 2047]
    on_card = gf.from_u64(leafs).to(cuda)
    before = tip5_cuda.merkle_level.launches
    got = tmt.MerkleTree.authentication_structure_from_leafs(on_card, indices)
    assert tip5_cuda.merkle_level.launches > before
    tree = tmt.MerkleTree.new(on_card)
    assert got == tree.authentication_structure(indices)
    want = jmt.MerkleTree.new(leafs).authentication_structure(indices)
    assert [_vals(d) for d in got] == [_vals(d) for d in want]
    proof = tree.inclusion_proof_for_leaf_indices(indices)
    assert proof.verify(tree.root())



@pytest.mark.parametrize("height,count", [(1, 1), (6, 9), (17, 80)])
def test_partial_tree_fills_on_the_card_a_k2_launch_a_level(cuda, height,
                                                            count):
    """verify, try_verify and into_authentication_paths on the card: one
    K2 launch a level of the partial tree, the same verdicts, causes and
    paths as the plain twin on the card and the JAX package."""
    from twenty_first_tpu.util_types import merkle_tree as jmt
    from twenty_first_tpu_torch.util_types import merkle_tree as tmt

    leafs = _rand((1 << height, 5))
    indices = [int(i) for i in RNG.integers(0, 1 << height, count)]
    tree = tmt.MerkleTree.new(gf.from_u64(leafs).to(cuda))
    proof = tree.inclusion_proof_for_leaf_indices(indices + indices[:1])
    before = tip5_cuda.merkle_level.launches
    assert proof.verify(tree.root())
    assert tip5_cuda.merkle_level.launches == before + height
    paths = proof.into_authentication_paths()
    assert paths == proof.into_authentication_paths(plain=True)
    jtree = jmt.MerkleTree.new(leafs)
    jpaths = jtree.inclusion_proof_for_leaf_indices(
        indices + indices[:1]).into_authentication_paths()
    assert [[_vals(d) for d in p] for p in paths] == \
        [[_vals(d) for d in p] for p in jpaths]
    bad = tmt.MerkleTreeInclusionProof(
        height, proof.indexed_leafs, proof.authentication_structure[:-1])
    for kw in ({}, {"plain": True}):
        with pytest.raises(tmt.MerkleTreeError, match="length mismatch"):
            bad.try_verify(tree.root(), **kw)


def _k2_launches():
    return tip5_cuda.merkle_level.launches + tip5_cuda.merkle_commit.launches


@pytest.mark.parametrize("n", [300, 3 << 9])  # below the cutoff, above it
def test_mmr_on_the_card_matches_jax(cuda, n):
    from twenty_first_tpu.util_types import mmr as jmmr
    from twenty_first_tpu_torch.util_types import mmr as tmmr

    leafs, more = _rand((n, 5)), _rand((40, 5))
    before = _k2_launches()
    acc = tmmr.MmrAccumulator.new_from_leafs(gf.from_u64(leafs).to(cuda))
    assert _k2_launches() > before
    jacc = jmmr.MmrAccumulator.new_from_leafs(leafs)
    assert [_vals(d) for d in acc.peaks()] == [_vals(d) for d in jacc.peaks()]
    before = _k2_launches()  # host leafs asked onto the card go there too
    assert tmmr.MmrAccumulator.peaks_from_leafs(leafs, device=cuda) == \
        acc.peaks()
    assert _k2_launches() > before
    assert _vals(acc.bag_peaks()) == _vals(jacc.bag_peaks())
    proof = tmmr.MmrSuccessorProof.new_from_batch_append(
        acc, gf.from_u64(more).to(cuda))
    new = tmmr.MmrAccumulator.new_from_leafs(
        np.concatenate([leafs, more]), device=cuda)
    assert proof.verify(acc, new)


def test_hash_batch_on_the_card_matches_jax(cuda):
    """Tip5.hash_batch of objects of every codec type on K1, equal to the
    JAX package's Tip5.hash of each."""
    from twenty_first_tpu.tip5 import tip5 as jtip5
    from twenty_first_tpu_torch.tip5 import Tip5

    objects = chip_smoke.codec_objects(np.random.default_rng(5), 64)
    before = tip5_cuda.tip5_permute.launches
    got = Tip5.hash_batch(objects)
    assert tip5_cuda.tip5_permute.launches > before
    want = [jtip5.Tip5.hash(v) for v in chip_smoke.codec_objects(
        np.random.default_rng(5), 64, package="twenty_first_tpu")]
    assert [_vals(d) for d in got] == [_vals(d) for d in want]


def test_merkle_host_cut_on_the_card(cuda):
    """Host leafs at HOST_MERKLE_MAX_LEAFS take the host route (no K2
    launch, the nodes on the card); twice as many take K2, a launch a
    level; both equal the JAX package's trees."""
    from twenty_first_tpu.util_types import merkle_tree as jmt
    from twenty_first_tpu_torch.util_types import merkle_tree as tmt

    cut = tmt.HOST_MERKLE_MAX_LEAFS
    for n, launches in ((cut, 0), (2 * cut, (2 * cut).bit_length() - 1)):
        leafs = _rand((n, 5))
        before = _k2_launches()
        tree = tmt.MerkleTree.new(leafs)
        assert _k2_launches() == before + launches
        assert tree._nodes.device.type == "cuda"
        np.testing.assert_array_equal(tree.node_array(),
                                      jmt.MerkleTree.new(leafs).node_array())


def test_three_pass_ntt_matches_the_plain_twin(cuda):
    """The three-pass transform at 2^25 (K3, three launches) against the
    same route on the plain twins, and back; in place too."""
    x = gf.from_u64(_rand((1, 1 << 25))).to(cuda)
    before = ntt_cuda.ntt_local_pass.launches
    y = ntt.ntt(x)
    assert ntt_cuda.ntt_local_pass.launches == before + 3
    assert torch.equal(y, ntt.ntt(x, plain=True))
    assert torch.equal(ntt.intt(y), x)
    w = x.clone()
    assert ntt.ntt(w, out=w) is w
    assert torch.equal(w, y)


# -- the distributed layer (parallel/) on the card -----------------------------


@contextlib.contextmanager
def _world_of_one():
    """A world-1 NCCL mesh on the card in this process, its group destroyed
    on the way out when this made it."""
    import torch.distributed as dist
    from twenty_first_tpu_torch.parallel import mesh as mesh_mod

    made = not dist.is_initialized()
    try:
        yield mesh_mod.make_mesh(1)
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def _check_cases(results: dict, d: int) -> None:
    for key, value in results.items():
        if key not in ("rank", "backend", "device"):
            np.testing.assert_equal(value, tdist._expected(key, d),
                                    err_msg=str(key))


def test_distributed_cases_at_world_one_over_nccl(cuda):
    """Every case of tests/test_torch_dist.py at world 1, over NCCL, its
    transforms and trees on K3, K1 and K2, against the JAX package."""
    with _world_of_one() as mesh:
        assert (mesh.backend, mesh.device.type) == ("nccl", "cuda")
        before = (ntt_cuda.ntt_local_pass.launches,
                  tip5_cuda.tip5_permute.launches)
        results = tdist._cases(mesh)
        assert ntt_cuda.ntt_local_pass.launches > before[0]
        assert tip5_cuda.tip5_permute.launches > before[1]
    _check_cases(results, 1)


def test_distributed_cases_on_two_gloo_ranks_sharing_the_card(cuda, tmp_path):
    """The same cases on two spawned ranks over gloo, both on the card."""
    from twenty_first_tpu_torch import _build
    from twenty_first_tpu_torch.parallel import mesh as mesh_mod

    _build.load()  # built here, so that no rank runs nvcc
    ranks = mesh_mod.launch(tdist._rank_cases, 2, backend="gloo",
                            device="cuda", timeout=600, workdir=str(tmp_path))
    assert [(r["rank"], r["backend"]) for r in ranks] == [(0, "gloo"),
                                                        (1, "gloo")]
    assert all(r["device"].startswith("cuda") for r in ranks)
    for r in ranks:
        _check_cases(r, 2)


def test_lde_commit_and_merkle_root_at_2_12_match_the_jax_mesh(cuda):
    from twenty_first_tpu.parallel import distributed_merkle_root as jroot
    from twenty_first_tpu.parallel import make_mesh as jmesh
    from twenty_first_tpu.parallel.pipeline import (
        dist_lde_commit_values as jlde)
    from twenty_first_tpu_torch.parallel import distributed_merkle_root
    from twenty_first_tpu_torch.parallel.pipeline import dist_lde_commit_values

    x = _rand(1 << 12)
    leafs = _rand((1 << 12, 5))
    with _world_of_one() as mesh:
        got = (dist_lde_commit_values(x, mesh),
               distributed_merkle_root(leafs, mesh))
    want = (jlde(x, jmesh(2)), jroot(leafs, jmesh(2)))
    assert [_vals(d) for d in got] == [_vals(d) for d in want]
