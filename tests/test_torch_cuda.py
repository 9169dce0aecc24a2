"""The port's CUDA kernels on the card against the JAX reference (on the
CPU) and against their plain twins, exactly.

Marked ``cuda``: without a CUDA device every test skips. On a GPU machine:
    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

import chip_smoke
from twenty_first_tpu.math import gf as jgf
from twenty_first_tpu.math import ntt as jntt
from twenty_first_tpu.math.b_field_element import P
from twenty_first_tpu.parallel import dist_merkle
from twenty_first_tpu.tip5 import permutation as jperm
from twenty_first_tpu_torch.math import gf, ntt
from twenty_first_tpu_torch.ops import (ntt_cuda, poly_cuda, probe_cuda,
                                        tip5_batch, tip5_commit, tip5_cuda)
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
