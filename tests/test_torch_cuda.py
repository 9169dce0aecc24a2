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
from twenty_first_tpu_torch.ops import (ntt_cuda, probe_cuda, tip5_batch,
                                        tip5_commit, tip5_cuda)
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


@pytest.mark.parametrize("op", sorted(probe_cuda.CHAIN_OPS))
def test_k5_matches_jax_probe(cuda, op):
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
                              op, 7)
    np.testing.assert_array_equal(gf.to_u64(got), want)
