"""The port's trace LDE + commit (parallel/pipeline.py) against the JAX
package's trace_lde_commit and its host oracle, exactly."""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from twenty_first_tpu.math import gf as jgf
from twenty_first_tpu.math import gf_numpy as jgfn
from twenty_first_tpu.math import ntt as jntt
from twenty_first_tpu.math.b_field_element import GENERATOR, P, bfe
from twenty_first_tpu.parallel.pipeline import (
    trace_lde_commit as jax_trace_lde_commit)
from twenty_first_tpu.tip5 import Digest, Tip5
from twenty_first_tpu.util_types.merkle_tree import MerkleTree
from twenty_first_tpu_torch.math import gf
from twenty_first_tpu_torch.parallel import pipeline


def _host_oracle_root(trace, expansion, offset):
    """The step on host oracles: numpy NTTs, scalar Tip5, host Merkle tree."""
    w, n = trace.shape
    coeff = jntt.ntt_host(trace, inverse=True)
    scaled = jgfn.mul(coeff, jgfn.powers(offset, n)[None, :])
    padded = np.zeros((w, n * expansion), dtype=np.uint64)
    padded[:, :n] = scaled
    evals = jntt.ntt_host(padded)
    leafs = np.array(
        [Digest(Tip5.hash_10([bfe(int(v)) for v in row] + [bfe(0)] * (10 - w)))
         .to_array() for row in evals.T], dtype=np.uint64)
    return MerkleTree.new(leafs).root()


@pytest.mark.parametrize("log_n", [6, 10])
def test_root_matches_jax_and_pins_the_chip_roots(log_n):
    """The JAX reference re-derives the roots chip_smoke.py checks on the
    card, and the port reproduces them."""
    n = 1 << log_n
    trace = np.random.default_rng(0).integers(0, P, size=(8, n),
                                              dtype=np.uint64)
    want = jgf.from_limbs(jax.jit(lambda a, b: jax_trace_lde_commit((a, b), 4))(
        *jgf.to_limbs(trace)))
    assert want.tolist() == [chip_smoke.PINNED_ROOTS[n]]
    got = pipeline.trace_lde_commit(gf.from_u64(trace))
    assert got.shape == (1, 5)
    np.testing.assert_array_equal(gf.to_u64(got), want)


@pytest.mark.parametrize("w,n,expansion,offset", [
    (1, 4, 2, GENERATOR), (3, 16, 4, GENERATOR), (10, 8, 8, 3),
    (5, 32, 1, GENERATOR), (2, 1, 4, GENERATOR)])
def test_root_matches_host_oracle(w, n, expansion, offset):
    trace = np.random.default_rng(w * n).integers(0, P, size=(w, n),
                                                  dtype=np.uint64)
    got = pipeline.trace_lde_commit(gf.from_u64(trace), expansion, offset)
    assert Digest.from_array(gf.to_u64(got)[0]) == _host_oracle_root(
        trace, expansion, offset)


def test_module_holds_tables_and_reuses_them():
    step = pipeline.TraceLdeCommit(4, 1 << 13, 2, device="cpu")
    buffers = dict(step.named_buffers())
    for name in ("inv_tw1", "inv_tw2", "inv_diag", "fwd_tw1", "fwd_tw2",
                 "fwd_diag", "offset_powers", "round_constants",
                 "lookup_table"):
        assert name in buffers, name
    assert buffers["fwd_diag"].shape == (1 << 7, 1 << 7)
    assert step.state_dict() == {}  # derived tables, not state
    trace = gf.from_u64(np.random.default_rng(5).integers(
        0, P, size=(4, 1 << 13), dtype=np.uint64))
    root = step(trace)
    assert torch.equal(step(trace), root)
    assert torch.equal(step(trace, plain=True), root)
    assert torch.equal(pipeline.trace_lde_commit(trace, 2), root)


def test_module_rejects_bad_shapes():
    with pytest.raises(ValueError):
        pipeline.TraceLdeCommit(11, 16, device="cpu")
    with pytest.raises(ValueError):
        pipeline.TraceLdeCommit(4, 12, device="cpu")
    with pytest.raises(ValueError):
        pipeline.TraceLdeCommit(4, 16, expansion=3, device="cpu")
    step = pipeline.TraceLdeCommit(4, 16, device="cpu")
    with pytest.raises(ValueError):
        step(torch.zeros(4, 32, dtype=torch.int64))
    with pytest.raises(ValueError):
        step(torch.zeros(4, 16, dtype=torch.int32))
