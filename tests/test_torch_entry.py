"""The port's entry() and lde_commit against the JAX package's
__graft_entry__.entry and a host oracle, exactly."""

import numpy as np
import pytest
import torch

import __graft_entry__
import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu.math import gf as jgf
from twenty_first_tpu.math import ntt as jntt
from twenty_first_tpu.math.b_field_element import P, bfe
from twenty_first_tpu.tip5 import Digest, Tip5
from twenty_first_tpu.util_types.merkle_tree import MerkleTree
from twenty_first_tpu_torch.entry import entry
from twenty_first_tpu_torch.math import gf, ntt
from twenty_first_tpu_torch.ops import tip5_batch
from twenty_first_tpu_torch.parallel import pipeline
from twenty_first_tpu_torch.tip5 import permutation as tperm


def test_entry_root_matches_jax_entry():
    """Same inputs, same root; the JAX value is the root chip_smoke.py
    checks on the card."""
    jfn, jargs = __graft_entry__.entry()
    want = jgf.from_limbs(tuple(np.asarray(a) for a in jfn(*jargs)))
    assert want.tolist() == [chip_smoke.ENTRY_ROOT]
    fn, args = entry("cpu")
    np.testing.assert_array_equal(gf.to_u64(args[0]),
                                  jgf.from_limbs(jargs))
    got = fn(*args)
    np.testing.assert_array_equal(gf.to_u64(got), want)
    assert torch.equal(fn(*args, plain=True), got)


def test_lde_commit_matches_host_oracle():
    x = np.random.default_rng(3).integers(0, P, size=(4, 16), dtype=np.uint64)
    got = pipeline.lde_commit(gf.from_u64(x))
    leafs = np.array(
        [Digest(Tip5.hash_varlen([bfe(int(v)) for v in row])).to_array()
         for row in jntt.ntt_host(x)], dtype=np.uint64)
    assert Digest.from_array(gf.to_u64(got)[0]) == MerkleTree.new(leafs).root()


@pytest.mark.parametrize("call", [
    lambda: entry()[1][0],
    lambda: pipeline.TraceLdeCommit(4, 16).offset_powers,
    lambda: ntt.ntt_tables(64).tw1,
    lambda: tperm.tip5_tables()[0],
], ids=["entry", "TraceLdeCommit", "ntt_tables", "tip5_tables"])
def test_entry_points_default_to_the_card(call):
    """With no device argument the tensors go to the card; a machine
    without one raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()


@pytest.mark.parametrize("call", [
    lambda x: ntt.ntt_values(x), lambda x: ntt.intt_values(x),
    lambda x: tperm.permutation_batch_values(x.reshape(-1, 16)),
    lambda x: tperm.trace_values(x.reshape(-1, 16)),
    lambda x: tperm.hash_varlen(x), lambda x: tperm.hash_varlen_ragged([x]),
    lambda x: tip5_batch.permutation_values(x.reshape(-1, 16)),
], ids=["ntt_values", "intt_values", "permutation_batch_values",
        "trace_values", "hash_varlen", "hash_varlen_ragged",
        "t4_permutation_values"])
def test_host_entry_points_never_fall_back_to_the_cpu(call):
    x = np.arange(16, dtype=np.uint64)
    if torch.cuda.is_available():
        assert isinstance(call(x), np.ndarray)
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call(x)
