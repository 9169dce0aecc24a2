"""The port's entry() and lde_commit against the JAX package's
__graft_entry__.entry and a host oracle, exactly."""

import numpy as np
import torch

import __graft_entry__
import chip_smoke
from twenty_first_tpu.math import gf as jgf
from twenty_first_tpu.math import ntt as jntt
from twenty_first_tpu.math.b_field_element import P, bfe
from twenty_first_tpu.tip5 import Digest, Tip5
from twenty_first_tpu.util_types.merkle_tree import MerkleTree
from twenty_first_tpu_torch.entry import entry
from twenty_first_tpu_torch.math import gf
from twenty_first_tpu_torch.parallel import pipeline


def test_entry_root_matches_jax_entry():
    """Same inputs, same root; the JAX value is the root chip_smoke.py
    checks on the card."""
    jfn, jargs = __graft_entry__.entry()
    want = jgf.from_limbs(tuple(np.asarray(a) for a in jfn(*jargs)))
    assert want.tolist() == [chip_smoke.ENTRY_ROOT]
    fn, args = entry()
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
