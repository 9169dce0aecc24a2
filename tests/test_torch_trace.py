"""The port's spans (``twenty_first_tpu_torch/spans.py``) and its absorb
counter, on the CPU with the plain twins at small sizes: the shared null
context without a profiler, exactly one ``tft.*`` span a layer's call
under one, nested as the layers are, the counter's growth, and every
instrumented function's output bit for bit the same with the profiler on
and off, and equal to the pins the JAX package derived."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401
from twenty_first_tpu_torch import spans
from twenty_first_tpu_torch.math import gf
from twenty_first_tpu_torch.math import ntt
from twenty_first_tpu_torch.math.b_field_element import P
from twenty_first_tpu_torch.ops import tip5_commit
from twenty_first_tpu_torch.parallel import pipeline
from twenty_first_tpu_torch.tip5 import permutation as tperm
from twenty_first_tpu_torch.tip5.constants import RATE
from twenty_first_tpu_torch.util_types.merkle_tree import MerkleTree


def _profiled(fn):
    """fn() under a CPU profile: (its result, the tft.* spans as nested
    (name, [children]) in the order they opened)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _nested(prof.events())


def _nested(events):
    found = sorted((e for e in events if e.name.startswith(spans.PREFIX)),
                   key=lambda e: (e.time_range.start, -e.time_range.end))
    roots, stack = [], []
    for e in found:
        while stack and stack[-1][0].time_range.end < e.time_range.end:
            stack.pop()
        node = (e, [])
        (stack[-1][1] if stack else roots).append(node)
        stack.append(node)

    def plain(nodes):
        return [(e.name, plain(children)) for e, children in nodes]
    return plain(roots)


def _trace(w, n, seed=0):
    rng = np.random.default_rng(seed)
    return gf.from_u64(rng.integers(0, P, size=(w, n), dtype=np.uint64))


def _table(rows, length, seed=1):
    rng = np.random.default_rng(seed)
    return gf.from_u64(rng.integers(0, P, size=(rows, length),
                                    dtype=np.uint64))


def test_span_without_a_profiler_is_the_shared_null_context():
    assert spans.span("lde") is spans.NULL
    assert spans.span("sponge") is spans.span("tree")
    with spans.span("lde") as entered:
        assert entered is None


def test_span_under_a_profiler_records_its_name():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("probe"):
            torch.zeros(3)
    assert [e.name for e in prof.events()
            if e.name.startswith(spans.PREFIX)] == ["tft.probe"]
    assert spans.span("probe") is spans.NULL  # off again after the profile


TRACE_COMMIT = [("tft.trace_commit", [
    ("tft.lde", [("tft.ntt", []), ("tft.ntt", [])]),
    ("tft.leaf_hash", []),
    ("tft.tree", [])])]


@pytest.mark.parametrize("w,n,expansion", [(1, 4, 2), (3, 16, 4), (10, 8, 8),
                                           (2, 1, 4)])
def test_trace_commit_records_its_layers(w, n, expansion):
    step = pipeline.TraceLdeCommit(w, n, expansion, device="cpu")
    _, found = _profiled(lambda: step(_trace(w, n)))
    assert found == TRACE_COMMIT


@pytest.mark.parametrize("length", [0, 9, 10, 25, 40])
def test_table_commit_records_pad_sponge_and_tree(length):
    table = _table(4, length)

    def commit():
        return MerkleTree.new(tperm.hash_varlen_padded(
            tperm.pad_for_varlen(table)))
    _, found = _profiled(commit)
    # one span a call, however many chunks the sponge absorbs
    assert found == [("tft.pad", []), ("tft.sponge", []), ("tft.tree", [])]


def test_host_padding_opens_no_span():
    host = np.arange(12, dtype=np.uint64).reshape(2, 6)
    out, found = _profiled(lambda: tperm.pad_for_varlen(host))
    assert found == [] and out.shape == (2, RATE)


@pytest.mark.parametrize("length", [0, 1, 9, 10, 19, 20, 40])
def test_absorbs_grow_by_the_chunks_of_each_call(length):
    padded = tperm.pad_for_varlen(_table(3, length))
    before = tperm.hash_varlen_padded.absorbs
    tperm.hash_varlen_padded(padded)
    chunks = tperm.padded_length(length) // RATE
    assert tperm.hash_varlen_padded.absorbs - before == chunks
    _profiled(lambda: tperm.hash_varlen_padded(padded))
    assert tperm.hash_varlen_padded.absorbs - before == 2 * chunks


def _instrumented():
    """Each instrumented function at a small size, as a thunk."""
    step = pipeline.TraceLdeCommit(3, 16, 4, device="cpu")
    trace = _trace(3, 16, seed=5)
    evals = _trace(3, 64, seed=6)
    padded = tperm.pad_for_varlen(_table(4, 23, seed=7))
    digests = _table(8, 5, seed=8)
    post = gf.from_u64(np.arange(1, 17, dtype=np.uint64))
    return {
        "TraceLdeCommit.forward": lambda: step(trace),
        "TraceLdeCommit.leaf_digests": lambda: step.leaf_digests(trace),
        "hash_rows": lambda: pipeline.hash_rows(evals),
        "ntt": lambda: ntt.ntt(evals),
        "ntt.inverse_post_out": lambda: ntt.ntt(
            trace, inverse=True, post=post, out=torch.zeros_like(trace)),
        "pad_for_varlen": lambda: tperm.pad_for_varlen(_table(2, 30)),
        "hash_varlen_padded": lambda: tperm.hash_varlen_padded(padded),
        "reduce_layers": lambda: tip5_commit.reduce_layers(digests, 3),
        "MerkleTree.new": lambda: torch.as_tensor(
            MerkleTree.new(digests).node_array().astype(np.int64)),
    }


INSTRUMENTED = ["MerkleTree.new", "TraceLdeCommit.forward",
                "TraceLdeCommit.leaf_digests", "hash_rows",
                "hash_varlen_padded", "ntt", "ntt.inverse_post_out",
                "pad_for_varlen", "reduce_layers"]


def test_every_instrumented_function_is_held():
    assert sorted(_instrumented()) == INSTRUMENTED


@pytest.mark.parametrize("name", INSTRUMENTED)
def test_outputs_are_the_same_with_the_profiler_on_and_off(name):
    fn = _instrumented()[name]
    off = fn()
    on, found = _profiled(fn)
    assert found, "the call opened no span"
    assert torch.equal(off, on)


def test_profiled_roots_equal_the_pins():
    """Under the profiler the step reproduces the root the JAX package
    derived (chip_smoke.PINNED_ROOTS) and the sponge its digest
    (PINNED_VARLEN)."""
    trace = np.random.default_rng(0).integers(0, P, size=(8, 64),
                                              dtype=np.uint64)
    root, _ = _profiled(lambda: pipeline.trace_lde_commit(gf.from_u64(trace)))
    assert gf.to_u64(root).tolist() == [chip_smoke.PINNED_ROOTS[64]]
    digest, _ = _profiled(lambda: tperm.hash_varlen(
        chip_smoke.varlen_input(10), "cpu"))
    assert digest.tolist() == chip_smoke.PINNED_VARLEN[10]
