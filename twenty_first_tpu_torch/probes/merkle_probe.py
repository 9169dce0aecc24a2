"""The Merkle tree's host/card crossover (``HOST_MERKLE_MAX_LEAFS``).

For 2^1..2^22 leafs it times ``MerkleTree.new`` over numpy leafs up to the
root, host wall time, on both routes: the host route (the native core a
level, then the node tensor's copy to the card) and the card's (the leafs'
copy, a K2 launch a level). The two are timed in turns, one call each, so
that a change in the host's load lands on both; their roots must agree. It
prints one JSON line: the medians by size, ``host_up_to`` (the largest size
at which the host's median is at least as fast) and the cut in force.
Its reading on an H100's host set the default (PERF.md section 6, with
the port's bring-up).

    python -m twenty_first_tpu_torch.probes.merkle_probe
"""

from __future__ import annotations

import contextlib
import json
import statistics

import numpy as np

from .. import native
from ..math import gf
from ..util_types import merkle_tree
from .timing import crossover, require_card, wall_times

LOG2_LEAFS = range(1, 23)


@contextlib.contextmanager
def merkle_cut(leafs: int):
    """HOST_MERKLE_MAX_LEAFS set to ``leafs`` inside the block."""
    saved = merkle_tree.HOST_MERKLE_MAX_LEAFS
    merkle_tree.HOST_MERKLE_MAX_LEAFS = leafs
    try:
        yield
    finally:
        merkle_tree.HOST_MERKLE_MAX_LEAFS = saved


def sweep(rng, log2_leafs=LOG2_LEAFS) -> dict:
    """Host against card wall ms of MerkleTree.new(leafs).root() by leaf
    count (see the module docstring)."""
    if not native.available():
        raise RuntimeError("the native host core did not load")
    host, card = {}, {}
    for log_n in log2_leafs:
        n = 1 << log_n
        leafs = rng.integers(0, gf.P, size=(n, 5), dtype=np.uint64)
        reps = 7 if log_n <= 16 else 3

        def tree_root():
            return merkle_tree.MerkleTree.new(leafs).root()

        times, roots = {n: [], 0: []}, {}
        for rep in range(reps + 1):
            for cut in ((n, 0) if rep % 2 else (0, n)):
                with merkle_cut(cut):
                    if rep == 0:  # warm-up
                        roots[cut] = tree_root()
                    else:
                        times[cut] += wall_times(tree_root, 1, warmup=0)
        if roots[n] != roots[0]:
            raise AssertionError(f"Merkle root of {n} leafs: host != card")
        host[n] = statistics.median(times[n])
        card[n] = statistics.median(times[0])
    return {"host_ms": {f"2^{n.bit_length() - 1}": v for n, v in host.items()},
            "card_ms": {f"2^{n.bit_length() - 1}": v for n, v in card.items()},
            "host_up_to": crossover(host, card),
            "chosen": merkle_tree.HOST_MERKLE_MAX_LEAFS}


def main() -> None:
    print(require_card(), flush=True)
    print(json.dumps({"probe": "merkle_crossover",
                      **sweep(np.random.default_rng(11))}), flush=True)


if __name__ == "__main__":
    main()
