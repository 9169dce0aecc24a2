"""A prover's trace commitment: the low-degree extension of a (W, n) trace
onto the coset offset * <w_(expansion n)>, one Tip5 leaf hash per row of
the extension, and the Merkle root over those leafs, read back to the host.

The program's entry is ``parallel/pipeline.py::TraceLdeCommit.forward``,
whose tables are built once in set-up. The reference works the same
commitment out of the same trace with reference/ntt.py and reference/tip5.py.
"""

from __future__ import annotations

import numpy as np

from reference import goldilocks as gl
from reference import ntt as ref_ntt


class Operation:
    keeps_nodes = False

    def __init__(self, config: dict, mix: dict, device):
        from twenty_first_tpu_torch.parallel import pipeline

        self.w, self.n = config["columns"], 1 << config["log_rows"]
        self.expansion, self.offset = config["expansion"], config["offset"]
        self.shape = (self.w, self.n)
        self.step = pipeline.TraceLdeCommit(self.w, self.n, self.expansion,
                                            self.offset, device=device)

    def run(self, trace):
        """One commitment: (root as (5,) uint64 on the host, no nodes)."""
        return gl.to_u64(self.step(trace)).reshape(-1), None

    def release(self):
        del self.step

    def work(self) -> dict:
        big = self.expansion * self.n
        return {"hash_perms": big, "tree_leafs": big, "tree_nodes_out": 1,
                "ntt": [[self.w, self.n], [self.w, big]],
                "ntt_scaled": self.w * self.n}


def reference(config: dict, traces: list, tip5) -> list:
    """[(root, None)] of each (W, n) trace, a column of the extension at a
    time."""
    return [(_root(config, trace, tip5), None) for trace in traces]


def _root(config: dict, trace, tip5) -> np.ndarray:
    expansion, offset = config["expansion"], config["offset"]
    w, n = trace.shape
    states = None
    for c in range(w):
        col = ref_ntt.coset_lde(trace[c:c + 1], expansion, offset)[0]
        if states is None:
            states = col.new_zeros((expansion * n, w))
        states[:, c] = col
    root = tip5.merkle_root(tip5.hash_fixed(states))
    return np.asarray(gl.to_u64(root))
