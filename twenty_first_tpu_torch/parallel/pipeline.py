"""STARK trace LDE + Tip5 Merkle commit: the library's flagship step.

The counterpart of ``twenty_first_tpu/parallel/pipeline.py``.
``trace_lde_commit`` low-degree-extends a (W, n) trace on one device and
commits to it:

1. interpolate each column: an inverse NTT over the trace domain;
2. scale coefficient j by offset^j (the coset offset, GENERATOR = 7 by
   default) and zero-pad to the extended length expansion * n;
3. evaluate: a forward NTT of length expansion * n;
4. hash each row of the (expansion * n, W) evaluation matrix with ONE Tip5
   permutation (W words, zeros up to RATE, capacity words 1: the
   FixedLength domain, W <= RATE);
5. reduce the leaf digests to a Merkle root.

On a CUDA tensor the NTTs run through K3, the leaf hash through K1 and the
tree through K2; ``plain=True`` runs the plain twins instead, on any device.

``make_dist_lde_commit`` and ``dist_lde_commit_values`` are the variant
over a mesh (``parallel/mesh.py``): the distributed NTT of one vector in
its Z layout (``dist_ntt``: K3, one all-to-all), each rank's rows hashed
by the variable-length sponge (K1, one launch per absorb), and the
distributed Merkle root over the n2 leafs (``dist_merkle``: K2, one
all-gather). Leaf k2 is the hash of X[k2::n2], the stride-n2 slice of the
natural-order codeword, not of a natural-order row.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..math import gf
from ..math import gf_numpy as gfn
from ..math import ntt as ntt_mod
from ..math.b_field_element import GENERATOR
from ..ops import tip5_commit
from ..tip5 import permutation as tip5
from ..tip5.constants import DIGEST_LENGTH, RATE, STATE_SIZE
from ..tip5.digest import Digest
from . import dist_merkle, dist_ntt
from .mesh import AXIS, Mesh, shard_host_array


def _log2_exact(n: int, what: str) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{what} must be a power of two, got {n}")
    return n.bit_length() - 1


class TraceLdeCommit(nn.Module):
    """LDE + commit of (w, n) traces: ``forward(trace) -> (1, 5)`` root.

    Holds every table of the step as a buffer, on ``device`` (the card
    unless the caller asks for another): the twiddles and four-step
    diagonals of the n-point iNTT and the (expansion * n)-point NTT, the
    coset offset's powers, and Tip5's round constants and lookup table."""

    def __init__(self, w: int, n: int, expansion: int = 4,
                 offset: int | None = None, device="cuda"):
        super().__init__()
        if not 1 <= w <= RATE:
            raise ValueError(f"trace width must be 1..{RATE}, got {w}")
        _log2_exact(n, "trace length")
        _log2_exact(expansion, "expansion")
        self.w, self.n, self.expansion = w, n, expansion
        self.big_n = n * expansion
        offset = GENERATOR if offset is None else offset
        for name, tables in (("inv", ntt_mod.ntt_tables(n, True, device)),
                             ("fwd", ntt_mod.ntt_tables(self.big_n, False,
                                                        device))):
            for field in ("tw1", "tw2", "diag"):
                self.register_buffer(f"{name}_{field}",
                                     getattr(tables, field), persistent=False)
        self.register_buffer(
            "offset_powers", gf.from_u64(gfn.powers(offset, n)).to(device),
            persistent=False)
        rc, lut = tip5.tip5_tables(device)
        self.register_buffer("round_constants", rc, persistent=False)
        self.register_buffer("lookup_table", lut, persistent=False)

    def _ntt_tables(self, name: str, n: int, inverse: bool):
        return ntt_mod.NttTables(n, inverse, getattr(self, f"{name}_tw1"),
                                 getattr(self, f"{name}_tw2"),
                                 getattr(self, f"{name}_diag"))

    def leaf_digests(self, trace, plain: bool = False):
        """Steps 1-4: the (expansion * n, 5) leaf digests of the commit."""
        if trace.shape != (self.w, self.n) or trace.dtype != torch.int64:
            raise ValueError(f"trace must be ({self.w}, {self.n}) int64, got "
                             f"{tuple(trace.shape)} {trace.dtype}")
        if trace.device != self.offset_powers.device:
            raise ValueError(f"trace on {trace.device}, tables on "
                             f"{self.offset_powers.device}")
        # the iNTT scales coefficient j by offset^j in its last pass's
        # epilogue and writes straight into the head of the padded planes
        padded = torch.zeros((self.w, self.big_n), dtype=trace.dtype,
                             device=trace.device)
        ntt_mod.ntt(trace, inverse=True, plain=plain,
                    tables=self._ntt_tables("inv", self.n, True),
                    post=self.offset_powers, out=padded[:, :self.n])
        evals = ntt_mod.ntt(padded, plain=plain,
                            tables=self._ntt_tables("fwd", self.big_n, False))
        return hash_rows(evals, tables=(self.round_constants,
                                        self.lookup_table), plain=plain)

    def forward(self, trace, plain: bool = False):
        return tip5_commit.reduce_layers(
            self.leaf_digests(trace, plain), self.big_n.bit_length() - 1,
            tables=(self.round_constants, self.lookup_table), plain=plain)


def hash_rows(evals, *, tables=None, plain: bool = False):
    """(W, big_n) evaluation planes -> (big_n, 5) leaf digests: one
    fixed-length Tip5 permutation per row (W <= RATE)."""
    w, big_n = evals.shape
    if w > RATE:
        raise ValueError(f"at most {RATE} columns fit one permutation, got {w}")
    states = torch.zeros((big_n, STATE_SIZE), dtype=evals.dtype,
                         device=evals.device)
    states[:, :w] = evals.t()
    states[:, RATE:] = 1
    leafs = tip5.permutation(states, tables=tables, plain=plain)
    return leafs[:, :DIGEST_LENGTH].contiguous()


def trace_lde_commit(trace, expansion: int = 4, offset: int | None = None,
                     plain: bool = False):
    """Single-device STARK trace commitment: (W, n) carrier -> (1, 5) root.

    Builds the step's tables on the trace's device for this one call; keep
    a ``TraceLdeCommit`` to reuse them."""
    w, n = trace.shape
    step = TraceLdeCommit(w, n, expansion, offset, device=trace.device)
    return step(trace, plain=plain)


def lde_commit(x, plain: bool = False):
    """LDE + commit on (rows, n): NTT each row, hash each evaluation row
    with the variable-length sponge into a leaf digest, and reduce the
    ``rows`` leafs (a power of two) to a (1, 5) root."""
    log_rows = _log2_exact(x.shape[0], "row count")
    tables = tip5.tip5_tables(x.device)
    z = ntt_mod.ntt(x, plain=plain)
    leafs = tip5.hash_varlen_padded(tip5.pad_for_varlen(z), tables=tables,
                                    plain=plain)
    return tip5_commit.reduce_layers(leafs, log_rows, tables=tables,
                                     plain=plain)


@functools.lru_cache(maxsize=16)
def make_dist_lde_commit(mesh: Mesh, log_n: int):
    """The distributed LDE + commit of 2^log_n coefficients: a function of
    this rank's (n2, n1/d) column block (an int64 carrier on
    ``mesh.device``; ``plain`` runs the twins) returning the (1, 5) root
    on every rank."""
    dist_ntt._check_divisible(log_n, mesh.size)
    log_n2 = ntt_mod.four_step_split(log_n)[1]

    def run(block, plain: bool = False):
        z = dist_ntt.distributed_ntt(block, mesh, plain=plain)  # (n2/d, n1)
        leafs = tip5.hash_varlen_padded(
            tip5.pad_for_varlen(z), tables=tip5.tip5_tables(z.device),
            plain=plain)
        return dist_merkle._root(leafs, mesh, log_n2, plain)

    return run


def dist_lde_commit_values(values, mesh: Mesh, *,
                           plain: bool = False) -> Digest:
    """Host convenience: every rank passes the whole coefficient vector
    (n,) and gets the committed root."""
    values = np.asarray(values, dtype=np.uint64)
    n = values.shape[-1]
    log_n = _log2_exact(n, "vector length")
    n1, n2 = dist_ntt._split_sizes(log_n)
    step = make_dist_lde_commit(mesh, log_n)
    block = shard_host_array(mesh, (None, AXIS), values.reshape(n2, n1))
    return Digest.from_array(gf.to_u64(step(block, plain))[0])
