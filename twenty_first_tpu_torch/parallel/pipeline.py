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

``trace_lde_commit_scrambled`` gives the same root by the JAX package's
other route (its DESIGN.md section 15): the iNTT as the DIF four-step into
the scrambled layout, with offset^j / n in its second pass; the zero
padding as a row interleave of that layout (the extended transform's split
is (log_n1 + log_e, log_n2), and brev_{L1+e}(r1 * 2^e) = brev_{L1}(r1)),
which the second pass writes straight into; the no-reverse forward
four-step back to natural order. K3's order modes (``rev_out``, ``rev_in``)
do the bit reversals in its addressing, so no pass reorders a block.

``make_dist_lde_commit`` and ``dist_lde_commit_values`` are the variant
over a mesh (``parallel/mesh.py``): the distributed NTT of one vector in
its Z layout (``dist_ntt``: K3, one all-to-all), each rank's rows hashed
by the variable-length sponge (K1's absorb mode, one launch), and the
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
from ..spans import span
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
    coset offset's powers, and Tip5's round constants and lookup table.
    ``ntt_diags`` (``lde_commit_diags``) stand in for the four-step
    diagonals it would build (``ntt.ntt_tables``)."""

    def __init__(self, w: int, n: int, expansion: int = 4,
                 offset: int | None = None, device="cuda", ntt_diags=None):
        super().__init__()
        if not 1 <= w <= RATE:
            raise ValueError(f"trace width must be 1..{RATE}, got {w}")
        _log2_exact(n, "trace length")
        _log2_exact(expansion, "expansion")
        self.w, self.n, self.expansion = w, n, expansion
        self.big_n = n * expansion
        offset = GENERATOR if offset is None else offset
        inv_diag, fwd_diag = ntt_diags if ntt_diags is not None else (None,
                                                                      None)
        for name, tables in (("inv", ntt_mod.ntt_tables(n, True, device,
                                                        inv_diag)),
                             ("fwd", ntt_mod.ntt_tables(self.big_n, False,
                                                        device, fwd_diag))):
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
        with span("lde"):
            # the iNTT scales coefficient j by offset^j in its last pass's
            # epilogue and writes straight into the head of the padded planes
            padded = torch.zeros((self.w, self.big_n), dtype=trace.dtype,
                                 device=trace.device)
            ntt_mod.ntt(trace, inverse=True, plain=plain,
                        tables=self._ntt_tables("inv", self.n, True),
                        post=self.offset_powers, out=padded[:, :self.n])
            evals = ntt_mod.ntt(padded, plain=plain,
                                tables=self._ntt_tables("fwd", self.big_n,
                                                        False))
        return hash_rows(evals, tables=(self.round_constants,
                                        self.lookup_table), plain=plain)

    def forward(self, trace, plain: bool = False):
        with span("trace_commit"):
            return tip5_commit.reduce_layers(
                self.leaf_digests(trace, plain), self.big_n.bit_length() - 1,
                tables=(self.round_constants, self.lookup_table), plain=plain)


def hash_rows(evals, *, tables=None, plain: bool = False):
    """(W, big_n) evaluation planes -> (big_n, 5) leaf digests: one
    fixed-length Tip5 permutation per row (W <= RATE)."""
    w, big_n = evals.shape
    if w > RATE:
        raise ValueError(f"at most {RATE} columns fit one permutation, got {w}")
    with span("leaf_hash"):
        states = torch.zeros((big_n, STATE_SIZE), dtype=evals.dtype,
                             device=evals.device)
        states[:, :w] = evals.t()
        states[:, RATE:] = 1
        leafs = tip5.permutation(states, tables=tables, plain=plain)
        return leafs[:, :DIGEST_LENGTH].contiguous()


def lde_commit_diags(n: int, expansion: int = 4, device="cuda"):
    """The four-step diagonals of ``trace_lde_commit`` at trace length n,
    carriers on ``device``: (the n-point iNTT's or None, the (expansion *
    n)-point NTT's or None), each given from 2^FOUR_STEP_THRESHOLD_LOG2, as
    the JAX package gives them. Pass them as ``ntt_diags`` to use them in
    place of the ones the step would build."""
    inv_d = fwd_d = None
    log_n = _log2_exact(n, "trace length")
    log_big = log_n + _log2_exact(expansion, "expansion")
    if log_n >= ntt_mod.FOUR_STEP_THRESHOLD_LOG2:
        inv_d = ntt_mod._four_step_diag_device(log_n, True, device=device)
    if log_big >= ntt_mod.FOUR_STEP_THRESHOLD_LOG2:
        fwd_d = ntt_mod._four_step_diag_device(log_big, False, device=device)
    return inv_d, fwd_d


def trace_lde_commit(trace, expansion: int = 4, offset: int | None = None,
                     ntt_diags=None, plain: bool = False):
    """Single-device STARK trace commitment: (W, n) carrier -> (1, 5) root.

    Builds the step's tables on the trace's device for this one call, with
    ``ntt_diags`` (``lde_commit_diags``) in place of its four-step
    diagonals where given; keep a ``TraceLdeCommit`` to reuse them."""
    w, n = trace.shape
    step = TraceLdeCommit(w, n, expansion, offset, device=trace.device,
                          ntt_diags=ntt_diags)
    return step(trace, plain=plain)


def lde_scrambled_tables(n: int, expansion: int = 4,
                         offset: int | None = None, device="cuda"):
    """The tables of ``trace_lde_commit_scrambled`` at trace length n, as
    carriers on ``device``: (the DIF iNTT's diagonal, pw_scr, the no-reverse
    NTT's diagonal). pw_scr (n1, n2) holds offset^j / n at the scrambled
    position of j (r1 * n2 + r2 for j = brev(r2) + n2 brev(r1)): the coset
    scaling and the iNTT's 1/n in one epilogue."""
    log_n = _log2_exact(n, "trace length")
    log_e = _log2_exact(expansion, "expansion")
    log_n1, log_n2 = ntt_mod.four_step_split(log_n)
    n1, n2 = 1 << log_n1, 1 << log_n2
    offset = GENERATOR if offset is None else offset
    d1 = ntt_mod._diag_device_general(log_n, True, True, (log_n1, log_n2),
                                      device)
    d4 = ntt_mod._norev_diag_device(log_n + log_e, False,
                                    (log_n1 + log_e, log_n2), device)
    b1 = ntt_mod.bit_reverse_permutation(log_n1)
    b2 = ntt_mod.bit_reverse_permutation(log_n2)
    j = b2[None, :] + n2 * b1[:, None]
    pw_scr = gfn.mul(gfn.powers(offset, n)[j],
                     np.uint64(pow(n, gf.P - 2, gf.P)))
    return d1, gf.from_u64(pw_scr.reshape(n1, n2)).to(device), d4


def scrambled_leaf_digests(trace, expansion: int = 4, tables=None, *,
                           plain: bool = False):
    """Steps 1-4 of ``trace_lde_commit_scrambled``: the (expansion * n, 5)
    leaf digests of the (W, n) carrier trace, the same as
    ``TraceLdeCommit.leaf_digests``. ``tables`` from
    ``lde_scrambled_tables`` (built on the trace's device when None)."""
    w, n = trace.shape
    if not 1 <= w <= RATE or trace.dtype != torch.int64:
        raise ValueError(f"trace must be (1..{RATE}, n) int64, got "
                         f"{tuple(trace.shape)} {trace.dtype}")
    log_n = _log2_exact(n, "trace length")
    log_e = _log2_exact(expansion, "expansion")
    log_n1, log_n2 = ntt_mod.four_step_split(log_n)
    d1, pw_scr, d4 = (tables if tables is not None else
                      lde_scrambled_tables(n, expansion, device=trace.device))
    # the DIF iNTT writes the scrambled coefficients into rows r1 * e of
    # the extended transform's (n1 e, n2) scrambled layout; the other rows
    # are its zero padding
    padded = torch.zeros((w, 1 << log_n1, expansion, 1 << log_n2),
                         dtype=trace.dtype, device=trace.device)
    ntt_mod._four_step(trace.reshape(w, n), (log_n1, log_n2), True, d1,
                       order="dif", post_diag=pw_scr, out=padded[:, :, 0],
                       plain=plain)
    evals = ntt_mod._four_step(padded.view(w, n * expansion),
                               (log_n1 + log_e, log_n2), False, d4,
                               order="norev", plain=plain)
    return hash_rows(evals.view(w, n * expansion),
                     tables=tip5.tip5_tables(trace.device), plain=plain)


def trace_lde_commit_scrambled(trace, expansion: int = 4, tables=None, *,
                               plain: bool = False):
    """``trace_lde_commit`` (at the default offset, or the one ``tables``
    were built for) by the scrambled route: (W, n) carrier -> (1, 5) root,
    bit for bit the natural route's (the no-reverse pass ends in natural
    order, so the leafs are the same)."""
    leafs = scrambled_leaf_digests(trace, expansion, tables, plain=plain)
    return tip5_commit.reduce_layers(
        leafs, leafs.shape[0].bit_length() - 1,
        tables=tip5.tip5_tables(trace.device), plain=plain)


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
