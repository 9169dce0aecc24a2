"""Distributed NTT: the four-step (Bailey) decomposition over a mesh.

The counterpart of ``twenty_first_tpu/parallel/dist_ntt.py``, with the same
values bit for bit. With n = n1 * n2, j = j1 + n1*j2 and k = k2 + n2*k1:

    X[k2 + n2*k1] = NTT_n1( w^(j1*k2) * NTT_n2( x[j1 + n1*j2] )_{j2} )_{j1}

1. x viewed as an (n2, n1) matrix, its columns j1 cut over the ranks: rank
   r holds the (n2, n1/d) column block;
2. pass 1, K3 over each column (length n2), with the rank's block of the
   diagonal w^(j1*k2) in its epilogue;
3. one ``all_to_all_single`` hands rank p the rows k2 of block p from every
   rank, and a copy lays the received [source, row, column] buffer out as
   (n2/d, n1) rows;
4. pass 2, K3 over each row (length n1), with n^-1 in its epilogue for the
   inverse.

Each rank then holds the (n2/d, n1) row block of Z, Z[k2, k1] = X[k2 +
n2*k1]: X cut cyclically. ``natural_output`` pays a second all-to-all and
a local transpose for the (n1/d, n2) row block of X in natural order.

The transpose goes in ``a2a_chunks`` all-to-alls (JAX's overlap lever),
each a slice of every destination's row block, so any chunk count gives
the same rows. Both passes are ``ntt.ntt_columns``, so a transform longer
than one pass of K3 (a column from 2^25, a row from 2^26) takes two, as in
``ntt()``, with the diagonal and scale in the second one's epilogue.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..math import gf
from ..math import ntt as ntt_mod
from ..math.b_field_element import P as FIELD_P
from .mesh import AXIS, Mesh, shard_host_array

def _split_sizes(log_n: int) -> tuple[int, int]:
    """n1 (outer/natural-row) and n2 (inner) with n1 * n2 = 2^log_n."""
    log_n1, log_n2 = ntt_mod.four_step_split(log_n)
    return 1 << log_n1, 1 << log_n2


def _a2a_chunks_default() -> int:
    """``TWENTY_FIRST_TPU_A2A_CHUNKS`` (default 4), read on every call."""
    return max(1, int(os.environ.get("TWENTY_FIRST_TPU_A2A_CHUNKS", "4")))


@functools.lru_cache(maxsize=16)
def _column_diag(log_n: int, inverse: bool, rank: int, size: int,
                 device: torch.device):
    """Rank ``rank``'s (n2, n1/size) column block of
    ``ntt.four_step_diag``, kept on the rank's device."""
    cols = (1 << ntt_mod.four_step_split(log_n)[0]) // size
    block = ntt_mod.four_step_diag(log_n, inverse)[:, rank * cols:
                                                   (rank + 1) * cols]
    return gf.from_u64(np.ascontiguousarray(block)).to(device)


def _check_shape(n2: int, cols: int, d: int) -> int:
    """log_n of a rank's (n2, n1/d) block, with the JAX package's errors."""
    n1 = cols * d
    log_n = (n1 * n2).bit_length() - 1
    if n1 * n2 == 0 or (1 << log_n) != n1 * n2:
        raise ValueError("total size must be a power of two")
    expect_n1, expect_n2 = _split_sizes(log_n)
    if (n1, n2) != (expect_n1, expect_n2):
        raise ValueError(
            f"input must be shaped (n2, n1) = ({expect_n2}, {expect_n1})")
    _check_divisible(log_n, d)
    return log_n


def _check_divisible(log_n: int, d: int) -> None:
    n1, n2 = _split_sizes(log_n)
    if n1 % d or n2 % d:
        raise ValueError(f"n1={n1}, n2={n2} must be divisible by mesh size {d}")


def _chunks(n2: int, d: int, a2a_chunks: int | None) -> int:
    chunks = _a2a_chunks_default() if a2a_chunks is None else a2a_chunks
    if n2 % (d * chunks) or (n2 // d) % chunks:
        return 1  # indivisible: one all-to-all
    return chunks


def distributed_ntt(x, mesh: Mesh, inverse: bool = False,
                    natural_output: bool = False,
                    a2a_chunks: int | None = None, *, plain: bool = False):
    """Distributed NTT (see the module docstring). Every rank calls it.

    x: this rank's (n2, n1/d) column block of the coefficient vector viewed
    as M[j2, j1] = x[j1 + n1*j2], an int64 carrier on ``mesh.device``.
    Returns this rank's (n2/d, n1) row block of Z, Z[k2, k1] = X[k2 +
    n2*k1]; with ``natural_output``, its (n1/d, n2) row block of X as an
    (n1, n2) matrix in row-major natural order.

    a2a_chunks: all-to-alls the transpose takes (None: the
    TWENTY_FIRST_TPU_A2A_CHUNKS default, 4); the same values for any
    count. ``plain`` runs K3's plain twin on any device."""
    d = mesh.size
    n2, cols = x.shape
    log_n = _check_shape(n2, cols, d)
    n1 = cols * d
    rows = n2 // d
    # pass 1: the columns, with this rank's diagonal block
    y = torch.empty((n2, cols), dtype=x.dtype, device=x.device)
    ntt_mod.ntt_columns(
        x.unsqueeze(0), y.unsqueeze(0), inverse, plain=plain,
        diag=_column_diag(log_n, inverse, mesh.rank, d, x.device))
    # the transpose, chunk i handing rank p rows [i*b, (i+1)*b) of its block
    chunks = _chunks(n2, d, a2a_chunks)
    b = rows // chunks
    scale = pow(1 << log_n, FIELD_P - 2, FIELD_P) if inverse else 1
    z = torch.empty((rows, n1), dtype=x.dtype, device=x.device)
    blocks = y.view(d, chunks, b, cols)
    for i in range(chunks):
        recv = mesh.all_to_all(blocks[:, i])  # [source, row, column]
        z_rows = recv.permute(1, 0, 2).reshape(b, n1, 1)
        # pass 2: the rows
        ntt_mod.ntt_columns(z_rows, z[i * b:(i + 1) * b].unsqueeze(-1),
                            inverse, scale=scale, plain=plain)
    if not natural_output:
        return z
    # rank p gets column block p of every rank's rows: Z[:, block p], whose
    # transpose is X's rows k1 of block p in natural order
    recv = mesh.all_to_all(z.view(rows, d, cols).transpose(0, 1))
    return recv.reshape(n2, cols).t().contiguous()


def distributed_ntt_values(values, mesh: Mesh, inverse: bool = False,
                           a2a_chunks: int | None = None, *,
                           plain: bool = False) -> np.ndarray:
    """Host convenience: every rank passes the whole uint64 vector (n,) and
    gets the whole natural-order NTT back (a final all-gather)."""
    values = np.asarray(values, dtype=np.uint64)
    n = values.shape[-1]
    log_n = n.bit_length() - 1
    if n == 0 or (1 << log_n) != n:
        raise ValueError("total size must be a power of two")
    _check_divisible(log_n, mesh.size)
    n1, n2 = _split_sizes(log_n)
    x = shard_host_array(mesh, (None, AXIS), values.reshape(n2, n1))
    block = distributed_ntt(x, mesh, inverse=inverse, natural_output=True,
                            a2a_chunks=a2a_chunks, plain=plain)
    return gf.to_u64(mesh.all_gather(block)).reshape(-1)


def distributed_ntt_xfe_values(values, mesh: Mesh, inverse: bool = False, *,
                               plain: bool = False) -> np.ndarray:
    """Distributed extension-field NTT of (n, 3) canonical values: three
    base-field plane transforms (the twiddles are base-field elements)."""
    values = np.asarray(values, dtype=np.uint64)
    if values.ndim != 2 or values.shape[1] != 3:
        raise ValueError("expected (n, 3) extension-field values")
    planes = [distributed_ntt_values(values[:, i], mesh, inverse=inverse,
                                     plain=plain) for i in range(3)]
    return np.stack(planes, axis=1)
