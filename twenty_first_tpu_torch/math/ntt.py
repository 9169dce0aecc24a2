"""Natural-order NTT / iNTT over the last axis of int64 carrier tensors.

The counterpart of ``twenty_first_tpu/math/ntt.py``'s default path
(``ntt_limbs_traceable`` and ``four_step_ntt_traceable``): the same values
as the reference's bit-reverse + radix-2 DIT transform, X[k] = sum_j
x[j] w^(jk) with w = PRIMITIVE_ROOTS[n] (its inverse for the iNTT, which
also scales by 1/n).

Up to 2^12 one local pass (K3, ``ops/ntt_cuda.py``) transforms every row.
Above, up to 2^24, the four-step decomposition with n = n1 * n2, log_n1 =
log_n // 2:

    X[k2 + n2*k1] = NTT_n1( w^(j1*k2) * NTT_n2( x[j1 + n1*j2] )_{j2} )_{j1}

pass 1 transforms over j2 and multiplies the diagonal w^(j1*k2) (laid out
[k2, j1]) in its epilogue; pass 2 reads the (n2, n1) result transposed,
transforms over j1 with 1/n in its epilogue, and writes natural order. The
values do not depend on the decomposition, so the JAX package's 2^17
threshold does not matter here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import gf
from . import gf_numpy as gfn
from .b_field_element import P, PRIMITIVE_ROOTS
from ..ops import ntt_cuda
from ..ops.ntt_cuda import MAX_LOG_T, bit_reverse_permutation  # noqa: F401

MAX_LOG_N = 2 * MAX_LOG_T


def _log2(n: int) -> int:
    log_n = n.bit_length() - 1
    if n < 1 or n != 1 << log_n or log_n > MAX_LOG_N:
        raise ValueError(f"NTT length must be a power of two <= 2^{MAX_LOG_N}, "
                         f"got {n}")
    return log_n


def _root(n: int, inverse: bool) -> int:
    root = PRIMITIVE_ROOTS[n]
    return pow(root, P - 2, P) if inverse else root


def four_step_split(log_n: int) -> tuple[int, int]:
    """(log_n1, log_n2): n1 = 2^(log_n // 2) columns of length n2."""
    return log_n // 2, log_n - log_n // 2


def stage_twiddles(log_t: int, inverse: bool) -> np.ndarray:
    """(t - 1,) uint64: stage s (m = 2^s) holds w_{2m}^r for r < m at
    offset m - 1, w_{2m} = root_t^(t / 2m)."""
    t = 1 << log_t
    root = _root(t, inverse)
    stages = [gfn.powers(pow(root, t // (2 << s), P), 1 << s)
              for s in range(log_t)]
    return np.concatenate(stages) if stages else np.zeros(0, np.uint64)


def four_step_diag(log_n: int, inverse: bool) -> np.ndarray:
    """(n2, n1) uint64 diagonal twiddles w^(j1*k2), laid out [k2, j1]."""
    log_n1, log_n2 = four_step_split(log_n)
    pw = gfn.powers(_root(1 << log_n, inverse), 1 << log_n)
    k2 = np.arange(1 << log_n2, dtype=np.int64)[:, None]
    j1 = np.arange(1 << log_n1, dtype=np.int64)[None, :]
    return pw[k2 * j1]  # j1 * k2 < n: no wrap


@dataclass(frozen=True)
class NttTables:
    """Device tables of one transform size and direction.

    tw1: pass 1's stage twiddles (length n for a single pass, else n2);
    tw2, diag: pass 2's twiddles (length n1) and the [k2, j1] diagonal,
    both None for a single pass."""

    n: int
    inverse: bool
    tw1: torch.Tensor
    tw2: torch.Tensor | None = None
    diag: torch.Tensor | None = None


def ntt_tables(n: int, inverse: bool = False, device="cuda") -> NttTables:
    log_n = _log2(n)
    if log_n <= MAX_LOG_T:
        return NttTables(n, inverse,
                         gf.from_u64(stage_twiddles(log_n, inverse)).to(device))
    log_n1, log_n2 = four_step_split(log_n)
    return NttTables(
        n, inverse,
        gf.from_u64(stage_twiddles(log_n2, inverse)).to(device),
        gf.from_u64(stage_twiddles(log_n1, inverse)).to(device),
        gf.from_u64(four_step_diag(log_n, inverse)).to(device))


def ntt(x, inverse: bool = False, *, tables: NttTables | None = None,
        plain: bool = False):
    """NTT over the last axis of a (..., n) carrier tensor; a new tensor.

    Through K3 for a CUDA tensor, its plain twin for a CPU tensor or when
    ``plain`` asks for it. ``tables`` (from ``ntt_tables``) saves building
    them per call."""
    n = x.shape[-1]
    log_n = _log2(n)
    if n == 1:
        return x.clone()
    if tables is None:
        tables = ntt_tables(n, inverse, x.device)
    if tables.n != n or tables.inverse != inverse:
        raise ValueError("tables were built for another size or direction")
    local_pass = (ntt_cuda.ntt_local_pass_plain if plain
                  else ntt_cuda.ntt_local_pass)
    scale = pow(n, P - 2, P) if inverse else 1
    rows = x.reshape(-1, n).contiguous()
    if tables.diag is None:
        # one pass; the rows are its columns: views (1, n, rows)
        out = torch.empty_like(rows)
        local_pass(rows.t().unsqueeze(0), tables.tw1, scale=scale,
                   out=out.t().unsqueeze(0))
        return out.reshape(x.shape)
    log_n1, log_n2 = four_step_split(log_n)
    y = local_pass(rows.view(-1, 1 << log_n2, 1 << log_n1), tables.tw1,
                   diag=tables.diag)  # Y[b, k2, j1]
    z = local_pass(y.transpose(1, 2), tables.tw2, scale=scale)  # Z[b, k1, k2]
    return z.reshape(x.shape)


def intt(x, *, tables: NttTables | None = None, plain: bool = False):
    return ntt(x, inverse=True, tables=tables, plain=plain)


def ntt_values(values, inverse: bool = False, device="cuda") -> np.ndarray:
    """NTT of a host uint64 array over its last axis, on ``device`` (the
    card unless the caller asks for another)."""
    x = gf.from_u64(values).to(device)
    return gf.to_u64(ntt(x, inverse=inverse))


def intt_values(values, device="cuda") -> np.ndarray:
    return ntt_values(values, inverse=True, device=device)
