"""Wrapper of the NTT local-pass kernel in ``csrc/ntt.cu``, beside its twin.

The counterpart of ``twenty_first_tpu/ops/ntt_pallas.py``: K3
``ntt_local_pass`` replaces ``fused_local_pass``. A pass takes a strided
(B, t, C) view ``x`` and writes, for every batch b and column c, the
natural-order NTT of length t of ``x[b, :, c]`` into ``out[b, :, c]``,
times ``diag``, ``diag2`` and ``scale`` where given (each diagonal a (t, C)
view shared by the batches, or a (B, t, C) one). The views' strides are
what let the four-step and three-pass transforms run without a separate
transpose (``math/ntt.py``).

Two order modes serve the scrambled four-step transforms (``math/ntt.py``:
the counterparts of the JAX package's no-reverse DIT and DIF cores):
``rev_in`` reads row r of a column as element brev(r) of its input, and
``rev_out`` writes output k to row brev(k), its diagonal read at that row.
They take no second diagonal.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
twin. The wrapper counts its launches in ``ntt_local_pass.launches``.

The kernel runs the pass as rounds of up to four radix-2 stages in
registers, the inner twiddles of each round as shifts by powers of two
(``csrc/ntt.cu``), so ``tw`` must be ``math.ntt.stage_twiddles`` of the
length and direction (the twin takes any stage table).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..math import gf

#: Longest transform one pass takes (its tile must fit shared memory).
MAX_LOG_T = 12
#: log2 of the tile the wrapper aims for, in elements (2^13 * 8 B = 64 KB),
#: and of the fewest columns a tile takes; the kernel narrows a tile whose
#: t / 16 threads a column would pass 1024 threads.
_TILE_LOG2 = 13
_MIN_LOG_TC = 2


def bit_reverse_permutation(log_n: int) -> np.ndarray:
    """rev[k] = k with its log_n low bits reversed (int64)."""
    idx = np.arange(1 << log_n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def _log_t(x) -> int:
    t = x.shape[1]
    log_t = t.bit_length() - 1
    if t != 1 << log_t or not 1 <= log_t <= MAX_LOG_T:
        raise ValueError(f"pass length must be 2^1..2^{MAX_LOG_T}, got {t}")
    return log_t


def _check(x, tw, diag, diag2, out):
    if x.dim() != 3 or x.dtype != torch.int64:
        raise ValueError(f"x must be a (B, t, C) int64 view, got "
                         f"{tuple(x.shape)} {x.dtype}")
    t = 1 << _log_t(x)
    if out.shape != x.shape or out.dtype != x.dtype or out.device != x.device:
        raise ValueError("out must match x's shape, dtype and device")
    if (tw.shape != (t - 1,) or tw.dtype != torch.int64
            or tw.device != x.device or not tw.is_contiguous()):
        raise ValueError(f"tw must be the contiguous ({t - 1},) int64 stage "
                         "twiddles on x's device")
    for d in (diag, diag2):
        if d is not None and (d.shape not in (x.shape, x.shape[1:])
                              or d.dtype != x.dtype or d.device != x.device):
            raise ValueError(f"a diagonal must be a {tuple(x.shape[1:])} or "
                             f"{tuple(x.shape)} int64 tensor on x's device")
    same_view = (out.data_ptr() == x.data_ptr()
                 and out.stride() == x.stride())
    if (not same_view and out.numel() and x.numel()
            and out.untyped_storage().data_ptr()
            == x.untyped_storage().data_ptr()):
        raise ValueError("out may share x's storage only as x's very view")


def column_tile_log2(log_t: int, ncols: int) -> int:
    """log2 of the columns the wrapper asks a block to take (the kernel
    narrows it to its thread limit)."""
    return min(max(_MIN_LOG_TC, _TILE_LOG2 - log_t), (ncols - 1).bit_length())


def occupancy(log_t: int, ncols: int, device=None) -> tuple[int, int]:
    """(threads per block, resident blocks per SM) of K3's launch at
    t = 2^log_t over ``ncols`` columns, from the CUDA runtime."""
    lib = _build.load()
    block, blocks = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        _build.check(lib.tf_ntt_occupancy(
            log_t, column_tile_log2(log_t, ncols), ctypes.byref(block),
            ctypes.byref(blocks)), "ntt_occupancy")
    return block.value, blocks.value


def _strides(d):
    """(batch, element, column) strides of a diagonal, 0 where absent."""
    if d is None:
        return 0, 0, 0
    return (0,) * (3 - d.dim()) + d.stride()


def _order(diag2, rev_in: bool, rev_out: bool) -> int:
    """K3's order mode: 0 natural, 1 rev_in, 2 rev_out."""
    if rev_in and rev_out:
        raise ValueError("rev_in and rev_out exclude each other")
    if (rev_in or rev_out) and diag2 is not None:
        raise ValueError("the order modes take no second diagonal")
    return 1 if rev_in else 2 if rev_out else 0


def ntt_local_pass_plain(x, tw, *, diag=None, diag2=None, scale: int = 1,
                         out=None, rev_in: bool = False,
                         rev_out: bool = False):
    """Plain twin of K3: bit-reverse (unless ``rev_in``: the input is so
    already), radix-2 DIT stages, bit-reverse the output rows for
    ``rev_out``, epilogue."""
    _order(diag2, rev_in, rev_out)
    b, t, c = x.shape
    log_t = t.bit_length() - 1
    y = x.permute(0, 2, 1).reshape(b * c, t)
    rev = torch.from_numpy(bit_reverse_permutation(log_t)).to(x.device)
    if not rev_in:
        y = y[:, rev]
    for s in range(log_t):
        m = 1 << s
        y = y.reshape(b * c, t // (2 * m), 2, m)
        u = y[:, :, 0, :]
        v = gf.mul(y[:, :, 1, :], tw[m - 1:2 * m - 1])
        y = torch.stack([gf.add(u, v), gf.sub(u, v)], dim=2)
    y = y.reshape(b * c, t)
    if rev_out:
        y = y[:, rev]
    y = y.reshape(b, c, t).permute(0, 2, 1)
    for d in (diag2, diag):
        if d is not None:
            y = gf.mul(y, d)
    if scale != 1:
        y = gf.mul_const(y, scale)
    if out is None:
        return y.contiguous()
    out.copy_(y)
    return out


def ntt_local_pass(x, tw, *, diag=None, diag2=None, scale: int = 1,
                   out=None, rev_in: bool = False, rev_out: bool = False):
    """One local pass (see the module docstring); returns ``out``.

    x: (B, t, C) int64 view, any non-negative strides, t = 2^1..2^12.
    tw: (t - 1,) stage twiddles (``math.ntt.stage_twiddles``).
    diag, diag2: optional (t, C) or (B, t, C) views multiplied into the
    output (broadcast views with zero strides are fine).
    scale: python int multiplied into the output (1: none).
    out: (B, t, C) view to write; a new contiguous tensor when None. It
    shares no storage with x unless it is x itself (each block reads its
    whole tile before it writes, so in place is safe).
    rev_in, rev_out: the order modes (see the module docstring); a
    diagonal is then indexed by the row written.
    """
    order = _order(diag2, rev_in, rev_out)
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _check(x, tw, diag, diag2, out)
    if x.device.type == "cpu":
        return ntt_local_pass_plain(x, tw, diag=diag, diag2=diag2,
                                    scale=scale, out=out, rev_in=rev_in,
                                    rev_out=rev_out)
    if not x.is_cuda:
        raise ValueError(f"no kernel for device {x.device}")
    nb, _, ncols = x.shape
    if nb > 65535:
        raise ValueError(f"at most 65535 batches per pass, got {nb}")
    if x.numel() == 0:
        return out
    log_t = _log_t(x)
    log_tc = column_tile_log2(log_t, ncols)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.tf_ntt_local_pass(
            x.data_ptr(), out.data_ptr(), log_t, log_tc, ncols, nb,
            *x.stride(), *out.stride(), tw.data_ptr(),
            diag.data_ptr() if diag is not None else None, *_strides(diag),
            diag2.data_ptr() if diag2 is not None else None,
            *_strides(diag2), scale % gf.P, order, _build.stream_of(x))
        _build.check(err, "ntt_local_pass")
    ntt_local_pass.launches += 1
    return out


ntt_local_pass.launches = 0
