"""Wrappers of the polynomial batch kernels in ``csrc/poly.cu``, beside
their plain twins.

No TPU kernel stands behind these three: each replaces plain-jnp work
that XLA fused on the TPU, and which the port's plain int64 torch runs as
dozens of launches per field product.

* K6 ``coset_extrapolate_fold``: out[r, j] = sum_k b[r, k] w_j^k, the
  coefficient fold of ``twenty_first_tpu/math/poly_batch.py``'s
  ``_coset_extrapolate_pow_core`` (:152) and
  ``_coset_extrapolate_xfe_pow_core`` (:226), for base-field points over
  base coefficients and extension points over base or extension
  coefficients;
* K7 ``batch_inversion``: Montgomery batch inversion along the last axis
  of a (rows, n) carrier, ``gf.batch_inversion`` (:503);
* K8 ``gf_pointwise``: the path's elementwise ops, ``gf.mul``,
  ``gf_ext.mul`` (:71), ``gf_ext.mul_base`` (:84) and
  ``gf.inverse_or_zero`` (:444), with a row operand broadcast over rows.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain twin. Each wrapper counts its calls that reach the card in
``<wrapper>.launches`` (K6 and K7 run two device kernels per call).
"""

from __future__ import annotations

import math

import torch

from .. import _build
from ..math import gf

#: K8's ops by name -> the kernel's op code: base x base, xfe x xfe,
#: xfe x base, and the base field's inverse-or-zero
POINTWISE_OPS = {"mul": 0, "xmul": 1, "xmul_base": 2, "inv": 3}

#: K6: threads a block (8 warps)
FOLD_THREADS = 256
#: K6: B, the terms a lane sums unreduced between two reductions (the
#: kernel's kFoldBlock), and by (xfe points, xfe coefficients) the lanes the
#: plan aims to fill: about one wave of resident lanes, fewer with xfe
#: points, whose lanes hold more registers and set up more, the fastest
#: that probes/fold_probe.py measured at the path's shapes on an H100
FOLD_BLOCK = 16
FOLD_TARGET_LANES = {(False, False): 1 << 16, (True, False): 1 << 15,
                     (True, True): 1 << 15}
#: K6: log2 of the shortest coefficient segment a lane folds
FOLD_MIN_SEG_LOG2 = 7

#: K7: threads a block and elements a thread, so a segment (one block's
#: product, and one field inversion) is 4096 elements
INV_THREADS = 256
INV_PER_THREAD = 16
INV_SEGMENT = INV_THREADS * INV_PER_THREAD
#: K7's device kernels a call: the segment pass, then the zero-row fix
INV_KERNELS = ("inv_segment_kernel", "inv_zero_rows_kernel")

_MAX_GRID_Y = 65535


def _device_ok(x) -> None:
    if not x.is_cuda:
        raise ValueError(f"no kernel for device {x.device}")


# ---------------------------------------------------------------------------
# K8: elementwise field ops
# ---------------------------------------------------------------------------


def _rows_view(x, lead, tail):
    """x broadcast to (*lead, *tail) as a (rows, *tail) tensor whose rows
    are one stride apart and whose tail is contiguous, and that stride (0
    for one row read for every row). A view where one serves, else a
    contiguous copy."""
    size = math.prod(tail)
    if x.numel() == size:
        return x.reshape(tail).contiguous(), 0
    v = x.expand(*lead, *tail).reshape(-1, *tail)
    tail_strides = (1,) if len(tail) == 1 else (tail[-1], 1)
    if v.stride()[1:] != tail_strides or v.stride(0) < size:
        v = v.contiguous()
    return v, v.stride(0)


def _pointwise_shapes(a, b, op: str):
    """(lead, a's tail, b's tail, out's tail) of a K8 op."""
    if op not in POINTWISE_OPS:
        raise ValueError(f"op must be one of {sorted(POINTWISE_OPS)}, got "
                         f"{op!r}")
    if a.dtype != torch.int64 or (b is not None and (
            b.dtype != torch.int64 or b.device != a.device)):
        raise ValueError("operands must be int64 tensors on one device")
    if op == "inv":
        if b is not None:
            raise ValueError("inv takes one operand")
        return a.shape[:-1], a.shape[-1:], None, a.shape[-1:]
    if b is None:
        raise ValueError(f"{op} takes two operands")
    xa = op in ("xmul", "xmul_base")
    xb = op == "xmul"
    k = 2 if xa else 1
    if a.dim() < k or b.dim() < (2 if xb else 1):
        raise ValueError(f"{op}: operands of too few axes")
    n = a.shape[-1]
    if (xa and a.shape[-2] != 3) or (xb and b.shape[-2] != 3):
        raise ValueError(f"{op}: an xfe operand needs 3 components on "
                         "axis -2")
    if b.shape[-1] != n:
        raise ValueError(f"{op}: operands of lengths {n} and {b.shape[-1]}")
    a_tail = (3, n) if xa else (n,)
    b_tail = (3, n) if xb else (n,)
    lead = torch.broadcast_shapes(a.shape[:a.dim() - len(a_tail)],
                                  b.shape[:b.dim() - len(b_tail)])
    return lead, a_tail, b_tail, a_tail


def gf_pointwise_plain(a, b, op: str):
    """Plain twin of K8: ``math/gf.py`` and ``math/gf_ext.py``'s torch
    forms, broadcasting as torch does."""
    from ..math import gf_ext

    _pointwise_shapes(a, b, op)
    if op == "mul":
        return gf.mul(a, b)
    if op == "xmul":
        return gf_ext.mul(a, b, plain=True)
    if op == "xmul_base":
        return gf_ext.mul_base(a, b, plain=True)
    return gf.inverse_or_zero(a, plain=True)


def gf_pointwise(a, b, op: str, *, out=None):
    """K8: ``op`` of ``a`` and ``b`` elementwise, canonical out.

    mul: (..., n) x (..., n); xmul: (..., 3, n) x (..., 3, n); xmul_base:
    (..., 3, n) x (..., n); inv: (..., n) alone (b None). The leading axes
    broadcast (an operand of one row is read for every row; other
    broadcasts take a copy). ``out``, where given, is a (rows, n) view
    with a contiguous last axis (the head of wider planes, say)."""
    lead, a_tail, b_tail, out_tail = _pointwise_shapes(a, b, op)
    if a.device.type == "cpu":
        res = gf_pointwise_plain(a, b, op)
        return res if out is None else out.copy_(res.reshape(out.shape))
    _device_ok(a)
    rows = math.prod(lead)
    n = a_tail[-1]
    if out is None:
        out = torch.empty((*lead, *out_tail), dtype=torch.int64,
                          device=a.device)
        out_row = n * (3 if len(out_tail) == 2 else 1)
    else:
        if (out.dim() != 2 or out.shape[0] != rows or out.shape[1] != n
                or out.stride(1) != 1 or len(out_tail) != 1
                or out.device != a.device or out.dtype != torch.int64):
            raise ValueError(f"out must be a ({rows}, {n}) int64 view with "
                             "a contiguous last axis, for a base-field op")
        out_row = out.stride(0)
    if rows == 0 or n == 0:
        return out
    av, a_row = _rows_view(a, lead, a_tail)
    bv, b_row = (None, 0) if b is None else _rows_view(b, lead, b_tail)
    lib = _build.load()
    with torch.cuda.device(a.device):
        err = lib.tf_gf_pointwise(
            av.data_ptr(), None if bv is None else bv.data_ptr(),
            out.data_ptr(), rows, n, a_row, b_row, out_row,
            POINTWISE_OPS[op], _build.stream_of(a))
        _build.check(err, "gf_pointwise")
    gf_pointwise.launches += 1
    return out


gf_pointwise.launches = 0


# ---------------------------------------------------------------------------
# K7: batch inversion
# ---------------------------------------------------------------------------


def batch_inversion_plain(x):
    """Plain twin of K7: ``gf.batch_inversion``'s prefix-product form."""
    return gf.batch_inversion(x, plain=True)


def batch_inversion(x):
    """K7: the inverse of every element of a (rows, n) carrier, one field
    inversion a 4096-element segment; a row holding a 0 comes out all
    zeros. A new (rows, n) tensor.

    Two launches: one pass over x, in which each segment's block scans its
    elements' products both ways, inverts the segment's product and writes
    every inverse, flagging a segment whose product is 0; then the flagged
    rows' segments are zeroed (a row without a 0 only reads its flags)."""
    if x.dim() != 2 or x.dtype != torch.int64:
        raise ValueError(f"x must be a (rows, n) int64 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return batch_inversion_plain(x)
    _device_ok(x)
    rows, n = x.shape
    out = torch.empty((rows, n), dtype=torch.int64, device=x.device)
    if x.numel() == 0:
        return out
    x = x.contiguous()
    zero = torch.empty((rows, -(-n // INV_SEGMENT)), dtype=torch.uint8,
                       device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.tf_batch_inversion(x.data_ptr(), out.data_ptr(), rows, n,
                                     zero.data_ptr(), _build.stream_of(x))
        _build.check(err, "batch_inversion")
    batch_inversion.launches += 1
    return out


batch_inversion.launches = 0


# ---------------------------------------------------------------------------
# K6: the coset extrapolation's coefficient fold
# ---------------------------------------------------------------------------


def fold_plan(rows: int, n: int, m: int, seg_log2: int | None = None, *,
              xpts: bool = False, xcoef: bool = False) -> dict:
    """K6's launch plan: ``log_p`` (2^log_p points a warp, lanes p, p +
    2^log_p, ... on successive segments), ``log_l`` (a lane folds a
    segment of 2^log_l coefficients, ``FOLD_BLOCK`` terms at a time, then
    scales it by w^(s 2^log_l)), ``nseg`` segments a row and ``groups``
    blocks of ``FOLD_THREADS / 2^log_p`` segments each, whose partial sums
    the second kernel adds. The segment is the longest that still gives
    ``FOLD_TARGET_LANES`` lanes (the target of the operands' fields), but
    at least 2^FOLD_MIN_SEG_LOG2 (or n); ``seg_log2`` forces it."""
    log_p = min(5, max(m - 1, 0).bit_length())
    pts = 1 << log_p
    tiles = -(-m // pts)
    log_n = max(n - 1, 0).bit_length()
    if seg_log2 is None:
        per_seg = max(rows * tiles * pts, 1)
        want_seg = -(-FOLD_TARGET_LANES[xpts, xcoef] // per_seg)
        seg_log2 = max(log_n - max(want_seg - 1, 0).bit_length(),
                       min(FOLD_MIN_SEG_LOG2, log_n))
    seg_log2 = max(0, min(seg_log2, log_n))
    nseg = max(-(-n // (1 << seg_log2)), 1)
    per_block = FOLD_THREADS >> log_p
    return {"log_p": log_p, "log_l": seg_log2, "nseg": nseg,
            "groups": -(-nseg // per_block), "tiles": tiles}


def _fold_kinds(b, w):
    """(xfe points, xfe coefficients) of a fold's operands."""
    if b.dtype != torch.int64 or w.dtype != torch.int64:
        raise ValueError("b and w must be int64 carriers")
    if w.dim() == 1:
        xpts = False
    elif w.dim() == 2 and w.shape[1] == 3:
        xpts = True
    else:
        raise ValueError(f"w must be (m,) or (m, 3) points, got "
                         f"{tuple(w.shape)}")
    if b.dim() == 2:
        xcoef = False
    elif b.dim() == 3 and b.shape[1] == 3:
        xcoef = True
    else:
        raise ValueError(f"b must be (rows, n) or (rows, 3, n) "
                         f"coefficients, got {tuple(b.shape)}")
    if xcoef and not xpts:
        raise ValueError("xfe coefficients need xfe points")
    if b.device != w.device:
        raise ValueError("b and w must lie on one device")
    return xpts, xcoef


def coset_extrapolate_fold_plain(b, w, *, point_chunk: int = 64):
    """Plain twin of K6: the JAX package's log-doubling power tables and
    weighted folds (``math/poly_batch.py``'s cores), ``point_chunk`` points
    at a time, which bounds the working set (rows x chunk x n terms)."""
    from ..math import poly_batch

    xpts, xcoef = _fold_kinds(b, w)
    chunks = []
    for start in range(0, w.shape[0], point_chunk):
        wc = w[start:start + point_chunk]
        chunks.append(poly_batch._coset_extrapolate_xfe_pow_core(b, wc, xcoef)
                      if xpts else
                      poly_batch._coset_extrapolate_pow_core(b, wc))
    if not chunks:
        shape = (b.shape[0], 0, 3) if xpts else (b.shape[0], 0)
        return torch.empty(shape, dtype=torch.int64, device=b.device)
    return torch.cat(chunks, dim=1)


def coset_extrapolate_fold(b, w, *, point_chunk: int = 64,
                           seg_log2: int | None = None):
    """K6: out[r, j] = sum_k b[r, k] w_j^k over the field of the points.

    b: (rows, n) base or (rows, 3, n) xfe coefficients; w: (m,) base or
    (m, 3) xfe points. Returns (rows, m) or (rows, m, 3), canonical.
    ``point_chunk`` only bounds the CPU twin's working set; ``seg_log2``
    forces the plan's segment length (``fold_plan``)."""
    xpts, xcoef = _fold_kinds(b, w)
    if b.device.type == "cpu":
        return coset_extrapolate_fold_plain(b, w, point_chunk=point_chunk)
    _device_ok(b)
    rows, n, m = b.shape[0], b.shape[-1], w.shape[0]
    comps = 3 if xpts else 1
    out = torch.empty((rows, m, 3) if xpts else (rows, m), dtype=torch.int64,
                      device=b.device)
    if rows == 0 or m == 0:
        return out
    if n == 0:
        return out.zero_()
    plan = fold_plan(rows, n, m, seg_log2, xpts=xpts, xcoef=xcoef)
    partial = torch.empty((rows, plan["groups"], m, comps),
                          dtype=torch.int64, device=b.device)
    b, w = b.contiguous(), w.contiguous()
    lib = _build.load()
    with torch.cuda.device(b.device):
        err = lib.tf_coset_fold(
            b.data_ptr(), w.data_ptr(), partial.data_ptr(), out.data_ptr(),
            rows, n, m, plan["log_p"], plan["log_l"], plan["nseg"],
            plan["groups"], int(xpts), int(xcoef), _build.stream_of(b))
        _build.check(err, "coset_extrapolate_fold")
    coset_extrapolate_fold.launches += 1
    return out


coset_extrapolate_fold.launches = 0
