"""Batch-first polynomial ops on the card.

The counterpart of ``twenty_first_tpu/math/poly_batch.py``: the layer a
STARK prover drives on whole batches of polynomials after the trace
commit, numpy in, numpy out, with the same signatures plus ``device``
(the card unless the caller names another) and ``plain`` (the plain torch
twins instead of the kernels, for holding one against the other):

  * batch_ntt / batch_intt              (rows, n) transforms (K3)
  * batch_coset_evaluate / interpolate  low-degree extension on a coset
  * batch_multiply                      pointwise-NTT products (K8)
  * batch_evaluate_barycentric          codeword-form evaluation at a point
                                        (K7's batch inversion, K8)
  * batch_coset_extrapolate(_xfe)       out-of-domain sampling: one
                                        row-batched iNTT, then K6's fold

JAX's ``use_jit`` has no counterpart: PyTorch runs eagerly. The field sums
of the barycentric formula, concatenations and zero pads stay plain torch.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gf
from . import gf_ext
from . import gf_numpy as gfn
from . import ntt as ntt_mod
from . import xgf_numpy as xgf
from .b_field_element import GENERATOR, P, PRIMITIVE_ROOTS
from ..ops import poly_cuda


def _pow_row(base: int, n: int):
    return gfn.powers(base, n)


def _to(values, device):
    return gf.from_u64(values).to(device)


def _mul(a, b, plain: bool):
    """Base-field product, through K8 unless ``plain``."""
    return gf.mul(a, b) if plain else poly_cuda.gf_pointwise(a, b, "mul")


def batch_ntt(values: np.ndarray, inverse: bool = False, device="cuda",
              plain: bool = False) -> np.ndarray:
    """(rows, n) uint64 -> row-wise (i)NTT."""
    x = _to(values, device)
    return gf.to_u64(ntt_mod.ntt(x, inverse, plain=plain))


def batch_intt(values: np.ndarray, device="cuda",
               plain: bool = False) -> np.ndarray:
    return batch_ntt(values, True, device, plain)


def batch_coset_evaluate(coefficients: np.ndarray, order: int,
                         offset: int = GENERATOR, device="cuda",
                         plain: bool = False) -> np.ndarray:
    """Row-wise low-degree extension: evaluate each row's polynomial on the
    coset offset * <omega_order>. coefficients: (rows, k) with k <= order.
    K8 scales the coefficients into the head of zero planes, K3 transforms
    them."""
    coefficients = np.asarray(coefficients, dtype=np.uint64)
    rows, k = coefficients.shape
    if k > order or order & (order - 1):
        raise ValueError(f"{k} coefficients on a coset of order {order}: "
                         "the order must be a power of two >= k")
    x = _to(coefficients, device)
    powers = _to(_pow_row(offset, k), device)
    padded = torch.zeros((rows, order), dtype=torch.int64, device=device)
    if plain:
        padded[:, :k] = gf.mul(x, powers)
    else:
        poly_cuda.gf_pointwise(x, powers, "mul", out=padded[:, :k])
    return gf.to_u64(ntt_mod.ntt(padded, plain=plain))


def batch_coset_interpolate(codewords: np.ndarray, offset: int = GENERATOR,
                            device="cuda", plain: bool = False) -> np.ndarray:
    """Inverse of batch_coset_evaluate: (rows, order) -> coefficients. The
    offset's inverse powers multiply in the iNTT's last pass (K3's
    epilogue)."""
    codewords = np.asarray(codewords, dtype=np.uint64)
    order = codewords.shape[-1]
    offset_inv = pow(int(offset), P - 2, P)
    post = _to(_pow_row(offset_inv, order), device)
    return gf.to_u64(ntt_mod.intt(_to(codewords, device), plain=plain,
                                  post=post))


def batch_multiply(a: np.ndarray, b: np.ndarray, device="cuda",
                   plain: bool = False) -> np.ndarray:
    """Row-wise polynomial products via NTT.

    a: (rows, da+1), b: (rows, db+1) -> (rows, da+db+1)."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    rows = a.shape[0]
    if b.shape[0] != rows:
        raise ValueError(f"{rows} rows times {b.shape[0]} rows")
    out_len = a.shape[1] + b.shape[1] - 1
    n = 1 << (out_len - 1).bit_length()
    pa = torch.zeros((rows, n), dtype=torch.int64, device=device)
    pb = torch.zeros((rows, n), dtype=torch.int64, device=device)
    pa[:, :a.shape[1]] = _to(a, device)
    pb[:, :b.shape[1]] = _to(b, device)
    fa = ntt_mod.ntt(pa, plain=plain)
    fb = ntt_mod.ntt(pb, plain=plain)
    prod = ntt_mod.intt(_mul(fa, fb, plain), plain=plain)
    return gf.to_u64(prod[:, :out_len])


def batch_evaluate_barycentric(codewords: np.ndarray, point: int,
                               device="cuda", plain: bool = False
                               ) -> np.ndarray:
    """Evaluate each row's interpolant (over <omega_n>) at ``point`` by the
    barycentric formula (polynomial.rs:2587-2638). A point in the domain
    gives 0 (the batch inversion's row holds a 0). codewords: (rows, n) ->
    (rows,)."""
    codewords = np.asarray(codewords, dtype=np.uint64)
    rows, n = codewords.shape
    domain = _pow_row(PRIMITIVE_ROOTS[n], n)
    z = np.full(n, point % P, dtype=np.uint64)
    diffs = _to(gfn.sub(z, domain), device)
    inv = gf.batch_inversion(diffs, plain=plain)
    weights = _mul(_to(domain, device), inv, plain)  # d_i / (z - d_i)
    terms = _mul(_to(codewords, device), weights, plain)
    num = _row_field_sum(terms)
    den_inv = gf.inverse_or_zero(_row_field_sum(weights[None, :]),
                                 plain=plain)
    return gf.to_u64(_mul(num[:, None], den_inv[None, :], plain)[:, 0])


def batch_coset_extrapolate(codewords: np.ndarray, offset: int,
                            points: np.ndarray, point_chunk: int = 64,
                            device="cuda", plain: bool = False) -> np.ndarray:
    """Extrapolate codeword rows over the coset ``offset * <omega_n>`` to
    arbitrary points, the STARK out-of-domain-sampling hot path (reference
    dispatch: polynomial.rs:2117-2331).

    Coefficient route: ONE row-batched iNTT recovers g with g(omega^i) =
    c_i, and f(z) = g(z/offset) is K6's fold of the coefficients at the
    scaled points (no inversion; exact at in-domain points too).
    ``point_chunk`` bounds the plain twin's working set. codewords: (rows,
    n); points: (m,) -> (rows, m)."""
    cw = np.asarray(codewords, dtype=np.uint64)
    pts = np.asarray(points, dtype=np.uint64) % np.uint64(P)
    off = int(offset) % P
    coeffs = ntt_mod.intt(_to(cw, device), plain=plain)
    w = _to(gfn.mul(pts, np.uint64(pow(off, P - 2, P))), device)
    fold = (poly_cuda.coset_extrapolate_fold_plain if plain
            else poly_cuda.coset_extrapolate_fold)
    return gf.to_u64(fold(coeffs, w, point_chunk=point_chunk))


def _coset_extrapolate_pow_core(b, w):
    """Plain core: coefficients (rows, n), scaled point chunk (c,) ->
    (rows, c) values g(w_j) = sum_k b_k w_j^k.

    The power table W[j, k] = w_j^k is built by log-doubling (concat(W,
    W * w^width) per level: n multiplies per point), then one weighted
    fold against the coefficients."""
    n = b.shape[-1]
    pw = torch.ones((w.shape[0], 1), dtype=torch.int64, device=w.device)
    step = w  # w^width, width = the table's current width
    width = 1
    while width < n:
        pw = torch.cat([pw, gf.mul(pw, step[:, None])], dim=-1)
        width *= 2
        if width < n:
            step = gf.mul(step, step)
    terms = gf.mul(b[:, None, :], pw[None, :, :n])  # (rows, c, n)
    return _row_field_sum(terms)


def batch_coset_extrapolate_xfe(codewords: np.ndarray, offset: int,
                                points: np.ndarray, point_chunk: int = 16,
                                device="cuda", plain: bool = False
                                ) -> np.ndarray:
    """Extrapolate codeword rows to EXTENSION-FIELD points, the STARK
    out-of-domain-sampling shape (base-field trace columns sampled at an
    xfe challenge; x_field_element.rs lift semantics).

    codewords: (rows, n) base-field or (rows, n, 3) extension-field values;
    points: (m, 3) xfe values (in- or out-of-domain). Returns (rows, m, 3).
    The same route as batch_coset_extrapolate with K6 folding in the
    extension field; base-field codewords keep base coefficients (the
    reference's ``MulAssign<BFieldElement>`` structure), xfe codewords
    transform as three base rows each."""
    cw = np.asarray(codewords, dtype=np.uint64)
    pts = np.asarray(points, dtype=np.uint64) % np.uint64(P)
    off = int(offset) % P
    x = gf_ext.from_u64(cw) if cw.ndim == 3 else gf.from_u64(cw)
    coeffs = ntt_mod.intt(x.to(device), plain=plain)
    w = _to(xgf.mul_base(pts, np.uint64(pow(off, P - 2, P))), device)
    fold = (poly_cuda.coset_extrapolate_fold_plain if plain
            else poly_cuda.coset_extrapolate_fold)
    return gf.to_u64(fold(coeffs, w, point_chunk=point_chunk))


def _coset_extrapolate_xfe_pow_core(b, w, cw_x: bool):
    """Plain core, extension-field points: coefficients ((rows, n) base or
    (rows, 3, n) xfe), scaled point chunk (c, 3) -> (rows, c, 3) values by
    log-doubling xfe power tables."""
    n = b.shape[-1]
    c = w.shape[0]
    # power table (c, 3, width): starts at [w^0] = [1, 0, 0]
    pw = torch.zeros((c, 3, 1), dtype=torch.int64, device=w.device)
    pw[:, 0, :] = 1
    step = w[..., None]  # w^width as (c, 3, 1)
    width = 1
    while width < n:
        pw = torch.cat([pw, gf_ext.mul(pw, step, plain=True)], dim=-1)
        width *= 2
        if width < n:
            step = gf_ext.mul(step, step, plain=True)
    pw = pw[..., :n]
    if cw_x:
        terms = gf_ext.mul(pw[None], b[:, None], plain=True)  # (rows, c, 3, n)
    else:
        terms = gf_ext.mul_base(pw[None], b[:, None, :], plain=True)
    return _row_field_sum(terms)  # (rows, c, 3)


def _row_field_sum(x):
    """Field sum along the last (power-of-two) axis via log-depth halving."""
    n = x.shape[-1]
    assert n & (n - 1) == 0 and n > 0
    while n > 1:
        half = n // 2
        x = gf.add(x[..., :half], x[..., half:])
        n = half
    return x[..., 0]
