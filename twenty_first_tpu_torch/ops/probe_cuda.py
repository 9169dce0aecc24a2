"""Wrappers of the probe kernels in ``csrc/probes.cu``, beside their twins.

The counterparts of the Pallas probes in ``scripts/``:

* K4 ``ntt_stage`` (replaces ``prof_pallas_pass.py::make_pass`` with
  ``roundtrip``, :53/:57): one radix-2 DIT stage of a t-point NTT over the
  columns of a (t, C) view, through device memory; ``log_t`` launches make
  a pass (``probes/pass_probe.py``);
* K5 ``gf_chain`` (replaces ``pallas_alu_probe.py::make_pallas``, :38/:39):
  k steps of ``o = op(o, b)`` then the limb swap, op ``mul_lazy`` or
  ``add_lazy``, returning the raw lazy words (``probes/alu_probe.py``), in
  one of the forms of ``CHAIN_FORMS``, which give the same words.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
twin. Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from .. import _build
from ..math import gf
from .ntt_cuda import bit_reverse_permutation

#: K5's ops, by the name of their ``math/gf.py`` form -> the kernel's code.
CHAIN_OPS = {"mul_lazy": 0, "add_lazy": 1}
#: K5's forms of an op -> the kernel's code: "cc" the carry chains the
#: library's kernels run (``gl::mul_red``, ``gl::add_lazy_cc``), "c" the C
#: forms with compares and selects (``gl::mul_lazy``, ``gl::add_lazy``)
CHAIN_FORMS = {"cc": 0, "c": 1}
MAX_LOG_T = 30


def _shares_storage(a, b) -> bool:
    return (a.numel() > 0 and b.numel() > 0
            and a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr())


# ---------------------------------------------------------------------------
# K4: one NTT stage through device memory
# ---------------------------------------------------------------------------


def _check_stage(x, tw, stage: int, bit_reverse: bool, out) -> int:
    if x.dim() != 2 or x.dtype != torch.int64:
        raise ValueError(f"x must be a (t, C) int64 view, got "
                         f"{tuple(x.shape)} {x.dtype}")
    t = x.shape[0]
    log_t = t.bit_length() - 1
    if t != 1 << log_t or not 1 <= log_t <= MAX_LOG_T:
        raise ValueError(f"stage length must be 2^1..2^{MAX_LOG_T}, got {t}")
    if not 0 <= stage < log_t:
        raise ValueError(f"stage must be 0..{log_t - 1}, got {stage}")
    if (tw.shape != (t - 1,) or tw.dtype != torch.int64
            or tw.device != x.device or not tw.is_contiguous()):
        raise ValueError(f"tw must be the contiguous ({t - 1},) int64 stage "
                         "twiddles on x's device")
    if out.shape != x.shape or out.dtype != x.dtype or out.device != x.device:
        raise ValueError("out must match x's shape, dtype and device")
    same_view = out.data_ptr() == x.data_ptr() and out.stride() == x.stride()
    if _shares_storage(out, x) and (bit_reverse or not same_view):
        raise ValueError("out may share x's storage only as x's very view, "
                         "and not with bit_reverse")
    return log_t


def ntt_stage_plain(x, tw, stage: int, *, bit_reverse: bool = False,
                    out=None):
    """Plain twin of one K4 launch (see ``ntt_stage``)."""
    t, cols = x.shape
    log_t = t.bit_length() - 1
    y = x.t()
    if bit_reverse:
        y = y[:, torch.from_numpy(bit_reverse_permutation(log_t)).to(x.device)]
    m = 1 << stage
    y = y.reshape(cols, t // (2 * m), 2, m)
    u = y[:, :, 0, :]
    v = gf.mul(y[:, :, 1, :], tw[m - 1:2 * m - 1])
    y = torch.stack([gf.add(u, v), gf.sub(u, v)], dim=2).reshape(cols, t).t()
    if out is None:
        return y.contiguous()
    out.copy_(y)
    return out


def ntt_stage(x, tw, stage: int, *, bit_reverse: bool = False, out=None):
    """Radix-2 DIT stage ``stage`` (m = 2^stage) over the columns of x.

    x: (t, C) int64 view, any non-negative strides, canonical values.
    tw: (t - 1,) stage twiddles (``math.ntt.stage_twiddles``).
    bit_reverse: read row rev(j) for row j first (stage 0 of a pass).
    out: (t, C) view to write, a new contiguous tensor when None; it may be
    x itself (a stage reads both elements of a butterfly before it writes
    them) unless ``bit_reverse``. Canonical out; returns ``out``."""
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    log_t = _check_stage(x, tw, stage, bit_reverse, out)
    if x.device.type == "cpu":
        return ntt_stage_plain(x, tw, stage, bit_reverse=bit_reverse, out=out)
    if not x.is_cuda:
        raise ValueError(f"no kernel for device {x.device}")
    if x.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.tf_ntt_stage(
            x.data_ptr(), out.data_ptr(), log_t, stage, x.shape[1],
            *x.stride(), *out.stride(), tw.data_ptr(), int(bit_reverse),
            _build.stream_of(x))
        _build.check(err, "ntt_stage")
    ntt_stage.launches += 1
    return out


ntt_stage.launches = 0


# ---------------------------------------------------------------------------
# K5: a chain of lazy field ops
# ---------------------------------------------------------------------------


def _swap_limbs(x):
    """(lo, hi) -> (hi, lo): a 32-bit rotation of the u64 pattern."""
    return (x << 32) | gf._shr(x, 32)


def _check_chain(a, b, op: str, k: int, form: str = "cc"):
    if op not in CHAIN_OPS:
        raise ValueError(f"op must be one of {sorted(CHAIN_OPS)}, got {op!r}")
    if form not in CHAIN_FORMS:
        raise ValueError(f"form must be one of {sorted(CHAIN_FORMS)}, got "
                         f"{form!r}")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    if (a.dtype != torch.int64 or b.dtype != torch.int64
            or a.shape != b.shape or a.device != b.device):
        raise ValueError("a and b must be int64 tensors of one shape on one "
                         "device")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")


def gf_chain_plain(a, b, op: str, k: int):
    """Plain twin of K5: k steps of ``o = op(o, b)``, each followed by the
    limb swap, from o = a (``math/gf.py``'s lazy forms)."""
    fn = getattr(gf, op)
    o = a
    for _ in range(k):
        o = _swap_limbs(fn(o, b))
    return o.clone() if k == 0 else o


def gf_chain(a, b, op: str, k: int, form: str = "cc"):
    """K5: the chain of ``gf_chain_plain`` on any u64 words, raw lazy words
    out (a new tensor of a's shape), the op in ``form`` (``CHAIN_FORMS``;
    every form gives the same words)."""
    _check_chain(a, b, op, k, form)
    if a.device.type == "cpu":
        return gf_chain_plain(a, b, op, k)
    if not a.is_cuda:
        raise ValueError(f"no kernel for device {a.device}")
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(a.device):
        err = lib.tf_gf_chain(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                              a.numel(), k, CHAIN_OPS[op], CHAIN_FORMS[form],
                              _build.stream_of(a))
        _build.check(err, "gf_chain")
    gf_chain.launches += 1
    return out


gf_chain.launches = 0
