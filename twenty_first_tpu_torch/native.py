"""ctypes bridge to the native host core (``native/twenty_first_native.cpp``).

The port's own loader of the C++ core the JAX package loads through
``twenty_first_tpu/native.py`` (importing that package would import JAX).
The ctypes signatures and wrappers are copies of that module's; the build
is the port's: ``native/twenty_first_native.cpp``, unedited, compiled by
g++ with the flags of ``native/Makefile`` into ``.build/`` beside this file
(git ignores it), keyed by a hash of the source, the flags and the host's
CPU (the flags hold ``-march=native``), so an edited source or another CPU
never loads a stale library. Nothing is written into ``native/``. Several
processes may start the build at once (test workers): one builds under a
file lock, to a temporary name moved into place.

The JAX package's switches are honored: ``TWENTY_FIRST_TPU_NO_NATIVE``
(any value) leaves the core unloaded, ``TWENTY_FIRST_TPU_NATIVE_HOST=0``
keeps the host arithmetic on its numpy forms. Without the core (no g++,
or the switch) every caller takes its numpy form, which gives the same
values. ``available()`` reports the state.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

SOURCE = (Path(__file__).resolve().parent.parent / "native"
          / "twenty_first_native.cpp")
BUILD_DIR = Path(__file__).resolve().parent / ".build"
CXX = "g++"
# native/Makefile's CXXFLAGS
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall",
            "-fopenmp")

_LIB = None
_TRIED = False


def _cpu_identity() -> bytes:
    """What ``-march=native`` compiles for: the machine and the CPU's
    model and feature flags."""
    ident = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    ident += line
                if line.strip() == "":
                    break
    except OSError:
        pass
    return ident.encode()


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join((CXX,) + CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_cpu_identity())
    return Path(build_dir) / f"native_{h.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the core unless this exact build exists; returns the .so."""
    so = library_path(build_dir)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not so.exists():
                tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
                proc = subprocess.run(
                    [CXX, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                    capture_output=True, text=True, timeout=300, check=False)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"{CXX} exited {proc.returncode}:\n"
                                       f"{proc.stderr}")
                os.replace(tmp, so)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so


def open_library(path: Path):
    """Load a built core and declare every entry point's signature."""
    lib = ctypes.CDLL(str(path))
    # Pointer args are declared c_void_p and passed as raw ints
    # (arr.ctypes.data): a ctypes POINTER object per argument costs ~10 us
    # a call, which dominates small arrays.
    vp, sz, u64 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint64
    lib.gl_mul_arrays.argtypes = [vp, vp, vp, sz]
    lib.gl_xfe_mul_arrays.argtypes = [vp, vp, vp, sz]
    lib.gl_add_arrays.argtypes = [vp, vp, vp, sz]
    lib.gl_sub_arrays.argtypes = [vp, vp, vp, sz]
    lib.gl_batch_inverse.argtypes = [vp, vp, sz]
    lib.gl_batch_inverse_or_zero.argtypes = [vp, vp, sz]
    lib.gl_mul_scalar.argtypes = [u64, u64]
    lib.gl_mul_scalar.restype = u64
    lib.gl_inv_scalar.argtypes = [u64]
    lib.gl_inv_scalar.restype = u64
    lib.gl_pow_scalar.argtypes = [u64, u64]
    lib.gl_pow_scalar.restype = u64
    lib.tip5_init.argtypes = [vp, vp, vp]
    lib.tip5_permute_batch.argtypes = [vp, sz]
    lib.tip5_hash_pairs.argtypes = [vp, vp, sz]
    lib.tip5_merkle_root.argtypes = [vp, vp, sz]
    lib.tip5_hash_varlen.argtypes = [vp, sz, vp]
    lib.gl_horner_points.argtypes = [vp, sz, vp, sz, vp]
    lib.gl_reduce_by_ntt_modulus.argtypes = [vp, sz, vp, sz, sz, vp, vp, u64,
                                             vp]
    lib.gl_ntt.argtypes = [vp, sz, u64]
    lib.gl_intt.argtypes = [vp, sz, u64]
    lib.gl_ntt_rows.argtypes = [vp, sz, sz, vp, u64]
    lib.gl_poly_divmod.argtypes = [vp, sz, vp, sz, vp, vp]
    lib.gl_lagrange_interpolate.argtypes = [vp, vp, sz, vp]
    for name in ("gl_mul_arrays", "gl_xfe_mul_arrays", "gl_add_arrays",
                 "gl_sub_arrays", "gl_batch_inverse",
                 "gl_batch_inverse_or_zero", "tip5_init",
                 "tip5_permute_batch", "tip5_hash_pairs", "tip5_merkle_root",
                 "tip5_hash_varlen", "gl_horner_points",
                 "gl_reduce_by_ntt_modulus", "gl_ntt", "gl_intt",
                 "gl_ntt_rows", "gl_poly_divmod", "gl_lagrange_interpolate"):
        getattr(lib, name).restype = None

    # one-time Tip5 constant upload
    from .tip5.constants import (
        LOOKUP_TABLE,
        MDS_MATRIX_FIRST_COLUMN,
        ROUND_CONSTANTS,
    )

    lut = np.ascontiguousarray(LOOKUP_TABLE.astype(np.uint8))
    rc = np.ascontiguousarray(ROUND_CONSTANTS)
    col = np.ascontiguousarray(MDS_MATRIX_FIRST_COLUMN.astype(np.uint64))
    lib.tip5_init(lut.ctypes.data, rc.ctypes.data, col.ctypes.data)
    return lib


def _load():
    """The core, built and loaded on first use; None where it cannot be
    (the switch is set, or g++ is missing or fails)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("TWENTY_FIRST_TPU_NO_NATIVE"):
        return None
    try:
        path = build()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    _LIB = open_library(path)
    return _LIB


def available() -> bool:
    return _load() is not None


def host_arithmetic():
    """The loaded core for the host arithmetic of ``gf_numpy`` and
    ``xgf_numpy``, or None when it is unavailable or
    ``TWENTY_FIRST_TPU_NATIVE_HOST=0`` keeps them on numpy."""
    if os.environ.get("TWENTY_FIRST_TPU_NATIVE_HOST") == "0":
        return None
    return _load()


def _u64p(arr):
    """Raw data pointer as int (argtypes are c_void_p: see open_library)."""
    return arr.ctypes.data


def _lib():
    lib = _load()
    if lib is None:
        raise RuntimeError("the native host core is not available")
    return lib


def tip5_permute_batch(states: np.ndarray) -> np.ndarray:
    """(..., 16) uint64 canonical states -> permuted."""
    out = np.ascontiguousarray(states, dtype=np.uint64).copy()
    _lib().tip5_permute_batch(_u64p(out), out.size // 16)
    return out


def tip5_hash_pairs(nodes: np.ndarray) -> np.ndarray:
    """One Merkle layer: (2b, 5) uint64 digests -> (b, 5) hash_pair rows."""
    nodes = np.ascontiguousarray(nodes, dtype=np.uint64)
    b = nodes.shape[0] // 2
    out = np.empty((b, 5), dtype=np.uint64)
    _lib().tip5_hash_pairs(_u64p(nodes), _u64p(out), b)
    return out


def tip5_hash_varlen(values: np.ndarray) -> np.ndarray:
    """Whole variable-length sponge hash (n,) uint64 -> (5,) digest words."""
    values = np.ascontiguousarray(values, dtype=np.uint64)
    out = np.empty(5, dtype=np.uint64)
    _lib().tip5_hash_varlen(_u64p(values), values.size, _u64p(out))
    return out


def tip5_merkle_root(leafs: np.ndarray) -> np.ndarray:
    """Frugal Merkle root of (n, 5) uint64 leafs, n a power of two."""
    leafs = np.ascontiguousarray(leafs, dtype=np.uint64)
    root = np.empty(5, dtype=np.uint64)
    _lib().tip5_merkle_root(_u64p(leafs), _u64p(root), leafs.shape[0])
    return root


def reduce_by_ntt_modulus(coeffs: np.ndarray, shift_ntt: np.ndarray,
                          tail_len: int, tw_f: np.ndarray,
                          tw_i: np.ndarray, n_inv: int) -> np.ndarray:
    """Whole chunked structured-modulus reduction in one call (the
    reduce_by_ntt_friendly_modulus loop). Returns the surviving window of
    len(shift_ntt) coefficients."""
    coeffs = np.ascontiguousarray(coeffs, dtype=np.uint64)
    shift_ntt = np.ascontiguousarray(shift_ntt, dtype=np.uint64)
    out = np.empty(shift_ntt.size, dtype=np.uint64)
    _lib().gl_reduce_by_ntt_modulus(
        _u64p(coeffs), coeffs.size, _u64p(shift_ntt), shift_ntt.size,
        tail_len, _u64p(tw_f), _u64p(tw_i), ctypes.c_uint64(n_inv),
        _u64p(out))
    return out


def horner_points(coeffs: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Multipoint evaluation: (k,) coefficients at (m,) points -> (m,)."""
    coeffs = np.ascontiguousarray(coeffs, dtype=np.uint64)
    pts = np.ascontiguousarray(pts, dtype=np.uint64)
    out = np.empty(pts.shape[0], dtype=np.uint64)
    _lib().gl_horner_points(_u64p(coeffs), coeffs.size, _u64p(pts), pts.size,
                            _u64p(out))
    return out


def ntt_inplace(x: np.ndarray, root: int) -> np.ndarray:
    out = np.ascontiguousarray(x, dtype=np.uint64).copy()
    _lib().gl_ntt(_u64p(out), out.size, ctypes.c_uint64(root))
    return out


def intt_inplace(x: np.ndarray, root_inv: int) -> np.ndarray:
    out = np.ascontiguousarray(x, dtype=np.uint64).copy()
    _lib().gl_intt(_u64p(out), out.size, ctypes.c_uint64(root_inv))
    return out


def ntt_rows_inplace(x: np.ndarray, stage_tw: np.ndarray,
                     n_inv: int = 0) -> None:
    """Row-batched in-place NTT of a C-contiguous (rows, n) uint64 array,
    with concatenated stage twiddles (length n-1); ``n_inv`` != 0 scales
    the rows by it (the iNTT)."""
    if x.dtype != np.uint64 or x.ndim != 2 or not x.flags.c_contiguous:
        raise ValueError("ntt_rows_inplace needs a C-contiguous (rows, n) "
                         "uint64 array")
    rows, n = x.shape
    stage_tw = np.ascontiguousarray(stage_tw, dtype=np.uint64)
    if stage_tw.size != n - 1:
        raise ValueError(f"{stage_tw.size} stage twiddles for length {n}")
    _lib().gl_ntt_rows(_u64p(x), rows, n, _u64p(stage_tw),
                       ctypes.c_uint64(n_inv))


def batch_inverse(x: np.ndarray) -> np.ndarray:
    xc = np.ascontiguousarray(x, dtype=np.uint64)
    out = np.empty_like(xc)
    _lib().gl_batch_inverse(_u64p(xc), _u64p(out), xc.size)
    return out


def batch_inverse_or_zero(x: np.ndarray) -> np.ndarray:
    """Elementwise inverse-or-zero (zero-tolerant Montgomery trick)."""
    xc = np.ascontiguousarray(x, dtype=np.uint64)
    out = np.empty_like(xc)
    _lib().gl_batch_inverse_or_zero(_u64p(xc), _u64p(out), xc.size)
    return out


def lagrange_interpolate(dom: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """O(n^2) zerofier-based Lagrange interpolation on canonical uint64
    arrays; returns the (n,) coefficient array."""
    dom = np.ascontiguousarray(dom, dtype=np.uint64)
    vals = np.ascontiguousarray(vals, dtype=np.uint64)
    if dom.shape != vals.shape:
        raise ValueError(f"{dom.size} points, {vals.size} values")
    out = np.empty_like(vals)
    _lib().gl_lagrange_interpolate(_u64p(dom), _u64p(vals), dom.size,
                                   _u64p(out))
    return out


def poly_divmod(num: np.ndarray, den: np.ndarray):
    """Long division on coefficient arrays (degree = len-1, no trailing
    zeros in den). Returns (quotient, remainder) arrays."""
    num = np.ascontiguousarray(num, dtype=np.uint64)
    den = np.ascontiguousarray(den, dtype=np.uint64)
    dn, dd = num.size - 1, den.size - 1
    if dd < 0 or den[dd] == 0:
        raise ValueError("the divisor needs a nonzero leading coefficient")
    if dn < dd:
        return np.zeros(1, dtype=np.uint64), num.copy()
    quot = np.empty(dn - dd + 1, dtype=np.uint64)
    rem = np.empty(max(dd, 1), dtype=np.uint64)
    _lib().gl_poly_divmod(_u64p(num), dn, _u64p(den), dd, _u64p(quot),
                          _u64p(rem))
    return quot, rem[:dd]
