"""Build and load the hand-written Hopper kernels.

``csrc/*.cu`` compile with nvcc into one shared library with a plain C
interface, loaded with ctypes. The build happens at first use, into
``.build/`` beside this file (git ignores it), and is keyed by a hash of the
sources and flags, so an edited source never loads a stale library. Each C
entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / ".build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_VP, _I, _LL, _ULL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_ulonglong)
_PI = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # in, out, rows, rc, lut, stream
    "tf_tip5_permute": (_VP, _VP, _LL, _VP, _VP, _VP),
    # in, out (rows, 6, 16), rows, rc, lut, stream
    "tf_tip5_trace": (_VP, _VP, _LL, _VP, _VP, _VP),
    # in, out, parents, leaf, rc, lut, stream
    "tf_merkle_level": (_VP, _VP, _LL, _I, _VP, _VP, _VP),
    # in, out, blocks, threads, leaf, levels, rc, lut, stream
    "tf_merkle_commit": (_VP, _VP, _LL, _I, _I, _I, _VP, _VP, _VP),
    # kernel, threads, out block size, out resident blocks per SM
    "tf_tip5_occupancy": (_I, _I, _PI, _PI),
    # in, out, log_t, log_tc, ncols, nbatch, in strides (b, e, c),
    # out strides (b, e, c), tw, diag, diag strides (e, c), scale, stream
    "tf_ntt_local_pass": (_VP, _VP, _I, _I, _LL, _I, _LL, _LL, _LL, _LL, _LL,
                          _LL, _VP, _VP, _LL, _LL, _ULL, _VP),
    # log_t, log_tc, out block size, out resident blocks per SM
    "tf_ntt_occupancy": (_I, _I, _PI, _PI),
    # in, out, log_t, stage, ncols, in strides (e, c), out strides (e, c),
    # tw, bit_reverse, stream
    "tf_ntt_stage": (_VP, _VP, _I, _I, _LL, _LL, _LL, _LL, _LL, _VP, _I, _VP),
    # a, b, out, n, k, op, form, stream
    "tf_gf_chain": (_VP, _VP, _VP, _LL, _I, _I, _I, _VP),
    # out, blocks, k, form, stream
    "tf_imad_rate": (_VP, _I, _I, _I, _VP),
    # a, b, out, rows, n, a_row, b_row, out_row, op, stream
    "tf_gf_pointwise": (_VP, _VP, _VP, _LL, _LL, _LL, _LL, _LL, _I, _VP),
    # x, out, rows, n, zero flags, stream
    "tf_batch_inversion": (_VP, _VP, _LL, _LL, _VP, _VP),
    # b, w, partial, out, rows, n, m, log_p, log_l, nseg, groups, xpts,
    # xcoef, stream
    "tf_coset_fold": (_VP, _VP, _VP, _VP, _LL, _LL, _I, _I, _I, _LL, _I, _I,
                      _I, _VP),
}

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # finds the toolkit

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this exact build exists; returns the .so.

    One nvcc per source, all started together, then one link. The
    compiler's report (``-Xptxas -v``: registers, shared memory and spills
    per kernel) is kept beside the library, see ``build_log``."""
    so = _library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = so.with_name(f"{so.stem}.{os.getpid()}")
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = Path(f"{stem}.{src.stem}.o")
        log = obj.with_suffix(".log")
        with open(log, "w") as sink:
            proc = subprocess.Popen(
                [_nvcc(), *compile_flags, "-c", "-I", str(CSRC), "-o",
                 str(obj), str(src)], stdout=sink, stderr=subprocess.STDOUT)
        jobs.append((src, obj, log, proc))
    report, failed = [], []
    for src, obj, log, proc in jobs:
        proc.wait()
        report.append(log.read_text())
        log.unlink()
        if proc.returncode != 0:
            failed.append(f"{src.name}: nvcc exited {proc.returncode}")
    tmp = Path(f"{stem}.tmp")
    if not failed:
        link = subprocess.run(
            [_nvcc(), "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
             *(str(obj) for _, obj, _, _ in jobs)],
            capture_output=True, text=True, check=False)
        report.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"link: nvcc exited {link.returncode}")
    for _, obj, _, _ in jobs:
        obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(report))
    if failed:
        raise RuntimeError("nvcc failed: " + "; ".join(failed) + "\n"
                           + "".join(report))
    os.replace(tmp, so)
    return so


def build_log(library: Path | None = None) -> str:
    """The compiler's report kept beside ``library`` (this build's by
    default)."""
    path = Path(library or _library_path()).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def sass(library: Path | None = None) -> dict[str, list[str]] | None:
    """A built library's SASS by ``cuobjdump -sass`` (this build's by
    default): each kernel's (mangled) name -> its instruction lines. None
    where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    proc = subprocess.run([tool, "-sass", str(library or build())],
                          capture_output=True, text=True, check=True)
    kernels: dict[str, list[str]] = {}
    lines = None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            lines = kernels.setdefault(line.split("Function :")[1].strip(), [])
        elif lines is not None:
            lines.append(line)
    return kernels


def load():
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.tf_error_string.argtypes = (ctypes.c_int,)
        lib.tf_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load().tf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def stream_of(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream
