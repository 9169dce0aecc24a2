#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (twenty_first_tpu_torch) on one GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the hand-written kernels from twenty_first_tpu_torch/csrc with
nvcc, holds each against its plain PyTorch twin on the card (exact
equality: this is integer field arithmetic), reproduces roots pinned from
the JAX reference, drives the flagship step (W = 8 trace columns, n = 2^20,
expansion 4: a 2^22-row LDE + Tip5 Merkle commit) and the entry point, and
prints one JSON line per phase. The last lines are the card's name and
power limit (as nvidia-smi reports them), the per-kernel JSON line, and
the device line. Any failure raises: a non-zero exit and no device line.
It needs a CUDA device and refuses to run without one.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
P = 0xFFFF_FFFF_0000_0001

# trace_lde_commit roots of the JAX reference for
# np.random.default_rng(0).integers(0, P, size=(8, n), dtype=np.uint64),
# expansion 4 (tests/test_torch_pipeline.py re-derives them).
PINNED_ROOTS = {
    1 << 6: [7212400738294442629, 4786144134398700650, 11416967223783225047,
             9494336110101299495, 13113325513619585193],
    1 << 10: [8422239226348898290, 10027258591245203499, 3115357317289785295,
              7829678549101749663, 13746998341487405660],
}
# the JAX reference's root for __graft_entry__.entry() (tests/test_torch_entry.py)
ENTRY_ROOT = [13477972335611674128, 8311010285982245351, 480628304788764524,
              17490066220839094773, 14904063755748097382]
# Tip5 reference snapshot on raw Montgomery words (tests/test_tip5.py)
RAW_SNAPSHOT_IN = [
    0x0000_000F_FFFF_FFF0, 0x0000_0000_FFFF_FFFF, 0x0000_0000_FFFF_FFFF,
    0x0000_0028_FFFF_FFD7, 0x0000_0006_FFFF_FFF9, 0x0000_0002_FFFF_FFFD,
    0x0000_0000_FFFF_FFFF, 0x0000_0030_FFFF_FFCF, 0x0000_0397_FFFF_FC68,
    0x0000_000F_FFFF_FFF0, 0x316B_FB72_3638_2123, 0x216F_521B_66EF_83F5,
    0x5689_D7B3_63F5_2DF0, 0xEB2F_59E3_AEAE_25FC, 0xB082_99D2_77CB_B4DC,
    0xCBE3_D9FD_C534_9140,
]
RAW_SNAPSHOT_OUT5 = [
    0x15D3_8EA9_29F6_632A, 0xF988_E509_FF73_8BB4, 0x48BC_DFAE_88A2_E9F3,
    0x8733_9E83_2DAA_C02A, 0x511E_4126_8150_FDAC,
]
R = (1 << 64) % P
R_INV = pow(1 << 64, -1, P)

# the main path's full width: W trace columns of length N, expansion E
W, N, E = 8, 1 << 20, 4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_times(fn, reps: int) -> list[float]:
    """Milliseconds of each of ``reps`` fn() calls by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() by CUDA events, after one warm-up call."""
    return statistics.median(cuda_times(fn, reps))


def max_abs_err(got, want) -> float:
    """Largest |got - want| over the u64 values (0.0 when equal)."""
    diff = (got != want).nonzero(as_tuple=True)
    if diff[0].numel() == 0:
        return 0.0
    g = got[diff].cpu().numpy().view(np.uint64)
    w = want[diff].cpu().numpy().view(np.uint64)
    return float(max(abs(int(a) - int(b)) for a, b in zip(g, w)))


def require_equal(what: str, got, want) -> float:
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = max_abs_err(got, want)
    if err != 0.0:
        bad = int((got != want).sum())
        raise AssertionError(f"{what}: {bad} of {got.numel()} elements differ "
                             f"(max abs err {err})")
    return err


def random_field(rng, shape, device="cuda"):
    from twenty_first_tpu_torch.math import gf

    return gf.from_u64(rng.integers(0, P, size=shape, dtype=np.uint64)).to(device)


def check_device() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on a GPU")
    sys.path.insert(0, str(HERE))
    import twenty_first_tpu_torch

    pkg_root = Path(twenty_first_tpu_torch.__file__).resolve().parent.parent
    if pkg_root != HERE:
        raise RuntimeError(f"imported the port from {pkg_root}, not {HERE}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)))
    return smi


def phase_build() -> None:
    from twenty_first_tpu_torch import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    seconds = time.perf_counter() - t0
    ptxas = [line.strip() for line in _build.build_log().splitlines()
             if "Used" in line or "spill" in line or "Compiling" in line]
    emit("build", seconds=seconds, library=so.name, ptxas=ptxas)


def phase_k1(rng, tables) -> dict:
    from twenty_first_tpu_torch.math import gf
    from twenty_first_tpu_torch.ops import tip5_cuda

    edges = [0, 1, P - 1, (1 << 32) - 1, 1 << 32, (1 << 32) + 1]
    edge_states = gf.from_u64(np.array(
        [[e] * 16 for e in edges]
        + [[edges[(i + j) % len(edges)] for j in range(16)] for i in range(6)],
        dtype=np.uint64)).cuda()
    states = torch.cat([random_field(rng, (1 << 16, 16)), edge_states])
    got = tip5_cuda.tip5_permute(states, *tables)
    require_equal("K1 random+edge states", got,
                  tip5_cuda.tip5_permute_plain(states, *tables))
    snap = gf.from_u64([[(raw * R_INV) % P for raw in RAW_SNAPSHOT_IN]]).cuda()
    out = gf.to_u64(tip5_cuda.tip5_permute(snap, *tables))[0, :5]
    if [(int(v) * R) % P for v in out] != RAW_SNAPSHOT_OUT5:
        raise AssertionError("K1 misses the Tip5 reference snapshot")
    # at the main path's shape: the leaf hash of 2^22 rows
    big = random_field(rng, (N * E, 16))
    got = tip5_cuda.tip5_permute(big, *tables)
    err = require_equal("K1 at the path's shape", got,
                        tip5_cuda.tip5_permute_plain(big, *tables))
    ms = cuda_ms(lambda: tip5_cuda.tip5_permute(big, *tables), 10)
    plain_ms = cuda_ms(lambda: tip5_cuda.tip5_permute_plain(big, *tables), 3)
    emit("k1_tip5_permute", states=states.shape[0], snapshot=True,
         shape=[N * E, 16], ms=ms, plain_ms=plain_ms,
         perms_per_s=N * E / (ms * 1e-3))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_k2(rng, tables) -> dict:
    from twenty_first_tpu_torch.ops import tip5_commit, tip5_cuda

    states = random_field(rng, (1 << 16, 16))
    require_equal("K2 commit of 2^16 leaf states",
                  tip5_commit.commit_states(states, 16, tables=tables),
                  tip5_commit.commit_states(states, 16, tables=tables,
                                            plain=True))
    cases = [(2, 1), (4, 2), (8, 3), (6, 1), (96, 5), (384, 7), (512, 9),
             (1024, 10), (1536, 9), (3 << 11, 11), (1 << 13, 13)]
    for rows, layers in cases:
        dig = random_field(rng, (rows, 5))
        require_equal(f"K2 reduce ({rows}, {layers})",
                      tip5_commit.reduce_layers(dig, layers, tables=tables),
                      tip5_commit.reduce_layers(dig, layers, tables=tables,
                                                plain=True))
    for rows, layers in [(48, 4), (1024, 0), (40, 3), (256, 8)]:
        st = random_field(rng, (rows, 16))
        require_equal(f"K2 commit ({rows}, {layers})",
                      tip5_commit.commit_states(st, layers, tables=tables),
                      tip5_commit.commit_states(st, layers, tables=tables,
                                                plain=True))
    # at the main path's shape: the tree over 2^22 leaf digests
    leafs = random_field(rng, (N * E, 5))
    log_rows = (N * E).bit_length() - 1
    root = tip5_commit.reduce_layers(leafs, log_rows, tables=tables)
    err = require_equal("K2 tree over the path's leafs", root,
                        tip5_commit.reduce_layers(leafs, log_rows,
                                                  tables=tables, plain=True))
    first = lambda: tip5_cuda.merkle_commit(leafs, False, 9, 256, *tables)  # noqa: E731
    first_plain = lambda: tip5_cuda.merkle_commit_plain(  # noqa: E731
        leafs, False, 9, 256, *tables)
    require_equal("K2 first launch at the path's shape", first(),
                  first_plain())
    ms = cuda_ms(first, 10)
    plain_ms = cuda_ms(first_plain, 3)
    tree_ms = cuda_ms(lambda: tip5_commit.reduce_layers(
        leafs, log_rows, tables=tables), 5)
    emit("k2_merkle_commit", cases=len(cases) + 5, launch_shape=[N * E, 5],
         launch_levels=9, ms=ms, plain_ms=plain_ms, tree_ms=tree_ms)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_k3(rng) -> dict:
    from twenty_first_tpu_torch.math import gf, ntt
    from twenty_first_tpu_torch.ops import ntt_cuda

    checked = 0
    for log_t in range(1, 13):
        t = 1 << log_t
        tw = gf.from_u64(ntt.stage_twiddles(log_t, log_t % 2 == 1)).cuda()
        diag = random_field(rng, (t, 37))
        n_inv = pow(t, P - 2, P)
        for layout in ("cols_fast", "elems_fast"):
            if layout == "cols_fast":
                x = random_field(rng, (2, t, 37))
            else:
                x = random_field(rng, (2, 37, t)).transpose(1, 2)
            for d, scale in ((None, 1), (diag, 1), (None, n_inv),
                             (diag, n_inv)):
                require_equal(
                    f"K3 log_t={log_t} {layout} diag={d is not None} "
                    f"scale={scale != 1}",
                    ntt_cuda.ntt_local_pass(x, tw, diag=d, scale=scale),
                    ntt_cuda.ntt_local_pass_plain(x, tw, diag=d, scale=scale))
                checked += 1
    for log_n in (10, 17, 22):
        n = 1 << log_n
        x = random_field(rng, (2, n))
        fwd = ntt.ntt_tables(n, False, "cuda")
        inv = ntt.ntt_tables(n, True, "cuda")
        y = ntt.ntt(x, tables=fwd)
        require_equal(f"ntt 2^{log_n}", y, ntt.ntt(x, tables=fwd, plain=True))
        require_equal(f"intt 2^{log_n}", ntt.intt(y, tables=inv),
                      ntt.intt(y, tables=inv, plain=True))
        require_equal(f"intt(ntt(x)) 2^{log_n}", ntt.intt(y, tables=inv), x)
    golden = ntt.ntt(gf.from_u64([1, 4, 0, 0]).cuda())
    if gf.to_u64(golden).tolist() != [5, 1125899906842625,
                                      18446744069414584318,
                                      18445618169507741698]:
        raise AssertionError("ntt misses the [1, 4, 0, 0] golden vector")
    # at the main path's shape: pass 1 of the forward transform of N * E
    fwd = ntt.ntt_tables(N * E, False, "cuda")
    log_n1, log_n2 = ntt.four_step_split((N * E).bit_length() - 1)
    x = random_field(rng, (W, 1 << log_n2, 1 << log_n1))
    err = require_equal(
        f"K3 at {tuple(x.shape)}",
        ntt_cuda.ntt_local_pass(x, fwd.tw1, diag=fwd.diag),
        ntt_cuda.ntt_local_pass_plain(x, fwd.tw1, diag=fwd.diag))
    ms = cuda_ms(lambda: ntt_cuda.ntt_local_pass(x, fwd.tw1, diag=fwd.diag), 10)
    plain_ms = cuda_ms(lambda: ntt_cuda.ntt_local_pass_plain(
        x, fwd.tw1, diag=fwd.diag), 3)
    flat = x.reshape(W, N * E)
    ntt_ms = cuda_ms(lambda: ntt.ntt(flat, tables=fwd), 10)
    ntt_plain_ms = cuda_ms(lambda: ntt.ntt(flat, tables=fwd, plain=True), 3)
    emit("k3_ntt_local_pass", passes_checked=checked, ntt_sizes=[10, 17, 22],
         shape=list(x.shape), ms=ms, plain_ms=plain_ms,
         ntt_path_ms=ntt_ms, ntt_path_plain_ms=ntt_plain_ms)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_pinned_roots() -> None:
    from twenty_first_tpu_torch.math import gf
    from twenty_first_tpu_torch.parallel import pipeline

    for n, want in PINNED_ROOTS.items():
        trace = gf.from_u64(np.random.default_rng(0).integers(
            0, P, size=(W, n), dtype=np.uint64)).cuda()
        for plain in (False, True):
            got = gf.to_u64(pipeline.trace_lde_commit(trace, plain=plain))
            if got.tolist() != [want]:
                raise AssertionError(f"n={n} plain={plain}: root {got.tolist()}"
                                     f" != pinned JAX root {want}")
    emit("pinned_jax_roots", sizes=sorted(PINNED_ROOTS), ok=True)


def device_breakdown(fn) -> dict:
    """Device time by kernel over one fn() under torch.profiler, and the
    device's busy share of that call's CUDA-event time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    span_ms = start.elapsed_time(end)
    return {"span_ms": span_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / span_ms if busy_ms else "not measured",
            "kernels": [{"name": e.key[:90], "calls": e.count,
                         "device_ms": e.self_device_time_total / 1e3}
                        for e in kernels[:12]]}


def phase_slice(counters) -> dict:
    from twenty_first_tpu_torch.math import gf
    from twenty_first_tpu_torch.parallel import pipeline

    step = pipeline.TraceLdeCommit(W, N, E, device="cuda")
    trace = random_field(np.random.default_rng(2026), (W, N))
    torch.cuda.synchronize()
    # the main path, once, with every launch counter at 0
    for c in counters:
        c.launches = 0
    root = step(trace)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path never ran: {launches}")
    vals = gf.to_u64(root)
    if root.shape != (1, 5) or not (vals < np.uint64(P)).all():
        raise AssertionError(f"bad root {vals.tolist()}")
    require_equal("slice root: kernels vs plain on the card", root,
                  step(trace, plain=True))
    torch.cuda.reset_peak_memory_stats()
    times = sorted(cuda_times(lambda: step(trace), 21))
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    plain_ms = cuda_ms(lambda: step(trace, plain=True), 3)
    plain_peak = torch.cuda.max_memory_allocated()
    emit("slice_lde_commit", w=W, n=N, expansion=E, rows=N * E,
         root=vals[0].tolist(), launches=launches, ms=ms, runs=len(times),
         ms_min=times[0], ms_max=times[-1], plain_ms=plain_ms,
         max_memory_allocated=peak, plain_max_memory_allocated=plain_peak)
    emit("slice_profile", **device_breakdown(lambda: step(trace)))
    return launches


def phase_entry() -> None:
    from twenty_first_tpu_torch.entry import entry
    from twenty_first_tpu_torch.math import gf

    fn, args = entry("cuda")
    root = fn(*args)
    require_equal("entry root vs plain", root, fn(*args, plain=True))
    if gf.to_u64(root).tolist() != [ENTRY_ROOT]:
        raise AssertionError(f"entry root {gf.to_u64(root).tolist()} != "
                             f"JAX reference {ENTRY_ROOT}")
    emit("entry", shape=list(args[0].shape), root=ENTRY_ROOT, ok=True)


def main() -> None:
    smi = check_device()
    phase_build()
    from twenty_first_tpu_torch.ops import ntt_cuda, tip5_cuda
    from twenty_first_tpu_torch.tip5.permutation import tip5_tables

    rng = np.random.default_rng(0)
    tables = tip5_tables("cuda")
    k1 = phase_k1(rng, tables)
    k2 = phase_k2(rng, tables)
    k3 = phase_k3(rng)
    phase_pinned_roots()
    counters = (tip5_cuda.tip5_permute, tip5_cuda.merkle_commit,
                ntt_cuda.ntt_local_pass)
    launches = phase_slice(counters)
    phase_entry()
    kernels = [
        {"name": "tip5_permute", "route": "cuda",
         "source": "twenty_first_tpu_torch/csrc/tip5.cu",
         "replaces": "twenty_first_tpu/ops/tip5_pallas.py:252",
         "launches": launches["tip5_permute"], **k1},
        {"name": "merkle_commit", "route": "cuda",
         "source": "twenty_first_tpu_torch/csrc/tip5.cu",
         "replaces": "twenty_first_tpu/ops/tip5_pallas.py:262",
         "launches": launches["merkle_commit"], **k2},
        {"name": "ntt_local_pass", "route": "cuda",
         "source": "twenty_first_tpu_torch/csrc/ntt.cu",
         "replaces": "twenty_first_tpu/ops/ntt_pallas.py:47",
         "launches": launches["ntt_local_pass"], **k3},
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
