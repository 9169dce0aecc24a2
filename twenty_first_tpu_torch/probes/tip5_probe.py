"""What the Tip5 kernels issue per permutation and how many warps of each
the card holds: K1 (``tip5_permute``), its trace mode, its absorb mode
(``tip5_absorb``) and that mode's lane mode (``tip5_absorb_lanes``), K2
(the Merkle tree's two kernels: the full-width level and the fused tail)
and K9 (``tip5_permute_mma``, the MDS on the integer tensor cores).

For each kernel it reads, from the build:

* registers, shared memory and spill bytes from the compiler's report
  (``nvcc -Xptxas -v``, kept beside the library);
* resident warps per SM at the launch's block size, as the CUDA runtime
  reports them for this build (``tip5_cuda.occupancy``);
* SASS instructions per permutation by class (``CLASSES``): the round
  loop's body in ``cuobjdump -sass`` (the permutation keeps one round per
  loop iteration) times five, and how many of them are IMAD-family, IMAD
  moves, IMMA (the tensor-core products) and shared-memory loads: a
  thread's instructions for the one permutation it takes part in. A warp
  permutes 32 states in every kernel (K9's as two tiles of 16) but the
  lane mode, whose warp permutes two, 16 lanes a state
  (``states_per_warp``).

With a card it also times the kernels at the main path's shapes (device
time, ``timing.cuda_ms``) and sets each beside its issue-bound time:
SASS instructions x permutations over the instruction rate that K5 reaches
on chains of ``mul_lazy`` in the same run (``alu_probe``). For K2 it times
the whole tree of 2^22 leaf digests and each of its launches, as
``ops/tip5_commit.py`` plans them, and (for the fused kernel's own cost
per level) fused launches of 1, 2, ..., 9 levels at full width, whose
differences are each level's time under a schedule that halves a block's
working threads every level.

    python -m twenty_first_tpu_torch.probes.tip5_probe
    python -m twenty_first_tpu_torch.probes.tip5_probe --library PATH.so
    python -m twenty_first_tpu_torch.probes.tip5_probe --absorb-sweep

``--absorb-sweep`` times only the two designs of K1's absorb mode, a
thread a row and 16 lanes a row, side by side (``ABSORB_SWEEP``), beside
the design that ``tip5_cuda.lane_mode`` picks.

``--library`` reads another build's SASS and report (for instance the
parent commit's, built in its own checkout): registers, spills and SASS,
no resident warps, and it times nothing.
"""

from __future__ import annotations

import argparse
import json
import re
from pathlib import Path

import numpy as np

from .. import _build
from ..tip5.constants import NUM_ROUNDS
from . import alu_probe
from .timing import cuda_ms, require_card, sm_clock_mhz

#: the kernels by a regular expression on their mangled names, with the
#: block size of their launch; K1, its absorb mode and the lane mode are
#: one template at kPermute, told apart by their parameters (rows, then the
#: rc table; rows, stride and chunks; the rows as an int)
KERNELS = {
    "tip5_permute": (r"tip5_permute_kernelIL[bi]0EE+vPKmPmlS", 128),
    "tip5_absorb": (r"tip5_permute_kernelIL[bi]0EE+vPKmPmlll", 32),
    "tip5_absorb_lanes": (r"tip5_permute_kernelIL[bi]0EE+vPKmPmill", 32),
    "tip5_trace": (r"tip5_permute_kernelIL[bi]1E", 128),
    "merkle_level": (r"tip5_permute_kernelILi2E", 128),
    "merkle_commit": (r"merkle_commit_kernel", 256),
    "tip5_permute_mma": (r"tip5_permute_mma_kernel", 128),
}
#: states a warp permutes where it is not 32
STATES_PER_WARP = {"tip5_absorb_lanes": 2}
#: SASS a permutation by class: all, IMAD-family, its moves, tensor-core
#: products, shared-memory loads
CLASSES = ("sass_per_perm", "imad_per_perm", "imad_mov_per_perm",
           "imma_per_perm", "lds_per_perm")
#: the main path's leaf rows (W = 8, n = 2^20, expansion 4)
LEAF_ROWS = 1 << 22
TRACE_ROWS = 1 << 16
#: the two designs of K1's absorb mode by their C entries (csrc/tip5.cu)
ABSORB_DESIGNS = {"threads": "tf_tip5_absorb",
                  "lanes": "tf_tip5_absorb_lanes"}
#: where the two designs are timed side by side: words a row (the table
#: commit's 16,384 padded, rows near the crossover; the distributed LDE
#: commit's 4,096 at 2^24) by row counts
ABSORB_SWEEP = {16390: (8192, 10240, 12288, 13516, 14336, 16384),
                4100: (80, 1024, 2048, 4096, 8192, 12288, 13516, 16384,
                       32768)}

_ENTRY = re.compile(r"(?:Compiling entry function|Function properties for)"
                    r" '?([\w$.]+)'?")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_report(log: str) -> dict[str, dict]:
    """Each kernel's registers, static shared memory and spill bytes from
    ``-Xptxas -v`` output, by mangled name."""
    out: dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        if m := _USED.search(line):
            out[name]["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            out[name]["smem_bytes"] = int(s.group(1)) if s else 0
        if m := _SPILL.search(line):
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    return out


def kernel_stats(library: Path | None = None) -> dict[str, dict]:
    """Registers, spills and SASS per permutation of every kernel in
    ``KERNELS`` that ``library`` (this build's by default) has, and for this
    build the resident warps per SM."""
    sass = _build.sass(library)  # builds this build first
    report = ptxas_report(_build.build_log(library))
    stats = {}
    for name, (tag, threads) in KERNELS.items():
        mangled = next((k for k in report if re.search(tag, k)), None)
        if mangled is None:
            continue
        res = report[mangled]
        st = alu_probe.sass_per_perm(sass, tag, NUM_ROUNDS)
        stats[name] = {"threads": threads, **res, **st, **sass_classes(st),
                       "states_per_warp": STATES_PER_WARP.get(name, 32)}
        if library is None:
            block, blocks = _occupancy(name, threads)
            stats[name]["resident_warps_per_sm"] = blocks * block // 32
    return stats


def sass_classes(st: dict) -> dict:
    """``CLASSES`` of one kernel from ``alu_probe.sass_per_perm``'s round
    loop, per permutation: the loop's counts times the rounds. IMAD-family
    includes the moves ptxas puts on the FMA pipe (IMAD.MOV,
    IMAD.MOV.U32), which are also counted apart."""
    if not isinstance(st.get("sass_per_perm"), int):
        return {k: st.get("sass_per_perm") for k in CLASSES}
    ops = st["round_opcodes"]

    def per_perm(*prefixes):
        return sum(n for op, n in ops.items()
                   if op.startswith(prefixes)) * NUM_ROUNDS

    return {"sass_per_perm": st["sass_per_perm"],
            "imad_per_perm": st["imad_per_perm"],
            "imad_mov_per_perm": per_perm("IMAD.MOV"),
            "imma_per_perm": per_perm("IMMA"),
            "lds_per_perm": per_perm("LDS")}


def _occupancy(name: str, threads: int) -> tuple[int, int]:
    from ..ops import tip5_cuda, tip5_mxu

    if name == "tip5_permute_mma":
        return tip5_mxu.occupancy()
    return tip5_cuda.occupancy(name, threads=threads)


def issue_rate() -> float:
    """SASS instructions per second that K5 issues on ``mul_lazy`` chains
    in the C form (the rate earlier readings used) at 2^22 elements,
    measured now (alu_probe)."""
    sass = alu_probe.sass_per_op("mul_lazy", "c")
    if not isinstance(sass.get("instructions_per_op"), float):
        return float("nan")
    res = alu_probe.run_case("mul_lazy", "c", alu_probe.FULL_SHAPE, sass,
                             sm_clock_mhz()[1])
    return res.get("g_instructions_per_s", float("nan")) * 1e9


def issue_bound_ms(stats: dict, perms: dict[str, int], rate) -> float | str:
    """Issue-bound ms of ``perms[name]`` permutations in each named kernel:
    their SASS instructions (a thread's for a permutation, times the
    threads that share one: 32 / ``states_per_warp``) over ``rate``
    instructions per second (what K5 issues on ``mul_lazy`` chains in the
    same run); "not measured" without a SASS count or a rate."""
    per_perm = [stats.get(name, {}).get("sass_per_perm") for name in perms]
    if not (rate and rate == rate) or not all(isinstance(v, int)
                                              for v in per_perm):
        return "not measured"
    sharing = [32 // stats[name].get("states_per_warp", 32) for name in perms]
    return sum(v * k * n for v, k, n in zip(per_perm, sharing,
                                            perms.values())) / rate * 1e3


def counts(stats: dict, name: str, perms: int, rate) -> dict:
    """One kernel's SASS per permutation, registers, spills and resident
    warps, and its issue-bound ms for ``perms`` permutations."""
    keys = (*CLASSES, "registers", "spill_bytes", "resident_warps_per_sm")
    st = stats.get(name, {})
    return {**{k: st.get(k, "not measured") for k in keys},
            "issue_bound_ms": issue_bound_ms(stats, {name: perms}, rate)}


def fused_level_ms(leafs, tables, max_levels: int, threads: int) -> list:
    """Device ms of one fused K2 launch over ``leafs`` reducing 1, 2, ...,
    ``max_levels`` levels: the differences are the levels' own times."""
    from ..ops import tip5_cuda

    return [cuda_ms(lambda lv=lv: tip5_cuda.merkle_commit(
        leafs, False, lv, threads, *tables), 5)
        for lv in range(1, max_levels + 1)]


def tree_launch_ms(leafs, tables, reps: int = 10) -> list[dict]:
    """Device ms of each launch of the tree over ``leafs`` as
    ``tip5_commit.plan`` orders it on this card, each on its own input."""
    from ..ops import tip5_commit, tip5_cuda

    log_rows = leafs.shape[0].bit_length() - 1
    steps = tip5_commit.plan(leafs.shape[0], log_rows,
                             tip5_cuda.resident_threads(leafs.device))
    out, x = [], leafs
    for step in steps:
        if step[0] == "level":
            fn = lambda x=x: tip5_cuda.merkle_level(x, False, *tables)  # noqa: E731
        else:
            fn = lambda x=x, st=step: tip5_cuda.merkle_commit(  # noqa: E731
                x, *st[1:], *tables)
        levels = 1 if step[0] == "level" else step[2]
        out.append({"launch": step[0], "levels": levels,
                    "rows_in": x.shape[0], "ms": cuda_ms(fn, reps)})
        x = fn()
    return out


def tree_summary(launches: list[dict]) -> dict:
    """The full-width levels' times and the fused tail's time per level."""
    tail = [t for t in launches if t["launch"] == "fused"]
    tail_levels = sum(t["levels"] for t in tail)
    tail_ms = sum(t["ms"] for t in tail)
    return {"launches": len(launches),
            "full_width_level_ms": [t["ms"] for t in launches
                                    if t["launch"] == "level"],
            "tail_launches": len(tail), "tail_levels": tail_levels,
            "tail_ms": tail_ms,
            "tail_ms_per_level": tail_ms / tail_levels if tail_levels else 0.0}


def measure(stats: dict) -> dict:
    """Device times of K1, K9, the trace mode and K2 at the main path's
    shapes, each beside its issue-bound time."""
    from ..math import gf
    from ..ops import tip5_commit, tip5_cuda, tip5_mxu
    from ..tip5.permutation import tip5_tables

    tables = tip5_tables()
    rng = np.random.default_rng(5)

    def field(shape):
        return gf.from_u64(rng.integers(0, gf.P, size=shape,
                                        dtype=np.uint64)).cuda()

    rate = issue_rate()
    states, trace_in, leafs = (field((LEAF_ROWS, 16)),
                               field((TRACE_ROWS, 16)), field((LEAF_ROWS, 5)))
    log_rows = LEAF_ROWS.bit_length() - 1
    out = {"issue_rate_t_per_s": rate / 1e12}
    for name, ms, perms in (
            ("tip5_permute", cuda_ms(lambda: tip5_cuda.tip5_permute(
                states, *tables), 10), LEAF_ROWS),
            ("tip5_permute_mma", cuda_ms(lambda: tip5_mxu.tip5_permute_mma(
                states, *tables), 10), LEAF_ROWS),
            ("tip5_trace", cuda_ms(lambda: tip5_cuda.tip5_trace(
                trace_in, *tables), 10), TRACE_ROWS)):
        out[name] = {"ms": ms, "perms": perms,
                     "issue_bound_ms": issue_bound_ms(stats, {name: perms},
                                                      rate)}
    launches = tree_launch_ms(leafs, tables)
    out["tree"] = {
        "ms": cuda_ms(lambda: tip5_commit.reduce_layers(
            leafs, log_rows, tables=tables), 10),
        "perms": LEAF_ROWS - 1, "launch_ms": launches,
        **tree_summary(launches),
        "fused_launch_ms_by_levels_at_full_width": fused_level_ms(
            leafs, tables, 9, 256)}
    return out


def absorb_design(padded, tables, design: str):
    """A function that runs one design of K1's absorb mode ("threads" or
    "lanes", ``ABSORB_DESIGNS``) over ``padded`` (rows, k * 10) on the
    card, whichever ``tip5_cuda.lane_mode`` picks for its rows, and returns
    the (rows, 5) digests."""
    import torch

    from ..tip5.constants import DIGEST_LENGTH, RATE

    launch = getattr(_build.load(), ABSORB_DESIGNS[design])
    rc, lut = tables
    out = torch.empty((padded.shape[0], DIGEST_LENGTH), dtype=torch.int64,
                      device=padded.device)

    def run():
        _build.check(launch(padded.data_ptr(), out.data_ptr(),
                            padded.shape[0], padded.stride(0),
                            padded.shape[1] // RATE, rc.data_ptr(),
                            lut.data_ptr(), _build.stream_of(padded)),
                     ABSORB_DESIGNS[design])
        return out
    return run


def absorb_sweep(tables, sweep=ABSORB_SWEEP, seed: int = 22) -> list[dict]:
    """Device ms of both designs of K1's absorb mode over random rows at
    each (words a row, rows) of ``sweep``, their digests required equal,
    beside the design that ``tip5_cuda.lane_mode`` picks there."""
    import torch

    from ..ops import tip5_cuda

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    out = []
    for width, row_counts in sweep.items():
        table = torch.randint(0, (1 << 63) - 1, (max(row_counts), width),
                              generator=g, device="cuda", dtype=torch.int64)
        resident = tip5_cuda.resident_threads(table.device, "tip5_absorb")
        for rows in row_counts:
            fns = {d: absorb_design(table[:rows], tables, d)
                   for d in ABSORB_DESIGNS}
            if not torch.equal(fns["threads"](), fns["lanes"]()):
                raise AssertionError(f"the absorb designs differ at "
                                     f"({rows}, {width})")
            out.append({"rows": rows, "width": width,
                        **{f"{d}_ms": cuda_ms(fn, 5) for d, fn in fns.items()},
                        "picked": "lanes" if tip5_cuda.lane_mode(
                            rows, resident) else "threads"})
        del table
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--library", type=Path, default=None,
                    help="read this build's SASS and report, time nothing")
    ap.add_argument("--absorb-sweep", action="store_true",
                    help="time only the absorb mode's two designs "
                         "(ABSORB_SWEEP)")
    args = ap.parse_args()
    if args.absorb_sweep:
        from ..tip5.permutation import tip5_tables

        print(require_card(), flush=True)
        for row in absorb_sweep(tip5_tables()):
            print(json.dumps({"probe": "tip5_absorb_sweep", **row}),
                  flush=True)
        return
    print(require_card(), flush=True)
    stats = kernel_stats(args.library)
    for name, st in stats.items():
        print(json.dumps({"probe": "tip5_sass", "name": name, **st}),
              flush=True)
    if args.library is None:
        print(json.dumps({"probe": "tip5_times", **measure(stats)}),
              flush=True)


if __name__ == "__main__":
    main()
