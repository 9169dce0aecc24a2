"""What the Tip5 kernels issue per permutation and how many warps of each
the card holds: K1 (``tip5_permute``), its trace mode and K2 (the Merkle
tree's two kernels: the full-width level and the fused tail).

For each kernel it reads, from the build:

* registers, shared memory and spill bytes from the compiler's report
  (``nvcc -Xptxas -v``, kept beside the library);
* resident warps per SM at the launch's block size, as the CUDA runtime
  reports them for this build (``tip5_cuda.occupancy``);
* SASS instructions per permutation: the round loop's body in
  ``cuobjdump -sass`` (the permutation keeps one round per loop iteration)
  times five, and how many of them are IMAD-family, counted by
  ``alu_probe.sass_per_perm``.

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
#: block size of their launch
KERNELS = {
    "tip5_permute": (r"tip5_permute_kernelIL[bi]0E", 128),
    "tip5_trace": (r"tip5_permute_kernelIL[bi]1E", 128),
    "merkle_level": (r"tip5_permute_kernelILi2E", 128),
    "merkle_commit": (r"merkle_commit_kernel", 256),
}
#: the main path's leaf rows (W = 8, n = 2^20, expansion 4)
LEAF_ROWS = 1 << 22
TRACE_ROWS = 1 << 16

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
        stats[name] = {"threads": threads, **res,
                       **alu_probe.sass_per_perm(sass, tag, NUM_ROUNDS)}
        if library is None:
            from ..ops import tip5_cuda

            block, blocks = tip5_cuda.occupancy(name, threads=threads)
            stats[name]["resident_warps_per_sm"] = blocks * block // 32
    return stats


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
    their SASS instructions over ``rate`` instructions per second (what K5
    issues on ``mul_lazy`` chains in the same run); "not measured" without
    a SASS count or a rate."""
    per_perm = [stats.get(name, {}).get("sass_per_perm") for name in perms]
    if not (rate and rate == rate) or not all(isinstance(v, int)
                                              for v in per_perm):
        return "not measured"
    return sum(v * n for v, n in zip(per_perm, perms.values())) / rate * 1e3


def counts(stats: dict, name: str, perms: int, rate) -> dict:
    """One kernel's SASS per permutation, registers, spills and resident
    warps, and its issue-bound ms for ``perms`` permutations."""
    keys = ("sass_per_perm", "imad_per_perm", "registers", "spill_bytes",
            "resident_warps_per_sm")
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
    """Device times of K1, the trace mode and K2 at the main path's shapes,
    each beside its issue-bound time."""
    from ..math import gf
    from ..ops import tip5_commit, tip5_cuda
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--library", type=Path, default=None,
                    help="read this build's SASS and report, time nothing")
    args = ap.parse_args()
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
