"""What one lazy Goldilocks op costs on the card: chains of K5.

The counterpart of ``scripts/pallas_alu_probe.py``. K5 runs k steps of
``o = op(o, b)`` (then the limb swap) on every element, op ``mul_lazy`` or
``add_lazy``; the time of one step is (t(k=112) - t(k=16)) / 96, which
cancels the launch and the memory traffic. Each op runs in both forms
(``probe_cuda.CHAIN_FORMS``: the carry chains the library's kernels run,
and the C forms of earlier readings), side by side in one run. It runs at
the JAX probe's shape, 512 x 128 elements (65,536 threads' worth: the card
is mostly idle), and at 2^22 elements, which fill it. For each it prints
one JSON line: the time per step, the SM cycles a warp spends on one step
of one chain (``sm_cycles_per_warp_step``: the step's time at the maximum
SM clock, times the card's SMs, over the warps' steps), G ops/s, and,
where the toolkit has ``cuobjdump``, what those ops issue per second from
the instructions of one op in K5's SASS: its IMAD-family instructions
(multiply-adds, which run on the FMA pipe) beside the card's IMAD rate,
SMs x 64 lanes x the SM clock nvidia-smi reports, and all its
instructions beside the dispatch rate, SMs x 4 schedulers x 32 lanes x
that clock (integer adds, compares and selects issue to lanes of their
own, so all instructions together can pass the IMAD rate but not the
dispatch rate). Times are device times: the
host's launch overheads do not enter them. ``plain_over_kernel`` is the
plain twin's time per step over K5's: it replaces the JAX script's
"pallas/xla" ratio, and is no yardstick of speed (the twin is hundreds of
small torch launches).

    python -m twenty_first_tpu_torch.probes.alu_probe
"""

from __future__ import annotations

import collections
import json
import re

import numpy as np
import torch

from .. import _build
from ..math import gf
from ..ops import probe_cuda
from .timing import (DISPATCH_LANES_PER_SM, IMAD_LANES_PER_SM, cuda_ms,
                     lane_rate, require_card, sm_clock_mhz)

JAX_SHAPE = (512, 128)
FULL_SHAPE = (1 << 15, 128)  # 2^22 elements
K_LO, K_HI = 16, 112
#: four times the ~0.5 us resolution of CUDA events: a shorter difference
#: t(k=112) - t(k=16) says nothing about one step
MIN_RESOLVED_MS = 0.002
#: K5's instantiations in csrc/probes.cu, by (op, form)
KERNEL_TAG = {(op, form): f"gf_chain_kernelILi{code}ELi"
                          f"{probe_cuda.CHAIN_FORMS[form]}EE"
              for op, code in probe_cuda.CHAIN_OPS.items()
              for form in probe_cuda.CHAIN_FORMS}

_ADDR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"\bBRA\b.*?(?:`\(([.\w]+)\)|(0x[0-9a-f]+))")
_LABEL = re.compile(r"^\s*([.\w]+):\s*$")


def operands(shape, seed: int = 0, device="cuda"):
    """a, b: uniform field values, as the JAX probe draws them."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, gf.P, size=shape, dtype=np.uint64)
    b = rng.integers(0, gf.P, size=shape, dtype=np.uint64)
    return gf.from_u64(a).to(device), gf.from_u64(b).to(device)


def loops(lines: list[str]) -> list[tuple[int, int, list[str]]]:
    """Every backward-branch loop in one kernel's SASS: (first address,
    branch address, the instructions from the one to the other)."""
    insns, labels = [], {}
    pending = []
    for line in lines:
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _ADDR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[label] = addr
            pending = []
            insns.append((addr, m.group(2)))
    found = []
    for addr, text in insns:
        m = _TARGET.search(text)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if target is not None and target < addr:
            found.append((target, addr,
                          [t for a, t in insns if target <= a <= addr]))
    return found


def loop_body(lines: list[str]) -> list[str]:
    """The instructions of the longest backward-branch loop in one
    kernel's SASS (K5's step loop, which is not unrolled)."""
    return max((body for _, _, body in loops(lines)), key=len, default=[])


def opcode_counts(body: list[str]) -> collections.Counter:
    """Opcodes (predicates stripped) of SASS instructions, counted."""
    return collections.Counter(t.split()[1] if t.startswith("@") else
                               t.split()[0] for t in body)


def imad_count(opcodes: collections.Counter) -> int:
    """The IMAD-family instructions (multiply-adds on the FMA pipe)."""
    return sum(n for opcode, n in opcodes.items() if opcode.startswith("IMAD"))


def sass_per_op(op: str, form: str = "cc") -> dict:
    """Instructions of one ``op`` in ``form`` in K5: the step loop's body
    (one step of four chains) over four, with the body's opcode counts."""
    kernels = _build.sass()
    if kernels is None:
        return {"instructions_per_op": "not measured (no cuobjdump)"}
    name = next(k for k in kernels if KERNEL_TAG[op, form] in k)
    body = loop_body(kernels[name])
    opcodes = opcode_counts(body)
    return {"kernel": name, "loop_instructions": len(body),
            "instructions_per_op": len(body) / 4,
            "imad_per_op": imad_count(opcodes) / 4,
            "loop_opcodes": dict(opcodes.most_common())}


def sass_per_perm(kernels: dict[str, list[str]] | None, tag: str,
                  rounds: int) -> dict:
    """Instructions of one Tip5 permutation in the kernel whose mangled
    name matches the regular expression ``tag``: its round loop (one round
    per iteration: the innermost loop that issues the most IMAD-family
    instructions) times ``rounds``, with the loop's opcode counts.
    ``kernels`` is ``_build.sass()``'s map, None without cuobjdump."""
    if kernels is None:
        return {"sass_per_perm": "not measured (no cuobjdump)",
                "imad_per_perm": "not measured (no cuobjdump)"}
    name = next(k for k in kernels if re.search(tag, k))
    found = loops(kernels[name])
    inner = [body for lo, hi, body in found
             if not any(lo <= a and b <= hi and (a, b) != (lo, hi)
                        for a, b, _ in found)]
    body = max(inner, key=lambda b: (imad_count(opcode_counts(b)), -len(b)))
    opcodes = opcode_counts(body)
    return {"kernel": name, "round_instructions": len(body),
            "sass_per_perm": len(body) * rounds,
            "imad_per_perm": imad_count(opcodes) * rounds,
            "round_opcodes": dict(opcodes.most_common())}


def per_step_ms(a, b, op: str, form: str | None = "cc",
                reps: int = 10) -> dict:
    """Device ms at k = 16 and 112 and of one step; form None: the twin."""
    def chain(k):
        if form is None:
            return probe_cuda.gf_chain_plain(a, b, op, k)
        return probe_cuda.gf_chain(a, b, op, k, form)

    t_lo = cuda_ms(lambda: chain(K_LO), reps)
    t_hi = cuda_ms(lambda: chain(K_HI), reps)
    return {"ms_k16": t_lo, "ms_k112": t_hi,
            "ms_per_step": (t_hi - t_lo) / (K_HI - K_LO)}


def run_case(op: str, form: str, shape, sass: dict, clock_mhz: float,
             plain: dict | None = None) -> dict:
    """One (op, form) at one shape; ``plain``: the twin's ``per_step_ms``
    at that shape, where the twin was timed."""
    a, b = operands(shape)
    n = a.numel()
    kern = per_step_ms(a, b, op, form)
    imad_rate = lane_rate(IMAD_LANES_PER_SM, clock_mhz)
    dispatch = lane_rate(DISPATCH_LANES_PER_SM, clock_mhz)
    res = {"op": op, "form": form, "shape": list(shape), "elements": n,
           **kern, "imad_rate_g_per_s": imad_rate / 1e9,
           "dispatch_rate_g_per_s": dispatch / 1e9}
    if plain is not None:
        res["plain_ms_per_step"] = plain["ms_per_step"]
    if kern["ms_k112"] - kern["ms_k16"] < MIN_RESOLVED_MS:
        res["gops_per_s"] = ("not measured: the 96 steps take less than "
                             "the CUDA events resolve")
        return res
    ops_per_s = n / (kern["ms_per_step"] * 1e-3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res["sm_cycles_per_warp_step"] = (kern["ms_per_step"] * 1e-3 * clock_mhz
                                      * 1e6 * sms / (n / 32))
    res["gops_per_s"] = ops_per_s / 1e9
    if plain is not None:
        res["plain_over_kernel"] = plain["ms_per_step"] / kern["ms_per_step"]
    per_op = sass.get("instructions_per_op")
    if isinstance(per_op, float):
        res["g_instructions_per_s"] = ops_per_s * per_op / 1e9
        res["share_of_dispatch_rate"] = ops_per_s * per_op / dispatch
        res["g_imad_per_s"] = ops_per_s * sass["imad_per_op"] / 1e9
        res["share_of_imad_rate"] = ops_per_s * sass["imad_per_op"] / imad_rate
    return res


def run(shapes=None, plain_reps: int = 3) -> list[dict]:
    """Both ops in both forms at every shape (the JAX probe's and the full
    one by default), one JSON line each, after one line per (op, form)
    with what K5's SASS says one op costs. The twin is timed once an (op,
    shape)."""
    shapes = shapes or (JAX_SHAPE, FULL_SHAPE)
    _, clock_max = sm_clock_mhz()
    results = []
    for op in probe_cuda.CHAIN_OPS:
        plain = {shape: per_step_ms(*operands(shape), op, None, plain_reps)
                 for shape in shapes}
        for form in probe_cuda.CHAIN_FORMS:
            sass = sass_per_op(op, form)
            print(json.dumps({"probe": "alu_sass", "op": op, "form": form,
                              **sass}), flush=True)
            for shape in shapes:
                res = run_case(op, form, shape, sass, clock_max, plain[shape])
                res["sm_clock_mhz_max"] = clock_max
                res["sm_clock_mhz_after"] = sm_clock_mhz()[0]
                print(json.dumps({"probe": "alu", **res}), flush=True)
                results.append({**res, "sass": sass})
    return results


def main() -> None:
    print(require_card(), flush=True)
    run()


if __name__ == "__main__":
    main()
