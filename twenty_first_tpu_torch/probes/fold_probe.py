"""K6 and K8's inverse at the polynomial batch path's shapes, by schedule,
and the rates of the multiply-add forms they are built from.

K6 (``coset_extrapolate_fold``) runs at its three path shapes: one 2^18
coefficient row to 2^10 base points (``bench.py``'s out-of-domain shape),
8 rows of 2^20 base coefficients and 2 rows of 2^20 xfe coefficients to
16 xfe points. For each lane target it forces the segment length that
``poly_cuda.fold_plan`` would pick for that target (``seg_log2``), checks
the kernel against the plain twin and prints one JSON line with the device
time (``timing.cuda_ms``) and the plan. Then K8's inverse at 2^22 and 2^20
elements; first, the registers and spills the build reports for K6's and
K8's kernels, and the SM clock and power that nvidia-smi reads right after
each shape's runs.

With ``--rates`` it first times ``imad_rate_kernel`` (``csrc/probes.cu``)
for each form: 32-bit multiply-add low, multiply high, the wide
multiply-add (a 32x32 product into a 64-bit sum), add, the double FMA, and
the product into a three-word sum by the carry chain that K6's accumulator
is built from. It prints each form's operations per clock and SM (a full
card of resident threads, the SM clock nvidia-smi reads just after) and
the SASS opcodes of the form's step loop, which show what ptxas made of
it.

    python -m twenty_first_tpu_torch.probes.fold_probe [--lanes 15 16 17]
        [--rates]
"""

from __future__ import annotations

import argparse
import json
import re

import numpy as np
import torch

from .. import _build
from ..math import gf
from ..ops import poly_cuda
from .alu_probe import loop_body, opcode_counts
from .timing import cuda_ms, nvidia_smi, require_card, sm_clock_mhz
from .tip5_probe import ptxas_report

#: (label, rows, n, m, xfe points, xfe coefficients)
SHAPES = (("bench_1x2^18_to_2^10", 1, 1 << 18, 1 << 10, False, False),
          ("stark_8x2^20_to_16_xfe", 8, 1 << 20, 16, True, False),
          ("xfe_2x3x2^20_to_16_xfe", 2, 1 << 20, 16, True, True))
INVERSE_SIZES = (1 << 22, 1 << 20)
#: imad_rate_kernel's forms by code (csrc/probes.cu); each step of a chain
#: counts one operation (form 5: one 32x32 product into three words by a
#: carry chain of three instructions)
RATE_FORMS = {0: "mad.lo.u32", 1: "mul.hi.u32", 2: "mad.wide.u32",
              3: "add.u32", 4: "fma.rn.f64",
              5: "mad.lo.cc+madc.hi.cc+addc"}
RATE_THREADS, RATE_CHAINS = 256, 8


def _field(rng, shape):
    return gf.from_u64(rng.integers(0, gf.P, size=shape,
                                    dtype=np.uint64)).cuda()


def seg_log2_for(rows: int, n: int, m: int, log_lanes: int) -> int:
    """The segment length (log2) ``fold_plan`` picks for a lane target of
    2^log_lanes."""
    plan = poly_cuda.fold_plan(rows, n, m, 0)
    per_seg = rows * plan["tiles"] << plan["log_p"]
    want = -(-(1 << log_lanes) // per_seg)
    log_n = max(n - 1, 0).bit_length()
    return max(log_n - max(want - 1, 0).bit_length(),
               min(poly_cuda.FOLD_MIN_SEG_LOG2, log_n))


def fold_cases(lanes, reps: int = 10) -> list[dict]:
    """Every shape at every lane target, each checked against the plain
    twin computed once a shape."""
    rng = np.random.default_rng(7)
    results = []
    for label, rows, n, m, xpts, xcoef in SHAPES:
        b = _field(rng, (rows, 3, n) if xcoef else (rows, n))
        w = _field(rng, (m, 3) if xpts else (m,))
        want = poly_cuda.coset_extrapolate_fold_plain(b, w, point_chunk=4)
        for log_lanes in lanes:
            seg = seg_log2_for(rows, n, m, log_lanes)

            def fold():
                return poly_cuda.coset_extrapolate_fold(b, w, seg_log2=seg)

            if not torch.equal(fold(), want):
                raise AssertionError(f"K6 {label} lanes=2^{log_lanes} "
                                     "differs from the twin")
            res = {"probe": "k6", "shape": label,
                   "target_lanes_log2": log_lanes, "ms": cuda_ms(fold, reps),
                   "plan": poly_cuda.fold_plan(rows, n, m, seg, xpts=xpts,
                                               xcoef=xcoef)}
            print(json.dumps(res), flush=True)
            results.append(res)
        print(json.dumps({"probe": "clock", "after": label,
                          "sm_clock_power": nvidia_smi(
                              "clocks.sm,power.draw")}), flush=True)
        del b, w, want
    return results


def inverse_cases(reps: int = 10) -> list[dict]:
    """K8's inverse at each size, checked against the twin."""
    rng = np.random.default_rng(8)
    results = []
    for size in INVERSE_SIZES:
        x = _field(rng, (size,))
        x[::97] = 0

        def inv():
            return poly_cuda.gf_pointwise(x, None, "inv")

        if not torch.equal(inv(), poly_cuda.gf_pointwise_plain(x, None,
                                                               "inv")):
            raise AssertionError(f"K8 inv at {size} differs from the twin")
        res = {"probe": "k8_inv", "n": size, "ms": cuda_ms(inv, reps)}
        print(json.dumps(res), flush=True)
        results.append(res)
    return results


def rates(k: int = 4096, reps: int = 5) -> list[dict]:
    """Operations per clock and SM of each imad_rate_kernel form, with a
    full card of resident threads (2048 an SM)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * 2048 // RATE_THREADS
    out = torch.empty(blocks * RATE_THREADS, dtype=torch.int64,
                      device="cuda")
    lib = _build.load()
    kernels = _build.sass() or {}
    results = []
    for form, name in RATE_FORMS.items():
        def run():
            _build.check(lib.tf_imad_rate(out.data_ptr(), blocks, k, form,
                                          _build.stream_of(out)),
                         "imad_rate")

        ms = cuda_ms(run, reps)
        clock = sm_clock_mhz()[0]
        ops = blocks * RATE_THREADS * RATE_CHAINS * k
        tag = f"imad_rate_kernelILi{form}E"
        sass = next((v for key, v in kernels.items() if tag in key), None)
        res = {"probe": "rate", "form": name, "ms": ms, "sm_clock_mhz": clock,
               "ops_per_clock_per_sm": ops / (ms * 1e-3 * clock * 1e6 * sms),
               "loop_opcodes": (dict(opcode_counts(loop_body(sass))
                                     .most_common())
                                if sass else "not measured (no cuobjdump)")}
        print(json.dumps(res), flush=True)
        results.append(res)
    return results


def kernel_stats() -> dict[str, dict]:
    """Registers, shared memory and spills of K6's and K8's kernels, by
    mangled name, from the build's ``-Xptxas -v`` report; for K6's, the
    opcodes of the longest loop's body (a block of terms) by cuobjdump."""
    report = ptxas_report(_build.build_log())
    stats = {k: v for k, v in report.items()
             if re.search(r"coset_fold_kernel|gf_pointwise_kernel", k)}
    kernels = _build.sass() or {}
    for name, stat in stats.items():
        if "coset_fold_kernel" in name and name in kernels:
            stat["block_loop_opcodes"] = dict(
                opcode_counts(loop_body(kernels[name])).most_common())
    return stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, nargs="+", default=[15, 16, 17],
                    help="log2 of the lane targets to run")
    ap.add_argument("--rates", action="store_true",
                    help="first time the multiply-add forms alone")
    args = ap.parse_args(argv)
    print(require_card(), flush=True)
    _build.load()
    if args.rates:
        rates()
    print(json.dumps({"probe": "ptxas", **kernel_stats()}), flush=True)
    fold_cases(args.lanes)
    inverse_cases()


if __name__ == "__main__":
    main()
