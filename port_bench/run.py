"""The port's benchmark: one run of one cell.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``twenty_first_tpu_torch``, on a
machine with an NVIDIA GPU. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, the numbers compared with the reference beside their limits.
Exits non-zero, printing no result, without a card, when the program
cannot be imported, or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))  # the checkout's root: the port


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    import harness

    try:
        cell = harness.Cell.load(args.workload)
    except harness.Refused as err:
        harness.log(f"refused: {err}")
        return 2
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"the cell needs {chips} CUDA device(s): the benchmark "
                    "runs only on the card")
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              T0)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"loaded in this process: {found}; the benchmark may "
                    "load neither JAX nor the JAX package")
        return 3
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
