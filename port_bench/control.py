"""The control of the benchmark's check, on the card at a cell's own size.

    python3 port_bench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, in one process: the program commits to each input of the
cell's pool once, as the window does, and the check compares its answers
with the reference (the lower reading); then the control, the plain
reference with its MDS products in float32, the precision below the
float64 in which they are exact, takes the program's place over the same
inputs, and the same check compares its answers (the upper reading). Each
seed prints one JSON line. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))


class Control:
    """The reference in the program's place, at ``mds_dtype``."""

    def __init__(self, cell, device, mds_dtype, shape):
        from reference.tip5 import Tip5

        self.cell, self.shape = cell, shape
        self.tip5 = Tip5(device, mds_dtype=mds_dtype)

    def run(self, x):
        return self.cell.operation.reference(self.cell.config, [x],
                                             self.tip5)[0]

    @staticmethod
    def host_nodes(nodes):
        return nodes


def readings(cell, op, seed: int, device) -> dict:
    """Each input of the pool once through ``op``, then the check."""
    import generator
    import harness

    pool = generator.make_pool(op.shape, cell.mix, seed, device)
    loop = cell.loop.Loop(op, pool, cell.mix)
    loop.run(cell.mix["pool"])
    loop.host_answers()
    return harness.check(cell, loop, device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)

    import torch

    import harness

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 as float32
    cell = harness.Cell.load(args.workload)
    program = cell.operation.Operation(cell.config, cell.mix, "cuda")
    control = Control(cell, "cuda", torch.float32, program.shape)
    for seed in args.seeds:
        lower = readings(cell, program, seed, "cuda")
        upper = readings(cell, control, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": lower, "control": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
