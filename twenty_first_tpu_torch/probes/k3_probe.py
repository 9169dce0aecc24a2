"""K3 at the flagship step's pass shapes, by column tile.

The 2^22-point NTT of 8 columns is two K3 passes over (8, 2^11, 2^11)
views: pass 1 reads a row-major matrix (a tile's columns contiguous, the
four-step diagonal in its epilogue), pass 2 reads its transpose (elements
contiguous, staged through shared memory) and writes rows, the epilogue
multiplying a [k1, k2] diagonal as ``ntt(post=)`` does. For each column
tile the wrapper aims for (``ntt_cuda._TILE_LOG2``, 2^13 elements by
default) it checks both passes against the plain twin and prints one JSON
line: their device times (``timing.cuda_ms``), the launch's threads and
resident warps, and the build's registers, spills and SASS per butterfly
(``pass_probe.kernel_stats``).

    python -m twenty_first_tpu_torch.probes.k3_probe [--tiles 13 14]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..math import gf, ntt
from ..ops import ntt_cuda
from .pass_probe import kernel_stats
from .timing import cuda_ms, require_card

LOG_N, COLS = 22, 8


def run(tiles=(13,), reps: int = 10) -> list[dict]:
    """Both passes at every tile target, one JSON line each."""
    rng = np.random.default_rng(11)
    log_n1, log_n2 = ntt.four_step_split(LOG_N)
    n1, n2 = 1 << log_n1, 1 << log_n2

    def field(shape):
        return gf.from_u64(rng.integers(0, gf.P, size=shape,
                                        dtype=np.uint64)).cuda()

    fwd = ntt.ntt_tables(1 << LOG_N, False, "cuda")
    x = field((COLS, n2, n1))
    post = field((n1, n2))
    y, z = torch.empty_like(x), torch.empty_like(x)
    passes = {
        "pass1": (lambda: ntt_cuda.ntt_local_pass(x, fwd.tw1, diag=fwd.diag,
                                                  out=y),
                  lambda: ntt_cuda.ntt_local_pass_plain(x, fwd.tw1,
                                                        diag=fwd.diag)),
        "pass2": (lambda: ntt_cuda.ntt_local_pass(y.transpose(1, 2), fwd.tw2,
                                                  diag=post, out=z),
                  lambda: ntt_cuda.ntt_local_pass_plain(
                      y.transpose(1, 2), fwd.tw2, diag=post))}
    default, results = ntt_cuda._TILE_LOG2, []
    try:
        for tile in tiles:
            ntt_cuda._TILE_LOG2 = tile
            res = {"tile_log2": tile, "shape": [COLS, n2, n1]}
            for name, (kernel, plain) in passes.items():
                out = kernel()
                if not torch.equal(out, plain()):
                    raise AssertionError(f"K3 {name} at tile 2^{tile} "
                                         "differs from the twin")
                res[f"{name}_ms"] = cuda_ms(kernel, reps)
            res.update(kernel_stats(log_n2, n1))
            res.pop("round_opcodes", None)
            print(json.dumps({"probe": "k3", **res}), flush=True)
            results.append(res)
    finally:
        ntt_cuda._TILE_LOG2 = default
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles", type=int, nargs="+", default=[13],
                    help="log2 of the tile the wrapper aims for")
    args = ap.parse_args(argv)
    print(require_card(), flush=True)
    run(tuple(args.tiles))


if __name__ == "__main__":
    main()
