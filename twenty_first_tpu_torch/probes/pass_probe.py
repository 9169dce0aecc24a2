"""Timing probe of one NTT local pass over 2^24 elements on the card.

The counterpart of ``scripts/prof_pallas_pass.py``. The 2^24 values (drawn
from ``np.random.default_rng(0)``) form a (t, w) matrix, w = 2^24 / t, and
a pass is the natural-order NTT of length t down every column. A spec
``"log_t,tc[,rt|ng]"`` picks t = 2^log_t and one of three variants:

* (none) T6, ``make_pass``: K3 as one launch over the whole matrix; K3
  picks its own shared-memory tile, so tc has no meaning here;
* ``ng`` T7, ``make_pass_nogrid``: K3 launched once per tile of tc columns
  (w / tc launches);
* ``rt`` T6 with ``roundtrip``: the K4 chain, one launch per butterfly
  stage (log_t round trips of the matrix through device memory).

For each spec it prints one JSON line: the pass's median device time by
CUDA events (``ms``) and its host wall time with the launch overheads
(``wall_ms``), G elements/s, and the bytes the variant moves over the
device time beside 3.35 TB/s (the H100's memory rate), after checking the
whole output of the timed variant against the plain pass (the JAX script
checks 256 columns, :166).

    python -m twenty_first_tpu_torch.probes.pass_probe [spec ...]
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..math import gf, ntt
from ..ops import ntt_cuda, probe_cuda
from .timing import MEMORY_BYTES_PER_S, cuda_ms, require_card, wall_ms

LOG_N = 24
#: the JAX script's specs (:183), and its grid-free variant
DEFAULT_SPECS = ("12,128", "12,64", "8,512", "8,128", "12,128,rt",
                 "12,128,ng")
VARIANTS = ("grid", "ng", "rt")


def parse_spec(spec: str) -> tuple[int, int, str]:
    """'log_t,tc[,rt|ng]' -> (log_t, tc, variant)."""
    parts = spec.split(",")
    if len(parts) not in (2, 3) or (len(parts) == 3
                                    and parts[2] not in ("rt", "ng")):
        raise ValueError(f"spec must be 'log_t,tc[,rt|ng]', got {spec!r}")
    return int(parts[0]), int(parts[1]), parts[2] if len(parts) == 3 else "grid"


def run_pass(x, tw, variant: str, tc: int, out=None):
    """The pass over the columns of the (t, w) tensor x, by ``variant``;
    returns ``out`` (a new tensor when None)."""
    if out is None:
        out = torch.empty_like(x)
    if variant == "grid":
        ntt_cuda.ntt_local_pass(x.unsqueeze(0), tw, out=out.unsqueeze(0))
    elif variant == "ng":
        for c in range(0, x.shape[1], tc):
            ntt_cuda.ntt_local_pass(x[None, :, c:c + tc], tw,
                                    out=out[None, :, c:c + tc])
    elif variant == "rt":
        probe_cuda.ntt_stage(x, tw, 0, bit_reverse=True, out=out)
        for stage in range(1, x.shape[0].bit_length() - 1):
            probe_cuda.ntt_stage(out, tw, stage, out=out)
    else:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    return out


def plain_pass(x, tw):
    """The plain pass the variants are checked against (K3's twin)."""
    return ntt_cuda.ntt_local_pass_plain(x.unsqueeze(0), tw)[0]


def make_input(log_t: int, device="cuda"):
    """The (2^log_t, 2^24 / 2^log_t) matrix of the JAX script's values."""
    vals = np.random.default_rng(0).integers(0, gf.P, size=1 << LOG_N,
                                             dtype=np.uint64)
    return gf.from_u64(vals.reshape(1 << log_t, -1)).to(device)


def run_case(spec: str, x=None, reps: int = 10) -> dict:
    """Check and time one spec on the card; x: its input (made when None)."""
    log_t, tc, variant = parse_spec(spec)
    if x is None:
        x = make_input(log_t)
    tw = gf.from_u64(ntt.stage_twiddles(log_t, False)).to(x.device)
    out = torch.empty_like(x)
    counters = (ntt_cuda.ntt_local_pass, probe_cuda.ntt_stage)
    before = sum(c.launches for c in counters)
    run_pass(x, tw, variant, tc, out)
    launches = sum(c.launches for c in counters) - before
    correct = torch.equal(out, plain_pass(x, tw))
    ms = cuda_ms(lambda: run_pass(x, tw, variant, tc, out), reps)
    host_ms = wall_ms(lambda: run_pass(x, tw, variant, tc, out), reps)
    n = x.numel()
    pass_bytes = 2 * 8 * n  # each element read once and written once
    moved = pass_bytes * (log_t if variant == "rt" else 1)
    return {"spec": spec, "log_t": log_t, "tc": tc, "variant": variant,
            "launches_per_pass": launches, "ms": ms, "wall_ms": host_ms,
            "gelems_per_s": n / (ms * 1e-3) / 1e9,
            "bytes_moved": moved, "tb_per_s": moved / (ms * 1e-3) / 1e12,
            "share_of_3_35_tb_per_s": moved / (ms * 1e-3) / MEMORY_BYTES_PER_S,
            "bound_ms": pass_bytes / MEMORY_BYTES_PER_S * 1e3,
            "correct": correct}


def run(specs=DEFAULT_SPECS, reps: int = 10) -> list[dict]:
    """Every spec, one JSON line each; raises if a variant disagrees with
    the plain pass."""
    results, inputs = [], {}
    for spec in specs:
        log_t = parse_spec(spec)[0]
        if log_t not in inputs:
            inputs[log_t] = make_input(log_t)
        res = run_case(spec, inputs[log_t], reps)
        print(json.dumps({"probe": "pass", **res}), flush=True)
        results.append(res)
    bad = [r["spec"] for r in results if not r["correct"]]
    if bad:
        raise AssertionError(f"pass probe: {bad} differ from the plain pass")
    return results


def main(argv=None) -> None:
    print(require_card(), flush=True)
    run(tuple(argv if argv is not None else sys.argv[1:]) or DEFAULT_SPECS)


if __name__ == "__main__":
    main()
