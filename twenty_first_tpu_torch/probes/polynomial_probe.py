"""The polynomial engine's host/card crossovers (``ntt.HOST_NTT_MAX_ELEMS``,
``ntt.HOST_CONV_MAX_ELEMS``, ``polynomial.HOST_INVERSE_MAX_ELEMS``).

For 2^8..2^22 elements it times, host wall time with numpy in and out
(medians of 5), one-shot transforms (``ntt_host`` against ``ntt_values``
on the card), convolutions (``_conv_host`` against ``conv_values``) and
batch inversions (the native core's ``batch_inverse`` against
``_finv_device``); then ``Polynomial._mul_rows``, the product tree's
batched row products, under ``host_routes()`` and ``card_routes()``
(medians of 3, results required equal) at three row widths. It prints one
JSON line: each operation's medians by size, ``host_up_to`` (the largest
size at which the host's median is at least as fast) and the cuts in
force. ``card_routes``/``host_routes`` also serve the card script's checks
and the CPU tests, which hold the engine's results on the card's routes
against the host's.

    python -m twenty_first_tpu_torch.probes.polynomial_probe
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys

import numpy as np

from .. import native
from ..math import ntt, polynomial
from ..math.gf import P
from . import timing

EXTRAPOLATE_KNOB = "TWENTY_FIRST_TPU_EXTRAPOLATE_DEVICE"
#: the crossover sweep: one-shot transforms, convolutions and batch
#: inversions of 2^8 .. 2^22 elements; batched row products of rows of
#: 2^(k+1) + 1 coefficients (the product tree's levels over leafs of 2^k
#: points), 2^(k+2) elements a padded row, at 2^9 .. 2^22 elements a level
SWEEP_LOG2 = range(8, 23)
ROWS_SWEEP = ((4, (9, 10, 11, 12, 14, 18, 22)), (7, (10, 11, 12, 14, 18, 22)),
              (10, (12, 13, 14, 18, 22)))


@contextlib.contextmanager
def polynomial_routes(limit: int, knob: str, device=None):
    """The polynomial engine with every crossover (``ntt.HOST_NTT_MAX_ELEMS``,
    ``HOST_CONV_MAX_ELEMS``, ``polynomial.HOST_INVERSE_MAX_ELEMS``) at
    ``limit``, the extrapolation knob at ``knob`` and ``ntt.DEVICE`` at
    ``device`` (unchanged if None): 0 and "1" send all of its work to the
    device, ``sys.maxsize`` and "0" keep it on the host."""
    saved = (ntt.DEVICE, ntt.HOST_NTT_MAX_ELEMS, ntt.HOST_CONV_MAX_ELEMS,
             polynomial.HOST_INVERSE_MAX_ELEMS)
    old_knob = os.environ.get(EXTRAPOLATE_KNOB)
    ntt.DEVICE = device or ntt.DEVICE
    ntt.HOST_NTT_MAX_ELEMS = ntt.HOST_CONV_MAX_ELEMS = limit
    polynomial.HOST_INVERSE_MAX_ELEMS = limit
    os.environ[EXTRAPOLATE_KNOB] = knob
    try:
        yield
    finally:
        (ntt.DEVICE, ntt.HOST_NTT_MAX_ELEMS, ntt.HOST_CONV_MAX_ELEMS,
         polynomial.HOST_INVERSE_MAX_ELEMS) = saved
        os.environ.pop(EXTRAPOLATE_KNOB, None)
        if old_knob is not None:
            os.environ[EXTRAPOLATE_KNOB] = old_knob


def card_routes(device=None):
    """All of the polynomial engine's work on ``device`` (ntt.DEVICE, the
    card, if None)."""
    return polynomial_routes(0, "1", device)


def host_routes():
    """All of the polynomial engine's work on the host."""
    return polynomial_routes(sys.maxsize, "0")


def sweep(rng) -> dict:
    """Host wall time against the card's, numpy in and out, of one-shot
    transforms, convolutions, batched row products and batch inversions;
    the measured cuts beside the chosen ones."""
    rows = {"ntt": ({}, {}), "conv": ({}, {}), "inverse": ({}, {})}
    for log_n in SWEEP_LOG2:
        n = 1 << log_n
        x, y = (rng.integers(0, P, size=n, dtype=np.uint64) for _ in "xy")
        inv = np.where(x == 0, np.uint64(1), x)
        for name, host, card in (
                ("ntt", lambda: ntt.ntt_host(x),
                 lambda: ntt.ntt_values(x, device=ntt.DEVICE)),
                ("conv", lambda: ntt._conv_host(x, y, False, False),
                 lambda: ntt.conv_values(x, y, device=ntt.DEVICE)),
                ("inverse", lambda: native.batch_inverse(inv),
                 lambda: polynomial._finv_device(inv, False))):
            rows[name][0][n] = statistics.median(timing.wall_times(host, 5))
            rows[name][1][n] = statistics.median(timing.wall_times(card, 5))
    for k, logs in ROWS_SWEEP:
        size = 1 << (k + 2)
        row_host, row_card = {}, {}
        for log_total in logs:
            m = (1 << log_total) // size
            a = rng.integers(0, P, size=(m, (1 << (k + 1)) + 1),
                             dtype=np.uint64)
            b = rng.integers(0, P, size=a.shape, dtype=np.uint64)

            def mul_rows():
                return polynomial.Polynomial._mul_rows(a, b, False)

            with host_routes():
                host = statistics.median(timing.wall_times(mul_rows, 3))
                want = mul_rows()
            with card_routes():
                card = statistics.median(timing.wall_times(mul_rows, 3))
                if not np.array_equal(mul_rows(), want):
                    raise AssertionError(f"_mul_rows ({m}, {a.shape[1]}): "
                                         "the card's and the host's differ")
            row_host[m * size], row_card[m * size] = host, card
        rows[f"rows_of_{(1 << (k + 1)) + 1}"] = (row_host, row_card)
    return {"ms": {name: {"host_ms": {f"2^{n.bit_length() - 1}": v
                                      for n, v in h.items()},
                          "card_ms": {f"2^{n.bit_length() - 1}": v
                                      for n, v in c.items()},
                          "host_up_to": timing.crossover(h, c)}
                   for name, (h, c) in rows.items()},
            "chosen": {"HOST_NTT_MAX_ELEMS": ntt.HOST_NTT_MAX_ELEMS,
                       "HOST_CONV_MAX_ELEMS": ntt.HOST_CONV_MAX_ELEMS,
                       "HOST_INVERSE_MAX_ELEMS":
                           polynomial.HOST_INVERSE_MAX_ELEMS,
                       "_mul_rows": "the card above HOST_CONV_MAX_ELEMS "
                                    "elements a level (m rows x the padded "
                                    "product length)"}}


def main() -> None:
    print(timing.require_card(), flush=True)
    if not native.available():
        raise RuntimeError("the native host core did not load")
    print(json.dumps({"probe": "polynomial_crossover",
                      **sweep(np.random.default_rng(10))}), flush=True)


if __name__ == "__main__":
    main()
