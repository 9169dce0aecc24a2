"""The closed loop of one prover: operation i takes input i mod pool of
the mix, waits for its root on the host, and only then sends the next
(Fiat-Shamir absorbs each root before the next challenge is sampled).

A loop is found by the name a traffic mix gives under ``loop``: a mix
that sends otherwise (several operations in flight, arrivals at a rate)
brings a module of its own beside this one, with a ``Loop`` of the same
methods and ``KEYS``, the further mix keys it reads.
"""

from __future__ import annotations

import time

import torch

import devtrace
import generator

#: mix keys this loop reads beyond the generator's own
KEYS: frozenset = frozenset()


class Loop:
    """Drives ``op`` over ``pool``; keeps every root for the check, and,
    where the operation keeps its tree, the newest tree of each input."""

    def __init__(self, op, pool: list, mix: dict):
        self.op, self.pool, self.mix = op, pool, mix
        self.index = 0
        self.roots = []  # (pool index, root)
        self.nodes = {}  # pool index -> the newest tree of that input

    def one(self):
        k = generator.pool_index(self.mix, self.index)
        self.index += 1
        root, nodes = self.op.run(self.pool[k])
        self.roots.append((k, root))
        if nodes is not None:
            self.nodes[k] = nodes

    def run(self, count: int) -> None:
        """``count`` operations, each under the harness's own span (set-up
        and the traced window)."""
        for _ in range(count):
            with torch.profiler.record_function(devtrace.OWN_SPAN):
                self.one()

    def window(self, seconds: float, log) -> dict:
        """Operations until ``seconds`` have passed: each one's latency
        from its call until its root is on the host, the window's wall
        time, and the operations that raised."""
        latencies, failed = [], 0
        start = time.perf_counter()
        end = start + seconds
        while True:
            t0 = time.perf_counter()
            if t0 >= end:
                break
            try:
                self.one()
            except RuntimeError as err:  # a CUDA or shape error of one call
                failed += 1
                log(f"operation {self.index - 1} failed: {err}")
                continue
            latencies.append(time.perf_counter() - t0)
        wall = time.perf_counter() - start
        return {"latencies": latencies, "failed": failed, "wall_s": wall,
                "attempted": len(latencies) + failed}

    def host_answers(self) -> None:
        """Bring the kept trees to the host, so the program's memory can go."""
        self.nodes = {k: self.op.host_nodes(v) for k, v in self.nodes.items()}
