"""Merkle commitment with Tip5: the launch plan around K2.

The counterpart of ``twenty_first_tpu/ops/tip5_packed.py`` (the TPU commit
path) and ``parallel/dist_merkle._reduce_layers`` (its plain form). Parent j
of a level is ``hash_pair(child 2j, child 2j + 1)`` with the capacity set to
1.

``plan`` orders the launches. A level with at least as many parents as the
card holds resident threads of the level kernel runs as one full-width
``merkle_level`` launch, so every warp works. Below that size a level is
latency-bound, and the rest of the tree goes through fused
``merkle_commit`` launches, each reducing as many levels as one block holds
(up to 9 for 2 * 256 digests); the last takes a layer smaller than a block.
"""

from __future__ import annotations

import torch

from ..spans import span
from ..tip5.constants import DIGEST_LENGTH, STATE_SIZE
from ..tip5.permutation import tip5_tables
from . import tip5_cuda


def _lowbit(rows: int) -> int:
    return rows & -rows


def _check_divisible(rows: int, num_layers: int):
    if num_layers < 0 or rows % (1 << num_layers):
        raise ValueError(f"{rows} rows cannot reduce {num_layers} layers")


def plan(rows: int, num_layers: int, resident_threads: int,
         leaf: bool = False) -> list[tuple]:
    """The K2 launches that reduce ``num_layers`` levels of ``rows``
    digests (or, with ``leaf``, hash ``rows`` leaf states first), given how
    many threads of the level kernel the card holds at once:

    * ``("level", leaf)``: one level at full width (leaf: the leaf hash);
    * ``("fused", leaf, levels, threads)``: ``levels`` levels in one launch
      of ``threads``-thread blocks.
    """
    _check_divisible(rows, num_layers)
    steps: list[tuple] = []
    if rows == 0:
        return steps
    if leaf and rows >= resident_threads:
        steps.append(("level", True))
        leaf = False
    while not leaf and num_layers > 0 and rows // 2 >= resident_threads:
        steps.append(("level", False))
        rows //= 2
        num_layers -= 1
    if leaf:
        threads = min(tip5_cuda.MAX_THREADS, _lowbit(rows))
        levels = min(num_layers, threads.bit_length() - 1)
        steps.append(("fused", True, levels, threads))
        rows >>= levels
        num_layers -= levels
    while num_layers > 0:
        span = min(2 * tip5_cuda.MAX_THREADS, _lowbit(rows))
        levels = min(num_layers, span.bit_length() - 1)
        steps.append(("fused", False, levels, span // 2))
        rows >>= levels
        num_layers -= levels
    return steps


def _run(x, steps, tables, plain: bool):
    level = tip5_cuda.merkle_level_plain if plain else tip5_cuda.merkle_level
    fused = tip5_cuda.merkle_commit_plain if plain else tip5_cuda.merkle_commit
    for step in steps:
        x = level(x, step[1], *tables) if step[0] == "level" else fused(
            x, *step[1:], *tables)
    return x


def _resident(x, plain: bool, resident_threads: int | None) -> int:
    if resident_threads is not None:
        return resident_threads
    return 0 if plain else tip5_cuda.resident_threads(x.device)


def reduce_layers(digests, num_layers: int, *, tables=None,
                  plain: bool = False, resident_threads: int | None = None):
    """Repeated batched hash_pair: (b, 5) -> (b >> num_layers, 5).

    ``resident_threads`` defaults to the card's (``tip5_cuda``), and to 0,
    every level at full width, where the plain twins run."""
    if digests.dim() != 2 or digests.shape[1] != DIGEST_LENGTH:
        raise ValueError(f"digests must be (b, 5), got {tuple(digests.shape)}")
    rows = digests.shape[0]
    _check_divisible(rows, num_layers)
    with span("tree"):
        tables = tables if tables is not None else tip5_tables(digests.device)
        if rows == 0 or num_layers == 0:
            return digests.contiguous()
        steps = plan(rows, num_layers,
                     _resident(digests, plain, resident_threads))
        return _run(digests.contiguous(), steps, tables, plain)


def commit_states(states, num_layers: int, *, tables=None,
                  plain: bool = False, resident_threads: int | None = None):
    """Leaf-hash states (B, 16) -> (B >> num_layers, 5) digests: hash every
    leaf state (one permutation each) and reduce ``num_layers`` levels."""
    if states.dim() != 2 or states.shape[1] != STATE_SIZE:
        raise ValueError(f"states must be (B, 16), got {tuple(states.shape)}")
    rows = states.shape[0]
    _check_divisible(rows, num_layers)
    tables = tables if tables is not None else tip5_tables(states.device)
    if rows == 0:
        return torch.empty((0, DIGEST_LENGTH), dtype=states.dtype,
                           device=states.device)
    steps = plan(rows, num_layers, _resident(states, plain, resident_threads),
                 leaf=True)
    return _run(states.contiguous(), steps, tables, plain)
