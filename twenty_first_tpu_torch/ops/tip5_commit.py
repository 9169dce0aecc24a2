"""Merkle commitment with Tip5: the launch plan around K2.

The counterpart of ``twenty_first_tpu/ops/tip5_packed.py`` (the TPU commit
path) and ``parallel/dist_merkle._reduce_layers`` (its plain form). Parent j
of a level is ``hash_pair(child 2j, child 2j + 1)`` with the capacity set to
1. Each K2 launch reduces as many levels as one block holds (up to 9 for
2 * 256 digests); the host loop launches it until ``num_layers`` levels are
done, so the last launch takes a layer smaller than a full block.
"""

from __future__ import annotations

import torch

from ..tip5.constants import DIGEST_LENGTH, STATE_SIZE
from ..tip5.permutation import tip5_tables
from . import tip5_cuda


def _lowbit(rows: int) -> int:
    return rows & -rows


def _launch(plain: bool):
    return tip5_cuda.merkle_commit_plain if plain else tip5_cuda.merkle_commit


def _check_divisible(rows: int, num_layers: int):
    if num_layers < 0 or rows % (1 << num_layers):
        raise ValueError(f"{rows} rows cannot reduce {num_layers} layers")


def reduce_layers(digests, num_layers: int, *, tables=None,
                  plain: bool = False):
    """Repeated batched hash_pair: (b, 5) -> (b >> num_layers, 5)."""
    rows = digests.shape[0]
    _check_divisible(rows, num_layers)
    if digests.dim() != 2 or digests.shape[1] != DIGEST_LENGTH:
        raise ValueError(f"digests must be (b, 5), got {tuple(digests.shape)}")
    rc, lut = tables if tables is not None else tip5_tables(digests.device)
    x = digests.contiguous()
    while num_layers > 0 and x.shape[0] > 0:
        span = min(2 * tip5_cuda.MAX_THREADS, _lowbit(x.shape[0]))
        levels = min(num_layers, span.bit_length() - 1)
        x = _launch(plain)(x, False, levels, span // 2, rc, lut)
        num_layers -= levels
    return x


def commit_states(states, num_layers: int, *, tables=None,
                  plain: bool = False):
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
    threads = min(tip5_cuda.MAX_THREADS, _lowbit(rows))
    levels = min(num_layers, threads.bit_length() - 1)
    digests = _launch(plain)(states.contiguous(), True, levels, threads,
                             *tables)
    return reduce_layers(digests, num_layers - levels, tables=tables,
                         plain=plain)
