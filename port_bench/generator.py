"""The one traffic generator: a traffic mix is a data file of parameters
(``traffic/<name>.json``), and this module turns it, with the cell's
configuration and the run's seed, into the input pool and the order in
which the operations take its inputs. Each input has the configuration's
size (2^log_rows rows of its columns).

A mix names:

* ``pool``: how many distinct inputs live on the device at once; the
  operations cycle through them, so consecutive operations never share an
  input and the pool can be made larger than the card's L2 cache. Set-up
  warms up over the whole pool once;
* ``loop``: the module of ``loops/`` that sends the operations (``closed``:
  one prover that waits for each root), and any further keys that module
  reads.

Every seed gives the same sizes and the same order; the seed changes only
the values, which are uniform canonical field elements made on the device.
"""

from __future__ import annotations

import torch

from reference import goldilocks as gl

KEYS = {"what", "pool", "loop"}


def check_mix(mix: dict, loop_keys=frozenset()) -> None:
    """Raises on a key that neither the generator nor the mix's loop
    (``loop_keys``) reads, and on sizes out of range."""
    unknown = set(mix) - KEYS - set(loop_keys)
    if unknown:
        raise ValueError(f"traffic keys {sorted(unknown)} are not known")
    if mix["pool"] < 1:
        raise ValueError(f"bad traffic sizes {mix}")


def make_pool(shape: tuple, mix: dict, seed: int, device) -> list:
    """``pool`` distinct inputs of ``shape`` (the operation's layout of the
    configuration's rows and columns) from ``seed``, on
    ``device``, drawn by a generator on that device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    return [gl.random_elements(shape, gen, device) for _ in range(mix["pool"])]


def pool_index(mix: dict, i: int) -> int:
    """The input of operation i: round robin over the pool."""
    return i % mix["pool"]
