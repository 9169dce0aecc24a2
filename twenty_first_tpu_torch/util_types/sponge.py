"""Sponge construction interface (util_types/sponge.rs).

A copy of ``twenty_first_tpu/util_types/sponge.py`` (importing that
package would import JAX).

`Domain` selects the capacity initialization; `Sponge` provides the shared
pad-and-absorb-all logic (pad with 1, 0, ..., 0 to a RATE multiple,
sponge.rs:41-55).
"""

from __future__ import annotations

import enum
from typing import Sequence

from ..math.b_field_element import BFieldElement, bfe

RATE = 10


class Domain(enum.Enum):
    VARIABLE_LENGTH = "variable_length"
    FIXED_LENGTH = "fixed_length"


class Sponge:
    """Base class: subclasses define RATE, init(), absorb(), squeeze()."""

    RATE = RATE

    @classmethod
    def init(cls):
        raise NotImplementedError

    def absorb(self, input_chunk: Sequence[BFieldElement]) -> None:
        raise NotImplementedError

    def squeeze(self) -> list[BFieldElement]:
        raise NotImplementedError

    def pad_and_absorb_all(self, input_elements: Sequence) -> None:
        elements = [bfe(e) for e in input_elements]
        rate = type(self).RATE
        full, rem = divmod(len(elements), rate)
        for i in range(full):
            self.absorb(elements[i * rate: (i + 1) * rate])
        last_chunk = elements[full * rate:]
        last_chunk.append(bfe(1))
        last_chunk.extend([bfe(0)] * (rate - len(last_chunk)))
        self.absorb(last_chunk)
