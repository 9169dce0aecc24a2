"""Zerofier tree: balanced binary tree of vanishing polynomials.

A copy of ``twenty_first_tpu/math/zerofier_tree.py`` (importing that
package would import JAX) over the port's ``Polynomial``;
``tests/test_torch_polynomial_interp.py`` holds it against the JAX
package's.

Mirrors twenty-first/src/math/zerofier_tree.rs: leafs hold up to
RECURSION_CUTOFF_THRESHOLD points plus their zerofier; branches hold the
product of their children's zerofiers. Used by divide-and-conquer batch
evaluation and interpolation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

RECURSION_CUTOFF_THRESHOLD = 16


@dataclass
class ZerofierTreeNode:
    zerofier: "Polynomial"
    points: Optional[list] = None  # leaf payload
    left: Optional["ZerofierTreeNode"] = None
    right: Optional["ZerofierTreeNode"] = None

    @property
    def is_leaf(self) -> bool:
        return self.points is not None


class ZerofierTree:
    """Built bottom-up from chunks of <= 16 points (zerofier_tree.rs:66-86)."""

    def __init__(self, root: Optional[ZerofierTreeNode]):
        self.root = root

    @classmethod
    def new_from_domain(cls, domain) -> "ZerofierTree":
        from .polynomial import Polynomial, _to_field_array

        if len(domain) == 0:
            return cls(None)
        pts, x = _to_field_array(domain)
        k = RECURSION_CUTOFF_THRESHOLD
        n_full = pts.shape[0] // k
        nodes = []
        if n_full:
            # all full leaf chunks batched: 2k vectorized calls total
            rows = Polynomial.batch_smart_zerofier_rows(
                pts[: n_full * k].reshape((n_full, k, 3) if x
                                          else (n_full, k)), x)
            for i in range(n_full):
                chunk = list(domain[i * k: (i + 1) * k])
                nodes.append(ZerofierTreeNode(
                    zerofier=Polynomial.from_array(rows[i].copy(), x),
                    points=chunk))
        if pts.shape[0] % k:
            chunk = list(domain[n_full * k:])
            nodes.append(ZerofierTreeNode(
                zerofier=Polynomial.zerofier(chunk), points=chunk))
        while len(nodes) > 1:
            next_level = []
            for i in range(0, len(nodes) - 1, 2):
                left, right = nodes[i], nodes[i + 1]
                next_level.append(
                    ZerofierTreeNode(
                        zerofier=left.zerofier * right.zerofier,
                        left=left,
                        right=right,
                    )
                )
            if len(nodes) % 2:
                next_level.append(nodes[-1])
            nodes = next_level
        return cls(nodes[0])

    def zerofier(self) -> "Polynomial":
        from .polynomial import Polynomial

        if self.root is None:
            return Polynomial.one()
        return self.root.zerofier
