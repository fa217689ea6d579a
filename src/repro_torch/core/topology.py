"""Topology plane: the exchange tree above the shard-local rounds.

Port of the part of `repro.core.topology` that the single-shard engine
reads: the `Topology` spec, its `flat` / `two_level` constructors and
`validate`, which `serving.engine.init` calls. The per-level
`hierarchical_exchange` moves with the hierarchical-engine slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple

# canonical level names, innermost boundary first
LEVEL_NAMES = ("node", "enclosure", "fabric")


class Topology(NamedTuple):
    """Spec of the exchange tree above the leaves.

    ``group_sizes``: members per group at each exchange level, innermost
    first; prod(group_sizes) must equal the leaf count. ``tiers``: the
    `costs.LEVEL_EXTRA_HOPS` tier each exchange level prices at (defaults
    to level + 1).
    """

    group_sizes: tuple[int, ...]
    tiers: tuple[int, ...] = ()

    @property
    def depth(self) -> int:
        """Levels including the leaf-local round."""
        return 1 + len(self.group_sizes)

    @property
    def n_leaves(self) -> int:
        return math.prod(self.group_sizes)

    def level_tier(self, level: int) -> int:
        if self.tiers:
            return self.tiers[level]
        return level + 1

    def level_name(self, level: int) -> str:
        t = self.level_tier(level)
        return (LEVEL_NAMES[t] if t < len(LEVEL_NAMES)
                else f"fabric+{t - len(LEVEL_NAMES) + 1}")

    def validate(self, n: int) -> "Topology":
        if not self.group_sizes:
            raise ValueError("Topology needs at least one exchange level")
        if any(g < 1 for g in self.group_sizes):
            raise ValueError(f"group sizes must be >= 1: {self.group_sizes}")
        if self.n_leaves != n:
            raise ValueError(
                f"topology covers {self.n_leaves} leaves "
                f"(group_sizes={self.group_sizes}) but got {n}")
        if self.tiers and len(self.tiers) != len(self.group_sizes):
            raise ValueError(
                f"tiers {self.tiers} must match group_sizes "
                f"{self.group_sizes} in length")
        return self


def flat(n: int) -> Topology:
    """One exchange level over all n leaves."""
    return Topology(group_sizes=(n,))


def two_level(inner: int, outer: int) -> Topology:
    """Settle within enclosures of ``inner`` leaves first, then across
    ``outer`` enclosures."""
    return Topology(group_sizes=(inner, outer))
