"""Metric registry of the observability plane.

Port of the registration half of `repro.obs.metrics`: `ObsConfig` and the
`MetricSet` declarations (gauge / counter / histogram, each with the
reduction its stats-dict entry takes). The serving engine's
`_finish_stats` reads this registry, so a stat nobody declared raises
instead of drifting. The in-step metric rings (`init`/`record`/`history`)
move with the observability slice; until then `ObsConfig(enabled=True)`
is refused by the engine.
"""
from __future__ import annotations

from typing import NamedTuple


class ObsConfig(NamedTuple):
    """Static switchboard for the observability plane."""

    enabled: bool = False
    ring_depth: int = 64
    event_capacity: int = 1024


class MetricSpec(NamedTuple):
    name: str
    kind: str  # "counter" | "gauge" | "histogram"
    per: str  # "node" | "scalar"
    reduce: str  # "concat" | "sum" | "first" | "none" (ring-only)
    bins: int = 0
    lo: float = 0.0
    hi: float = 1.0


_KINDS = ("counter", "gauge", "histogram")
_REDUCES = ("concat", "sum", "first", "none")


class MetricSet:
    """Registry of metric specs, filled once at module import."""

    def __init__(self, name: str):
        self.name = name
        self._specs: dict[str, MetricSpec] = {}

    def _register(self, spec: MetricSpec) -> MetricSpec:
        if spec.name in self._specs:
            raise ValueError(f"{self.name}: duplicate metric {spec.name!r}")
        if spec.kind not in _KINDS:
            raise ValueError(f"{self.name}: bad kind {spec.kind!r}")
        if spec.reduce not in _REDUCES:
            raise ValueError(f"{self.name}: bad reduce {spec.reduce!r}")
        self._specs[spec.name] = spec
        return spec

    def counter(self, name, per="node", reduce="none"):
        return self._register(MetricSpec(name, "counter", per, reduce))

    def gauge(self, name, per="node", reduce="none"):
        return self._register(MetricSpec(name, "gauge", per, reduce))

    def histogram(self, name, bins=8, lo=0.0, hi=1.0):
        # one [bins] count row per window — ring-only, never in stats
        return self._register(
            MetricSpec(name, "histogram", "scalar", "none", bins, lo, hi))

    def spec(self, name: str) -> MetricSpec:
        try:
            return self._specs[name]
        except KeyError:
            raise KeyError(
                f"{self.name}: metric {name!r} is not registered "
                f"(known: {sorted(self._specs)})") from None

    def specs(self) -> tuple[MetricSpec, ...]:
        return tuple(self._specs.values())
