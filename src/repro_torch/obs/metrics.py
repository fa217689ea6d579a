"""In-step metric rings: typed counter/gauge/histogram primitives.

Port of `repro.obs.metrics`. The metric store is a NamedTuple of
fixed-shape tensors in the engine state: recording a window is a handful
of masked writes inside the step, and nothing reads back to the host
until `MetricSet.history()` decodes the rings after the run.

Metric kinds: a **gauge** ring slot stores the value as recorded; a
**counter** stores the per-window delta and keeps a running total; a
**histogram** stores the ``bins`` counts of the recorded values over
``[lo, hi)`` (clamped). Every metric is ``per="node"`` (ring ``[n,
depth]``) or ``per="scalar"`` (one lane per shard: ``[lead, depth]``,
histograms ``[lead, depth, bins]``). The engine's `_finish_stats` reads
the registry's reductions, so a stat nobody declared raises.

Rings wrap: slot ``cursor % depth`` is written each window and the cursor
counts windows, so `history()` returns the last ``min(cursor, depth)``
windows oldest-first. `record` runs on a local view whose leaves may
carry leading batch axes (the engine's [S, ...] shard axis): cursor
``[..., lead]``, rings ``[..., lanes, depth(, bins)]``, values ``[...,
n]`` (node) or ``[...]`` (scalar).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device


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


class MetricsState(NamedTuple):
    """Device-side metric store (lives in the engine state)."""

    cursor: torch.Tensor  # [lead] int32 — windows recorded so far
    rings: dict  # name -> [n|lead, depth] f32 (histogram: [lead, depth, bins])
    totals: dict  # counters only: name -> [n|lead] f32 running total


_KINDS = ("counter", "gauge", "histogram")
_REDUCES = ("concat", "sum", "first", "none")


class MetricSet:
    """Registry of metric specs with one record/decode API: registration
    once at module import, `init` sizes the tensors, `record` runs inside
    the step, `history`/`totals` decode on the host after the run."""

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

    def names(self) -> tuple[str, ...]:
        return tuple(self._specs)

    def init(self, n: int, cfg: ObsConfig, lead: int = 1, *,
             device=None) -> MetricsState | None:
        """Canonical (unsharded) state: node rings ``[n, depth]``, scalar
        rings ``[lead, depth]`` — ``lead`` is the shard count, so a
        leading-axis split gives each shard its local view."""
        if not cfg.enabled:
            return None
        dev = resolve_device(device)
        d = cfg.ring_depth
        rings, totals = {}, {}
        for s in self._specs.values():
            if s.kind == "histogram":
                shape = (lead, d, s.bins)
            else:
                shape = (n if s.per == "node" else lead, d)
            rings[s.name] = torch.zeros(shape, dtype=torch.float32, device=dev)
            if s.kind == "counter":
                lanes = n if s.per == "node" else lead
                totals[s.name] = torch.zeros(lanes, dtype=torch.float32, device=dev)
        return MetricsState(
            cursor=torch.zeros(lead, dtype=torch.int32, device=dev),
            rings=rings, totals=totals)

    def record(self, ms: MetricsState, values: dict) -> MetricsState:
        """Record one window (no host sync). Strict on both sides: every
        registered metric must be supplied and every supplied name must be
        registered."""
        unknown = sorted(set(values) - set(self._specs))
        if unknown:
            raise KeyError(f"{self.name}: unregistered metric(s) {unknown}")
        missing = sorted(set(self._specs) - set(values))
        if missing:
            raise KeyError(f"{self.name}: record() missing metric(s) {missing}")
        cur = ms.cursor[..., 0]                       # [...] per batch entry
        batch = tuple(cur.shape)
        dev = ms.cursor.device
        rings, totals = dict(ms.rings), dict(ms.totals)
        for s in self._specs.values():
            ring = rings[s.name]
            hist = s.kind == "histogram"
            depth = ring.shape[-2] if hist else ring.shape[-1]
            slot = torch.remainder(cur, depth)
            at = torch.arange(depth, device=dev) == slot[..., None]  # [..., depth]
            v = torch.as_tensor(values[s.name], dtype=torch.float32, device=dev)
            v = v.expand(batch + v.shape[len(batch):]).reshape(batch + (-1,))
            if hist:
                # the reference divides by the bin width, which its
                # compiled code multiplies by as a float32 reciprocal
                inv_w = float(np.float32(1.0) / np.float32((s.hi - s.lo) / s.bins))
                idx = torch.floor((v - s.lo) * inv_w).to(torch.int32)
                idx = idx.clamp(0, s.bins - 1)
                counts = (idx[..., None] == torch.arange(s.bins, device=dev)
                          ).sum(dim=-2).to(torch.float32)        # [..., bins]
                rings[s.name] = torch.where(at[..., None, :, None],
                                            counts[..., None, None, :], ring)
                continue
            # node values arrive [..., n]; scalar values [...] fill the
            # local lead lanes
            v = v[..., : ring.shape[-2]]
            rings[s.name] = torch.where(at[..., None, :], v[..., None], ring)
            if s.kind == "counter":
                totals[s.name] = totals[s.name] + v
        return MetricsState(cursor=ms.cursor + 1, rings=rings, totals=totals)

    def history(self, ms: MetricsState) -> dict:
        """Host-side decode: {name: [t, lanes(, bins)]} oldest-first, t =
        min(windows recorded, ring depth). Call on the canonical (merged)
        state."""
        cur = int(np.asarray(ms.cursor.cpu()).reshape(-1)[0])
        out = {}
        for name, ring in ms.rings.items():
            r = ring.cpu().numpy()
            depth = r.shape[1]
            t = min(cur, depth)
            idx = np.arange(cur - t, cur) % depth if t else np.zeros(0, np.int64)
            out[name] = np.moveaxis(r[:, idx, ...], 1, 0)
        return out

    def totals(self, ms: MetricsState) -> dict:
        return {k: v.cpu().numpy() for k, v in ms.totals.items()}


def merge_lead(ms):
    """Collapse a stacked leading axis (one entry per enclosure or shard)
    into the canonical layout: ``[E, lanes, ...] -> [E * lanes, ...]``."""
    def merge(a):
        return a.reshape(a.shape[0] * a.shape[1], *a.shape[2:])

    return MetricsState(cursor=merge(ms.cursor),
                        rings={k: merge(v) for k, v in ms.rings.items()},
                        totals={k: merge(v) for k, v in ms.totals.items()})
