"""Seeded synthetic mapping-page reference traces (telemetry input).

The port's own copy of `repro.telemetry.traces` (NumPy only, the same
seeded `np.random` calls, so the arrays are the reference's); it returns
NumPy arrays, and the caller moves them to a device.

`jbof.workloads.arrivals` synthesizes *byte demand* per window; this module
synthesizes the matching *address stream* — which 16 KB mapping pages those
commands touch — as ``uint32[T, n, A]`` per-window reference blocks, padded
with `windows.EMPTY_REF`. The stream is what the online SHARDS estimator
consumes, so phase structure here (working sets growing for a burst and
shrinking after it) is exactly the non-stationarity the static per-run MRC
grid cannot express.

Four reference shapes compose per phase:

* **zipf working sets** — rank-probability ``(i+1)^-a`` over ``ws_pages``
  pages, through a per-(node, phase) permutation so hot ranks land on
  scattered page ids;
* **sequential streams** — a cursor walking the working set in order
  (mapping-page locality folds a 16 MB logical span onto one page, which
  is why sequential tenants barely want cache);
* **scan bursts** — sequential with ``ws_pages`` much larger than the
  phase touches: every page is seen once, reuse only at segment grain;
* **phase-change schedules** — a list of `TracePhase` per node, switched
  on window index (`table2_phases` derives burst/idle alternation from a
  Table-2 workload's duty cycle, mirroring `arrivals`).

Everything is generated outside the scanned simulator step with NumPy from
an explicit seed, like the arrival matrices.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

EMPTY_REF = np.uint32(0xFFFFFFFF)
# 2 MB DRAM segment / 16 KB mapping page (ssd.SEGMENT_BYTES / PAGE_BYTES,
# restated here so telemetry does not import the jbof package).
PAGES_PER_SEGMENT = 128


class TracePhase(NamedTuple):
    """One reference regime, active from window ``start`` until the next
    phase (phases sorted by start; the first should start at 0)."""

    start: int
    ws_pages: int              # working-set size in mapping pages
    refs_per_window: int       # live references per window (<= trace width)
    zipf_a: float = 1.1        # rank exponent; 0.0 = uniform over the set
    sequential: bool = False   # cursor walk instead of random ranks
    offset: int = 0            # base page id — disjoint sets get offsets


def segments(n: float) -> int:
    """Convenience: working-set size of ``n`` DRAM segments, in pages."""
    return int(n * PAGES_PER_SEGMENT)


def _zipf_probs(ws: int, a: float) -> np.ndarray:
    p = (np.arange(1, ws + 1, dtype=np.float64)) ** (-a)
    return p / p.sum()


def synth_trace(
    n_windows: int,
    schedules: Sequence[Sequence[TracePhase]],
    refs_max: int,
    seed: int = 0,
) -> np.ndarray:
    """uint32[T, n, refs_max] — one phase schedule per node. An empty
    schedule means an idle node (every slot padded)."""
    n = len(schedules)
    out = np.full((n_windows, n, refs_max), EMPTY_REF, np.uint32)
    for i, phases in enumerate(schedules):
        if not phases:
            continue
        rng = np.random.default_rng((seed, i))
        phases = sorted(phases, key=lambda p: p.start)
        perms = [rng.permutation(p.ws_pages).astype(np.uint32) for p in phases]
        probs = [None if p.sequential or p.zipf_a <= 0
                 else _zipf_probs(p.ws_pages, p.zipf_a) for p in phases]
        starts = [p.start for p in phases]
        cursor = 0
        for t in range(n_windows):
            pi = int(np.searchsorted(starts, t, side="right")) - 1
            if pi < 0:
                continue
            ph = phases[pi]
            a = min(ph.refs_per_window, refs_max)
            if a <= 0:
                continue
            if ph.sequential:
                pages = (cursor + np.arange(a)) % ph.ws_pages
                cursor = (cursor + a) % ph.ws_pages
            else:
                pages = (rng.choice(ph.ws_pages, size=a, p=probs[pi])
                         if probs[pi] is not None
                         else rng.integers(0, ph.ws_pages, a))
                pages = perms[pi][pages]
            out[t, i, :a] = ph.offset + pages.astype(np.uint32)
    return out


def table2_phases(
    duty: float,
    n_windows: int,
    ws_burst_pages: int,
    ws_base_pages: int,
    refs_per_window: int,
    node_index: int = 0,
    n_nodes: int = 1,
    zipf_a: float = 1.1,
) -> list[TracePhase]:
    """Burst/idle phase alternation matching `workloads.arrivals`' burst
    process (period = 20% of the run, staggered onset per node): burst
    windows reference a large zipf set, off-burst windows a small one —
    the Table-2 sporadic-burst premise as an address stream."""
    if duty >= 1.0 - 1e-6:
        return [TracePhase(0, ws_burst_pages, refs_per_window, zipf_a)]
    period = max(int(n_windows * 0.2), 8)
    burst_len = max(int(period * duty), 1)
    offset = (node_index * period) // max(n_nodes, 1)
    phases = []
    t = -offset % period
    if t > 0:  # leading off-burst stub
        phases.append(TracePhase(0, ws_base_pages, refs_per_window, zipf_a))
    while t < n_windows:
        phases.append(TracePhase(t, ws_burst_pages, refs_per_window, zipf_a))
        if t + burst_len < n_windows:
            phases.append(TracePhase(
                t + burst_len, ws_base_pages, refs_per_window, zipf_a))
        t += period
    return phases


def phase_change(
    n_windows: int,
    burst_start: int,
    burst_end: int,
    ws_burst_pages: int,
    ws_base_pages: int,
    refs_per_window: int,
    zipf_a: float = 1.1,
) -> list[TracePhase]:
    """The fig20 shape: one explicit burst window [start, end) over a large
    disjoint working set, small steady set before and after — traffic never
    stops, only the footprint shrinks, which is precisely what arrival-rate
    signals (the static grid's ``active`` test) cannot see."""
    return [
        TracePhase(0, ws_base_pages, refs_per_window, zipf_a),
        TracePhase(burst_start, ws_burst_pages, refs_per_window, zipf_a,
                   offset=ws_base_pages),
        TracePhase(burst_end, ws_base_pages, refs_per_window, zipf_a),
    ]
