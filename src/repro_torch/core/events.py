"""Shared failure/reclaim event schedules for both substrates.

Port of `repro.core.events`. XBOF's §4.3 descriptor invalidation covers
the happy path: a lender going busy withdraws its descriptors at the next
management round. This module gives the unhappy paths as *data* — a typed,
declarative schedule of lender preemptions, SSD failures and hot-removals,
and enclosure fabric drops — rendered once on the host into dense boolean
streams that a loop slices window by window. One schedule drives the JBOF
simulator (`jbof.sim.SimConfig.events`) and the serving engine's scenario
driver (`serving.scenarios.drive_events`) identically.

Event semantics:

  LENDER_RECLAIM   the lender's own load returns for `duration` windows:
                   its utilization is forced above every lend watermark,
                   so the ordinary §4.3 machinery withdraws its
                   descriptors and drains its grants. The reclaim
                   predictor's job is to see this coming.
  SSD_FAIL         the node dies at `t` with no warning. Its standing
                   descriptors invalidate and every claim it holds
                   releases at once (`manager.revoke_nodes`).
  SSD_HOT_REMOVE   a *planned* removal: SSD_FAIL at `t`, with the reclaim
                   stream raised for `reclaim_lead` windows beforehand —
                   the drain window an operator (or the predictor) gets.
  ENCLOSURE_DROP   the enclosure at `target` drops off the fabric at `t`:
                   exactly its block's standing cross-level grants
                   invalidate (`topology.invalidate_block_grants`).

The streams are cumulative where the event is terminal (`dead`, `drop`)
and windowed where it is transient (`reclaim`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device

# Event kind codes (small exact integers, the reference's)
LENDER_RECLAIM, SSD_FAIL, SSD_HOT_REMOVE, ENCLOSURE_DROP = range(4)
KIND_NAMES = ("lender_reclaim", "ssd_fail", "ssd_hot_remove", "enclosure_drop")


class Event(NamedTuple):
    """One scheduled incident. ``target`` is a node id for the SSD-level
    kinds and an enclosure id for ENCLOSURE_DROP. ``duration`` (windows)
    only matters for LENDER_RECLAIM; 0 means one window."""

    kind: int
    t: int
    target: int
    duration: int = 0


class EventSchedule(NamedTuple):
    """Hashable, frozen schedule: a tuple of `Event`s plus the warning
    lead (windows) a planned SSD_HOT_REMOVE grants before the pull."""

    events: tuple = ()
    reclaim_lead: int = 8

    def __bool__(self) -> bool:
        return bool(self.events)


def lender_reclaim(t: int, node: int, duration: int = 1) -> Event:
    return Event(LENDER_RECLAIM, t, node, duration)


def ssd_fail(t: int, node: int) -> Event:
    return Event(SSD_FAIL, t, node)


def ssd_hot_remove(t: int, node: int) -> Event:
    return Event(SSD_HOT_REMOVE, t, node)


def enclosure_drop(t: int, enclosure: int) -> Event:
    return Event(ENCLOSURE_DROP, t, enclosure)


def schedule(*events: Event, reclaim_lead: int = 8) -> EventSchedule:
    """Build a validated schedule from events in any order."""
    for e in events:
        if e.kind not in range(len(KIND_NAMES)):
            raise ValueError(f"unknown event kind {e.kind}")
        if e.t < 0 or e.target < 0 or e.duration < 0:
            raise ValueError(f"negative field in {e}")
    evs = tuple(sorted(events, key=lambda e: e.t))
    return EventSchedule(events=evs, reclaim_lead=int(reclaim_lead))


class EventArrays(NamedTuple):
    """Dense per-window streams a loop slices on its leading axis.

    reclaim  bool[T, n]  lender is reclaiming (forced busy) this window
    dead     bool[T, n]  node has failed / been removed (cumulative)
    drop     bool[T, E]  enclosure is off the fabric (cumulative)
    """

    reclaim: torch.Tensor
    dead: torch.Tensor
    drop: torch.Tensor


class NodeEvents(NamedTuple):
    """One window's node-level view (`drop` is consumed a level up)."""

    reclaim: torch.Tensor  # bool[..., n]
    dead: torch.Tensor     # bool[..., n]


def render(sched: EventSchedule, steps: int, n_nodes: int,
           n_enclosures: int = 1) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The streams of `compile` as NumPy arrays (reclaim, dead, drop), for
    host-side drivers. Targets are validated against the run's shape here,
    so one schedule can drive differently sized runs."""
    reclaim = np.zeros((steps, n_nodes), bool)
    dead = np.zeros((steps, n_nodes), bool)
    drop = np.zeros((steps, n_enclosures), bool)
    for e in sched.events:
        t, tgt = e.t, e.target
        if e.kind == ENCLOSURE_DROP:
            if tgt >= n_enclosures:
                raise ValueError(
                    f"{e} targets enclosure {tgt} but the run has "
                    f"{n_enclosures}")
            drop[min(t, steps):, tgt] = True
            continue
        if tgt >= n_nodes:
            raise ValueError(f"{e} targets node {tgt} but the run has {n_nodes}")
        if e.kind == LENDER_RECLAIM:
            reclaim[t:t + max(e.duration, 1), tgt] = True
        elif e.kind == SSD_FAIL:
            dead[t:, tgt] = True
        elif e.kind == SSD_HOT_REMOVE:
            reclaim[max(t - sched.reclaim_lead, 0):t, tgt] = True
            dead[t:, tgt] = True
    return reclaim, dead, drop


def compile(sched: EventSchedule, steps: int, n_nodes: int,
            n_enclosures: int = 1, *, device=None) -> EventArrays:
    """Render a schedule into dense bool streams for a ``steps``-window run,
    on ``device`` (CUDA when None). Rendered in NumPy on the host, once,
    and copied up in one go: consumers slice the tensors window by window
    on the device, with no host copy inside their loop."""
    dev = resolve_device(device)
    return EventArrays(*(torch.from_numpy(a).to(dev)
                         for a in render(sched, steps, n_nodes, n_enclosures)))


def node_view(ev: EventArrays) -> NodeEvents:
    """The node-level streams (what a window step consumes)."""
    return NodeEvents(reclaim=ev.reclaim, dead=ev.dead)


def step_view(ev: EventArrays, i) -> EventArrays:
    """Window ``i``'s slice of every stream (for eager drivers)."""
    return EventArrays(*(a[i] for a in ev))
