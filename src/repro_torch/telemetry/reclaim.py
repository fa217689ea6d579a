"""Reclaim predictor: anticipate lender preemption from utilization series.

Port of `repro.telemetry.reclaim`. A lender revokes its published DRAM
when its own load rises (paper §4.3 withdraw-on-trigger); a borrower that
waits for the revoke eats the whole migration burst at the worst moment.
The predictor watches each lender's utilization and raises a risk flag
while it is still *rising* toward the withdraw watermark, so the engine
drains offsite pages (`kv_pool.drain_offsite`) before the revoke or the
crash lands.

It is an EWMA level plus an EWMA slope per lender with a projected-crossing
test: `update` is shape-stable tensor code on [..., n], run inside the
engine step every iteration with no host sync. Offline, `evaluate` replays
a recorded utilization history against the true reclaims (the obs plane's
WITHDRAW events) and scores precision, recall and lead time.

The reference's compiled step contracts each update — ``ewma + decay *
(util - ewma)``, the slope's and the projection's — into one fused
multiply-add on the CPU (its HLO's `multiply_add_fusion`s); the port takes
them the same way (`manager._fma32`), so the risk flags — which decide
what drains, and so the integer state — land identically.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import manager as mgr


class ReclaimConfig(NamedTuple):
    """Knobs for the rising-utilization reclaim predictor.

    ``decay``:      EWMA decay for the level estimate (per step).
    ``slope_gain``: EWMA decay for the slope (utilization delta) estimate.
    ``threshold``:  utilization the lender is projected to cross within
                    ``horizon`` steps for the risk flag to raise.
    ``horizon``:    look-ahead steps for the projected crossing.
    """

    decay: float = 0.3
    slope_gain: float = 0.5
    threshold: float = 0.85
    horizon: int = 8


class ReclaimState(NamedTuple):
    """Per-lender EWMA carry: two float32[..., n] tensors."""

    ewma: torch.Tensor   # utilization level estimate
    slope: torch.Tensor  # utilization delta-per-step estimate


def init(n: int, *, device=None) -> ReclaimState:
    dev = resolve_device(device)
    return ReclaimState(ewma=torch.zeros(n, dtype=torch.float32, device=dev),
                        slope=torch.zeros(n, dtype=torch.float32, device=dev))


def update(state: ReclaimState, util: torch.Tensor,
           cfg: ReclaimConfig = ReclaimConfig()):
    """One predictor step: fold this step's per-lender utilization into
    the EWMA level and slope and flag the lenders projected to cross the
    threshold within the horizon. Returns (state', risk bool[..., n])."""
    util = util.to(torch.float32)
    ewma = mgr._fma32(util - state.ewma, cfg.decay, state.ewma)
    slope = mgr._fma32((ewma - state.ewma) - state.slope, cfg.slope_gain,
                       state.slope)
    projected = mgr._fma32(torch.clamp(slope, min=0.0), float(cfg.horizon), ewma)
    risk = projected >= float(np.float32(cfg.threshold))
    return ReclaimState(ewma=ewma, slope=slope), risk


def run(history, cfg: ReclaimConfig = ReclaimConfig()) -> np.ndarray:
    """Replay the predictor over a recorded utilization history
    (float[T, n], e.g. an obs-plane ring; NumPy or a tensor) and return
    the risk flags bool[T, n] — the offline twin of `update`, a loop over
    T on the history's device (the CPU for an array)."""
    hist = (history.to(torch.float32) if isinstance(history, torch.Tensor)
            else torch.from_numpy(np.asarray(history, np.float32)))
    st = ReclaimState(ewma=hist.new_zeros(hist.shape[1:]),
                      slope=hist.new_zeros(hist.shape[1:]))
    risks = []
    for u in hist:
        st, risk = update(st, u, cfg)
        risks.append(risk)
    if not risks:
        return np.zeros(tuple(hist.shape), bool)
    return torch.stack(risks).cpu().numpy()


class ReclaimScore(NamedTuple):
    precision: float   # flagged windows that a reclaim actually followed
    recall: float      # reclaims the predictor flagged ahead of time
    mean_lead: float   # average steps of warning on the recalled reclaims


def evaluate(history, reclaim_steps, cfg: ReclaimConfig = ReclaimConfig(),
             horizon: int | None = None) -> ReclaimScore:
    """Score the predictor against ground-truth reclaim events.

    ``history``: float[T, n] per-lender utilization; ``reclaim_steps``:
    iterable of (t, lender) true reclaims — in practice the obs plane's
    decoded WITHDRAW events. A reclaim counts as *recalled* when the risk
    flag was up at any step in the ``horizon`` windows before it; a
    flagged step counts as *precise* when a reclaim lands on that lender
    within the horizon after it. Lead time runs from the first flagged
    step of the warning run."""
    hz = cfg.horizon if horizon is None else horizon
    hist = np.asarray(history, np.float64)
    n = hist.shape[1]
    risks = run(hist, cfg)
    events = [(int(t), int(l)) for t, l in reclaim_steps if 0 <= int(l) < n]

    hits, leads = 0, []
    for t, lender in events:
        lo = max(t - hz, 0)
        window = risks[lo:t, lender]
        if window.any():
            hits += 1
            leads.append(t - (lo + int(np.argmax(window))))
    recall = hits / len(events) if events else 1.0

    flagged = np.argwhere(risks)
    if len(flagged):
        precise = sum(
            1 for t, lender in flagged
            if any(le == lender and t < te <= t + hz for te, le in events))
        precision = precise / len(flagged)
    else:
        precision = 1.0
    return ReclaimScore(precision=float(precision), recall=float(recall),
                        mean_lead=float(np.mean(leads)) if leads else 0.0)
