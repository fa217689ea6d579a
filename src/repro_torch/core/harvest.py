"""Trigger conditions and the harvest state machine (paper §4.4, §4.5).

Port of `repro.core.harvest`. Quadrant logic from §4.4 (watermark 75%):

  processor busy? | data-end busy? | action
  ----------------+----------------+--------------------------------------
        yes       |      yes       | nothing (no spare proc; borrowing futile)
        no        |      any       | LEND processor
        yes       |      no        | BORROW processor

DRAM decisions (§4.5) are MRC-driven: lend segments that do not lower your
own miss ratio; borrow until predicted miss ratio < ``target_miss``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import descriptors as d

WATERMARK = 0.75
TARGET_MISS = 0.10
# §4.5 lend floor: a node never lends away its last segments of mapping
# cache (resident hot set + WAL log pages)
DRAM_MIN_KEEP_SEGMENTS = 16.0


class HarvestDecision(NamedTuple):
    lend_proc: torch.Tensor    # bool[N]
    borrow_proc: torch.Tensor  # bool[N]
    lend_dram_segments: torch.Tensor    # int32[N] segments offered
    borrow_dram_segments: torch.Tensor  # int32[N] segments wanted


def harvest_triggers(own_util: torch.Tensor, gate_util: torch.Tensor,
                     watermark: float = WATERMARK,
                     gate_watermark: float | None = None):
    """(lend_mask, borrow_mask) per node: lend a resource whose own
    utilization is idle; borrow it when it is busy but the paired
    resource still has headroom. ``gate_watermark`` (default: the own
    watermark) gives the borrow trigger hysteresis. Comparisons run in
    float32, as the reference's weakly-typed scalars do."""
    if gate_watermark is None:
        gate_watermark = watermark
    own_busy = own_util > watermark
    gate_busy = gate_util > gate_watermark
    return ~own_busy, own_busy & ~gate_busy


# The historical PROCESSOR-specific name
processor_triggers = harvest_triggers


def want_fraction(mrc_grid: torch.Tensor, lookup_rate: torch.Tensor,
                  grid: torch.Tensor,
                  target_miss: float = TARGET_MISS) -> torch.Tensor:
    """float32[N] — smallest cache fraction in ``grid`` (float32[B],
    ascending) whose predicted per-lookup miss rate (``mrc_grid``
    float32[B, N] times ``lookup_rate``) is under ``target_miss``; 1.0
    when no size reaches it."""
    ok = mrc_grid * lookup_rate[None, :] <= target_miss
    first_ok = torch.argmax(ok.to(torch.uint8), dim=0)
    return torch.where(ok.any(dim=0), grid[first_ok],
                       torch.ones_like(grid[first_ok]))


def dram_triggers(miss_ratio: torch.Tensor, mrc: torch.Tensor,
                  segments_cached: torch.Tensor,
                  segments_total: torch.Tensor,
                  target_miss: float = TARGET_MISS):
    """(lend_segments, borrow_segments) int32[N] from an MRC ``mrc``
    float32[N, B]: segments beyond the knee (within 1e-3 of the full-size
    miss ratio) are spare; a node above ``target_miss`` wants the smallest
    size under target, minus what it holds."""
    n, buckets = mrc.shape
    seg_per_bucket = torch.clamp(segments_total // buckets, min=1)
    full_miss = mrc[:, -1]
    close = mrc <= (full_miss[:, None] + 1e-3)
    knee_bucket = torch.argmax(close.to(torch.uint8), dim=1)
    needed = (knee_bucket + 1) * seg_per_bucket
    spare = torch.clamp(segments_cached - needed, min=0)
    under = mrc < target_miss
    want_bucket = torch.where(under.any(dim=1),
                              torch.argmax(under.to(torch.uint8), dim=1),
                              buckets - 1)
    want = (want_bucket + 1) * seg_per_bucket
    borrow = torch.where(miss_ratio > target_miss,
                         torch.clamp(want - segments_cached, min=0), 0)
    return spare.to(torch.int32), borrow.to(torch.int32)


def decide(proc_util, dataend_util, miss_ratio, mrc, segments_cached,
           segments_total, watermark: float = WATERMARK,
           target_miss: float = TARGET_MISS) -> HarvestDecision:
    lend_p, borrow_p = harvest_triggers(proc_util, dataend_util, watermark)
    lend_s, borrow_s = dram_triggers(
        miss_ratio, mrc, segments_cached, segments_total, target_miss)
    return HarvestDecision(lend_p, borrow_p, lend_s, borrow_s)


def apply_processor_round(table: d.IdleResourceTable,
                          proc_util: torch.Tensor,
                          dataend_util: torch.Tensor,
                          watermark: float = WATERMARK,
                          slot: int = 0) -> d.IdleResourceTable:
    """One management round for processor descriptors with the historical
    harvest semantics: one proc descriptor in ``slot``, persistent claims,
    one sweep, one lender per borrower."""
    from . import manager as mgr  # local import: manager depends on harvest

    cfg = mgr.ManagerConfig(
        n_slots=table.n_slots,
        policies=(mgr.ResourcePolicy(
            rtype=d.PROCESSOR, slot0=slot, slots=1, claim_rounds=1,
            max_lenders=1, watermark=watermark, preserve_claims=True),),
    )
    inputs = {d.PROCESSOR: mgr.RoundInputs(util=proc_util,
                                           gate_util=dataend_util)}
    return mgr.ResourceManager(cfg).round(table, inputs)
