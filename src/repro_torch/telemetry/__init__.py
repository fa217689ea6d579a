"""Telemetry plane: trace-driven online MRC estimation (paper §4.5).

Port of `repro.telemetry`:

  windows   windowed / exponentially-decayed SHARDS, one estimator per
            node, every node updated by one kernel launch a window
  want      want-size derivation from the online curve
  traces    seeded synthetic mapping-page reference streams (zipf sets,
            sequential streams, scan bursts, phase-change schedules)
  reclaim   the reclaim predictor: an EWMA level and slope per lender
            flagging those about to withdraw, so migration drains first

The serving engine consumes it (`trace_driven`: the kv_pool page-access
stream drives the DRAM descriptor's lendable-page reserve;
``migrate_pages_per_step``: the predictor picks the lenders to drain).
"""
from . import reclaim, traces, want, windows

__all__ = ["reclaim", "traces", "want", "windows"]
