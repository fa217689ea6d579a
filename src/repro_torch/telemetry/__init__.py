"""Telemetry plane: trace-driven online MRC estimation (paper §4.5).

Port of `repro.telemetry`:

  windows   windowed / exponentially-decayed SHARDS, one estimator per
            node, every node updated by one kernel launch a window
  want      want-size derivation from the online curve
  traces    seeded synthetic mapping-page reference streams (zipf sets,
            sequential streams, scan bursts, phase-change schedules)

The serving engine consumes it (`trace_driven`: the kv_pool page-access
stream drives the DRAM descriptor's lendable-page reserve). The reclaim
predictor (`telemetry/reclaim.py`) moves with the failure plane.
"""
from . import traces, want, windows

__all__ = ["traces", "want", "windows"]
