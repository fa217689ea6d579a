"""Want-size derivation from an *online* MRC (§4.5, trace-driven).

Port of `repro.telemetry.want`: the smallest cache size (in entries)
whose estimated miss ratio is under target,

    want = smallest (b+1)*bucket_width with curve[b] * weight <= target

capped by the footprint the estimator has seen (resident sampled
addresses scaled by 1/R), and zero for a node whose decayed reference
total is under ``cfg.min_total``.
"""
from __future__ import annotations

import torch

from repro_torch.core import harvest as hv
from repro_torch.core import manager as mgr
from repro_torch.core import shards_mrc
from . import windows as tw


def want_entries(state: shards_mrc.ShardsState, cfg: tw.TelemetryConfig,
                 weight: torch.Tensor | None = None,
                 target_miss: float = hv.TARGET_MISS) -> torch.Tensor:
    """float32 [...] — per-node cache size (entries) wanted under the online
    MRC. ``weight`` (float32 [...], optional) scales the per-lookup curve
    into per-command impact; ``None`` means per-lookup target. When no
    size reaches the target the want saturates at ``buckets *
    bucket_width`` before the footprint cap."""
    curve = tw.mrc_batch(state, cfg)                          # [..., B]
    if weight is not None:
        curve = curve * weight.to(torch.float32)[..., None]
    ok = curve <= target_miss
    b = torch.arange(cfg.buckets, device=curve.device)
    first = torch.where(ok, b, cfg.buckets - 1).amin(dim=-1)
    # sizes are small whole numbers: exact in float32
    want = ((first + 1) * cfg.bucket_width).to(torch.float32)
    # resident sampled addresses scaled by 1/R: the reference divides by
    # the rate, which its compiled code multiplies by as a reciprocal
    rate = cfg.sample_thresh / cfg.sample_mod
    resident = (state.addrs != shards_mrc.EMPTY).sum(dim=-1).to(torch.float32)
    want = torch.minimum(want, resident * mgr.recip32(rate))
    return torch.where(state.total >= cfg.min_total, want, 0.0)
