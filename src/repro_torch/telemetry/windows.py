"""Windowed, exponentially-decayed SHARDS — the online MRC estimator.

Port of `repro.telemetry.windows`. Every window multiplies each node's
reuse-distance histogram, cold-miss count and reference total by
``decay`` before folding in the window's references, so the counts hold
an exponentially-weighted view of the trace and the estimated MRC tracks
phase changes. State carries leading node axes ([..., K]); one window is
ONE launch of `kernels.ops.shards_window` for every node, through
`core.shards_mrc.update` (the plain version for CPU tensors), where the reference vmaps its scalar scan.

Padded references use the ``EMPTY_REF`` sentinel (0xFFFFFFFF): masked
references neither sample nor advance the SHARDS clock.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import shards_mrc

EMPTY_REF = shards_mrc.EMPTY


class TelemetryConfig(NamedTuple):
    """Static estimator knobs (Python scalars, hashable).

    ``k``/``buckets``: SHARDS table entries and MRC buckets per node.
    ``sample_mod``/``sample_thresh``: spatial-hash sample rate R = t/m.
    ``bucket_width``: full-trace distinct addresses per MRC bucket.
    ``decay``: per-window histogram decay (1.0 = classic SHARDS).
    ``min_total``: decayed-reference floor under which a node reads idle.
    """

    k: int = 128
    buckets: int = 64
    sample_mod: int = 4
    sample_thresh: int = 1
    bucket_width: int = 8
    decay: float = 0.85
    min_total: float = 4.0


def init_batch(n_nodes: int, cfg: TelemetryConfig, *,
               device=None) -> shards_mrc.ShardsState:
    """Batched SHARDS state: every leaf gains a leading [n_nodes] axis."""
    return shards_mrc.init(cfg.k, cfg.buckets, lead=(n_nodes,), device=device)


def decay(state: shards_mrc.ShardsState, factor: float) -> shards_mrc.ShardsState:
    """Age the histogram mass; the address table keeps its own recency."""
    return state._replace(hist=state.hist * factor, cold=state.cold * factor,
                          total=state.total * factor)


def update_window(state: shards_mrc.ShardsState, addrs: torch.Tensor,
                  cfg: TelemetryConfig,
                  mask: torch.Tensor | None = None) -> shards_mrc.ShardsState:
    """Fold one window of references ([..., A], taken mod 2^32) into every
    node's estimator: decay, then one SHARDS window scan for all nodes.
    ``mask`` defaults to ``addrs != EMPTY_REF``."""
    # the reference's cast to uint32: an int32 -1 becomes 0xFFFFFFFF
    refs = addrs.to(torch.int64) & 0xFFFFFFFF
    if mask is None:
        mask = refs != EMPTY_REF
    return shards_mrc.update(decay(state, cfg.decay), refs, cfg.sample_mod,
                             cfg.sample_thresh, cfg.bucket_width, mask=mask)


def mrc_batch(state: shards_mrc.ShardsState, cfg: TelemetryConfig) -> torch.Tensor:
    """float32 [..., B] — each node's estimated miss-ratio curve."""
    return shards_mrc.mrc(state, cfg.bucket_width)


def miss_at_batch(state: shards_mrc.ShardsState, cache_entries,
                  cfg: TelemetryConfig) -> torch.Tensor:
    """float32 [...] — estimated miss ratio at each node's cache size (in
    entries, integer)."""
    return shards_mrc.miss_ratio_at(state, cache_entries, cfg.bucket_width)
