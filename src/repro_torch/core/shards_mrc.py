"""SHARDS online miss-ratio-curve estimation (paper §4.5; Waldspurger FAST'15).

Port of `repro.core.shards_mrc`. Spatially-hashed sampling: a reference to
address ``a`` is sampled iff ``hash(a) % P < T`` on the unsigned 32-bit
hash; the sampling rate is R = T/P. Reuse distances of sampled
references, scaled by 1/R, estimate the full-trace stack-distance
histogram, from which the MRC follows.

Fixed-size SHARDS (SHARDS_adj): a bounded table of the K most recent
sampled addresses with last-access times. The stack distance of a sampled
hit is the count of table entries with a newer time, scaled by 1/R.

Addresses are uint32 in the reference; torch's uint32 takes too few ops,
so the port holds them as int64 in [0, 2^32) (``EMPTY`` = 0xFFFFFFFF).
``last_seen`` and ``clock`` are int32, ``hist``, ``cold`` and ``total``
float32. State leaves may carry leading node axes ([..., K]).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops, ref

EMPTY = ref.EMPTY_ADDR


# h = addr * 2654435761 (mod 2^32); h ^ (h >> 16), on int64 addresses
_hash = ref.shards_hash


class ShardsState(NamedTuple):
    addrs: torch.Tensor       # int64[..., K] sampled addresses (EMPTY = empty)
    last_seen: torch.Tensor   # int32[..., K] logical time of last access
    clock: torch.Tensor       # int32[...] logical time
    hist: torch.Tensor        # float32[..., B] scaled reuse-distance histogram
    cold: torch.Tensor        # float32[...] scaled cold (first-touch) misses
    total: torch.Tensor       # float32[...] scaled total sampled references


def init(k: int = 256, buckets: int = 64, *, lead: tuple = (),
         device=None) -> ShardsState:
    """Empty state; ``lead`` prepends node axes to every leaf."""
    dev = resolve_device(device)
    lead = tuple(lead)
    return ShardsState(
        addrs=torch.full(lead + (k,), EMPTY, dtype=torch.int64, device=dev),
        last_seen=torch.full(lead + (k,), -1, dtype=torch.int32, device=dev),
        clock=torch.zeros(lead, dtype=torch.int32, device=dev),
        hist=torch.zeros(lead + (buckets,), dtype=torch.float32, device=dev),
        cold=torch.zeros(lead, dtype=torch.float32, device=dev),
        total=torch.zeros(lead, dtype=torch.float32, device=dev),
    )


def _flat(state: ShardsState) -> tuple[tuple, ShardsState]:
    """(leading shape, the state with its leading axes flattened to one)."""
    lead = tuple(state.clock.shape)
    k, b = state.addrs.shape[-1], state.hist.shape[-1]
    return lead, ShardsState(state.addrs.reshape(-1, k),
                             state.last_seen.reshape(-1, k),
                             state.clock.reshape(-1), state.hist.reshape(-1, b),
                             state.cold.reshape(-1), state.total.reshape(-1))


def _unflat(lead: tuple, flat) -> ShardsState:
    addrs, last_seen, clock, hist, cold, total = flat
    return ShardsState(addrs.reshape(lead + addrs.shape[-1:]),
                       last_seen.reshape(lead + last_seen.shape[-1:]),
                       clock.reshape(lead), hist.reshape(lead + hist.shape[-1:]),
                       cold.reshape(lead), total.reshape(lead))


def update(state: ShardsState, addrs: torch.Tensor, sample_mod: int = 64,
           sample_thresh: int = 4, bucket_width: int = 4,
           mask: torch.Tensor | None = None) -> ShardsState:
    """Feed a batch of address references (int64 [..., n], taken mod 2^32)
    through every node's SHARDS state [..., K]: the rate R = sample_thresh
    / sample_mod; ``bucket_width`` is each MRC bucket's width in scaled
    distinct addresses; ``mask`` (bool [..., n], all valid when None)
    skips padded references entirely — they neither sample nor advance
    the clock. One `kernels.ops.shards_window` call takes every node: a
    kernel launch for CUDA tensors, the plain version for CPU ones."""
    if mask is None:
        mask = torch.ones(addrs.shape, dtype=torch.bool, device=addrs.device)
    lead, flat = _flat(state)
    a = addrs.shape[-1]
    out = ops.shards_window(*flat, addrs.reshape(-1, a).to(torch.int64).contiguous(),
                            mask.reshape(-1, a).to(torch.bool).contiguous(),
                            sample_mod, sample_thresh, bucket_width)
    return _unflat(lead, out)


# the block length of XLA's rewrite of a long prefix sum (read off the
# compiled reference: a 64-bucket curve sums in 4 blocks of 16)
_SCAN_BLOCK = 16


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis in the reference's float32
    order: ``jnp.cumsum`` compiles to a reduce window that sums each prefix
    left to right, one add at a time, up to 16 terms; past that XLA splits
    the axis into blocks of 16 (the last padded with zeros), sums within
    each block left to right and adds each block's exclusive prefix of the
    block totals, summed by the same rule. (Torch's cumsum sums in float64
    on the CPU and in a tree on the GPU.)"""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        parts = x.unbind(-1)
        run = [parts[0]]
        for p in parts[1:]:
            run.append(run[-1] + p)
        return torch.stack(run, dim=-1)
    nb = -(-n // _SCAN_BLOCK)
    pad = x.new_zeros(x.shape[:-1] + (nb * _SCAN_BLOCK - n,))
    within = prefix_sum(torch.cat([x, pad], dim=-1).reshape(
        x.shape[:-1] + (nb, _SCAN_BLOCK)))
    totals = prefix_sum(within[..., -1])
    excl = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]], dim=-1)
    out = (within + excl[..., None]).reshape(x.shape[:-1] + (nb * _SCAN_BLOCK,))
    return out[..., :n]


def mrc(state: ShardsState, bucket_width: int = 4) -> torch.Tensor:
    """Miss-ratio curve: float32 [..., B]; entry b = predicted miss ratio
    with an LRU cache of (b+1)*bucket_width (scaled) entries."""
    total = torch.clamp(state.total, min=1.0)[..., None]
    misses = total - prefix_sum(state.hist)  # cold misses + reuses beyond size
    return torch.clamp(misses / total, 0.0, 1.0)


def miss_ratio_at(state: ShardsState, cache_entries,
                  bucket_width: int = 4) -> torch.Tensor:
    """The curve at ``cache_entries`` (integer, [...]) entries."""
    curve = mrc(state, bucket_width)
    c = torch.as_tensor(cache_entries, device=curve.device)
    b = torch.div(c, bucket_width, rounding_mode="floor") - 1
    b = b.clamp(0, curve.shape[-1] - 1).long()
    return torch.gather(curve, -1, b.expand(curve.shape[:-1])[..., None])[..., 0]
