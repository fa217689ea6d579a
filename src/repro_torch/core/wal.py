"""Log-based crash consistency for offsite metadata (paper §4.5).

Port of `repro.core.wal`. Every modification to offsite metadata (a
borrower's KV page-table entry pointing into a lender's pool) first
commits a redo entry to a 4 KB log page in the borrower's local memory;
when a page fills, the segment flushes and the page is recycled. On a
lender failure the borrower replays its log over its last durable image.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import resolve_device

# 4 KB page / 8 B entry (two int32) = 512 entries, the paper's page
ENTRIES_PER_PAGE = 512
INVALID = -1


class LogPages(NamedTuple):
    """One redo-log page per harvested segment, in borrower-local memory."""

    keys: torch.Tensor     # int32[n_segments, entries_per_page]
    vals: torch.Tensor     # int32[n_segments, entries_per_page]
    count: torch.Tensor    # int32[n_segments] valid entries per page
    flushes: torch.Tensor  # int32[] segment flush-backs (cost accounting)
    commits: torch.Tensor  # int32[] total log commits (cost accounting)
    # A log may carry leading axes: keys [..., n_segments, epp] with
    # counters [...] — one log per shard of the hierarchical engine, each
    # counting its own commits and flushes.


def make_log(n_segments: int, entries_per_page: int = ENTRIES_PER_PAGE, *,
             device=None) -> LogPages:
    dev = resolve_device(device)
    shape = (n_segments, entries_per_page)
    return LogPages(
        keys=torch.full(shape, INVALID, dtype=torch.int32, device=dev),
        vals=torch.full(shape, INVALID, dtype=torch.int32, device=dev),
        count=torch.zeros(n_segments, dtype=torch.int32, device=dev),
        flushes=torch.zeros((), dtype=torch.int32, device=dev),
        commits=torch.zeros((), dtype=torch.int32, device=dev),
    )


def commit_batch(log: LogPages, segments: torch.Tensor, keys: torch.Tensor,
                 vals: torch.Tensor,
                 mask: torch.Tensor | None = None) -> LogPages:
    """Commit a batch of (segment, key, val) entries at once.

    Entries append in batch order; whenever a segment's page fills it
    flushes (page cleared, ``flushes`` incremented) and later entries
    restart the page, so the entries surviving in a flushed segment are
    the last ``(count + n) % entries_per_page`` of its stream. A stable
    sort by segment gives each entry its arrival rank within its segment.

    A log with leading axes takes entries with the same leading axes
    (segments [..., B], local to each log); each log's counters count its
    own entries. ``mask`` skips entries. Skipped and flushed-away entries
    are written to one scratch slot past the end of a temporary copy of
    the pages and dropped with it; the surviving slots are distinct by
    construction, so no two live writes meet and no value is read back to
    the host.
    """
    lead = log.count.shape[:-1]
    nseg, epp = log.keys.shape[-2:]
    nall = math.prod(lead) * nseg                    # segments of every log
    dev = log.keys.device
    m = (torch.ones(segments.shape, dtype=torch.bool, device=dev)
         if mask is None else mask.to(torch.bool))
    base = (torch.arange(math.prod(lead), device=dev) * nseg).reshape(*lead, 1)
    seg = torch.where(m, segments.long() + base, nall).reshape(-1)  # masked -> dummy
    b = seg.shape[0]

    order = torch.argsort(seg, stable=True)
    sseg = seg[order]
    rank_sorted = torch.arange(b, device=dev) - torch.searchsorted(sseg, sseg)
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)

    per_seg = torch.zeros(nall + 1, dtype=torch.long, device=dev)
    per_seg.scatter_add_(0, seg, torch.ones_like(seg))
    c0 = torch.cat([log.count.reshape(-1).long(), per_seg.new_zeros(1)])
    pos = c0[seg] + rank                             # absolute stream position
    total = c0[:-1] + per_seg[:-1]
    n_flushes = total // epp
    new_count = total % epp

    # an entry survives iff it lands in its segment's final (partial) page
    survive = (m.reshape(-1)
               & (pos // epp == torch.cat([n_flushes, n_flushes.new_zeros(1)])[seg]))
    flushed = n_flushes > 0                          # pre-batch contents cleared
    target = torch.where(survive, seg * epp + pos % epp, nall * epp)

    def write(rows, new):
        rows = rows.reshape(nall, epp)
        flat = torch.cat([torch.where(flushed[:, None], INVALID, rows).reshape(-1),
                          rows.new_full((1,), INVALID)])
        flat[target] = new.reshape(-1).to(torch.int32)
        return flat[:-1].reshape(log.keys.shape)

    return LogPages(
        keys=write(log.keys, keys),
        vals=write(log.vals, vals),
        count=new_count.reshape(log.count.shape).to(torch.int32),
        flushes=log.flushes + n_flushes.reshape(*lead, nseg).sum(-1).to(torch.int32),
        commits=log.commits + m.sum(-1).to(torch.int32),
    )


def replay(log: LogPages, base_table: torch.Tensor) -> torch.Tensor:
    """Lender-failure recovery: apply the surviving redo entries over the
    borrower's last durable image ``base_table`` int32[table_size]. Entries
    apply in (segment, position) order, so for each key the last one wins —
    found as the largest flat log position per key, which keeps the result
    deterministic where a scatter of duplicate keys would not be."""
    size = base_table.shape[0]
    ks = log.keys.reshape(-1).long()
    vs = log.vals.reshape(-1)
    valid = ks != INVALID
    safe = ks.clamp(0, size - 1)
    position = torch.arange(ks.shape[0], device=ks.device)
    last = torch.full((size,), -1, dtype=torch.long, device=ks.device)
    last.scatter_reduce_(0, safe, torch.where(valid, position, -1), "amax")
    return torch.where(last >= 0, vs[last.clamp(min=0)], base_table)
