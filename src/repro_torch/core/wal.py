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


def _rows(log: LogPages, segment) -> tuple[torch.Tensor, torch.Tensor]:
    """(flat row index into keys.reshape(-1, epp), log index) of one
    segment per log: ``segment`` a number or a tensor of the log's leading
    shape."""
    lead = log.count.shape[:-1]
    nseg = log.count.shape[-1]
    dev = log.keys.device
    seg = torch.as_tensor(segment, device=dev).long().expand(lead).reshape(-1)
    which = torch.arange(seg.shape[0], device=dev)
    return which * nseg + seg, which


def commit(log: LogPages, segment, key, val, enable=True) -> LogPages:
    """Append one redo entry; if the page fills, flush the segment (page
    cleared, ``flushes`` incremented) and recycle it.

    ``enable=False`` is a no-op with the same work, so batched callers mask
    per entry. A log with leading axes takes one entry per log: each
    argument a tensor of the leading shape (or a number for every log).
    Only the target rows are touched. Returns a new log."""
    lead = log.count.shape[:-1]
    epp = log.keys.shape[-1]
    dev = log.keys.device
    flat, which = _rows(log, segment)
    e = torch.as_tensor(enable, device=dev).to(torch.bool).expand(lead).reshape(-1)
    key = torch.as_tensor(key, device=dev).to(torch.int32).expand(lead).reshape(-1)
    val = torch.as_tensor(val, device=dev).to(torch.int32).expand(lead).reshape(-1)
    keys = log.keys.reshape(-1, epp).clone()
    vals = log.vals.reshape(-1, epp).clone()
    count = log.count.reshape(-1).clone()
    c = count[flat].long()
    row_k, row_v = keys[flat], vals[flat]
    row_k[which, c] = torch.where(e, key, row_k[which, c])
    row_v[which, c] = torch.where(e, val, row_v[which, c])
    new_c = c + e.long()
    full = new_c >= epp
    keys[flat] = torch.where(full[:, None], INVALID, row_k)
    vals[flat] = torch.where(full[:, None], INVALID, row_v)
    count[flat] = torch.where(full, 0, new_c).to(torch.int32)
    return LogPages(
        keys=keys.reshape(log.keys.shape), vals=vals.reshape(log.vals.shape),
        count=count.reshape(log.count.shape),
        flushes=log.flushes + full.reshape(lead).to(torch.int32),
        commits=log.commits + e.reshape(lead).to(torch.int32))


def clear_segment(log: LogPages, segment) -> LogPages:
    """Borrower-failure path on the lender side: drop the segment's page
    (one segment per log, as `commit` takes it). Returns a new log."""
    epp = log.keys.shape[-1]
    flat, _ = _rows(log, segment)
    keys = log.keys.reshape(-1, epp).clone()
    vals = log.vals.reshape(-1, epp).clone()
    count = log.count.reshape(-1).clone()
    keys.index_fill_(0, flat, INVALID)
    vals.index_fill_(0, flat, INVALID)
    count.index_fill_(0, flat, 0)
    return log._replace(keys=keys.reshape(log.keys.shape),
                        vals=vals.reshape(log.vals.shape),
                        count=count.reshape(log.count.shape))


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


def commit_batch_scan(log: LogPages, segments: torch.Tensor, keys: torch.Tensor,
                      vals: torch.Tensor,
                      mask: torch.Tensor | None = None) -> LogPages:
    """The per-entry oracle of `commit_batch`: the entries one `commit`
    after another, in batch order (the batch on the last axis; a log with
    leading axes takes one entry per log each time). `commit_batch` must
    give the same log bit for bit."""
    if mask is None:
        mask = torch.ones(segments.shape, dtype=torch.bool, device=segments.device)
    for i in range(segments.shape[-1]):
        log = commit(log, segments[..., i], keys[..., i], vals[..., i],
                     enable=mask[..., i])
    return log


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
