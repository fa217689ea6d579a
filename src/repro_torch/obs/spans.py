"""Grant-lifecycle event records in a bounded device-side log.

Port of `repro.obs.spans`. Events are derived as a diff between the
descriptor table entering a management round and the table leaving it
(`core.manager.table_transitions`), packed into fixed-width float32 rows
and appended to a bounded log with one masked scatter — no host sync, no
dynamic shapes.

Row layout (`FIELDS`): t, event code, rtype, level, lender, borrower,
amount, price. `price` is the per-unit §4.6 link-byte cost of the grant's
tier. Cross-shard/fabric assist grants (level >= 1) carry *shard* or
*enclosure* ids in the lender/borrower columns; level-0 rows carry node
ids. Overflow drops the newest rows (``count`` keeps the true total, so
decode reports how many were dropped).

The log and the row functions take leading batch axes (the engine's [S,
...] shard axis): a local log is ``buf [..., 1, capacity, NF]``, ``count
[..., 1]``.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from ..core import costs
from ..core import descriptors as desc

FIELDS = ("t", "event", "rtype", "level", "lender", "borrower", "amount", "price")
NF = len(FIELDS)

# Event codes (f32 in the rows; small exact integers).
PUBLISH, WITHDRAW, CLAIM, RELEASE, ASSIST, FABRIC_GRANT = range(6)
EVENT_NAMES = ("publish", "withdraw", "claim", "release", "assist", "fabric_grant")

RTYPE_NAMES = {
    desc.PROCESSOR: "PROCESSOR",
    desc.DRAM: "DRAM",
    desc.FLASH_BW: "FLASH_BW",
    desc.LINK_BW: "LINK_BW",
}

_N_RTYPES = max(RTYPE_NAMES) + 1


@functools.lru_cache(maxsize=1)
def _price0() -> tuple:
    """Per-unit intra-pool (tier 0) command price per rtype, for level-0
    rows."""
    return tuple(float(costs.op_link_bytes(rt)) for rt in range(_N_RTYPES))


class EventLog(NamedTuple):
    """Bounded log: ``buf [lead, capacity, NF]`` f32, ``count [lead]`` i32.

    ``count`` is the number of rows *offered* (may exceed capacity; rows
    past capacity are dropped)."""

    buf: torch.Tensor
    count: torch.Tensor


def make_log(capacity: int, lead: int = 1, *, device=None) -> EventLog:
    dev = resolve_device(device)
    return EventLog(
        buf=torch.zeros((lead, capacity, NF), dtype=torch.float32, device=dev),
        count=torch.zeros(lead, dtype=torch.int32, device=dev))


def append(log: EventLog, rows: torch.Tensor, mask: torch.Tensor) -> EventLog:
    """Append ``rows[mask]`` (local view: lead == 1; rows ``[..., M, NF]``,
    mask ``[..., M]``). Masked rows and rows past capacity go to a scratch
    row after the log, which is then cut off — a fixed-shape scatter
    either way, as the reference's ``mode="drop"``."""
    buf = log.buf[..., 0, :, :]                             # [..., cap, NF]
    cap = buf.shape[-2]
    m = mask.to(torch.int32)
    idx = log.count + torch.cumsum(m, dim=-1, dtype=torch.int32) - m
    pos = torch.where(mask.to(torch.bool) & (idx < cap), idx, cap).to(torch.int64)
    ext = torch.cat([buf, torch.zeros_like(buf[..., :1, :])], dim=-2)
    ext = ext.scatter(-2, pos[..., None].expand(*pos.shape, NF),
                      rows.to(torch.float32))
    return EventLog(buf=ext[..., None, :cap, :],
                    count=log.count + m.sum(dim=-1, keepdim=True, dtype=torch.int32))


def _pack(*parts) -> torch.Tensor:
    """Stack broadcastable components (tensors or Python numbers) into
    [..., NF] float32 rows."""
    tens = [p for p in parts if isinstance(p, torch.Tensor)]
    dev = tens[0].device
    shape = torch.broadcast_shapes(*(p.shape for p in tens))
    cols = [p.to(torch.float32).expand(shape) if isinstance(p, torch.Tensor)
            else torch.full(shape, float(np.float32(p)), dtype=torch.float32,
                            device=dev)
            for p in parts]
    return torch.stack(cols, dim=-1)


def _price_of(rt: torch.Tensor) -> torch.Tensor:
    """The level-0 price of each rtype in ``rt`` (already clipped), from
    Python numbers: a tensor built from them would be a host copy."""
    price = torch.zeros(rt.shape, dtype=torch.float32, device=rt.device)
    for code, p in enumerate(_price0()):
        price = torch.where(rt == code, float(np.float32(p)), price)
    return price


def table_event_rows(prev, new, t, *, base=0):
    """Rows+mask for one management round's table diff (level-0 events).

    ``prev``/``new`` are `IdleResourceTable`s ([..., n, s] fields);
    ``base`` offsets local node ids to global ones ([...] or a number).
    Returns ``(rows [..., 4*n*s, NF], mask [..., 4*n*s])``."""
    from ..core import manager as mgr

    published, withdrawn, claimed, released = mgr.table_transitions(prev, new)
    n, s = prev.valid.shape[-2:]
    dev = prev.valid.device
    base = torch.as_tensor(base, dtype=torch.int32, device=dev) \
        if not isinstance(base, torch.Tensor) else base.to(torch.int32)
    base = base[..., None, None]
    lender = torch.arange(n, dtype=torch.int32, device=dev)[:, None] + base
    batch = prev.valid.shape[:-2]

    def block(code, mask, rtype, borrower, amount):
        rt = torch.clamp(rtype.to(torch.int32), 0, _N_RTYPES - 1)
        rows = _pack(t, code, rt, 0, lender, borrower, amount, _price_of(rt))
        return rows.reshape(*batch, n * s, NF), mask.reshape(*batch, n * s)

    no_peer = torch.full(prev.valid.shape, -1, dtype=torch.int32, device=dev)
    blocks = (
        block(PUBLISH, published, new.rtype, no_peer, new.amount_a),
        block(WITHDRAW, withdrawn, prev.rtype, no_peer, prev.amount_a),
        block(CLAIM, claimed, new.rtype, new.borrower_id.to(torch.int32) + base,
              new.amount_a),
        block(RELEASE, released, prev.rtype,
              prev.borrower_id.to(torch.int32) + base, prev.amount_a),
    )
    rows = torch.cat([b[0] for b in blocks], dim=-2)
    mask = torch.cat([b[1] for b in blocks], dim=-1)
    return rows, mask


def grant_event_rows(grants, *, rtype, level, t, price=0.0, code=ASSIST,
                     lender_base=0, borrower_base=0):
    """Rows+mask from an exchange grant matrix ``grants [..., L, B]``
    (lender x borrower amounts at one tier). Ids are scope-relative (shard
    ids for the engine's cross-shard exchange); the bases are numbers or
    tensors broadcastable to [..., 1, 1]."""
    nl, nb = grants.shape[-2:]
    dev = grants.device
    lender = torch.arange(nl, dtype=torch.int32, device=dev)[:, None] + lender_base
    borrower = torch.arange(nb, dtype=torch.int32, device=dev)[None, :] + borrower_base
    rows = _pack(t, code, rtype, level, lender, borrower, grants, price)
    batch = grants.shape[:-2]
    return rows.reshape(*batch, nl * nb, NF), (grants > 0).reshape(*batch, nl * nb)


def decode(log: EventLog, *, id_stride: int = 0):
    """Host-side decode to structured records, sorted by time.

    Multi-lane logs (one per shard/enclosure) merge; ``id_stride`` offsets
    level-0 node ids by ``lane * id_stride`` (the engine records global
    ids: stride 0). Returns ``(records, n_dropped)``."""
    buf = log.buf.cpu().numpy().reshape(-1, log.buf.shape[-2], NF)
    cnt = log.count.cpu().numpy().reshape(-1)
    cap = buf.shape[1]
    records, dropped = [], 0
    for lane, (b, c) in enumerate(zip(buf, cnt)):
        take = int(min(c, cap))
        dropped += int(c) - take
        for row in b[:take]:
            rec = dict(zip(FIELDS, (float(x) for x in row)))
            rec["t"] = int(rec["t"])
            rec["event"] = EVENT_NAMES[int(rec["event"])]
            rec["rtype"] = RTYPE_NAMES.get(int(rec["rtype"]), str(int(rec["rtype"])))
            rec["level"] = int(rec["level"])
            off = lane * id_stride if rec["level"] == 0 else 0
            rec["lender"] = int(rec["lender"]) + off
            rec["borrower"] = (
                int(rec["borrower"]) + off if rec["borrower"] >= 0 else None)
            rec["lane"] = lane
            records.append(rec)
    records.sort(key=lambda r: (r["t"], r["lane"]))
    return records, dropped
