"""Per-operation remote-assist cost model (paper §4.6).

Port of `repro.core.costs`: the one per-op price table both substrates
read. Every remote assist costs command dequeue + unwrap events on the
remote compute-end, CXL fabric hops, and the bytes the op moves across the
link:

  rtype       op                        dequeues  hops  link bytes/op
  ---------   ------------------------  --------  ----  -------------------
  PROCESSOR   redirected command (§4.4)     2      1    cmd descriptor only
  DRAM        remote mapping lookup (§4.5)  1      1    lookup cacheline
  FLASH_BW    redirected backbone op (§3)   2      1    cmd + full payload
  LINK_BW     multipath-detoured transfer   1      1    cmd (payload already
                                                        on the account)

The serving engine debits `REDIRECT_CMD_BYTES` per §4.4 shadow-slot
redirection from the same LINK_BW byte budget that meters lender-spill
pages. Scalars in give floats out; the two clipped rates take tensors
(`assist_link_bps` also a tensor of I/O sizes).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..jbof import ssd
from . import descriptors as desc

_TINY = 1e-12


class OpCost(NamedTuple):
    """Per-op §4.6 cost coefficients for one assisted-operation type."""

    dequeue_ops: float
    hops: float
    cmd_bytes: float = ssd.CMD_BYTES
    payload_frac: float = 0.0


OP_COSTS: dict[int, OpCost] = {
    desc.PROCESSOR: OpCost(dequeue_ops=2.0, hops=1.0),
    desc.DRAM: OpCost(dequeue_ops=1.0, hops=1.0),
    desc.FLASH_BW: OpCost(dequeue_ops=2.0, hops=1.0, payload_frac=1.0),
    desc.LINK_BW: OpCost(dequeue_ops=1.0, hops=1.0),
}

# §4.4 shadow-slot redirection command: what one redirected request debits
# from the unified LINK_BW byte account (serving/engine.py)
REDIRECT_CMD_BYTES = OP_COSTS[desc.PROCESSOR].cmd_bytes

# Extra CXL traversals per topology tier crossed (0 node-local, 1 the
# enclosure switch, 2 the inter-JBOF fabric); see core/topology.py.
LEVEL_EXTRA_HOPS: tuple[float, ...] = (0.0, 1.0, 4.0)


def level_extra_hops(level: int, *, table=LEVEL_EXTRA_HOPS) -> float:
    """Extra CXL traversals for an assist crossing a ``level``-tier
    boundary; levels beyond the table extrapolate geometrically."""
    if level < len(table):
        return table[level]
    ratio = table[-1] / max(table[-2], 1.0) if len(table) >= 2 else 2.0
    return table[-1] * ratio ** (level - len(table) + 1)


def op_cost(rtype: int) -> OpCost:
    return OP_COSTS[rtype]


def op_overhead_s(rtype: int, *, dequeue_s=ssd.T_INTER_SSD_OP,
                  hop_s=ssd.T_CXL_HOP):
    """Fixed §4.6 protocol time per assisted op (dequeues plus hops)."""
    c = OP_COSTS[rtype]
    return c.dequeue_ops * dequeue_s + c.hops * hop_s


def op_link_bytes(rtype: int, io_bytes=0.0, *, cmd_bytes=None,
                  payload_ratio: float = 1.0):
    """Bytes one assisted op moves across the CXL link: descriptors plus
    the payload fraction of ``io_bytes`` (``payload_ratio`` compresses the
    payload term only)."""
    c = OP_COSTS[rtype]
    cb = c.cmd_bytes if cmd_bytes is None else cmd_bytes
    return cb + c.payload_frac * io_bytes * payload_ratio


def tier_overhead_s(rtype: int, level: int = 1, *,
                    dequeue_s=ssd.T_INTER_SSD_OP, hop_s=ssd.T_CXL_HOP,
                    extra_hops: float | None = None):
    """Protocol time per assisted op crossing a ``level``-tier boundary."""
    eh = level_extra_hops(level) if extra_hops is None else extra_hops
    return op_overhead_s(rtype, dequeue_s=dequeue_s, hop_s=hop_s) + eh * hop_s


def tier_link_bytes(rtype: int, io_bytes=0.0, *, level: int = 1,
                    cmd_bytes=None, extra_hops: float | None = None,
                    payload_ratio: float = 1.0):
    """Bytes one assisted op crossing a ``level``-tier boundary puts on
    the fabric: the intra-pool bytes plus one descriptor re-crossing per
    extra hop."""
    c = OP_COSTS[rtype]
    cb = c.cmd_bytes if cmd_bytes is None else cmd_bytes
    eh = level_extra_hops(level) if extra_hops is None else extra_hops
    intra = op_link_bytes(rtype, io_bytes, cmd_bytes=cb,
                          payload_ratio=payload_ratio)
    return intra + eh * cb


def _over(num, service_s: torch.Tensor) -> torch.Tensor:
    """``num / max(service_s, tiny)`` as one float32 division (a Python
    scalar over a tensor would run as a reciprocal times the scalar,
    rounding twice)."""
    service_s = torch.clamp(service_s.to(torch.float32), min=_TINY)
    if not isinstance(num, torch.Tensor):
        num = torch.full_like(service_s, num)
    return torch.div(num, service_s)


def overhead_frac(rtype: int, op_service_s: torch.Tensor, *,
                  dequeue_s=ssd.T_INTER_SSD_OP, hop_s=ssd.T_CXL_HOP,
                  max_frac: float = 1e3) -> torch.Tensor:
    """Fractional tax on redirected work: the fixed per-op cost over the
    op's own service time, clipped at ``max_frac``."""
    per_op = op_overhead_s(rtype, dequeue_s=dequeue_s, hop_s=hop_s)
    return torch.clamp(_over(per_op, op_service_s), 0.0, max_frac)


def assist_link_bps(rtype: int, io_bytes, op_service_s: torch.Tensor, *,
                    cmd_bytes=None, payload_ratio: float = 1.0,
                    max_bps: float = ssd.CXL_BPS_PER_SSD) -> torch.Tensor:
    """Link byte-rate of redirected work (bytes per op over the op's
    service time), clipped at the port rate."""
    per_op = op_link_bytes(rtype, io_bytes, cmd_bytes=cmd_bytes,
                           payload_ratio=payload_ratio)
    return torch.clamp(_over(per_op, op_service_s), 0.0, max_bps)
