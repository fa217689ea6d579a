"""Idle resource descriptors and the idle-resource table (paper §4.3).

Port of `repro.core.descriptors`. Each node (replica in the serving
substrate) publishes descriptors for resources it is willing to lend; the
table is a struct-of-arrays NamedTuple of tensors, one row per (node,
slot). Every operation is a pure function of its inputs, so every replica
computing the same round on the same table gets the same answer —
determinism in place of the paper's CAS atomicity (DESIGN.md §3).

Descriptor layout (paper Fig. 7):
  valid        bool     descriptor holds a lendable resource
  rtype        int8     PROCESSOR=0 | DRAM=1 | FLASH_BW=2 | LINK_BW=3
  borrower_id  int32    FREE (=0xFF) when unclaimed, else borrower node id
  amount_a     float32  PROCESSOR: borrower utilization | others: amount
  amount_b     float32  PROCESSOR/FLASH_BW/LINK_BW: lender utilization
  info_a       int32    PROCESSOR: mapping-directory addr | DRAM: list head
  info_b       int32    PROCESSOR: CQ pair | DRAM: log-page addr

Resource types are data: each is a `ResourceSpec` in `REGISTRY` holding its
claim-score weights and sync rules, and `claim_best` / `sync_utilization`
loop over the registry.

A table may carry leading axes ([..., N, S]): the hierarchical engine
stacks one table per shard on a leading shard axis, the port's counterpart
of the reference's `jax.vmap`. Node ids stay local to their table.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device

PROCESSOR = 0   # compute-end clocks (§4.4)
DRAM = 1        # mapping-cache segments / KV pages (§4.5)
FLASH_BW = 2    # data-end (flash backbone) channel time (§3 disaggregation)
LINK_BW = 3     # CXL link bytes (inter-SSD assist traffic budget)
FREE = 0xFF  # borrower_id sentinel: not borrowed


class ResourceSpec(NamedTuple):
    """Per-rtype policy data for the generic descriptor machinery.

    ``score_a``/``score_b``: claim score = score_a * amount_a + score_b *
    amount_b; the borrower claims the highest-scoring descriptor.
    ``sync_a``: "borrower_util" | "amount" | "none" — how the sync
    refreshes ``amount_a``; ``sync_b``: "lender_util" | "none".
    """

    rtype: int
    name: str
    score_a: float = 0.0
    score_b: float = 0.0
    sync_a: str = "none"
    sync_b: str = "none"


REGISTRY: dict[int, ResourceSpec] = {}


def register(spec: ResourceSpec) -> ResourceSpec:
    """Register (or redefine) a resource type. Returns the spec."""
    if not 0 <= spec.rtype < 127:
        raise ValueError(f"rtype must fit int8, got {spec.rtype}")
    if spec.sync_a not in ("borrower_util", "amount", "none"):
        raise ValueError(f"bad sync_a {spec.sync_a!r}")
    if spec.sync_b not in ("lender_util", "none"):
        raise ValueError(f"bad sync_b {spec.sync_b!r}")
    REGISTRY[spec.rtype] = spec
    return spec


register(ResourceSpec(PROCESSOR, "processor",
                      score_b=-1.0, sync_a="borrower_util", sync_b="lender_util"))
register(ResourceSpec(DRAM, "dram", score_a=1.0, sync_a="amount"))
register(ResourceSpec(FLASH_BW, "flash_bw",
                      score_a=1.0, sync_a="amount", sync_b="lender_util"))
register(ResourceSpec(LINK_BW, "link_bw",
                      score_a=1.0, sync_a="amount", sync_b="lender_util"))


def spec_of(rtype: int) -> ResourceSpec:
    return REGISTRY[int(rtype)]


_WEIGHTS: dict = {}


def _score_weights(device) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense (score_a, score_b) weight tables indexed by rtype. Cached per
    device and registry contents, and filled entry by entry on the device:
    a tensor built from a Python list on a CUDA device is a host-to-device
    copy that waits for the stream, which a loop that must not sync may
    not make even once."""
    key = (str(device), tuple(sorted(
        (r, s.score_a, s.score_b) for r, s in REGISTRY.items())))
    if key not in _WEIGHTS:
        idx = torch.arange(max(REGISTRY) + 1, device=device)
        wa = torch.zeros(idx.shape, dtype=torch.float32, device=device)
        wb = torch.zeros_like(wa)
        for r, s in REGISTRY.items():
            wa = torch.where(idx == r, s.score_a, wa)
            wb = torch.where(idx == r, s.score_b, wb)
        _WEIGHTS[key] = (wa, wb)
    return _WEIGHTS[key]


class IdleResourceTable(NamedTuple):
    """Struct-of-arrays descriptor table, shape [..., n_nodes, n_slots]."""

    valid: torch.Tensor        # bool   [N, S]
    rtype: torch.Tensor        # int8   [N, S]
    borrower_id: torch.Tensor  # int32  [N, S]
    amount_a: torch.Tensor     # float32[N, S]
    amount_b: torch.Tensor     # float32[N, S]
    info_a: torch.Tensor       # int32  [N, S]
    info_b: torch.Tensor       # int32  [N, S]

    @property
    def n_nodes(self) -> int:
        return self.valid.shape[-2]

    @property
    def n_slots(self) -> int:
        return self.valid.shape[-1]


def make_table(n_nodes: int, n_slots: int = 2, *,
               device=None) -> IdleResourceTable:
    """Fresh table: all descriptors invalid / unclaimed."""
    dev = resolve_device(device)
    shape = (n_nodes, n_slots)
    return IdleResourceTable(
        valid=torch.zeros(shape, dtype=torch.bool, device=dev),
        rtype=torch.zeros(shape, dtype=torch.int8, device=dev),
        borrower_id=torch.full(shape, FREE, dtype=torch.int32, device=dev),
        amount_a=torch.zeros(shape, dtype=torch.float32, device=dev),
        amount_b=torch.zeros(shape, dtype=torch.float32, device=dev),
        info_a=torch.zeros(shape, dtype=torch.int32, device=dev),
        info_b=torch.zeros(shape, dtype=torch.int32, device=dev),
    )


def publish(table: IdleResourceTable, node_id: int, slot: int, rtype: int,
            amount_a: float, amount_b: float = 0.0, info_a: int = 0,
            info_b: int = 0) -> IdleResourceTable:
    """Lender announces an idle resource (paper workflow step 2)."""
    values = dict(valid=True, rtype=rtype, borrower_id=FREE,
                  amount_a=amount_a, amount_b=amount_b, info_a=info_a,
                  info_b=info_b)
    out = {}
    for name, val in values.items():
        a = getattr(table, name).clone()
        a[node_id, slot] = val
        out[name] = a
    return IdleResourceTable(**out)


def withdraw(table: IdleResourceTable, node_id, slot) -> IdleResourceTable:
    """Lender stops lending: tag the descriptor invalid (paper §4.3).
    ``node_id`` / ``slot`` index the last two axes (ints, or index tensors
    that broadcast against each other)."""
    valid = table.valid.clone()
    valid[..., node_id, slot] = False
    return table._replace(valid=valid)


def release(table: IdleResourceTable, borrower_id) -> IdleResourceTable:
    """Borrower ends harvesting: reset its claims to FREE (paper §4.3).
    ``borrower_id`` is an int, or one id per table as in `claim_best`."""
    mine = table.borrower_id == _node(table, borrower_id)
    return table._replace(borrower_id=torch.where(mine, FREE, table.borrower_id))


def _node(table: IdleResourceTable, node_id):
    """A node id to compare with [..., N, S]: a Python int as it is, a
    tensor of one id per table (shape [..., 1]) as [..., 1, 1]."""
    if isinstance(node_id, torch.Tensor):
        return node_id.reshape(*table.valid.shape[:-2], 1, 1)
    return node_id


def claimable_mask(table: IdleResourceTable, borrower_id,
                   rtype: int) -> torch.Tensor:
    """[..., N, S] bool — valid, unclaimed, right type, and not our own
    node."""
    node_ids = torch.arange(table.n_nodes, dtype=torch.int32,
                            device=table.valid.device)[:, None]
    return (table.valid
            & (table.borrower_id == FREE)
            & (table.rtype == rtype)
            & (node_ids != _node(table, borrower_id)))


def claim_best(table: IdleResourceTable, borrower_id, rtype: int):
    """Borrower claims the best matching descriptor (workflow step 3).

    "Best" comes from the rtype's registered score weights. Masked scores
    are -inf and the argmax goes to the lowest flat index on ties, so
    every replica computing it on the same table picks the same lender.
    ``borrower_id`` may be a tensor of one id per table (shape [..., 1]
    for a table [..., N, S]; the claim sweep passes one, so the sweep never
    reads a value back to the host).

    Returns (table', lender_id, slot, success), each of the table's
    leading shape; lender/slot are -1 on failure.
    """
    dev = table.valid.device
    lead = table.valid.shape[:-2]
    mask = claimable_mask(table, borrower_id, rtype)
    wa, wb = _score_weights(dev)
    rt = table.rtype.long().clamp(0, wa.shape[0] - 1)
    score = wa[rt] * table.amount_a + wb[rt] * table.amount_b
    score = torch.where(mask, score, float("-inf"))
    flat = torch.argmax(score.reshape(*lead, -1), dim=-1, keepdim=True)
    success = mask.reshape(*lead, -1).any(dim=-1, keepdim=True)
    if isinstance(borrower_id, torch.Tensor):
        me = borrower_id.reshape(*lead, 1).to(torch.int32)
    else:
        me = torch.full((*lead, 1), int(borrower_id), dtype=torch.int32,
                        device=dev)
    # gather/scatter with index tensors: indexing by a 0-d tensor would
    # read the index back to the host
    bid = table.borrower_id.reshape(*lead, -1)
    bid = bid.scatter(-1, flat, torch.where(success, me, bid.gather(-1, flat)))
    table = table._replace(borrower_id=bid.reshape(table.borrower_id.shape))
    lender = torch.where(success, flat // table.n_slots, -1).to(torch.int32)
    slot = torch.where(success, flat % table.n_slots, -1).to(torch.int32)
    return table, lender[..., 0], slot[..., 0], success[..., 0]


def per_node(u: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``u[..., ids]`` per table: u [..., N], ids [..., N, S] local ids."""
    lead = u.shape[:-1]
    return u.gather(-1, ids.reshape(*lead, -1)).reshape(ids.shape)


def sync_utilization(table: IdleResourceTable, node_utils=None,
                     amounts: dict | None = None) -> IdleResourceTable:
    """Per-step descriptor refresh, per rtype via the registry.

    ``node_utils``: float32[..., N] (shorthand for ``{PROCESSOR: utils}``)
    or a dict ``{rtype: float32[..., N]}``; ``amounts``: dict ``{rtype:
    float32[..., N]}`` of each node's current lendable amount for capacity
    resources.
    lender_util syncs amount_b to the owner's util; borrower_util syncs
    amount_a to the claimant's util; amount syncs amount_a to the current
    lendable amount.
    """
    n = table.n_nodes
    if node_utils is None:
        utils: dict = {}
    elif isinstance(node_utils, dict):
        utils = node_utils
    else:
        utils = {PROCESSOR: node_utils}
    amounts = amounts or {}

    amount_a, amount_b = table.amount_a, table.amount_b
    claimed = table.borrower_id != FREE
    safe_bid = table.borrower_id.long().clamp(0, n - 1)
    for rtype in sorted(REGISTRY):
        spec = REGISTRY[rtype]
        is_r = table.rtype == rtype
        u = utils.get(rtype)
        if u is not None:
            u = u.to(torch.float32)
            if spec.sync_b == "lender_util":
                amount_b = torch.where(is_r & table.valid, u[..., None],
                                       amount_b)
            if spec.sync_a == "borrower_util":
                amount_a = torch.where(is_r & table.valid & claimed,
                                       per_node(u, safe_bid), amount_a)
        amt = amounts.get(rtype)
        if amt is not None and spec.sync_a == "amount":
            amount_a = torch.where(is_r & table.valid,
                                   amt.to(torch.float32)[..., None], amount_a)
    return table._replace(amount_a=amount_a, amount_b=amount_b)


def lenders_of(table: IdleResourceTable, borrower_id, rtype: int) -> torch.Tensor:
    """bool[..., N] — which nodes currently lend ``rtype`` to
    ``borrower_id`` (an int, or one id per table as in `claim_best`)."""
    m = (table.valid & (table.borrower_id == _node(table, borrower_id))
         & (table.rtype == rtype))
    return m.any(dim=-1)
