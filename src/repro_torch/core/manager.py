"""The unified decentralized resource-management round (paper §4.3–§4.5).

Port of `repro.core.manager`. A `ManagerConfig` carries one
`ResourcePolicy` per harvestable rtype and `ResourceManager.round()` loops
over them; policy differences are data, not code forks. A round, per
policy (DESIGN.md §2):

  trigger     quadrant logic on (own util, gate util) via
              `harvest.harvest_triggers` (optional `gate_watermark`
              hysteresis); `amount_gated` policies lend whenever their
              amount exceeds `min_amount`
  publish     every lender (re)writes the policy's descriptor slots
  release     claims whose borrower no longer qualifies, and claims on
              withdrawn descriptors, drop to FREE
  claim       `claim_rounds` sweeps, busiest borrower first (a stable sort
              of -util, ties by node id), at most one lender per borrower
              per sweep up to `lender_cap`
  sync        `descriptors.sync_utilization` refreshes the amounts

Everything is a function of (table, inputs) that reads no value back to
the host, so the round can run inside a captured CUDA graph later. A table
and its inputs may carry leading axes ([..., N, S] and [..., N]): one
table per shard, the port's counterpart of the reference's `jax.vmap`, so
a claim sweep takes N steps, not N times the shard count.

`shard_exchange` is the inter-shard half of the hierarchical round
(DESIGN.md §9). The reference runs it compiled, where XLA divides by a
constant as a product with its float32 reciprocal, multiplies two scalar
factors together before it applies them to a vector, sums a short axis
left to right and contracts a product fused into a sum into FMAs; the port
does the same (`recip32`, `seq_sum`, `fma_sum`), so the floors the engine
takes of its grants land on the same integers.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from . import descriptors as d
from . import harvest as hv

_EPS = 1e-9


class ResourcePolicy(NamedTuple):
    """Static per-rtype knobs for the management round (Python scalars,
    so a tuple of policies is hashable)."""

    rtype: int                    # descriptors.REGISTRY key
    slot0: int = 0                # first descriptor slot owned by this rtype
    slots: int = 1                # slots carrying the fragmented surplus
    claim_rounds: int = 1         # claim sweeps (0 = no claims)
    max_lenders: int = 0          # cap lenders per borrower (0 = claim_rounds)
    watermark: float = hv.WATERMARK        # busy threshold on own utilization
    gate_watermark: float | None = None    # borrow-cancel hysteresis (§4.4)
    min_amount: float = 0.0       # publish only above this amount
    preserve_claims: bool = False  # keep claims across rounds
    amount_gated: bool = False    # capacity style: lend = amount > min_amount
    # the futility gate vetoes ACQUIRING new claims only; existing claims
    # stay while the borrower's own resource is busy (needs preserve_claims)
    gate_new_only: bool = False

    @property
    def lender_cap(self) -> int:
        return self.max_lenders if self.max_lenders > 0 else max(self.claim_rounds, 1)


class RoundInputs(NamedTuple):
    """Per-rtype inputs to one round: ``util`` float32[N] own
    utilization, ``gate_util`` float32[N] the paired resource's
    utilization (§4.4 futility gate), ``amount`` float32[N] lendable
    amount (capacity types)."""

    util: torch.Tensor | None = None
    gate_util: torch.Tensor | None = None
    amount: torch.Tensor | None = None


class ManagerConfig(NamedTuple):
    """Descriptor-table width plus one `ResourcePolicy` per rtype."""

    n_slots: int = 2
    policies: tuple[ResourcePolicy, ...] = ()

    def policy(self, rtype: int) -> ResourcePolicy:
        for pol in self.policies:
            if pol.rtype == rtype:
                return pol
        raise KeyError(f"no policy registered for rtype {rtype}")


def recip32(c: float) -> float:
    """float32 reciprocal of a constant divisor: the factor the reference's
    compiled code multiplies by where its source divides by ``c``."""
    return float(np.float32(1.0) / np.float32(c))


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis left to right, one add at a time: the order
    XLA's compiled reduction takes over a short axis, so a float total
    lands on the reference's bits (and on the same bits on every device)."""
    parts = x.unbind(-1)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def fma_sum(a: torch.Tensor, c: float) -> torch.Tensor:
    """Σ a·c over the last axis (``c`` a constant) as XLA's compiled
    reduction takes it when the product is fused into it: left to right,
    each step one fused multiply-add rounded once to float32. Emulated in
    float64, where the product of two float32 values is exact and so is
    its sum with a running total up to 16 times larger (the exchange sums
    at most 8 summaries of like size); past that a float32 tie could
    round twice."""
    prod = a.to(torch.float64) * float(np.float32(c))
    parts = prod.unbind(-1)
    out = parts[0].to(torch.float32)
    for part in parts[1:]:
        out = (part + out.to(torch.float64)).to(torch.float32)
    return out


def fma_rowsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ a·b over the last axis (``b`` broadcasting against ``a``) as XLA's
    compiled reduction takes it when the product is fused into it: left to
    right, one fused multiply-add a term, each rounded once to float32.
    Emulated in float64 as in `fma_sum`."""
    prod = (a.to(torch.float64) * b.to(torch.float64)).unbind(-1)
    out = prod[0].to(torch.float32)
    for part in prod[1:]:
        out = (part + out.to(torch.float64)).to(torch.float32)
    return out


def _fma32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """a·b + c rounded once to float32, as an FMA gives it (emulated in
    float64 as in `fma_sum`: exact while |c| is at most 16 |a·b|)."""
    b = b.to(torch.float64) if isinstance(b, torch.Tensor) else float(np.float32(b))
    return (a.to(torch.float64) * b + c.to(torch.float64)).to(torch.float32)


class Settled(NamedTuple):
    grants: torch.Tensor     # [..., lender, borrower]
    received: torch.Tensor   # [..., S]
    spare_net: torch.Tensor  # [..., S] spare after local netting
    want_left: torch.Tensor  # [..., S] net want not received


def settle(spare: torch.Tensor, want: torch.Tensor,
           overhead: float) -> Settled:
    """`shard_exchange`, with what each shard is left with for the next
    level of a hierarchical exchange."""
    spare = spare.to(torch.float32)
    want = want.to(torch.float32)
    spare_net = torch.clamp(spare - want, min=0.0)
    want_net = torch.clamp(want - spare, min=0.0)
    total_spare = seq_sum(spare_net)[..., None]
    # the product fused into the sum: one FMA a step (no-op factor at 0)
    total_draw = fma_sum(want_net, 1.0 + overhead)[..., None]
    scale = torch.where(
        total_draw > 0,
        torch.clamp(total_spare / torch.clamp(total_draw, min=_EPS), max=1.0),
        0.0)
    frac = torch.where(
        total_spare > 0, spare_net / torch.clamp(total_spare, min=_EPS), 0.0)
    if overhead == 0.0:
        # XLA drops the factors of 1: received is want_net * scale, and
        # what is left of the want is one FMA
        draw = received = want_net * scale
        want_left = _fma32(-want_net, scale, want_net)
    else:
        # XLA folds the two scalar factors first: want_net * (scale * (1 +
        # oh)); the division by the constant is a product with its
        # reciprocal, which the want left over takes as one FMA
        inv = recip32(1.0 + overhead)
        draw = want_net * (scale * (1.0 + overhead))
        received = draw * inv
        want_left = _fma32(-draw, inv, want_net)
    grants = frac[..., :, None] * draw[..., None, :]
    return Settled(grants, received, spare_net, want_left)


def fluid_transfer(assist: torch.Tensor, surplus: torch.Tensor,
                   deficit: torch.Tensor, overhead=0.0, *, lent: bool = False):
    """Turn an assist matrix into conserved fluid capacity transfers.

    ``assist``: float32[..., lender, borrower] pledge fractions (rows sum
    ≤ 1). ``surplus`` / ``deficit``: float32[..., N] spare / missing
    capacity per node in the resource's own unit. ``overhead``: fractional
    tax on redirected work, a Python scalar or float32[..., N] per
    borrower (`core.costs.overhead_frac`).

    Returns ``(assist_in, used_from)``: per-borrower capacity received
    (net of overhead) and the [..., lender, borrower] lender-time actually
    consumed. Each lender donates at most its surplus and each borrower
    receives at most its deficit. With ``lent`` a third tensor, each
    lender's total drawn ([..., N], the row sums of ``used_from``), is
    summed as the compiled reference sums it: the product fused into the
    sum, one FMA a term left to right (`fma_rowsum`). The pledges reach
    each borrower the same way, an FMA a lender."""
    pledged = assist * surplus[..., :, None]                  # [..., l, b]
    gross = fma_rowsum(assist.transpose(-1, -2), surplus[..., None, :])
    if isinstance(overhead, torch.Tensor):
        avail = gross / (1.0 + overhead)
    else:
        # a constant divisor: the compiled reference multiplies by its
        # float32 reciprocal
        avail = gross * recip32(1.0 + overhead)
    used = torch.minimum(avail, deficit)
    draw = torch.where(
        gross > 0, used * (1.0 + overhead) / torch.clamp(gross, min=_EPS), 0.0)
    used_from = pledged * draw[..., None, :]
    if lent:
        return used, used_from, fma_rowsum(pledged, draw[..., None, :])
    return used, used_from


def busy_split(work: torch.Tensor, cap: torch.Tensor, assist_in: torch.Tensor,
               used_from: torch.Tensor,
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decompose each node's performed work into busy-time attribution.

    ``work``: float32[..., N] resource time actually done (post-scale);
    ``cap``: own capacity; ``assist_in`` / ``used_from``: a
    `fluid_transfer` grant. Own capacity runs first, the overflow ran on
    lenders' donated capacity, and each lender's donation is charged by
    its borrowers' actual usage fraction (a batched product over the
    borrowers). Returns ``(own_done, remote_done, out_done)``; a node's
    busy time is ``own_done + out_done``."""
    remote = torch.minimum(torch.clamp(work - cap, min=0.0), assist_in)
    own = torch.minimum(torch.clamp(work - remote, min=0.0), cap)
    usage = torch.where(
        assist_in > 0, remote / torch.clamp(assist_in, min=_EPS), 0.0)
    out = torch.matmul(used_from, usage[..., None])[..., 0]
    return own, remote, out


def shard_exchange(spare: torch.Tensor, want: torch.Tensor,
                   overhead: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """The inter-shard half of a hierarchical management round (DESIGN.md
    §9), over the last axis.

    ``spare`` / ``want``: float32[..., S] per-shard aggregate post-local
    leftovers for one rtype. ``overhead``: fractional cross-shard tax — a
    borrower draws ``1 + overhead`` units of lender surplus per unit
    received. Local-first netting: a shard with both spare and want nets
    them first; total net demand is scaled to what net surplus can fund,
    and each lender shard contributes in proportion to its net spare.

    Returns ``(grants, received)``: grants float32[..., lender, borrower]
    drawn from each lender's surplus, received float32[..., S] usable
    units at each borrower. Σ_b grants[l, b] ≤ spare[l], received[b] ≤
    want[b], grants[s, s] == 0."""
    settled = settle(spare, want, overhead)
    return settled.grants, settled.received


def table_transitions(prev: d.IdleResourceTable, new: d.IdleResourceTable):
    """Grant-lifecycle transitions between two table snapshots (the obs
    plane's events are this diff of the table entering a round against
    the table leaving it). Returns bool [..., n, s] masks ``(published,
    withdrawn, claimed, released)``: invalid -> valid; valid -> invalid;
    ``borrower_id`` landed on a (new) borrower; a standing claim dropped
    or changed hands."""
    changed = new.borrower_id != prev.borrower_id
    published = new.valid & ~prev.valid
    withdrawn = prev.valid & ~new.valid
    claimed = (new.borrower_id != d.FREE) & changed
    released = (prev.borrower_id != d.FREE) & changed
    return published, withdrawn, claimed, released


def revoke_nodes(table: d.IdleResourceTable, dead: torch.Tensor):
    """Invalidate every descriptor a dead node published and release every
    claim a dead node holds (§4.3 invalidation, forced by failure instead
    of the lend trigger).

    ``dead``: bool[..., n] over a table [..., n, s] with the same leading
    axes (one table per shard or enclosure). A failed *lender*'s rows go
    invalid, so borrowers drawing on them lose the grant at the next
    transfer derivation; a failed *borrower*'s claims revert to FREE.
    Idempotent: re-revoking a dead node counts zero. Returns ``(table,
    n_revoked)``, n_revoked int32[...] the slots per leading index whose
    lender side invalidated or whose claim released."""
    dead = dead.to(torch.bool)
    n = dead.shape[-1]
    dead_lender = dead[..., :, None] & table.valid
    bid = table.borrower_id.long().clamp(0, n - 1)
    lead = bid.shape[:-2]
    dead_of = torch.gather(dead, -1, bid.reshape(*lead, -1)).reshape(bid.shape)
    hit = dead_lender | ((table.borrower_id != d.FREE) & dead_of)
    return table._replace(
        valid=table.valid & ~dead[..., :, None],
        borrower_id=torch.where(hit, d.FREE, table.borrower_id),
    ), hit.sum(dim=(-2, -1), dtype=torch.int32)


def fill_by_rank(capacity: torch.Tensor, total) -> torch.Tensor:
    """Split ``total`` across nodes by filling ``capacity`` in index order
    along the last axis: out[i] = clip(total − Σ_{j<i} cap[j], 0, cap[i]).
    ``total`` broadcasts against ``capacity`` (one total per row: shape
    [..., 1])."""
    cum = torch.cumsum(capacity, -1).to(capacity.dtype) - capacity
    return torch.minimum(torch.clamp(total - cum, min=0), capacity)


class ResourceManager:
    """Config-bound view of the management round. Stateless: the table is
    threaded through, never stored."""

    def __init__(self, cfg: ManagerConfig):
        for pol in cfg.policies:
            if pol.gate_new_only and not pol.preserve_claims:
                raise ValueError(
                    f"rtype {pol.rtype}: gate_new_only retains claims across "
                    "rounds and therefore requires preserve_claims=True")
            if pol.amount_gated and (pol.preserve_claims or pol.claim_rounds > 0):
                raise ValueError(
                    f"rtype {pol.rtype}: amount_gated policies make no claims "
                    "(claim_rounds must be 0, preserve_claims False)")
        self.cfg = cfg

    def init_table(self, n_nodes: int, *, device=None) -> d.IdleResourceTable:
        return d.make_table(n_nodes, self.cfg.n_slots, device=device)

    # ------------------------------------------------------------- round
    def round(self, table: d.IdleResourceTable,
              inputs: dict[int, RoundInputs]) -> d.IdleResourceTable:
        """One full management round: each registered policy through
        trigger → publish → release → claim, then one per-rtype sync."""
        zeros = torch.zeros(table.valid.shape[:-1], dtype=torch.float32,
                            device=table.valid.device)
        utils: dict[int, torch.Tensor] = {}
        amounts: dict[int, torch.Tensor] = {}
        for pol in self.cfg.policies:
            inp = inputs.get(pol.rtype)
            if inp is None:
                raise KeyError(
                    f"round() missing RoundInputs for configured rtype "
                    f"{pol.rtype}; every policy needs inputs every round")
            util = zeros if inp.util is None else inp.util.to(torch.float32)
            gate = zeros if inp.gate_util is None else inp.gate_util.to(torch.float32)
            amount = None if inp.amount is None else inp.amount.to(torch.float32)
            if pol.amount_gated:
                if amount is None:
                    raise ValueError(
                        f"amount_gated policy for rtype {pol.rtype} needs an amount")
                lend = amount > pol.min_amount
                borrow = torch.zeros_like(zeros, dtype=torch.bool)
                keep = borrow
            else:
                lend, borrow = hv.harvest_triggers(
                    util, gate, pol.watermark, pol.gate_watermark)
                keep = (util > pol.watermark) if pol.gate_new_only else borrow
                if amount is not None and pol.min_amount > 0.0:
                    lend = lend & (amount > pol.min_amount)
            table = self._publish(table, pol, lend, util, amount)
            if pol.preserve_claims:
                table = self._release_stale(table, pol, keep)
            if pol.claim_rounds > 0:
                table = self._claim_sweeps(table, pol, util, borrow)
            utils[pol.rtype] = util
            if amount is not None:
                amounts[pol.rtype] = amount
        return d.sync_utilization(table, utils, amounts)

    # ----------------------------------------------------------- publish
    @staticmethod
    def _slot_mask(pol: ResourcePolicy, n_slots: int, device) -> torch.Tensor:
        sid = torch.arange(n_slots, device=device)
        return (sid >= pol.slot0) & (sid < pol.slot0 + pol.slots)

    def slot_mask(self, rtype: int, n_slots: int | None = None, *,
                  device=None) -> torch.Tensor:
        """bool[S] — which descriptor slots ``rtype``'s policy owns; the
        supported way to locate a policy's descriptors in the table."""
        pol = self.cfg.policy(rtype)
        return self._slot_mask(
            pol, self.cfg.n_slots if n_slots is None else n_slots,
            resolve_device(device))

    def _publish(self, table, pol, lend, util, amount):
        """Every node writes the policy's slots at once."""
        sel = self._slot_mask(pol, table.n_slots, table.valid.device)
        sel = sel.expand(table.valid.shape)
        if pol.preserve_claims:
            # only claims sitting on a withdrawn descriptor drop
            drop = sel & (~lend)[..., None] & (table.rtype == pol.rtype)
            borrower = torch.where(drop, d.FREE, table.borrower_id)
        else:
            borrower = torch.where(sel, d.FREE, table.borrower_id)
        amount_a = table.amount_a
        if amount is not None:
            amount_a = torch.where(sel, amount[..., None], amount_a)
        return table._replace(
            valid=torch.where(sel, lend[..., None], table.valid),
            rtype=torch.where(sel, pol.rtype, table.rtype),
            amount_a=amount_a,
            amount_b=torch.where(sel, util[..., None], table.amount_b),
            borrower_id=borrower,
        )

    @staticmethod
    def _release_stale(table, pol, borrow):
        """Claims of nodes that stopped qualifying as borrowers drop."""
        n = table.n_nodes
        safe_bid = table.borrower_id.long().clamp(0, n - 1)
        mine = (table.borrower_id != d.FREE) & (table.rtype == pol.rtype)
        keep = ~mine | d.per_node(borrow, safe_bid)
        return table._replace(
            borrower_id=torch.where(keep, table.borrower_id, d.FREE))

    # ------------------------------------------------------------- claim
    def _claim_sweeps(self, table, pol, util, borrow):
        """``claim_rounds`` sequential sweeps over the nodes in a stable
        busiest-first order; in each, a borrowing node under its
        distinct-lender cap claims its best lender via
        `descriptors.claim_best`. A Python loop over node positions, every
        table of the leading axes at once — the node ids and the take/skip
        decisions stay on the device, so nothing syncs with the host.
        ``lender_cap`` bounds DISTINCT lender nodes (the any-slot
        `lenders_of` reduction); claimed slots are bounded separately by
        ``claim_rounds``."""
        cap = pol.lender_cap
        order = torch.argsort(-util, dim=-1, stable=True)
        for _ in range(pol.claim_rounds):
            for i in range(table.n_nodes):
                # a one-element slice per table: indexing with it stays on
                # the device (a 0-d tensor index would be read back)
                node = order[..., i : i + 1]
                have = d.lenders_of(table, node, pol.rtype).sum(dim=-1)
                claimed, _, _, _ = d.claim_best(table, node, pol.rtype)
                take = borrow.gather(-1, node) & (have < cap)[..., None]
                # claim_best only ever rewrites borrower_id
                table = table._replace(borrower_id=torch.where(
                    take[..., None], claimed.borrower_id, table.borrower_id))
        return table

    # ------------------------------------------------------------ derive
    def assist_matrix(self, table: d.IdleResourceTable,
                      rtype: int) -> torch.Tensor:
        """float32[..., lender, borrower] — fraction of each lender's
        surplus pledged to each borrower (claimed slots / the policy's
        slots)."""
        pol = self.cfg.policy(rtype)
        n = table.n_nodes
        claimed = (table.valid & (table.borrower_id != d.FREE)
                   & (table.rtype == rtype))
        b = table.borrower_id.long().clamp(0, n - 1)
        nodes = torch.arange(n, device=b.device)
        onehot = ((b[..., None] == nodes) & claimed[..., None]).to(torch.float32)
        return onehot.sum(dim=-2) / float(pol.slots)

    @staticmethod
    def sync_utilization(table, node_utils, amounts=None):
        return d.sync_utilization(table, node_utils, amounts)
