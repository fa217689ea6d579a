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
the host, so the round can run inside a captured CUDA graph later.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from . import descriptors as d
from . import harvest as hv


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


def fill_by_rank(capacity: torch.Tensor, total) -> torch.Tensor:
    """Split ``total`` across nodes by filling ``capacity`` in index order:
    out[i] = clip(total − Σ_{j<i} cap[j], 0, cap[i])."""
    cum = torch.cumsum(capacity, 0).to(capacity.dtype) - capacity
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
        n = table.n_nodes
        zeros = torch.zeros(n, dtype=torch.float32, device=table.valid.device)
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
                borrow = torch.zeros(n, dtype=torch.bool, device=zeros.device)
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
        n, s = table.valid.shape
        sel = self._slot_mask(pol, s, table.valid.device)[None, :].expand(n, s)
        if pol.preserve_claims:
            # only claims sitting on a withdrawn descriptor drop
            drop = sel & (~lend)[:, None] & (table.rtype == pol.rtype)
            borrower = torch.where(drop, d.FREE, table.borrower_id)
        else:
            borrower = torch.where(sel, d.FREE, table.borrower_id)
        amount_a = table.amount_a
        if amount is not None:
            amount_a = torch.where(sel, amount[:, None], amount_a)
        return table._replace(
            valid=torch.where(sel, lend[:, None], table.valid),
            rtype=torch.where(sel, pol.rtype, table.rtype),
            amount_a=amount_a,
            amount_b=torch.where(sel, util[:, None], table.amount_b),
            borrower_id=borrower,
        )

    @staticmethod
    def _release_stale(table, pol, borrow):
        """Claims of nodes that stopped qualifying as borrowers drop."""
        n = table.n_nodes
        safe_bid = table.borrower_id.long().clamp(0, n - 1)
        mine = (table.borrower_id != d.FREE) & (table.rtype == pol.rtype)
        keep = ~mine | borrow[safe_bid]
        return table._replace(
            borrower_id=torch.where(keep, table.borrower_id, d.FREE))

    # ------------------------------------------------------------- claim
    def _claim_sweeps(self, table, pol, util, borrow):
        """``claim_rounds`` sequential sweeps over the nodes in a stable
        busiest-first order; in each, a borrowing node under its
        distinct-lender cap claims its best lender via
        `descriptors.claim_best`. A Python loop over node positions — the
        node id and the take/skip decision stay on the device, so nothing
        syncs with the host. ``lender_cap`` bounds DISTINCT lender nodes
        (the any-slot `lenders_of` reduction); claimed slots are bounded
        separately by ``claim_rounds``."""
        cap = pol.lender_cap
        order = torch.argsort(-util, stable=True)
        for _ in range(pol.claim_rounds):
            for i in range(table.n_nodes):
                # a one-element slice: indexing with it stays on the device
                # (a 0-d tensor index would be read back to the host)
                node = order[i : i + 1]
                have = d.lenders_of(table, node, pol.rtype).sum()
                claimed, _, _, _ = d.claim_best(table, node, pol.rtype)
                take = borrow[node] & (have < cap)
                # claim_best only ever rewrites borrower_id
                table = table._replace(borrower_id=torch.where(
                    take, claimed.borrower_id, table.borrower_id))
        return table

    # ------------------------------------------------------------ derive
    def assist_matrix(self, table: d.IdleResourceTable,
                      rtype: int) -> torch.Tensor:
        """float32[lender, borrower] — fraction of each lender's surplus
        pledged to each borrower (claimed slots / the policy's slots)."""
        pol = self.cfg.policy(rtype)
        n, s = table.valid.shape
        claimed = (table.valid & (table.borrower_id != d.FREE)
                   & (table.rtype == rtype))
        b = table.borrower_id.long().clamp(0, n - 1)
        nodes = torch.arange(n, device=b.device)
        onehot = ((b[..., None] == nodes) & claimed[..., None]).to(torch.float32)
        return onehot.sum(dim=1) / float(pol.slots)

    @staticmethod
    def sync_utilization(table, node_utils, amounts=None):
        return d.sync_utilization(table, node_utils, amounts)
