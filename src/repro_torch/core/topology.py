"""Topology plane: ONE hierarchical exchange for node → enclosure → fabric.

Port of `repro.core.topology`. Full descriptor machinery runs inside a
local pool; aggregate (spare, want) summaries then settle level by level —
pool ↔ pool inside an enclosure, enclosure ↔ enclosure across the fabric —
nearest level first: level 1 settles each innermost group internally, only
the unmet residuals spill to level 2, and so on outward. Every level's
grants come back separately, so a caller prices each at its own tier
(`core.costs.LEVEL_EXTRA_HOPS`). Every participant computes the identical
per-level grant matrices from the same summaries: determinism replacing
CAS at every level of the tree (DESIGN.md §3, §11).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import manager as mgr

# canonical level names, innermost boundary first
LEVEL_NAMES = ("node", "enclosure", "fabric")


class Topology(NamedTuple):
    """Spec of the exchange tree above the leaves.

    ``group_sizes``: members per group at each exchange level, innermost
    first; prod(group_sizes) must equal the leaf count. ``tiers``: the
    `costs.LEVEL_EXTRA_HOPS` tier each exchange level prices at (defaults
    to level + 1).
    """

    group_sizes: tuple[int, ...]
    tiers: tuple[int, ...] = ()

    @property
    def depth(self) -> int:
        """Levels including the leaf-local round."""
        return 1 + len(self.group_sizes)

    @property
    def n_leaves(self) -> int:
        return math.prod(self.group_sizes)

    def level_tier(self, level: int) -> int:
        if self.tiers:
            return self.tiers[level]
        return level + 1

    def level_name(self, level: int) -> str:
        t = self.level_tier(level)
        return (LEVEL_NAMES[t] if t < len(LEVEL_NAMES)
                else f"fabric+{t - len(LEVEL_NAMES) + 1}")

    def validate(self, n: int) -> "Topology":
        if not self.group_sizes:
            raise ValueError("Topology needs at least one exchange level")
        if any(g < 1 for g in self.group_sizes):
            raise ValueError(f"group sizes must be >= 1: {self.group_sizes}")
        if self.n_leaves != n:
            raise ValueError(
                f"topology covers {self.n_leaves} leaves "
                f"(group_sizes={self.group_sizes}) but got {n}")
        if self.tiers and len(self.tiers) != len(self.group_sizes):
            raise ValueError(
                f"tiers {self.tiers} must match group_sizes "
                f"{self.group_sizes} in length")
        return self


def flat(n: int) -> Topology:
    """One exchange level over all n leaves."""
    return Topology(group_sizes=(n,))


def two_level(inner: int, outer: int) -> Topology:
    """Settle within enclosures of ``inner`` leaves first, then across
    ``outer`` enclosures."""
    return Topology(group_sizes=(inner, outer))


def _block_exchange(spare, want, overhead, block: int) -> mgr.Settled:
    """One exchange level at leaf resolution: settle within each contiguous
    block of ``block`` leaves (the last axis). Grants come back [..., N, N]
    block-diagonal. A single all-covering block is `manager.shard_exchange`
    itself; otherwise the blocks run as one batch over a block axis (the
    reference vmaps over it)."""
    n = spare.shape[-1]
    g = n // block
    if g == 1:
        return mgr.settle(spare, want, overhead)
    lead = spare.shape[:-1]
    out = mgr.settle(spare.reshape(*lead, g, block),
                      want.reshape(*lead, g, block), overhead)
    eye = torch.eye(g, dtype=torch.bool, device=spare.device)
    # full[a, i, b, j] = grants[a, i, j] where a == b, else 0
    full = torch.where(eye[:, None, :, None], out.grants[..., :, :, None, :], 0.0)
    return mgr.Settled(full.reshape(*lead, n, n),
                        *(x.reshape(*lead, n) for x in out[1:]))


def hierarchical_exchange(spare: torch.Tensor, want: torch.Tensor,
                          topo: Topology, overheads: tuple | None = None,
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Settle per-leaf (spare, want) summaries level by level, nearest
    level first.

    ``spare`` / ``want``: float32[N] post-local-round leftovers per leaf.
    ``overheads``: per-level fractional hop taxes, one per level of
    ``topo`` (zero at every level when None).

    Returns ``(grants, received)``: grants float32[L, N, N] per-level
    lender × borrower matrices (level l block-diagonal at its group span)
    and received float32[L, N] per-level usable units at each leaf. A leaf
    never both lends and borrows: netting zeroes one side at the first
    level, and each later level sees only the shrunken residuals.
    """
    spare = spare.to(torch.float32)
    want = want.to(torch.float32)
    topo.validate(spare.shape[-1])
    if overheads is None:
        overheads = (0.0,) * len(topo.group_sizes)
    if len(overheads) != len(topo.group_sizes):
        raise ValueError(
            f"need one overhead per level: got {len(overheads)} for "
            f"{len(topo.group_sizes)} levels")
    grants_l, recv_l = [], []
    sp, wt = spare, want
    block = 1
    for gsize, oh in zip(topo.group_sizes, overheads):
        block *= gsize
        out = _block_exchange(sp, wt, oh, block)
        grants_l.append(out.grants)
        recv_l.append(out.received)
        # residuals for the next (outer) level: netting first, then what
        # this level moved
        sp = torch.clamp(out.spare_net - mgr.seq_sum(out.grants), min=0.0)
        wt = torch.clamp(out.want_left, min=0.0)
    return torch.stack(grants_l), torch.stack(recv_l)


class RoundResult(NamedTuple):
    """What `hierarchical_round` hands back to a substrate."""

    tables: object             # leaf-local tables after the local rounds
    grants: torch.Tensor       # [L, N, N] per-level exchange grants
    received: torch.Tensor     # [L, N] per-level usable units per leaf
    lent: torch.Tensor         # [N] total units drawn from each leaf
    spare_resid: torch.Tensor  # [N] spare left after every level settled
    want_resid: torch.Tensor   # [N] want left after every level settled


def hierarchical_round(manager: mgr.ResourceManager, tables, inputs,
                       spare: torch.Tensor, want: torch.Tensor,
                       topo: Topology, overheads: tuple | None = None,
                       ) -> RoundResult:
    """Full local `ResourceManager.round()` at every leaf, then the
    per-level settlement of the (spare, want) leftovers.

    ``tables``: the leaves' descriptor tables stacked on a leading [N]
    axis; ``inputs``: the per-rtype `RoundInputs`, leading [N] axis on
    every tensor. The round takes the leaf axis as a leading table axis
    (one sweep over node positions for all leaves); ``spare`` / ``want``
    settle through `hierarchical_exchange`."""
    new_tables = manager.round(tables, inputs)
    grants, received = hierarchical_exchange(spare, want, topo, overheads)
    # per lender: levels, then borrowers, in row-major order
    lent = mgr.seq_sum(grants.permute(1, 0, 2).reshape(grants.shape[1], -1))
    spare_net = torch.clamp(spare - want, min=0.0)
    want_net = torch.clamp(want - spare, min=0.0)
    return RoundResult(
        tables=new_tables,
        grants=grants,
        received=received,
        lent=lent,
        spare_resid=torch.clamp(spare_net - lent, min=0.0),
        want_resid=torch.clamp(want_net - mgr.seq_sum(received.T), min=0.0),
    )


def invalidate_block_grants(grants: torch.Tensor, dead: torch.Tensor,
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """A leaf dropping off the fabric invalidates exactly its block's
    standing cross-level grants (§4.3 invalidation one level up).

    ``grants``: [L, N, N]; ``dead``: bool[N]. Every grant a dead leaf lends
    (its rows) or borrows (its columns) zeroes at every level; grants
    between surviving leaves are untouched. Returns ``(grants,
    released)``, released the total units invalidated (float32 scalar;
    zero when re-applied to an already drained block)."""
    dead = dead.to(torch.bool)
    kill = dead[None, :, None] | dead[None, None, :]
    released = torch.where(kill, grants, 0.0).sum()
    return torch.where(kill, 0.0, grants), released
