"""Shared engine scenarios and the loops that drive them, checking an
invariant every step (DESIGN.md §8).

Port of the link-account part of `repro.serving.scenarios`: the
unified-LINK_BW-account scenario (`link_account_scenario` +
`drive_link_account`). Replica 0 is memory-full (the §4.5 spill source);
replica 1 sits just past the lend watermark, so it keeps its own link
allowance for §4.4 redirect commands — two debit flows, one account type,
conservation asserted every step.

The failure/reclaim scenario (`failover_scenario`, `drive_events`) needs
the failure plane (`core.events`, `engine.fail_replica`) and moves with
that later slice.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.core import costs
from . import engine as E

# replica 1 sits just past the 0.75 lend watermark (~78% HBM) but below
# the 0.98 borrow gate — it neither pledges its link allowance away nor
# gets its redirects vetoed
LEND_WATERMARK_FILL = 0.78125


def link_account_scenario(link_pages: int = 1, page: int = 2,
                          quant: str = "none", *, device=None,
                          ) -> tuple[E.EngineConfig, E.EngineState]:
    """(cfg, state) on ``device`` (CUDA when None) for the two-flow
    LINK_BW account scenario. Pools are big enough that the redirect
    source (replica 1) never trips the HBM-pressure gate on its own
    sequences; replica 0 is pre-filled full with long-lived page-hungry
    sequences, so decode spills every step. ``quant="int8"`` runs the same
    flows over quantized KV pages."""
    cfg = E.EngineConfig(
        n_replicas=4, seq_slots=4, shadow_slots=4,
        pages_per_replica=32, page=page, kv_heads=2, head_dim=8,
        max_pages=8, link_pages_per_step=link_pages, kv_quant=quant)
    state = E.init(cfg, device=device)
    pool = state.pool
    keep = int(cfg.pages_per_replica * LEND_WATERMARK_FILL)
    used, active = pool.used.clone(), pool.seq_active.clone()
    used[0] = True
    used[1, :keep] = True
    active[0, : cfg.seq_slots] = True
    remaining = state.remaining.clone()
    remaining[0, : cfg.seq_slots] = 64
    state = state._replace(pool=pool._replace(used=used, seq_active=active),
                           remaining=remaining)
    return cfg, state


class LinkAccountRun(NamedTuple):
    redirect_bytes: float   # cumulative §4.4 command debits, all replicas
    spill_bytes: float      # cumulative §4.5 spill-page debits
    budget_bytes: float     # cumulative published byte budgets
    cmd_saturated: bool     # some step left replica 1 < one command of headroom
    saw_redirect: bool
    saw_spill: bool


def drive_link_account(cfg: E.EngineConfig, state: E.EngineState,
                       arrivals_fn: Callable[[int], object],
                       steps: int) -> LinkAccountRun:
    """Drive ``steps`` engine steps, enforcing the account invariant on
    every one: per replica, redirect-command bytes + spill-page bytes must
    not exceed the LINK_BW byte budget (own + borrowed − lent). Raises
    RuntimeError on a violation. Reads each step's stats back to the host
    (a loop around the step, not part of it)."""
    cmd_b = float(costs.REDIRECT_CMD_BYTES)
    red = spill = budget = 0.0
    cmd_saturated = saw_redirect = saw_spill = False
    for i in range(steps):
        state, st = E.step(cfg, state, arrivals_fn(i))
        b = st["link_budget_bytes"].cpu().numpy()
        r = st["link_redirect_bytes"].cpu().numpy()
        s = st["link_spill_bytes"].cpu().numpy()
        if not (r + s <= b + 1e-5).all() or (r < -1e-9).any() \
                or (s < -1e-9).any():
            raise RuntimeError(
                f"LINK_BW account violated at step {i}: "
                f"redirect {r} + spill {s} > budget {b}")
        cmd_saturated |= bool((b[1] > 0) and (r[1] > b[1] - cmd_b))
        saw_redirect |= bool(r.sum() > 0)
        saw_spill |= bool(s.sum() > 0)
        red += float(r.sum())
        spill += float(s.sum())
        budget += float(b.sum())
    return LinkAccountRun(red, spill, budget, cmd_saturated,
                          saw_redirect, saw_spill)
