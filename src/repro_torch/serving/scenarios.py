"""Shared engine scenarios and the loops that drive them, checking an
invariant every step (DESIGN.md §8, §13).

Port of `repro.serving.scenarios`:

  * the unified-LINK_BW-account scenario (`link_account_scenario` +
    `drive_link_account`): replica 0 is memory-full (the §4.5 spill
    source); replica 1 sits just past the lend watermark, so it keeps its
    own link allowance for §4.4 redirect commands — two debit flows, one
    account type, conservation asserted every step;

  * the failure/reclaim scenario (`failover_scenario` + `drive_events`):
    borrowers spill KV pages onto a lender, then a `core.events` schedule
    — the same typed schedule `jbof.sim` consumes — kills the lender, with
    or without a hot-remove warning. `drive_events` applies dead transitions
    through `engine.fail_replica`, models LENDER_RECLAIM as a rising
    host-pinned fill of the lender's pool (what the reclaim predictor
    watches), and accounts sequences end to end, so fig. 23's gates (zero
    lost sequences, a smaller spike when predicted) come from one code
    path.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import costs
from repro_torch.core import events as ev_m
from repro_torch.obs import metrics as obs_m
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


def failover_scenario(migrate: int = 0, obs: bool = False, events: bool = False,
                      *, device=None) -> tuple[E.EngineConfig, E.EngineState]:
    """(cfg, state) on ``device`` (CUDA when None) for the lender-crash
    scenario of fig. 23. Replicas 0 and 1 are borrowers whose 16-token
    sequences need 4 pages each — four active slots want 16 pages of a
    12-page pool, so about 4 pages per borrower spill, split between the
    two idle lenders. Replica 2 takes the crash; replica 3 survives and is
    where the predictor-driven drain re-homes 2's pages (the borrowers'
    own pools are full when the warning lands, so the WAL-logged move goes
    lender to lender).

    ``migrate`` is the per-step drain allowance (0: the unpredicted run);
    ``obs`` turns the metric rings on (how `drive_events` reports
    ``migrated_pages``); ``events`` reserves event-log capacity."""
    cfg = E.EngineConfig(
        n_replicas=4, seq_slots=4, shadow_slots=2,
        pages_per_replica=12, page=4, kv_heads=2, head_dim=8,
        max_pages=4, link_pages_per_step=8,
        track_failures=True, migrate_pages_per_step=migrate,
        obs=obs_m.ObsConfig(enabled=True, ring_depth=256,
                            event_capacity=512 if events else 64)
        if obs else obs_m.ObsConfig())
    return cfg, E.init(cfg, device=device)


class FailoverRun(NamedTuple):
    """End-to-end accounting of one event-scheduled engine run."""

    completed: int        # sequences admitted AND decoded to completion
    aborted: int          # dead replicas' own sequences (client gone)
    requeued: int         # hosted sequences bounced back to their home
    lost_tokens: int      # KV tokens truncated off crashed lenders
    lost_sequences: int   # sequences neither completed nor aborted — the
                          # zero-loss gate (stuck in flight at drain end)
    revoked: int          # descriptor rows invalidated by failures
    seq_steps: int        # sum over steps of active sequences — the
                          # latency integral the spike gates compare
    migrated_pages: int   # WAL-committed drain moves (0 unless cfg.obs)
    drained: bool         # system fully emptied within the settle window


def drive_events(cfg: E.EngineConfig, state: E.EngineState,
                 sched: ev_m.EventSchedule,
                 arrivals_fn: Callable[[int], np.ndarray], steps: int,
                 settle: int = 96, ramp: int = 4) -> FailoverRun:
    """Drive the engine under a `core.events` schedule and account every
    sequence.

    Host-side, between steps (each step itself reads nothing back):
    SSD_FAIL / SSD_HOT_REMOVE dead transitions apply through
    `engine.fail_replica` (which refuses ``n_shards > 1``); ENCLOSURE_DROP
    maps an enclosure to a shard and fails every replica in it; the
    LENDER_RECLAIM stream is the lender's own load returning — a
    host-pinned fill of its free pages rising to the full pool over
    ``ramp`` steps (owner_seq stays -1, so the pins are invisible to
    sequence accounting), released when the stream clears. That is the
    utilization signal the reclaim predictor watches, so a hot-remove's
    warning gives ``migrate_pages_per_step`` something to act on. Each
    step's arrivals are copied to the device before the step, and its
    ``active`` and ``queued`` read back after it.

    After the scheduled window `drive_events` feeds zero arrivals for up to
    ``settle`` extra steps so requeued and re-decoding sequences can
    finish; a sequence still in flight then counts as lost."""
    n = cfg.n_replicas
    nl = E.local_replicas(cfg)
    dev = state.queue.device
    reclaim_s, dead_s, drop_s = ev_m.render(sched, max(steps, 1), n,
                                            n_enclosures=max(cfg.n_shards, 1))
    # enclosure == shard on the serving side: a fabric drop takes every
    # replica of the shard with it
    dead_s = dead_s | np.repeat(drop_s, nl, axis=1)

    prev_dead = np.zeros((n,), bool)
    pinned = np.zeros((n, cfg.pages_per_replica), bool)
    chunk = -(-cfg.pages_per_replica // ramp)

    total_arrivals = 0
    aborted = requeued = lost_tokens = revoked = seq_steps = 0
    active = queued = 0
    drained = False
    for t in range(steps + settle):
        if t < steps:
            for r in np.nonzero(dead_s[t] & ~prev_dead)[0]:
                state, rep = E.fail_replica(cfg, state, int(r))
                aborted += rep.aborted
                requeued += rep.requeued
                lost_tokens += rep.lost_tokens
                revoked += rep.revoked
                pinned[r] = False
            prev_dead |= dead_s[t]
            act = reclaim_s[t] & ~prev_dead
        else:
            act = np.zeros((n,), bool)
        if act.any() or pinned.any():
            used = state.pool.used.cpu().numpy()
            for r in range(n):
                if act[r]:
                    # the lender's own load ramping back: pin another
                    # chunk of its free pages each reclaim window
                    free = np.nonzero(~used[r])[0][:chunk]
                    used[r, free] = True
                    pinned[r, free] = True
                elif pinned[r].any():
                    used[r] &= ~pinned[r]
                    pinned[r] = False
            state = state._replace(pool=state.pool._replace(
                used=torch.from_numpy(used).to(dev)))
        arr = np.zeros((n,), np.int64)
        if t < steps:
            arr = np.where(prev_dead, 0, np.asarray(arrivals_fn(t)))
            total_arrivals += int(arr.sum())
        arr_t = torch.from_numpy(arr.astype(np.int32)).to(dev)
        state, st = E.step(cfg, state, arr_t)
        active, queued = int(st["active"]), int(st["queued"])
        seq_steps += active
        if t >= steps and active == 0 and queued == 0:
            drained = True
            break

    in_flight = 0 if drained else active + queued
    migrated = 0
    if cfg.obs.enabled:
        migrated = int(E.obs_totals(state)["migrated_pages"].sum())
    return FailoverRun(
        completed=total_arrivals - aborted - in_flight,
        aborted=aborted, requeued=requeued, lost_tokens=lost_tokens,
        lost_sequences=in_flight, revoked=revoked, seq_steps=seq_steps,
        migrated_pages=migrated, drained=drained)
