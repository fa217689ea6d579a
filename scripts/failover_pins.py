#!/usr/bin/env python3
"""Recompute `chip_smoke.py`'s FAILOVER pins with the JAX reference, on the
CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/failover_pins.py [--heads N KV D]

For each failover phase: the reference engine (`repro.serving.engine`) at
the phase's configuration (FULL_WIDTH, or its geometry with ``--heads``
attention heads, KV heads and head dim), the lender holding the most
offsite pages after the crash window's steps under ARRIVALS, then
`repro.serving.scenarios.drive_events` under the phase's schedule. Prints
one JSON line per phase: the offsite pages per lender, the target, and
the FailoverRun, which must equal the phase's pin. Unmetered, the counts
depend on the pool's geometry only; metered, also on a page's bytes
(KV heads x head dim).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--heads", type=int, nargs=3, metavar=("N", "KV", "D"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import jax
    import jax.numpy as jnp
    from chip_smoke import ARRIVALS, FAILOVER, FULL_WIDTH, STEPS
    from repro.core import events as EV
    from repro.obs import metrics as obs_m
    from repro.serving import engine as E
    from repro.serving import scenarios as SC

    width = dict(FULL_WIDTH)
    if args.heads:
        width.update(n_heads=args.heads[0], kv_heads=args.heads[1],
                     head_dim=args.heads[2])
    for phase, (extra, (kind, t, target), lead, expect) in FAILOVER.items():
        if "obs" in extra:
            extra = {**extra, "obs": obs_m.ObsConfig(**extra["obs"])}
        cfg = E.EngineConfig(**width, **extra)
        state = E.init(cfg, jax.random.key(0))
        for _ in range(t):
            state, _ = E.step(cfg, state, jnp.asarray(ARRIVALS, jnp.int32))
        pt = np.asarray(state.pool.page_table)
        owner = np.where(pt >= 0, pt // cfg.pages_per_replica, -1)
        homes = np.arange(cfg.n_replicas)[:, None, None]
        held = [int(((owner == l) & (homes != l)).sum()) for l in range(cfg.n_replicas)]
        run = SC.drive_events(
            cfg, E.init(cfg, jax.random.key(0)),
            EV.schedule(getattr(EV, kind)(t, int(np.argmax(held))), reclaim_lead=lead),
            lambda _: np.asarray(ARRIVALS), STEPS)
        print(json.dumps({"phase": phase, "width": width, "offsite_by_lender": held,
                          "target": int(np.argmax(held)), "run": run._asdict(),
                          "equals_pin": run._asdict() == expect and
                          int(np.argmax(held)) == target}), flush=True)


if __name__ == "__main__":
    main()
