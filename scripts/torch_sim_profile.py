#!/usr/bin/env python3
"""Where a window of the port's JBOF simulator spends its time, on one GPU.

    python3 scripts/torch_sim_profile.py [--windows 20]

Runs `repro_torch.jbof.sim` on the configurations of `chip_smoke.py`'s
three simulator phases: `sim_jbof12` on XBOF and XBOF+ (fig. 9's JBOF,
static), `sim_trace8_obs` (fig. 20, trace-driven with the observability
plane) and `sim_fleet4096` federated (fig. 22's 4096 SSDs in 256
enclosures). For each, after a warm-up run of the same windows and a sync
check, it profiles the first N windows (N = --windows; the management
round runs on windows 0 and 10) and reports, all from that one run:

- wall ms per window: host clock around the run, from a synchronize to a
  synchronize, with the profiler recording host and device activity; and
  the same windows run again without the profiler;
- device-busy ms per window and the idle share (1 - busy / wall);
- kernels per window, in all and by stage, and per management window;
- device ms and host ms per window for each stage, from
  `torch.profiler.record_function` ranges: the management round
  (`round`, `ResourceManager.round`), the telemetry plane (`telemetry`:
  the trace's segment addresses, the decay, the curve and the want), the
  SHARDS window kernel alone (`shards_window`), the obs plane's record
  (`obs_record`: rings and the event append), the fabric level
  (`fabric_exchange`) and the rest of a window (`sim_mgmt_window` and
  `sim_window`: arrivals, demand, the transfers, service, accounting).
  Each is exclusive of the labelled ranges nested in it, as in
  `torch_model_profile.py`;
- host syncs inside the window loop: the warnings
  `torch.cuda.set_sync_debug_mode` raises over the warm-up run (the loop
  is meant to have none).

Prints the card's name and power limit, then one JSON line per phase.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def phases(P, W, T, obs_m, S):
    """(name, platform, workloads, arrivals, SimConfig) of each profiled
    configuration, from chip_smoke's constants."""
    from chip_smoke import SIM_FLEET, SIM_JBOF12, SIM_TRACE8
    c = SIM_JBOF12
    wls = [W.micro(True, c["io_kb"])] * c["busy"] + [W.idle()] * c["idle"]
    arr = W.arrivals(wls, c["windows"], seed=c["seed"])
    out = [(f"sim_jbof12[{p}]", P.ALL[p](), wls, arr, S.SimConfig(warmup=c["warmup"]))
           for p in ("XBOF", "XBOF+")]
    c = SIM_TRACE8
    n = c["windows"]
    wls = ([W.micro(True, 4.0, qd=8, random_access=True)] * c["busy"]
           + [W.idle()] * c["idle"])
    sched = [T.phase_change(n, c["burst"][0], c["burst"][1],
                            T.segments(c["ws_burst_segments"]),
                            T.segments(c["ws_base_segments"]), c["refs"])
             for _ in range(c["busy"])] + [[]] * c["idle"]
    out.append(("sim_trace8_obs", P.xbof(dram_frac=c["dram_frac"]), wls,
                W.arrivals(wls, n, seed=c["seed"]),
                S.SimConfig(traces=T.synth_trace(n, sched, c["refs"], seed=c["seed"] + 1),
                            obs=obs_m.ObsConfig(enabled=True, ring_depth=c["ring_depth"],
                                                event_capacity=c["event_capacity"]))))
    c = SIM_FLEET
    n = c["ssds"]
    e = n // c["per_enclosure"]
    n_busy = (e // 2) * c["per_enclosure"]
    wls = ([W.micro(read=False, io_kb=4, qd=4, random_access=True)] * n_busy
           + [W.micro(read=True, io_kb=128, qd=1)] * (n - n_busy))
    arr = np.zeros((c["windows"], n, 2), np.float32)
    arr[:, :n_busy, 1] = c["busy_bps"] * 1e-3
    arr[:, n_busy:, 0] = c["idle_bps"] * 1e-3
    out.append(("sim_fleet4096", P.xbof()._replace(fabric_extra_hops=c["extra_hops"]),
                wls, arr, S.SimConfig(warmup=c["warmup"], n_enclosures=e)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_sim_profile: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import dataclasses

    from repro_torch.core import manager as mgr
    from repro_torch.jbof import platforms as P
    from repro_torch.jbof import sim as S
    from repro_torch.jbof import workloads as W
    from repro_torch.kernels import ops
    from repro_torch.obs import metrics as obs_m
    from repro_torch.telemetry import traces as T
    from torch_model_profile import _label, _split

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    for module, attr, label in (
            (mgr.ResourceManager, "round", "round"),
            (ops, "shards_window", "shards_window")):
        _label(module, attr, label)
    stages = {"round", "telemetry", "shards_window", "obs_record", "fabric_exchange",
              "sim_mgmt_window", "sim_window"}
    nw = args.windows
    for name, plat, wls, arr, cfg in phases(P, W, T, obs_m, S):
        step = S._window_step

        def labelled(run, state, a, t, i, fabric=None, _step=step, _plat=plat):
            kind = "sim_mgmt_window" if i % _plat.mgmt_interval == 0 else "sim_window"
            with torch.profiler.record_function(kind):
                return _step(run, state, a, t, i, fabric)

        cfg = dataclasses.replace(cfg, traces=None if cfg.traces is None
                                  else cfg.traces[:nw])
        prep = lambda: S.prepare(plat, wls, arr[:nw], cfg, device=dev)  # noqa: E731
        # warm-up, with the sync check
        p = prep()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                S.run_prepared(p)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
                 if "called a synchronizing" in str(w.message)]

        def timed(p):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            S.run_prepared(p)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / nw

        p = prep()
        S._window_step = labelled
        try:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                wall_ms = timed(p)
        finally:
            S._window_step = step
        wall_unprofiled_ms = timed(prep())
        counts = {}
        device_ms, host_ms, busy, n_kernels, top = _split(prof, stages, counts)
        n_mgmt = sum(1 for i in range(nw) if i % plat.mgmt_interval == 0)
        print(json.dumps({
            "phase": name,
            "config": {"ssds": int(np.asarray(arr).shape[1]),
                       "enclosures": cfg.n_enclosures,
                       "trace_driven": cfg.traces is not None,
                       "obs": cfg.obs.enabled, "windows": nw,
                       "mgmt_windows": n_mgmt},
            "wall_ms_per_window": wall_ms,
            "wall_ms_per_window_unprofiled": wall_unprofiled_ms,
            "device_busy_ms_per_window": busy / nw if n_kernels else "not measured",
            "device_idle_share": (1.0 - busy / nw / wall_ms) if n_kernels else "not measured",
            "kernels_per_window": n_kernels / nw,
            "kernels_per_mgmt_window_round": counts.get("round", 0) / n_mgmt,
            "kernels_per_mgmt_window_rest": counts.get("sim_mgmt_window", 0) / n_mgmt,
            "kernels_per_window_rest": counts.get("sim_window", 0) / max(nw - n_mgmt, 1),
            "kernels_by_stage_per_window": {k: v / nw for k, v in sorted(counts.items())},
            "device_ms_by_stage_per_window": {k: v / nw for k, v in sorted(device_ms.items())},
            "host_ms_by_stage_per_window": {k: v / nw for k, v in sorted(host_ms.items())},
            "top_kernels": [{"name": k[:80], "ms_per_window": ms / nw,
                             "launches_per_window": c / nw}
                            for k, (ms, c) in top],
            "host_syncs_in_warmup": len(syncs),
            "host_sync_sites": sorted(collections.Counter(syncs).items()),
        }), flush=True)


if __name__ == "__main__":
    main()
