#!/usr/bin/env python3
"""Where a step of the port's serving engine spends its time, on one GPU.

    python3 scripts/torch_engine_profile.py [--quant int8 --link-pages 4] \\
        [--n-shards 4 --shards-per-enclosure 2] [--trace-driven] [--obs] \\
        [--track-failures] [--migrate 4]

Runs `repro_torch.serving.engine.step` at the configuration `chip_smoke.py`
drives (its FULL_WIDTH and ARRIVALS: qwen3-14b attention width, 8
replicas, arrivals [16, 4, 0, ...]), with one shard or the hierarchical
engine (``--n-shards``, ``--shards-per-enclosure``), with the telemetry
plane (``--trace-driven``), the observability plane (``--obs``: rings
of 32 windows, a log of 4096 rows, as `chip_smoke.py`'s obs phase) and the
failure plane (``--track-failures``: the dead-replica masks, no replica
dead; ``--migrate N``: the reclaim predictor and the drain of up to N
pages a step, which runs every step whatever it moves). After 6 steps of
warm-up and sync checks it profiles steps 7 .. 6 + N (N = --steps) and
reports, all from that one window:

- wall ms per step: host clock around the window, from a synchronize to a
  synchronize, with the profiler recording host and device activity;
- device-busy ms per step and the idle share (1 - busy / wall): the summed
  duration of the CUDA kernels `torch.profiler` records in the window, on
  the one stream the step uses;
- kernels launched per step, in all and by stage (below), and the
  kernels that take most device time;
- device ms and host ms per step for each stage of the step, from
  `torch.profiler.record_function` ranges this script wraps around the
  engine's functions: the management round (`round`), route (`route`),
  the exchange across shards (`exchange`), admission (`admit`), the KV
  pool's append (`append`), the paged-attention kernel
  (`paged_attention`), release and the offsite scan (`release`), the
  decode layer's products and the int8 read-back (`decode`), the shard
  layout (`layout`), the telemetry plane (`telemetry`: the SHARDS window
  with its decay, the want), the SHARDS window kernel alone
  (`shards_window`), the obs plane's record (`obs_record`, the engine's
  own range: rings and the event append), the reclaim predictor
  (`reclaim`), the drain (`drain`: `kv_pool.drain_offsite`, whole-pool
  page copy included) and the rest of the step
  (`step`: the LINK_BW account, the spill budget, the stats). Each is
  exclusive of the labelled
  ranges nested in it, as in `torch_model_profile.py`;
- host syncs inside the step: the warnings `torch.cuda.set_sync_debug_mode`
  raises over 2 steps (the step is meant to have none);
- for comparison, the wall ms per step of the next N steps run without the
  profiler.

Prints the card's name and power limit, then one JSON line. Needs a CUDA
device.
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

import torch

ROOT = Path(__file__).resolve().parents[1]


def engine_stages(E, mgr, ops, kvp) -> tuple:
    """(module, function, stage) for each function of the engine step a
    stage is named for (`scripts/torch_engine_ops.py` counts by them too);
    the rest of the step is the stage `step`."""
    return ((mgr.ResourceManager, "round", "round"), (E, "_route", "route"),
            (E, "_exchange", "exchange"), (E, "_admit", "admit"),
            (kvp, "append_tokens", "append"),
            (ops, "paged_attention", "paged_attention"),
            (kvp, "release_sequences", "release"), (kvp, "offsite_pages", "release"),
            (E, "_decode_all", "decode"), (E, "_to_shards", "layout"),
            (E, "_from_shards", "layout"),
            (E.tele_win, "update_window", "telemetry"),
            (E.tele_want, "want_entries", "telemetry"),
            (ops, "shards_window", "shards_window"),
            (E.tele_reclaim, "update", "reclaim"), (kvp, "drain_offsite", "drain"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quant", default="none", choices=["none", "int8"])
    ap.add_argument("--link-pages", type=int, default=0)
    ap.add_argument("--n-shards", type=int, default=1)
    ap.add_argument("--shards-per-enclosure", type=int, default=0)
    ap.add_argument("--trace-driven", action="store_true")
    ap.add_argument("--obs", action="store_true")
    ap.add_argument("--track-failures", action="store_true")
    ap.add_argument("--migrate", type=int, default=0)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_engine_profile: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import ARRIVALS, FULL_WIDTH
    from repro_torch.core import manager as mgr
    from repro_torch.kernels import ops
    from repro_torch.serving import engine as E
    from repro_torch.serving import kv_pool as kvp
    from torch_model_profile import _label, _split

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    cfg = E.EngineConfig(**FULL_WIDTH, kv_quant=args.quant,
                         link_pages_per_step=args.link_pages,
                         n_shards=args.n_shards,
                         shards_per_enclosure=args.shards_per_enclosure,
                         trace_driven=args.trace_driven,
                         obs=E.obs_m.ObsConfig(enabled=args.obs, ring_depth=32,
                                               event_capacity=4096),
                         track_failures=args.track_failures,
                         migrate_pages_per_step=args.migrate)
    state = E.init(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    arrivals = torch.tensor(ARRIVALS, dtype=torch.int32, device=dev)

    stages = {"round", "route", "exchange", "admit", "append",
              "paged_attention", "release", "decode", "layout", "step",
              "telemetry", "shards_window", "obs_record", "reclaim", "drain"}
    for module, attr, label in (*engine_stages(E, mgr, ops, kvp),
                                (E, "_shard_step", "step")):
        _label(module, attr, label)

    def run(n):
        nonlocal state
        for _ in range(n):
            state, _ = E.step(cfg, state, arrivals, generator=gen)

    run(4)  # warm-up: the kernel build and load, cuBLAS handles
    torch.cuda.synchronize()

    # host syncs inside the step
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run(2)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "called a synchronizing" in str(w.message)]

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall_ms = timed(args.steps)
    wall_unprofiled_ms = timed(args.steps)
    counts = {}
    device_ms, host_ms, busy, n_kernels, top = _split(prof, stages, counts)
    per = args.steps
    out = {
        "config": {"kv_quant": args.quant, "link_pages_per_step": args.link_pages,
                   "n_shards": args.n_shards,
                   "shards_per_enclosure": args.shards_per_enclosure,
                   "trace_driven": args.trace_driven, "obs": args.obs,
                   "track_failures": args.track_failures,
                   "migrate_pages_per_step": args.migrate, "steps": args.steps},
        "window": f"steps 7..{6 + args.steps}",
        "wall_ms_per_step": wall_ms,
        "wall_ms_per_step_unprofiled": wall_unprofiled_ms,
        "device_busy_ms_per_step": busy / per if n_kernels else "not measured",
        "device_idle_share": (1.0 - busy / per / wall_ms) if n_kernels else "not measured",
        "kernels_per_step": n_kernels / per,
        "kernels_by_stage": {k: v / per for k, v in sorted(counts.items())},
        "device_ms_by_stage": {k: v / per for k, v in sorted(device_ms.items())},
        "host_ms_by_stage": {k: v / per for k, v in sorted(host_ms.items())},
        "top_kernels": [{"name": name[:80], "ms_per_step": ms / per,
                         "launches_per_step": n / per}
                        for name, (ms, n) in top],
        "host_syncs_in_2_steps": len(syncs),
        "host_sync_sites": sorted(collections.Counter(syncs).items()),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
