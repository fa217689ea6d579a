#!/usr/bin/env python3
"""Where a step of the port's serving engine spends its time, on one GPU.

    python3 scripts/torch_engine_profile.py [--quant int8 --link-pages 4]

Runs `repro_torch.serving.engine.step` at the configuration `chip_smoke.py`
drives (its FULL_WIDTH and ARRIVALS: qwen3-14b attention width, 8
replicas, arrivals [16, 4, 0, ...]). After 6 steps of warm-up and sync
checks it profiles steps 7 .. 6 + N (N = --steps) and reports, all from
that one window:

- wall ms per step: host clock around the window, from a synchronize to a
  synchronize, with the profiler recording device activity only;
- device-busy ms per step and the idle share (1 - busy / wall): the summed
  duration of the CUDA kernels `torch.profiler` records in the window, on
  the one stream the step uses;
- kernels launched per step, and the kernels that take most device time;
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quant", default="none", choices=["none", "int8"])
    ap.add_argument("--link-pages", type=int, default=0)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_engine_profile: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import ARRIVALS, FULL_WIDTH
    from repro_torch.serving import engine as E

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    cfg = E.EngineConfig(**FULL_WIDTH, kv_quant=args.quant,
                         link_pages_per_step=args.link_pages)
    state = E.init(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    arrivals = torch.tensor(ARRIVALS, dtype=torch.int32, device=dev)

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

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall_ms = timed(args.steps)
    wall_unprofiled_ms = timed(args.steps)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    busy_ms = sum(v[0] for v in by_name.values()) / args.steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    out = {
        "config": {"kv_quant": args.quant, "link_pages_per_step": args.link_pages,
                   "steps": args.steps},
        "window": f"steps 7..{6 + args.steps}",
        "wall_ms_per_step": wall_ms,
        "wall_ms_per_step_unprofiled": wall_unprofiled_ms,
        "device_busy_ms_per_step": busy_ms if kernels else "not measured",
        "device_idle_share": (1.0 - busy_ms / wall_ms) if kernels else "not measured",
        "kernels_per_step": len(kernels) / args.steps,
        "top_kernels": [{"name": name[:80], "ms_per_step": ms / args.steps,
                         "launches_per_step": n / args.steps}
                        for name, (ms, n) in top],
        "host_syncs_in_2_steps": len(syncs),
        "host_sync_sites": sorted(collections.Counter(syncs).items()),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
