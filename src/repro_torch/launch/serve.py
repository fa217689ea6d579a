"""Serving launcher: the XBOF harvesting runtime layer.

Port of `run_runtime_layer` of `repro.launch.serve`: N data-parallel
replicas under skewed arrivals, redirecting overload through the unified
`core.manager` round. The model-zoo prefill/decode part of the reference
launcher comes with the model-zoo slice.

  PYTHONPATH=src python -m repro_torch.launch.serve --replicas 4
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.serving import engine as E


def run_runtime_layer(n_replicas: int, steps: int = 12, device=None) -> dict:
    """Skewed-load demo of the batched harvesting engine on ``device``
    (CUDA when None). Prints the rate and the harvesting counters and
    returns them."""
    dev = resolve_device(device)
    cfg = E.EngineConfig(n_replicas=n_replicas)
    state = E.init(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    arrivals = torch.zeros(n_replicas, dtype=torch.int32, device=dev)
    arrivals[0] = 5
    arrivals[1] = 1
    # warmup step so the printed rate is steady-state, not first-call setup
    state, stats = E.step(cfg, state, arrivals, generator=gen)
    redirected = stats["redirected"].clone()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, stats = E.step(cfg, state, arrivals, generator=gen)
        redirected += stats["redirected"]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    out = dict(redirected=int(redirected),
               offsite_pages=int(stats["offsite_pages"]),
               wal_commits=int(stats["log_commits"]),
               utils=[round(float(u), 2) for u in stats["util"]])
    print(f"runtime layer: {n_replicas} replicas x {steps} steps on "
          f"{dev.type} in {dt:.2f}s ({steps / dt:.1f} steps/s)")
    print(f"  redirected={out['redirected']} "
          f"offsite_pages={out['offsite_pages']} "
          f"wal_commits={out['wal_commits']} utils={out['utils']}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    run_runtime_layer(args.replicas, args.steps, device=args.device)


if __name__ == "__main__":
    main()
