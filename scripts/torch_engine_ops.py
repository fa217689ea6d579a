#!/usr/bin/env python3
"""Count the tensor operations one step of the port's serving engine runs,
on the CPU path: the prediction of its kernels a step on the card, where
each operation launches about one kernel.

    PYTHONPATH=src python3 scripts/torch_engine_ops.py [--quant int8 --link-pages 4] \\
        [--n-shards 4 --shards-per-enclosure 2] [--trace-driven] [--obs] \\
        [--track-failures] [--migrate 4]

Runs `repro_torch.serving.engine.step` on the CPU at `chip_smoke.py`'s
FULL_WIDTH and ARRIVALS (the flags as `torch_engine_profile.py` takes
them), 6 steps of warm-up, then counts the operations of step 7 with a
`TorchDispatchMode`, leaving out views (which launch nothing). Each is
counted in the innermost stage it ran in — the stages of
`torch_engine_profile.py`'s profile (`engine_stages`: `round`, `append`,
`drain`, ...), `step` for the rest — and the most frequent operations are
listed.
Prints one JSON line. Needs no GPU.
"""
from __future__ import annotations

import argparse
import collections
import functools
import json
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
# aten operations that only make a view: no kernel
VIEWS = {"view", "_unsafe_view", "expand", "reshape", "unsqueeze", "squeeze",
         "select", "slice", "t", "transpose", "permute", "alias", "detach",
         "as_strided", "unbind", "split", "lift_fresh"}


class Count(TorchDispatchMode):
    def __init__(self, stages):
        super().__init__()
        self.stages = stages
        self.by_stage = collections.Counter()
        self.by_op = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name not in VIEWS:
            self.by_stage[self.stages[-1]] += 1
            self.by_op[name] += 1
        return func(*args, **(kwargs or {}))


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
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    from chip_smoke import ARRIVALS, FULL_WIDTH
    from torch_engine_profile import engine_stages
    from repro_torch.core import manager as mgr
    from repro_torch.kernels import ops
    from repro_torch.serving import engine as E
    from repro_torch.serving import kv_pool as kvp

    cfg = E.EngineConfig(**FULL_WIDTH, kv_quant=args.quant,
                         link_pages_per_step=args.link_pages,
                         n_shards=args.n_shards,
                         shards_per_enclosure=args.shards_per_enclosure,
                         trace_driven=args.trace_driven,
                         obs=E.obs_m.ObsConfig(enabled=args.obs, ring_depth=32,
                                               event_capacity=4096),
                         track_failures=args.track_failures,
                         migrate_pages_per_step=args.migrate)
    stages = ["step"]

    def label(module, attr, name):
        fn = getattr(module, attr)

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            stages.append(name)
            try:
                return fn(*a, **kw)
            finally:
                stages.pop()

        setattr(module, attr, wrapped)

    for module, attr, name in engine_stages(E, mgr, ops, kvp):
        label(module, attr, name)

    state = E.init(cfg, device="cpu")
    arrivals = torch.tensor(ARRIVALS, dtype=torch.int32)
    gen = torch.Generator().manual_seed(7)
    for _ in range(6):
        state, _ = E.step(cfg, state, arrivals, generator=gen)
    counter = Count(stages)
    with counter:
        E.step(cfg, state, arrivals, generator=gen)
    print(json.dumps({
        "config": vars(args), "device": "cpu (a count, not a time)",
        "operations": sum(counter.by_stage.values()),
        "by_stage": dict(sorted(counter.by_stage.items())),
        "top_operations": counter.by_op.most_common(12)}))


if __name__ == "__main__":
    main()
