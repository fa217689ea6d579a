#!/usr/bin/env python3
"""The RG-LRU backward at recurrentgemma-9b's training shape, the
checkout's build beside an earlier one, on one GPU.

    python3 scripts/rglru_bwd_bench.py [--parent PATH.cu] [--variant NAME=PATH.cu ...]
        [--shapes NAME ...] [--rounds 1] [--profile] [--train]

Builds the checkout's `csrc/rglru_scan_bwd.cu`, ``--parent`` (an earlier
source of the same C entry, `xbof_rglru_bwd` and its workspace query,
e.g. a parent commit's unpacked with `git archive` into a directory that
.gitignore lists:

    --parent _checkout/parent/src/repro_torch/kernels/csrc/rglru_scan_bwd.cu

) and each ``--variant`` (a copy edited to try a change, say) side by
side with the kernels' nvcc flags (`chip_smoke.bench_builds`), prints
each build's ptxas report (registers and spills of each kernel
instantiation), and has the wrapper `rglru_scan.rglru_bwd` launch each
build in turn (`_build.use`).
Shapes (inputs from seed 26 as `chip_smoke.bwd_row`'s: a = 1 on a
quarter of the elements, x = 0 on half of those, unless named):
``train`` a microbatch of `train_recurrentgemma_9b`
(`chip_smoke.RGLRU_BWD_TRAIN`, [1, 4096, 4096], bf16, no h0),
``train_fp32`` the same in fp32, ``h0`` the same in bf16 from an initial
state, ``sigmoid`` the train shape with a = sigmoid(N(0, 1)) everywhere
(no |a| = 1, so no sqrt of 0 and no division by 0). Per shape and build:
the gradients against the plain gradient value for value
(`chip_smoke.scan_bwd_check`), a repeated call equal bit for bit, and
the workspace's bytes; then per round the builds walked forward and back
(`chip_smoke.walk`: parent, change, change, parent for two), each timed
spun (`chip_smoke.spun_ms`, 5 launches after an L2 flush). Prints the
card's name and power limit, a `build` line, a `check` line per shape
and build, a `run` line per (round, shape, build) and last a `summary`
line: per shape and build the mean ms, the bound (the larger of
`chip_smoke.scan_bwd_work`'s bytes at 3.35 TB/s and its fp32 operations
at 67 TFLOP/s, as `chip_smoke.bwd_row`) and `of_bound`. With
``--profile``, a `profile` line per shape and build: one call's CUDA
kernels under `torch.profiler` (`chip_smoke.profile_kernels`: the
launches, each kernel's device ms; the checkout's chains and groups).
With ``--train``, then `train_recurrentgemma_9b`'s model
(recurrentgemma-9b at `chip_smoke.TRAIN_FAMILIES`' 3 layers, batch 2 x
4096 in 2 microbatches, weights from seed 0) takes one train step with
each build to warm up, then per round one `chip_smoke.train_split`
(forward / backward / optimizer ms between CUDA events) per build in the
same walk, from the same state and batch
(`chip_smoke.bench_train_walk`): a `train` line each and last a
`train_summary` line, per build the mean of each stage. Needs a CUDA
device and nvcc.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

B, T, W = cs.RGLRU_BWD_TRAIN
# (dtype, h0, a's kind as `chip_smoke.scan_inputs` draws it)
SHAPES = {"train": (torch.bfloat16, False, "one-x0"),
          "train_fp32": (torch.float32, False, "one-x0"),
          "h0": (torch.bfloat16, True, "one-x0"),
          "sigmoid": (torch.bfloat16, False, "sigmoid")}
KERNELS = "rglru_bwd_chains|rglru_bwd_groups|rglru_bwd_kernel"
PHASE = "train_recurrentgemma_9b"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier rglru_scan_bwd.cu (the same C entry)")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=PATH.cu: another source of the same C entry")
    ap.add_argument("--shapes", nargs="+", default=["train"], choices=list(SHAPES))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--train", action="store_true",
                    help=f"time {PHASE}'s split with each build, in the same walk")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("rglru_bwd_bench: needs a CUDA device")
    from repro_torch.kernels import _build
    from repro_torch.kernels import rglru_scan as rg
    print(cs.card_line(), flush=True)
    # every build with the kernels' nvcc flags, side by side, for its ptxas rows
    sources = {**({"parent": args.parent} if args.parent else {}),
               "change": str(_build.CSRC / "rglru_scan_bwd.cu"),
               **dict(v.split("=", 1) for v in args.variant)}
    built, seconds = cs.bench_builds(sources, KERNELS, "rglru_bwd_bench")
    build = {"seconds": seconds, **{f"{name}_ptxas": rows for name, (_, rows) in built.items()}}
    libs = {name: lib for name, (lib, _) in built.items()}
    print(json.dumps({"build": build}), flush=True)

    def through(lib):
        def call(*a):
            _build.use("rglru_scan_bwd", lib)
            return rg.rglru_bwd(*a)
        return call
    calls = {name: through(lib) for name, lib in libs.items()}

    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB > L2
    inputs, times, summary = {}, {}, {}
    for label in args.shapes:
        dtype, h0, kind = SHAPES[label]
        x = cs.scan_bwd_inputs("rglru", (B, T, W, h0, kind), dtype, 26, dev)
        form = "fp32" if dtype == torch.float32 else "bf16"
        for name, call in calls.items():
            got, again = call(*x), call(*x)
            torch.cuda.synchronize()
            gate = cs.scan_bwd_check("rglru", form, x, got)
            same = cs.same_bits(tuple(g for g in got if g is not None),
                                tuple(g for g in again if g is not None))
            ws = libs[name].xbof_rglru_bwd_workspace(B, T, W) * 4
            print(json.dumps({"check": {"shape": label, "build": name, **gate,
                                        "repeat_equal": same, "workspace_bytes": ws}}),
                  flush=True)
            if not (gate["ok"] and same):
                sys.exit(f"rglru_bwd_bench: build {name} fails its gate on {label}")
            del got, again
        inputs[label] = x
    for rnd, name in cs.walk(list(calls), args.rounds):
        for label in args.shapes:
            x = inputs[label]
            ms, spin_ms, host_ms, attempts = cs.spun_ms(
                f"{name} {label}", lambda: calls[name](*x), 5, flush)
            times.setdefault((label, name), []).append(ms)
            print(json.dumps({"run": {"round": rnd, "shape": label, "build": name, "ms": ms,
                                      "spin_ms": spin_ms, "host_ms_max": host_ms,
                                      "spun_attempts": attempts}}), flush=True)
    if args.profile:
        for label in args.shapes:
            for name, call in calls.items():
                launched, rows = cs.profile_kernels(lambda: call(*inputs[label]))
                print(json.dumps({"profile": {"shape": label, "build": name,
                                              "launched": launched, "kernels": rows}}),
                      flush=True)
    for label in args.shapes:
        nbytes, flops = cs.scan_bwd_work("rglru", inputs[label][0])
        bound = max(1e3 * nbytes / cs.HBM_BPS, 1e3 * flops / cs.FP32_FLOPS)
        for name in calls:
            ms = sum(times[(label, name)]) / len(times[(label, name)])
            summary[f"{label}/{name}"] = {"ms": ms, "runs": times[(label, name)],
                                          "bound_ms": bound, "of_bound": bound / ms}
    print(json.dumps({"summary": summary}), flush=True)
    if args.train:
        del inputs, flush
        cs.bench_train_walk(libs, "rglru_scan_bwd", PHASE, args.rounds, dev)


if __name__ == "__main__":
    main()
