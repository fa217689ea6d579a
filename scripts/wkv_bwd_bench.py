#!/usr/bin/env python3
"""The WKV backward at rwkv6-3b's training shape, the checkout's build
beside an earlier one, on one GPU.

    python3 scripts/wkv_bwd_bench.py [--parent PATH.cu] [--variant NAME=PATH.cu ...]
        [--shapes NAME ...] [--rounds 1] [--profile] [--train]

Builds the checkout's `csrc/rwkv6_scan_bwd.cu`, ``--parent`` (an earlier
source of the same C entry, `xbof_rwkv6_wkv_bwd` and its workspace
query, e.g. a parent commit's unpacked with `git archive` into a
directory that .gitignore lists:

    --parent _checkout/parent/src/repro_torch/kernels/csrc/rwkv6_scan_bwd.cu

) and each ``--variant`` (a copy edited to try a change, say) side by
side with the kernels' nvcc flags (`chip_smoke.bench_builds`), prints
each build's ptxas report (registers and spills of each kernel
instantiation), and has the wrapper `rwkv6_scan.rwkv6_wkv_bwd` launch
each build in turn (`_build.use`).
Shapes (inputs from seed 26 as `chip_smoke.bwd_row`'s, "main" decays
near e^-1 as rwkv6-3b's): ``train`` a microbatch of `train_rwkv6_3b`
(`chip_smoke.WKV_BWD_TRAIN`, [1, 4096, 40, 64], bf16, no s0),
``train_fp32`` the same in fp32, ``state`` the same in bf16 from an
initial state with a final-state cotangent. Per shape and build: the
gradients against the plain gradient under `chip_smoke.WKV_BWD_TOL`
(`chip_smoke.scan_bwd_check`), a repeated call equal bit for bit, and
the workspace's bytes (a build that fails either check stops the bench
before any timing); then per round the builds walked forward and back
(`chip_smoke.walk`: parent, change, change, parent for two), each timed
spun (`chip_smoke.spun_ms`, 5 launches after an L2 flush). Prints the
card's name and power limit, a `build` line, a `check` line per shape
and build, a `run` line per (round, shape, build) and last a `summary`
line: per shape and build the mean ms, the bound (the larger of
`chip_smoke.scan_bwd_work`'s bytes at 3.35 TB/s and its fp32 operations
at 67 TFLOP/s, as `chip_smoke.bwd_row`) and `of_bound`. With
``--profile``, a `profile` line per shape and build: one call's CUDA
kernels under `torch.profiler` (`chip_smoke.profile_kernels`: the
launches, each kernel's device ms; the checkout's chains, groups and
du's sum). With ``--train``, then `train_rwkv6_3b`'s model (rwkv6-3b at
`chip_smoke.TRAIN_FAMILIES`' 8 layers, batch 2 x 4096 in 2 microbatches,
weights from seed 0) takes one train step with each build to warm up,
then per round one `chip_smoke.train_split` (forward / backward /
optimizer ms between CUDA events) per build in the same walk, from the
same state and batch (`chip_smoke.bench_train_walk`): a `train` line
each and last a `train_summary` line, per build the mean of each stage.
Needs a CUDA device and nvcc.
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

B, T, H, K = cs.WKV_BWD_TRAIN
# (dtype, s0 and a final-state cotangent)
SHAPES = {"train": (torch.bfloat16, False), "train_fp32": (torch.float32, False),
          "state": (torch.bfloat16, True)}
KERNELS = "wkv_bwd_chains|wkv_bwd_groups|wkv_bwd_du_kernel|wkv_bwd_kernel|wkv_bwd_sum_kernel"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier rwkv6_scan_bwd.cu (the same C entry)")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=PATH.cu: another source of the same C entry")
    ap.add_argument("--shapes", nargs="+", default=["train"], choices=list(SHAPES))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--train", action="store_true",
                    help="time train_rwkv6_3b's split with each build, in the same walk")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("wkv_bwd_bench: needs a CUDA device")
    from repro_torch.kernels import _build
    from repro_torch.kernels import rwkv6_scan as wkv
    print(cs.card_line(), flush=True)
    # every build with the kernels' nvcc flags, side by side, for its ptxas rows
    sources = {**({"parent": args.parent} if args.parent else {}),
               "change": str(_build.CSRC / "rwkv6_scan_bwd.cu"),
               **dict(v.split("=", 1) for v in args.variant)}
    built, seconds = cs.bench_builds(sources, KERNELS, "wkv_bwd_bench")
    build = {"seconds": seconds, **{f"{name}_ptxas": rows for name, (_, rows) in built.items()}}
    libs = {name: lib for name, (lib, _) in built.items()}
    print(json.dumps({"build": build}), flush=True)

    def through(lib):
        def call(*a):
            _build.use("rwkv6_scan_bwd", lib)
            return wkv.rwkv6_wkv_bwd(*a)
        return call
    calls = {name: through(lib) for name, lib in libs.items()}

    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB > L2
    inputs, times, summary = {}, {}, {}
    for label in args.shapes:
        dtype, state = SHAPES[label]
        x = cs.scan_bwd_inputs("rwkv6_wkv", (B, T, H, K, state, "main"), dtype, 26, dev)
        form = "fp32" if dtype == torch.float32 else "bf16"
        for name, call in calls.items():
            got, again = call(*x), call(*x)
            torch.cuda.synchronize()
            gate = cs.scan_bwd_check("rwkv6_wkv", form, x, got)
            same = cs.same_bits(tuple(g for g in got if g is not None),
                                tuple(g for g in again if g is not None))
            ws = libs[name].xbof_rwkv6_wkv_bwd_workspace(B, T, H, K) * 4
            print(json.dumps({"check": {"shape": label, "build": name, **gate,
                                        "repeat_equal": same, "workspace_bytes": ws}}),
                  flush=True)
            if not (gate["ok"] and same):
                sys.exit(f"wkv_bwd_bench: build {name} fails its gate on {label}")
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
        nbytes, flops = cs.scan_bwd_work("rwkv6_wkv", inputs[label][0])
        bound = max(1e3 * nbytes / cs.HBM_BPS, 1e3 * flops / cs.FP32_FLOPS)
        for name in calls:
            ms = sum(times[(label, name)]) / len(times[(label, name)])
            summary[f"{label}/{name}"] = {"ms": ms, "runs": times[(label, name)],
                                          "bound_ms": bound, "of_bound": bound / ms}
    print(json.dumps({"summary": summary}), flush=True)
    if args.train:
        del inputs, flush
        cs.bench_train_walk(libs, "rwkv6_scan_bwd", "train_rwkv6_3b", args.rounds, dev)


if __name__ == "__main__":
    main()
