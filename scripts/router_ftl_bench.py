#!/usr/bin/env python3
"""The MoE top-k router and FTL lookup kernels on their main-path inputs,
one or more builds of each side by side, on one GPU.

    python3 scripts/router_ftl_bench.py [--kernel NAME=PATH.cu ...] [--rounds 1]

With no --kernel, measures the checkout's
`src/repro_torch/kernels/csrc/moe_router.cu` and `ftl_lookup.cu`. Each
--kernel names a source of either kernel (told apart by its file name,
`moe_router.cu` or `ftl_lookup.cu`; same C entry as the checkout's), for
example a parent commit's, unpacked with `git archive` into a directory
that .gitignore lists:

    --kernel parent=_checkout/parent/src/repro_torch/kernels/csrc/moe_router.cu
    --kernel parent=_checkout/parent/src/repro_torch/kernels/csrc/ftl_lookup.cu
    --kernel change=src/repro_torch/kernels/csrc/moe_router.cu
    --kernel change=src/repro_torch/kernels/csrc/ftl_lookup.cu

Every source is built at once with nvcc (the flags of `kernels/_build.py`,
`chip_smoke.bench_builds`) into `kernels/build/bench/`, and its ptxas
report printed (registers and spills of each instantiation). The kernel
wrappers (`kernels/moe_router.py`, `kernels/ftl_lookup.py`) then launch
each build in turn (`_build.use`). Per round the builds are walked
forward, then backward (`chip_smoke.walk`: parent, change, change, parent
for two), on:

- the router's four main-path shapes, scores from a seed: DeepSeek-v2's
  prefill [4096, 160] and decode [4, 160] (a softmax, k = 6, no bias) and
  DeepSeek-v3's prefill [4096, 256] and decode [4, 256] (a sigmoid plus
  a bias of scale 0.1, k = 8), as `chip_smoke.py`'s DeepSeek runs give
  the router at batch 4, prompt 1024;
- the FTL burst of `chip_smoke.ftl_phase` (`chip_smoke.ftl_burst`: 2^20
  LPNs, 1862 segments, 1.95 GB of mapping pages).

Each gives `ms` (`chip_smoke.timed_ms`: events around the wrapper after
an L2 flush) and `ms_spun` (`chip_smoke.timed_spun_ms`: a spin kernel
ahead of the start event keeps the wrapper's host time out of the window;
the run fails when that host time outlasts the spin), the router's
indices against the plain version (exact) and its weights within 1e-6,
the FTL result against the plain version bit for bit, whether a second
call gives the same bits, and whether the outputs equal the FIRST build's
bit for bit (`first_equal`; weights included, so with the parent first
this compares each build's weights with the parent kernel's). Each run
also times `floor_ms`, the spun time of one trivial launch
(`torch.cuda._sleep(1)`), and gives every input's `over_floor`, ms_spun
over that run's floor_ms. Once per call: `gather_ms`, the spun time of
one PyTorch gather (`index_select`) of the burst's hit entries from the
mapping cache, the card's rate for random 32-byte sectors (a yardstick:
it does not compute the lookup).

Prints the card's name and power limit, a `build` JSON line per source,
a `yardsticks` line, a `run` line per (round, build), and last a
`summary` line: per build and input the mean `ms`, `ms_spun` and
`floor_ms` over the rounds, every run's `over_floor` and its spread, the
bound (bytes at 3.35 TB/s, or for the router's fp32 operations at 67
TFLOP/s if larger: `chip_smoke.router_bound`; the FTL's 9 B per LPN, the
directory once and 4 B per hit: `chip_smoke.ftl_bytes`), `of_bound`
(bound / ms_spun) and `of_bound_floor` (max(bound, mean floor_ms) /
ms_spun); the FTL also its bound with a 32-byte sector per gather
(`sector_bound_ms`). Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
KERNELS = ("moe_router", "ftl_lookup")
# (label, tokens, experts, k, sigmoid scores with a bias)
ROUTER_INPUTS = [("v2_prefill", 4096, 160, 6, False), ("v2_decode", 4, 160, 6, False),
                 ("v3_prefill", 4096, 256, 8, True), ("v3_decode", 4, 256, 8, True)]


def router_inputs(t, e, sigmoid, seed, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    logits = torch.randn((t, e), generator=g)
    if sigmoid:
        return torch.sigmoid(logits).to(dev), (torch.randn((e,), generator=g) * 0.1).to(dev)
    return torch.softmax(logits, -1).to(dev), None


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", action="append", default=[],
                    help="NAME=PATH of a moe_router.cu or ftl_lookup.cu to build and time")
    ap.add_argument("--rounds", type=int, default=1,
                    help="forward-then-backward walks over the builds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("router_ftl_bench: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ftl_lookup as fk
    from repro_torch.kernels import moe_router as mr

    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    sources = {}
    for spec in args.kernel:
        name, path = spec.split("=", 1)
        kernel = Path(path).stem
        if kernel not in KERNELS:
            sys.exit(f"router_ftl_bench: {path} is neither moe_router.cu nor ftl_lookup.cu")
        sources[kernel, name] = Path(path).resolve()
    for kernel in KERNELS:
        if not any(k == kernel for k, _ in sources):
            sources[kernel, "checkout"] = CSRC / f"{kernel}.cu"
    built, seconds = cs.bench_builds(sources, "router_kernel|ftl_kernel", "router_ftl_bench")
    for (kernel, name), (_, ptxas) in built.items():
        print(json.dumps({"build": {"kernel": kernel, "name": name,
                                    "source": str(sources[kernel, name]),
                                    "seconds_all": seconds, "ptxas": ptxas}}), flush=True)
    names = {kernel: [n for k, n in built if k == kernel] for kernel in KERNELS}
    if names["moe_router"] != names["ftl_lookup"]:
        sys.exit(f"router_ftl_bench: give both kernels the same build names: {names}")
    order = names["moe_router"]

    def use(name):
        for kernel in KERNELS:
            _build.use(kernel, built[kernel, name][0])

    # the inputs, their plain results and bounds
    inputs = {label: (router_inputs(t, e, sig, i, dev), k)
              for i, (label, t, e, k, sig) in enumerate(ROUTER_INPUTS)}
    lpns, directory, cache, entries = cs.ftl_burst(dev)
    want = {label: ref.topk_router(s, k, bias=b) for label, ((s, b), k) in inputs.items()}
    want_ftl = ref.ftl_lookup(lpns, directory, cache, entries)
    hits = int(want_ftl[1].sum())
    bounds = {label: cs.router_bound(*s.shape, k, b is not None)[0]
              for label, ((s, b), k) in inputs.items()}
    bounds["ftl"] = 1e3 * cs.ftl_bytes(lpns.numel(), directory.numel(), hits) / cs.HBM_BPS
    sector_bound = 1e3 * cs.ftl_bytes(lpns.numel(), directory.numel(), hits,
                                      per_gather=32) / cs.HBM_BPS
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB > L2
    flat = cs.ftl_hit_positions(lpns, directory, entries)
    gather_ms = cs.spun_ms("gather", lambda: cache.view(-1).index_select(0, flat), 20, flush)[0]
    del flat
    print(json.dumps({"yardsticks": {"gather_ms": gather_ms,
                                     "ftl_hits": hits, "ftl_sector_bound_ms": sector_bound}}),
          flush=True)

    calls = {label: (lambda s=s, b=b, k=k: mr.topk_router(s, k, bias=b))
             for label, ((s, b), k) in inputs.items()}
    calls["ftl"] = lambda: fk.ftl_lookup(lpns, directory, cache, entries)
    first = {}
    runs = []
    for rnd, name in cs.walk(order, args.rounds):
        use(name)
        floor_ms = cs.launch_floor_ms(flush)
        row = {"round": rnd, "name": name, "floor_ms": floor_ms, "inputs": {}}
        for label, fn in calls.items():
            got, again = fn(), fn()
            torch.cuda.synchronize()
            if label == "ftl":
                ok = torch.equal(got[0], want_ftl[0]) and torch.equal(got[1], want_ftl[1])
                err = 0.0
            else:
                err, _, ok = cs.router_compare(got, want[label])
            first.setdefault(label, got)
            ms = cs.timed_ms(fn, 20, flush)
            ms_spun, spin_ms, host_ms, attempts = cs.spun_ms(f"{name} {label}", fn, 50,
                                                             flush)
            row["inputs"][label] = dict(
                ms=ms, ms_spun=ms_spun, spin_ms=spin_ms, host_ms_max=host_ms,
                spun_attempts=attempts,
                over_floor=ms_spun / floor_ms, max_abs_err=err, ok=ok,
                repeat_equal=cs.same_bits(got, again),
                first_equal=cs.same_bits(got, first[label]))
        print(json.dumps({"run": row}), flush=True)
        runs.append(row)
    summary = {}
    mean = lambda xs: sum(xs) / len(xs)
    for name in order:
        mine = [r for r in runs if r["name"] == name]
        floor_ms = mean([r["floor_ms"] for r in mine])
        summary[name] = {"floor_ms": floor_ms, "floor_ms_runs": [r["floor_ms"] for r in mine]}
        for label in calls:
            ms_spun = mean([r["inputs"][label]["ms_spun"] for r in mine])
            over = [r["inputs"][label]["over_floor"] for r in mine]
            summary[name][label] = {
                "ms": mean([r["inputs"][label]["ms"] for r in mine]), "ms_spun": ms_spun,
                "over_floor_runs": over, "over_floor_min": min(over),
                "over_floor_max": max(over), "bound_ms": bounds[label],
                "of_bound": bounds[label] / ms_spun,
                "of_bound_floor": max(bounds[label], floor_ms) / ms_spun,
                "ok": all(r["inputs"][label]["ok"] and r["inputs"][label]["repeat_equal"]
                          for r in mine),
                "first_equal": all(r["inputs"][label]["first_equal"] for r in mine)}
        summary[name]["ftl"]["sector_bound_ms"] = sector_bound
        summary[name]["ftl"]["of_gather_ms"] = summary[name]["ftl"]["ms_spun"] / gather_ms
    print(json.dumps({"summary": summary, "gather_ms": gather_ms, "order": order}),
          flush=True)
    bad = [(name, label) for name, v in summary.items() for label in calls
           if not (v[label]["ok"] and v[label]["first_equal"])]
    if bad:
        sys.exit(f"router_ftl_bench: disagrees with the plain version, does not repeat "
                 f"bit for bit, or differs from the first build: {bad}")


if __name__ == "__main__":
    main()
