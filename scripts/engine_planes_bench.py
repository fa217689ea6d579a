#!/usr/bin/env python3
"""The engine's ms per step with and without its telemetry and
observability planes, in turns within one process, on one GPU.

    python3 scripts/engine_planes_bench.py [--rounds 2] \\
        [--pair fp32,trace_fp32] \\
        [--pair enclosure4_int8_metered,trace_enclosure4_int8_metered_obs]

Each --pair names two phases of `chip_smoke.PHASES` (default: the two
above, each plane-free phase beside its trace-driven counterpart). Per
round the pair is walked forward, then backward (`chip_smoke.walk`: A, B,
B, A), so a drift of the host or the card over the run falls on both
alike. Each visit is one `chip_smoke.engine_phase`: a warm-up, then 3
runs of 32 steps at FULL_WIDTH under the sync check, held to the
reference's counts and the kernels' launches; its median ms per step (host
clock from a synchronize to a synchronize) and spread are printed, then
per pair the ratio B / A of the medians of every visit.

Prints the card's name and power limit, one JSON line per visit, one
`summary` line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PAIRS = ("fp32,trace_fp32",
         "enclosure4_int8_metered,trace_enclosure4_int8_metered_obs")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--pair", action="append")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("engine_planes_bench: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving import engine as E

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    summary = {}
    for pair in args.pair or PAIRS:
        names = pair.split(",")
        if len(names) != 2 or any(n not in cs.PHASES for n in names):
            sys.exit(f"engine_planes_bench: --pair needs two of {sorted(cs.PHASES)}")
        medians = {n: [] for n in names}
        for rnd, name in cs.walk(names, args.rounds):
            line, _ = cs.engine_phase(E, pa, name, dev)
            medians[name].append(line["ms_per_step"])
            print(json.dumps({"round": rnd, "phase": name,
                              "ms_per_step": line["ms_per_step"],
                              "ms_per_step_spread": line["ms_per_step_spread"],
                              "launches": line["launches"],
                              "shards_window_launches": line["shards_window_launches"]}),
                  flush=True)
        a, b = (statistics.median(medians[n]) for n in names)
        summary[pair] = {"medians": medians, "ratio": b / a}
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
