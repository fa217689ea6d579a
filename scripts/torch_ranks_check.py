#!/usr/bin/env python3
"""The port's multi-rank paths on one GPU, alone: `chip_smoke.py`'s
phases 2r (the engine's sharded step on 2 and on 4 ranks against one
process, `engine_ranks_phase`; deepseek-v2's sequence-sharded MLA decode
on 2 and on 4 ranks, `mla_ranks_phase`), each rank a spawned process of
one gloo group on the one card, after the kernels' build.

    python3 scripts/torch_ranks_check.py [--only engine|mla]

Prints the card line and one JSON line per phase; exits non-zero when a
phase fails. The ranks' times are a check of values (gloo stages CUDA
tensors through the host), no figure for NCCL or for several cards.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("engine", "mla"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False: this check needs a CUDA device")
    from repro_torch.kernels import _build
    from repro_torch.serving import engine as E
    dev = torch.device("cuda", 0)
    print(chip_smoke.card_line(), flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    if args.only in (None, "engine"):
        for phase in chip_smoke.RANK_PHASES:
            t0 = time.perf_counter()
            line = chip_smoke.engine_ranks_phase(E, phase, dev)
            print(json.dumps({phase: line, "phase_s": time.perf_counter() - t0}), flush=True)
    if args.only in (None, "mla"):
        t0 = time.perf_counter()
        line = chip_smoke.mla_ranks_phase(dev)
        print(json.dumps({"mla_seq_sharded_v2": line,
                          "phase_s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"ok": True, "card": chip_smoke.card_line()}), flush=True)


if __name__ == "__main__":
    main()
