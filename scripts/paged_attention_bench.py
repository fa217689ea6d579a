#!/usr/bin/env python3
"""The paged decode-attention kernel on the serving engine's main-path
inputs, one or more builds of it side by side, on one GPU.

    python3 scripts/paged_attention_bench.py \\
        [--kernel NAME=PATH.cu ...] [--one-warp NAME] [--rounds 1]

With no --kernel, measures the checkout's
`src/repro_torch/kernels/csrc/paged_attention.cu`. Each --kernel names a
source with the same C entry (`xbof_paged_attention`), for example a
parent commit's, unpacked with `git archive` into a directory that
.gitignore lists:

    --kernel parent=_checkout/parent/src/repro_torch/kernels/csrc/paged_attention.cu
    --kernel change=src/repro_torch/kernels/csrc/paged_attention.cu

`--one-warp NAME` adds a build `NAME_nw1`: a copy of NAME's source with
`kUnitsPerSm = 0`, so every unit runs on one warp (the split of a unit's
tokens over 2 or 4 warps turned off), to time the split where it is
taken.

Each source is built with nvcc (the flags of `kernels/_build.py`, all
builds at once: `chip_smoke.bench_builds`) into `kernels/build/bench/`,
and its ptxas report printed (registers and spills of each
instantiation). The kernel wrapper (`kernels/paged_attention.py`) then
launches each build in turn (`_build.use`). `serving.engine.step` runs at `chip_smoke.py`'s FULL_WIDTH
(qwen3-14b's attention width, 8 replicas) for its two phases, fp32
unmetered and int8 at 4 link pages a step, through
`chip_smoke.engine_phase` (the reference's counts, one launch a step and
no host sync are required); the inputs of the last step, captured from
the first build's run, are the main-path inputs that every build is timed
on. Per round the builds are walked forward, then backward (parent,
change, change, parent for two: `chip_smoke.walk`), and each gives:

- the engine's ms per step in both phases (host clock, STEPS steps);
- per form: fp32; bf16 (the fp32 inputs cast); int8; fp32 with the main
  path's pools under two synthetic tables, `fp32_all_idle` (every row of
  length 0, all holes) and `fp32_all_one_page` (every row one page of 16
  tokens); and few long rows, where the kernel splits a unit's tokens over
  warps: `fp32_long_8` and `fp32_long_40` (the first 8 or 40 rows of q,
  each 16 distinct pages of 16 tokens, no holes) and `int8_long_40` from
  the int8 phase's pools: `ms` (`chip_smoke.timed_ms`: events around the
  wrapper after an L2 flush, the earlier method), `ms_spun`
  (`chip_smoke.timed_spun_ms`: a spin kernel ahead of the start event
  keeps the wrapper's host time out of the window; the form fails when
  that host time outlasts the spin), the max abs error against the plain
  version (gates of chip_smoke.TOL, bf16 relative to max |want|) and
  whether a second call gives the same bits.

Prints the card's name and power limit, a `build` JSON line per source, a
`run` line per (round, build), a `write_rate` line, and last a `summary`
line: per build and form the mean `ms` and `ms_spun` over the rounds,
the bound (chip_smoke's `work`: bytes at 3.35 TB/s or fp32 operations at
67 TFLOP/s, whichever is larger) and `of_bound` (bound / ms_spun), and
the engine's mean ms per step. `write_rate` times torch's fill
(`zero_`) of fp32 tensors of 1, 4 and 16 times out's bytes with
`timed_spun_ms` and fits ms = fixed + bytes / rate by least squares: the
slope is the card's write rate, the intercept the fixed cost of a
launch. Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "paged_attention.cu"


def write_rate(cs, like, flush) -> dict:
    """torch's fill of 1, 4 and 16 times ``like``'s bytes; the least-squares
    line ms = fixed_ms + bytes / bytes_per_s through the three times."""
    sizes, times = [], []
    for mult in (1, 4, 16):
        sink = torch.empty(mult * like.numel(), dtype=torch.float32, device=like.device)
        ms, spin_ms, host_ms = cs.timed_spun_ms(lambda: sink.zero_(), 20, flush)
        if host_ms >= spin_ms:
            sys.exit(f"paged_attention_bench: fill's host time {host_ms} ms "
                     f"outlasted the spin {spin_ms} ms")
        sizes.append(sink.numel() * 4)
        times.append(ms)
        del sink
    mx, my = sum(sizes) / 3, sum(times) / 3
    slope = (sum((x - mx) * (y - my) for x, y in zip(sizes, times))
             / sum((x - mx) ** 2 for x in sizes))
    return {"bytes": sizes, "ms": times, "bytes_per_s": 1e3 / slope,
            "fixed_ms": my - slope * mx}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", action="append", default=[],
                    help="NAME=PATH of a paged_attention.cu to build and time")
    ap.add_argument("--one-warp", action="append", default=[],
                    help="NAME of a --kernel to build again with one warp a unit")
    ap.add_argument("--rounds", type=int, default=1,
                    help="forward-then-backward walks over the builds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("paged_attention_bench: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving import engine as E

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    sources = dict(k.split("=", 1) for k in args.kernel) or {"checkout": str(SOURCE)}
    sources = {name: Path(p).resolve() for name, p in sources.items()}
    out_dir = _build.BUILD_DIR / "bench"   # ignored by git, as the kernels' builds
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in args.one_warp:
        text = sources[name].read_text()
        rule = "constexpr int kUnitsPerSm = 2 * kWarpsPerSm;"
        if rule not in text:
            sys.exit(f"paged_attention_bench: {sources[name]} has no `{rule}`")
        copy = out_dir / f"{name}_nw1.cu"
        copy.write_text(text.replace(rule, "constexpr int kUnitsPerSm = 0;"))
        sources[f"{name}_nw1"] = copy
    built, seconds = cs.bench_builds(sources, "paged_decode_kernel", "paged_attention_bench")
    for name, (_, ptxas) in built.items():
        print(json.dumps({"build": {"name": name, "source": str(sources[name]),
                                    "seconds_all": seconds, "ptxas": ptxas}}), flush=True)

    def use(name):
        _build.use("paged_attention", built[name][0])

    # the main path's inputs, from the first build's engine run
    use(next(iter(built)))
    inputs = {phase: cs.engine_phase(E, pa, phase, dev)[1]["paged_attention"]
              for phase in cs.PHASES}
    (fp_args, _), (i8_args, i8_kw) = inputs["fp32"], inputs["int8_metered"]
    forms = {"fp32": (list(fp_args), {}),
             "bf16": ([a.bfloat16() for a in fp_args[:3]] + list(fp_args[3:]), {}),
             "int8": (list(i8_args), dict(i8_kw))}
    # the main path's pools under synthetic tables: every row of length 0
    # with an all-hole table; every row one page of 16 tokens (page b mod
    # P); and few rows of mp full pages (row b: pages mp * b .. mp * b +
    # mp - 1 mod P), where the kernel splits a unit's tokens over warps
    q, k, v, table, lengths = fp_args
    n_rows, mp = table.shape
    n_pages, page = k.shape[:2]
    rows = torch.arange(n_rows, device=dev, dtype=table.dtype)
    one = torch.full_like(table, -1)
    one[:, 0] = rows % n_pages
    full = (rows[:, None] * mp + torch.arange(mp, device=dev, dtype=table.dtype)) % n_pages
    forms["fp32_all_idle"] = ([q, k, v, torch.full_like(table, -1),
                               torch.zeros_like(lengths)], {})
    forms["fp32_all_one_page"] = ([q, k, v, one, torch.full_like(lengths, page)], {})
    long_len = torch.full_like(lengths, mp * page)
    for n in (8, 40):
        forms[f"fp32_long_{n}"] = ([q[:n], k, v, full[:n], long_len[:n]], {})
    forms["int8_long_40"] = ([i8_args[0][:40], i8_args[1], i8_args[2], full[:40],
                              long_len[:40]], dict(i8_kw))
    want = {f: cs.plain(ref, a, kw) for f, (a, kw) in forms.items()}
    bounds = {}
    for f, (a, kw) in forms.items():
        nbytes, flops = cs.work(a, kw)
        bounds[f] = max(1e3 * nbytes / cs.HBM_BPS, 1e3 * flops / cs.FP32_FLOPS)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    writes = write_rate(cs, fp_args[0], flush)
    print(json.dumps({"write_rate": writes}), flush=True)
    order = list(built)
    runs = []
    for rnd, name in cs.walk(order, args.rounds):
        use(name)
        row = {"round": rnd, "name": name, "engine_ms_per_step": {}, "forms": {}}
        for phase in cs.PHASES:
            line, _ = cs.engine_phase(E, pa, phase, dev)
            row["engine_ms_per_step"][phase] = line["ms_per_step"]
        for f, (a, kw) in forms.items():
            got = pa.paged_attention(*a, **kw)
            again = pa.paged_attention(*a, **kw)
            torch.cuda.synchronize()
            err, rel, ok = cs.max_err(got, want[f], cs.TOL[f.split("_")[0]])
            if f == "bf16":
                ok = rel <= cs.TOL[f] and bool(torch.isfinite(got).all())
            ms = cs.timed_ms(lambda: pa.paged_attention(*a, **kw), 20, flush)
            ms_spun, spin_ms, host_ms = cs.timed_spun_ms(
                lambda: pa.paged_attention(*a, **kw), 20, flush)
            row["forms"][f] = dict(ms=ms, ms_spun=ms_spun, spin_ms=spin_ms,
                                   host_ms_max=host_ms, max_abs_err=err,
                                   max_rel_err=rel, ok=ok and host_ms < spin_ms,
                                   repeat_equal=torch.equal(got, again))
        print(json.dumps({"run": row}), flush=True)
        runs.append(row)
    summary = {}
    for name in order:
        mine = [r for r in runs if r["name"] == name]
        mean = lambda xs: sum(xs) / len(xs)
        summary[name] = {
            "engine_ms_per_step": {ph: mean([r["engine_ms_per_step"][ph] for r in mine])
                                   for ph in cs.PHASES},
            "forms": {f: {"ms": mean([r["forms"][f]["ms"] for r in mine]),
                          "ms_spun": mean([r["forms"][f]["ms_spun"] for r in mine]),
                          "bound_ms": bounds[f],
                          "of_bound": bounds[f] / mean([r["forms"][f]["ms_spun"]
                                                        for r in mine]),
                          "ok": all(r["forms"][f]["ok"] and r["forms"][f]["repeat_equal"]
                                    for r in mine)}
                      for f in forms}}
    print(json.dumps({"summary": summary}), flush=True)
    bad = [(name, f) for name, v in summary.items() for f, r in v["forms"].items()
           if not r["ok"]]
    if bad:
        sys.exit(f"paged_attention_bench: disagrees with the plain version, does not "
                 f"repeat bit for bit, or its host time outlasted the spin: {bad}")


if __name__ == "__main__":
    main()
