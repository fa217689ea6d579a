#!/usr/bin/env python3
"""The flash-attention backward on the trainers' attention shapes, the
checkout's build beside an earlier one, on one GPU.

    python3 scripts/flash_bwd_bench.py [--parent PATH.cu] [--variant NAME=PATH.cu ...]
        [--shapes NAME ...] [--rounds 1] [--profile]

Builds the checkout's `csrc/flash_attention.cu` and
`csrc/flash_attention_bwd.cu` (`kernels/_build.py`) and prints the
backward library's ptxas report (registers and spills of each kernel
instantiation), the count of HGMMA (wgmma) instructions in its SASS and
of ptxas's "wgmma serialized" reports. ``--parent`` names an earlier
backward source whose C entry is the one before the forward saved its
statistics (`xbof_flash_attention_bwd(kind, q, k, v, o, dout, dq, dk, dv,
scratch, B, S, T, H, KV, D, causal, window, scale, stream)`, scratch fp32
[3, B, H, S]), e.g. a parent commit's unpacked with `git archive` into a
directory that .gitignore lists:

    --parent _checkout/parent/src/repro_torch/kernels/csrc/flash_attention_bwd.cu

It is built with the same flags (`chip_smoke.bench_builds`), as is each
``--variant``, a source with the checkout's own C entry (a copy edited to
try a change, say), which the wrapper then launches (`_build.use`).
Shapes
(`chip_smoke.FLASH_BWD_*`, bf16, inputs from seed 25 as `chip_smoke.py`'s
rows): ``train`` h2o-danube-1.8b (1, 8192, 32/8 heads of 80, causal,
window 4096), ``whisper`` whisper-tiny's cross-attention (8, 448 over
1500 keys, 6 heads of 64, unmasked), ``qwen2_vl`` qwen2-vl-2b (1, 4096,
12/2 of 128, causal), ``recurrentgemma`` recurrentgemma-9b (1, 4096, 16/1
of 256, causal, window 2048). Per shape: the forward kernel's output and
statistics (`chip_smoke.stats_check`); the checkout's backward through
`chip_smoke.bwd_check` (its gates, and a repeated call equal bit for
bit), the parent's and each variant's the same (statistics or a build
that fail their gate stop the bench before any timing); then per round the
builds walked forward and back (`chip_smoke.walk`: parent, change,
change, parent for two), each timed spun
(`chip_smoke.spun_ms`, 5 launches after an L2 flush); once per shape the
backward of one `scaled_dot_product_attention` (`library_ms`, the band
as a boolean mask). Prints the card's name and power limit, a `build`
line, a `check` line per shape and build, a `run` line per (round, shape,
build) and last a `summary` line: per shape and build the mean ms, the
bound (10 * D flops a pair and head at the bf16 peak,
`chip_smoke.flash_bwd_work`), `of_bound`, TFLOP/s at 10 * D and at the
design's count (14 * D a pair, 16 * D at D = 256; the parent's 16 * D),
and `library_ms`. With ``--profile``, a `profile` line per shape and
build: one call's CUDA kernels under `torch.profiler`
(`chip_smoke.profile_kernels`: the launches, each kernel's device ms; the
checkout's delta pass, dq, dk / dv and sum kernels). Needs a CUDA
device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

SHAPES = {"train": cs.FLASH_BWD_TRAIN, "whisper": cs.FLASH_BWD_WHISPER,
          "qwen2_vl": cs.FLASH_BWD_QWEN2_VL, "recurrentgemma": cs.FLASH_BWD_RECURRENTGEMMA}


def parent_call(lib):
    """The earlier C entry as a function of (q, k, v, o, dout, causal,
    window): it recomputes the statistics into its own scratch."""
    fn = lib.xbof_flash_attention_bwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(q, k, v, o, dout, causal, window):
        b, s, h, d = q.shape
        t, kv = k.shape[1], k.shape[2]
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        scratch = torch.empty((3, b, h, s), dtype=torch.float32, device=q.device)
        err = fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(), b, s, t, h,
                 kv, d, int(causal), window, d ** -0.5,
                 torch.cuda.current_stream(q.device).cuda_stream)
        if err:
            raise RuntimeError(f"parent backward: error {err}")
        return dq, dk, dv
    return call


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an earlier flash_attention_bwd.cu (the old C entry)")
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=PATH.cu: a backward source with the checkout's C entry")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("flash_bwd_bench: needs a CUDA device")
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    print(cs.card_line(), flush=True)
    _build.build(("flash_attention", "flash_attention_bwd"))
    log = _build.LOG.get("flash_attention_bwd", "")
    build = {"ptxas": cs.ptxas_rows(log, "dq_hopper|dkdv_hopper|prep_kernel|sum_kernel|"
                                          "dq_kernel|dkdv_kernel"),
             "hgmma": cs.sass_count(_build, "flash_attention_bwd", "HGMMA"),
             "wgmma_serialized_reports": sum("wgmma.mma_async instructions are serialized"
                                             in ln for ln in log.splitlines())}
    checkout = _build.load("flash_attention_bwd")

    def through(lib):
        def call(q, k, v, o, st, g, c, w):
            _build.use("flash_attention_bwd", lib)
            return fa.flash_attention_bwd(q, k, v, o, st, g, causal=c, window=w)
        return call
    calls = {"change": through(checkout)}
    if args.variant:
        named = dict(v.split("=", 1) for v in args.variant)
        libs, seconds = cs.bench_builds(named, "dq_hopper|dkdv_hopper", "flash_bwd_bench")
        for name, (lib, rows) in libs.items():
            build[f"{name}_ptxas"] = rows
            calls[name] = through(lib)
    if args.parent:
        libs, seconds = cs.bench_builds({"parent": args.parent}, "dq_kernel|dkdv_kernel",
                                        "flash_bwd_bench")
        lib, rows = libs["parent"]
        build["parent_ptxas"], build["parent_build_s"] = rows, seconds
        old = parent_call(lib)
        calls = {"parent": lambda q, k, v, o, st, g, c, w: old(q, k, v, o, g, c, w), **calls}
    print(json.dumps({"build": build}), flush=True)

    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB > L2
    inputs, times, summary = {}, {}, {}
    for label in args.shapes:
        b, s, t, h, kv, d, causal, window = SHAPES[label]
        g = torch.Generator(device="cpu").manual_seed(25)
        q, k, v, dout = [torch.randn(sh, generator=g).to(torch.bfloat16).to(dev)
                         for sh in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d), (b, s, h, d))]
        stats = torch.empty((2, b, h, s), dtype=torch.float32, device=dev)
        o = fa.flash_attention(q, k, v, causal=causal, window=window, stats=stats)
        stats_gate = cs.stats_check(stats, q, k, causal, window)
        print(json.dumps({"stats": {"shape": label, **stats_gate}}), flush=True)
        if not stats_gate["ok"]:
            sys.exit(f"flash_bwd_bench: the forward's statistics fail their gate on {label}")
        for name, call in calls.items():
            got = call(q, k, v, o, stats, dout, causal, window)
            again = call(q, k, v, o, stats, dout, causal, window)
            torch.cuda.synchronize()
            gates = cs.bwd_check(got, q, k, v, o, dout, causal, window, "bf16")
            same = cs.same_bits(tuple(got), tuple(again))
            print(json.dumps({"check": {"shape": label, "build": name, **gates,
                                        "repeat_equal": same}}),
                  flush=True)
            if not (cs.bwd_ok(gates) and same):
                sys.exit(f"flash_bwd_bench: build {name} fails its gate on {label}")
            del got, again
        inputs[label] = (q, k, v, o, stats, dout, causal, window)
    for rnd, name in cs.walk(list(calls), args.rounds):
        for label in args.shapes:
            q, k, v, o, stats, dout, causal, window = inputs[label]
            ms, spin_ms, host_ms, attempts = cs.spun_ms(
                f"{name} {label}", lambda: calls[name](q, k, v, o, stats, dout, causal, window),
                5, flush)
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
    import torch.nn.functional as F
    for label in args.shapes:
        q, k, v, o, stats, dout, causal, window = inputs[label]
        b, s, h, d = q.shape
        t = k.shape[1]
        pos = torch.arange(s, device=dev)[:, None] + (t - s)
        cols = torch.arange(t, device=dev)[None, :]
        mask = None
        if causal:
            mask = cols <= pos
            if window:
                mask &= cols > pos - window
        leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, enable_gqa=True)
        dout_t = dout.transpose(1, 2)
        library_ms = cs.timed_ms(
            lambda: torch.autograd.grad(out, leaves, dout_t, retain_graph=True), 5, flush)
        del out, leaves, mask
        nbytes, flops = cs.flash_bwd_work(q, k, causal, window)
        _, design = cs.flash_bwd_work(q, k, causal, window, per_pair=14 if d <= 128 else 16)
        bound = max(1e3 * nbytes / cs.HBM_BPS, 1e3 * flops / cs.BF16_FLOPS)
        for name in calls:
            ms = sum(times[(label, name)]) / len(times[(label, name)])
            summary[f"{label}/{name}"] = {
                "ms": ms, "runs": times[(label, name)], "bound_ms": bound,
                "of_bound": bound / ms, "tflops": flops / ms / 1e9,
                # the parent recomputed the statistics: 16 * D a pair
                "design_tflops": (flops * 16 // 10 if name == "parent" else design) / ms / 1e9,
                "library_ms": library_ms, "over_library": ms / library_ms}
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
