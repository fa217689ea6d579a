#!/usr/bin/env python3
"""The readings behind `chip_smoke.py`'s limit for rwkv6-3b's full-width
train step on the card against the CPU (`RWKV6_TRAIN_TOL`), and the host
cost of the scan and router kernels' autograd Functions off the training
path, on one GPU.

    python3 scripts/torch_train_tolerance.py [--seeds 21 22 23] [--eps 1e-2 1e-3]

rwkv6-3b at its published width (d_model 2560, 40 heads of 64, d_ff 8960,
vocab 65536) cut to 2 layers takes one `training.train_step.train_step`
at batch 1 x 512 and `chip_smoke.TRAIN_VS_CPU_LR`, from the weights and
batch each seed draws, three ways:

- `kernel`: on the card, through the port's kernels (the main path);
- `plain_card`: on the card with `kernels.ops.rwkv6_wkv` swapped for its
  plain version (`kernels.ref.rwkv6_wkv`): no WKV kernel in the step;
- `cpu`: on the CPU (the plain path, `chip_smoke.train_vs_cpu`'s side).

For each pair it prints `chip_smoke.rel_diffs`: the loss's and the grad
norm's relative difference, and for each moment the largest over leaves
of max|a - b| / max|b| with its leaf. fp32 on every seed, bf16 on the
first. A difference that `plain_card` shows against `cpu` is not the WKV
kernels'.

Controls (fp32, the first seed): the `kernel` step with one output of the
WKV backward kernel (dr, dk, dv, dw or du) scaled by 1 + eps, against
`cpu`: the size of kernel fault a limit on that comparison catches.

Last, the autograd Functions' host cost where nothing needs a gradient
(serving): the host microseconds a call of `ops.topk_router`,
`ops.rglru` and `ops.rwkv6_wkv` (each through its Function) and of the raw
forward wrapper take to enqueue, at DeepSeek-v2's and v3's decode router
shapes and small scan shapes. Each JSON line also goes to
``chiprun_out/train_tolerance.jsonl``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUTPUTS = ("dr", "dk", "dv", "dw", "du")   # rwkv6_wkv_bwd's outputs, in order


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[21, 22, 23])
    ap.add_argument("--eps", type=float, nargs="+", default=[1e-2, 1e-3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_train_tolerance: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.models import transformer as T
    from repro_torch.training import train_step as TS
    from repro_torch.training import tree as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    sink = open(out_dir / "train_tolerance.jsonl", "w")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        sink.write(line + "\n")

    emit({"card": cs.card_line()})
    _build.build()
    batch, seq = cs.TRAIN_VS_CPU

    def step(cfg, params, seed, device):
        state, m = TS.train_step(
            cfg, TS.init_state(cfg, tr.tree_map(lambda t: t.to(device), params)),
            pipeline.batch_for_step(cfg, 0, batch, seq, seed, device=device),
            n_micro=1, lr=cs.TRAIN_VS_CPU_LR)
        if device != "cpu":
            torch.cuda.synchronize()
        return state, m

    def plain_card(cfg, params, seed):
        kernel_wkv = ops.rwkv6_wkv
        ops.rwkv6_wkv = ref.rwkv6_wkv
        try:
            return step(cfg, params, seed, dev)
        finally:
            ops.rwkv6_wkv = kernel_wkv

    def scaled_bwd(i, eps):
        kernel_bwd = wkv.rwkv6_wkv_bwd

        def bwd(*a, **kw):
            grads = list(kernel_bwd(*a, **kw))
            grads[i] = grads[i] * (1 + eps)
            return tuple(grads)
        bwd.launches = kernel_bwd.launches   # the kernel's wrapper counts on its module's name
        return kernel_bwd, bwd

    for form, seeds in (("float32", args.seeds), ("bfloat16", args.seeds[:1])):
        cfg = dataclasses.replace(configs.get("rwkv6-3b"), name="rwkv6-3b-2-layers",
                                  n_layers=2, dtype=form)
        for seed in seeds:
            params = T.init_params(cfg, device="cpu",
                                   generator=torch.Generator().manual_seed(seed))
            t0 = time.perf_counter()
            c_state, c_m = step(cfg, params, seed, "cpu")
            cpu_s = time.perf_counter() - t0
            k_state, k_m = step(cfg, params, seed, dev)
            p_state, p_m = plain_card(cfg, params, seed)
            emit({"form": form, "seed": seed, "cpu_s": cpu_s,
                  "loss": {"kernel": float(k_m["loss"]), "plain_card": float(p_m["loss"]),
                           "cpu": float(c_m["loss"])},
                  "kernel_vs_cpu": cs.rel_diffs(k_m, k_state, c_m, c_state),
                  "plain_card_vs_cpu": cs.rel_diffs(p_m, p_state, c_m, c_state),
                  "kernel_vs_plain_card": cs.rel_diffs(k_m, k_state, p_m, p_state)})
            del k_state, p_state
            if form == "float32" and seed == args.seeds[0]:
                for eps in args.eps:
                    for i, name in enumerate(OUTPUTS):
                        kernel_bwd, bwd = scaled_bwd(i, eps)
                        wkv.rwkv6_wkv_bwd = bwd
                        try:
                            x_state, x_m = step(cfg, params, seed, dev)
                        finally:
                            wkv.rwkv6_wkv_bwd = kernel_bwd
                        emit({"form": form, "seed": seed, "control": f"{name} x (1 + {eps})",
                              "kernel_vs_cpu": cs.rel_diffs(x_m, x_state, c_m, c_state)})
                        del x_state
            del c_state, params
            torch.cuda.empty_cache()

    emit({"function_host_us": function_host_us(ops, dev)})
    sink.close()


def function_host_us(ops, dev, calls=200, rounds=21) -> dict:
    """Host microseconds a call, the median over ``rounds`` of ``calls``
    enqueued back to back (fewer than the launch queue holds, so the host
    never waits), of each kernel through its Function (`ops`) and through
    its raw forward wrapper, on inputs that need no gradient."""
    from repro_torch.kernels import moe_router as mr
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as wkv
    g = torch.Generator(device="cpu").manual_seed(0)
    rnd = lambda *sh: torch.rand(sh, generator=g).to(dev)
    v2 = rnd(4, 160).softmax(-1)
    v3, bias = rnd(4, 256).sigmoid(), rnd(256) * 0.1
    x, a = rnd(1, 16, 4096).bfloat16(), rnd(1, 16, 4096).bfloat16()
    r, k, v, w = (rnd(1, 16, 40, 64).bfloat16() for _ in range(4))
    u = rnd(40, 64)
    cases = {
        "topk_router_v2_decode": (lambda: ops.topk_router(v2, 6),
                                  lambda: mr.topk_router(v2, 6)),
        "topk_router_v3_decode": (lambda: ops.topk_router(v3, 8, bias),
                                  lambda: mr.topk_router(v3, 8, bias=bias)),
        "rglru_1x16x4096": (lambda: ops.rglru(x, a), lambda: rg.rglru(x, a)),
        "rwkv6_wkv_1x16x40x64": (lambda: ops.rwkv6_wkv(r, k, v, w, u, return_state=True),
                                 lambda: wkv.rwkv6_wkv(r, k, v, w, u, return_state=True)),
    }
    out = {}
    for name, (through_function, raw) in cases.items():
        per = {}
        for label, fn in (("function", through_function), ("raw", raw)):
            samples = []
            for _ in range(rounds):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                samples.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
            per[label] = statistics.median(samples)
        per["added_us"] = per["function"] - per["raw"]
        out[name] = per
    return out


if __name__ == "__main__":
    main()
