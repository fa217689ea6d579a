#!/usr/bin/env python3
"""Where a prefill and a decode step of the port's model zoo spend their
time, on one GPU.

    python3 scripts/torch_model_profile.py [--arch qwen3-14b --batch 4 \\
        --prompt-len 2048 --decode-steps 8]

Runs `repro_torch.models.decode.prefill` and `decode_step` at the arch's
full published config (random weights from seed 0, as
`launch.serve.run_model` draws them). The DeepSeek archs, which do not
fit one card whole, run at `chip_smoke.py`'s depth cut: deepseek-v2-236b
at 8 layers (1 dense + 7 MoE), deepseek-v3-671b at 5 (3 dense + 2 MoE). After one warm-up prefill and
decode step it profiles one prefill, then ``--decode-steps`` decode steps,
and reports for each window:

- wall ms: host clock from a synchronize to a synchronize, with the
  profiler recording host and device activity, and the same work again
  without the profiler;
- device-busy ms and the idle share (1 - busy / wall): the summed
  duration of the CUDA kernels `torch.profiler` records in the window;
- device ms and host ms per layer of the model, from
  `torch.profiler.record_function` ranges this script wraps around the
  serve path's functions: embed, norm, the attention block's projections
  with qk-norm and RoPE (`attention_proj`), the attention itself (the
  flash kernel in prefill, the plain decode attention in decode), the
  KV-cache writes, the MLP and the unembedding; for the recurrent
  families also the RG-LRU block around its scan (`rec_block`: the
  projections, the temporal conv and the gates), RWKV6's time mix around
  its scan (`time_mix`: token shift, interpolation, projections, decay,
  group norm) and channel mix, and the scans themselves (`recurrence`:
  the scan kernel in prefill, the plain single step in decode); for
  DeepSeek MLA's projections into q and the latent (`attention_proj`)
  and its latent-space attention with the up-projections
  (`mla_attend`), and the MoE FFN: its router product and scores
  (`router`), the router kernel (`topk_router`), the dispatch and
  combine (`moe_dispatch`), the routed experts' products (`experts`)
  and the rest of the layer (`moe`: the shared experts). A layer's device ms is
  the summed duration of the kernels that ran inside its range and in no
  labelled range nested in it; `other` is the kernels outside every range
  (the residual adds). Its host ms is the host time inside its range,
  likewise exclusive;
- the kernels that take most device time.

With ``--train`` it profiles one training step instead
(`training.train_step.train_step` at ``--batch`` x ``--prompt-len``
tokens in ``--n-micro`` microbatches, the state from
`launch.train.init`), after one warm-up step:

    python3 scripts/torch_model_profile.py --train --arch h2o-danube-1.8b \
        --batch 2 --prompt-len 8192 --n-micro 2

and splits it into the forward (`lm_loss`), the optimizer
(`optimizer.update`) and the backward (the rest: the layers'
recomputation under remat, the products' gradients and the flash
backward kernel, `attention_bwd`), each as the device ms of the kernels
inside the stage's ranges (``stage_ms``), beside the per-layer split
above.

Prints the card's name and power limit, then one JSON line. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CUDA = torch.autograd.DeviceType.CUDA


def _label(module, attr: str, label: str) -> None:
    """Wrap ``module.attr`` in a profiler range named ``label``."""
    fn = getattr(module, attr)

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        with torch.profiler.record_function(label):
            return fn(*args, **kw)

    setattr(module, attr, wrapped)


def _split(prof, labels, counts=None) -> tuple[dict, dict, float, int, list]:
    """Per label: device ms of the kernels that ran inside it (and in no
    labelled range nested in it), and host ms spent inside it (likewise
    exclusive); then total busy ms, the number of kernels, and the top
    kernels by device time. A ``counts`` dict receives each label's number
    of kernels.

    A kernel belongs to the innermost labelled range whose span on the
    device timeline (the profiler's GPU-side copy of each
    `record_function` range) contains it; this holds for kernels launched
    through ctypes too, which the profiler does not link to a host op."""
    events = prof.events()
    device = [e for e in events if e.device_type == CUDA]
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in device if e.name in labels)
    starts = [a for a, _, _ in spans]
    kernel_ms = collections.defaultdict(float)
    kernels = collections.defaultdict(lambda: [0.0, 0])
    n = 0
    for e in device:
        if e.name in labels:
            continue
        n += 1
        k0, k1 = e.time_range.start, e.time_range.end
        owner = "other"
        for j in range(bisect.bisect_right(starts, k0) - 1, -1, -1):
            if k1 <= spans[j][1]:  # spans nest: the latest-starting cover is innermost
                owner = spans[j][2]
                break
        ms = e.time_range.elapsed_us() / 1e3
        kernel_ms[owner] += ms
        if counts is not None:
            counts[owner] = counts.get(owner, 0) + 1
        kernels[e.name][0] += ms
        kernels[e.name][1] += 1

    def labelled_below(e):
        for c in e.cpu_children:
            if c.name in labels:
                yield c
            else:
                yield from labelled_below(c)

    host_ms = collections.defaultdict(float)
    for e in events:
        if e.name in labels and e.device_type != CUDA:
            inner = sum(c.cpu_time_total for c in labelled_below(e))
            host_ms[e.name] += (e.cpu_time_total - inner) / 1e3
    busy = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(kernel_ms), dict(host_ms), busy, n, top


def _inclusive_ms(prof, label: str) -> float:
    """Device ms of the kernels inside any device-side span of ``label``,
    ranges nested in it included."""
    device = [e for e in prof.events() if e.device_type == CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in device if e.name == label]
    return sum(e.time_range.elapsed_us() / 1e3 for e in device
               if e.name != label and any(a <= e.time_range.start and e.time_range.end <= b
                                          for a, b in spans))


def label_layers() -> set:
    """Wrap the model zoo's layer functions in profiler ranges; return the
    labels."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    from repro_torch.models import decode as D
    from repro_torch.models import moe as M
    from repro_torch.models import rglru as RG
    from repro_torch.models import rwkv6 as RW
    from repro_torch.models import transformer as T
    labels = {"embed", "norm", "attention_proj", "attention", "cache_write",
              "mlp", "unembed", "rec_block", "time_mix", "channel_mix",
              "recurrence", "mla_attend", "moe", "router", "topk_router",
              "moe_dispatch", "experts"}
    for module, attr, label in (
            (D, "embed_tokens", "embed"), (D, "norm", "norm"), (T, "norm", "norm"),
            (T, "mlp", "mlp"), (RG, "rglru_block", "rec_block"),
            (RW, "time_mix", "time_mix"), (RW, "channel_mix", "channel_mix"),
            (ops, "rglru", "recurrence"), (ops, "rglru_step", "recurrence"),
            (ops, "rwkv6_wkv", "recurrence"), (ops, "rwkv6_wkv_step", "recurrence"),
            (A, "gqa_train", "attention_proj"), (D, "_decode_gqa", "attention_proj"),
            (ops, "attention", "attention"), (ops, "decode_attention", "attention"),
            (D, "_write_kv", "cache_write"), (D, "_ring_update", "cache_write"),
            (D, "mlp", "mlp"), (D, "unembed", "unembed"),
            (A, "_mla_qkv", "attention_proj"), (A, "_mla_attend", "mla_attend"),
            (M, "moe_ffn", "moe"), (M, "route", "router"),
            (ops, "topk_router", "topk_router"), (M, "_moe_sorted", "moe_dispatch"),
            (M, "_moe_small_batch", "moe_dispatch"), (M, "_expert_ffn", "experts")):
        _label(module, attr, label)
    return labels


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def profile_train(args, cfg, dev) -> None:
    """One train step, profiled after a warm-up step, then unprofiled."""
    from repro_torch.data import pipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as L
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training import train_step as TS
    labels = label_layers() | {"forward", "optimizer", "attention_bwd"}
    for module, attr, label in ((T, "lm_loss", "forward"), (O, "update", "optimizer"),
                                (fa, "flash_attention_bwd", "attention_bwd")):
        _label(module, attr, label)
    batch = pipeline.batch_for_step(cfg, 0, args.batch, args.prompt_len, device=dev)
    held = {"state": L.init(cfg, seed=0, device=dev)}

    def step():   # the state handed over, so only the step holds two
        held["state"], held["metrics"] = TS.train_step(cfg, held.pop("state"), batch,
                                                       n_micro=args.n_micro)

    _timed(step)   # warm-up
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall = _timed(step)
    wall_unprofiled = _timed(step)
    device_ms, host_ms, busy, n_kernels, top = _split(prof, labels)
    fwd, opt = _inclusive_ms(prof, "forward"), _inclusive_ms(prof, "optimizer")
    print(json.dumps({"config": {"arch": args.arch, "batch": args.batch,
                                 "seq": args.prompt_len, "n_micro": args.n_micro,
                                 "dtype": cfg.dtype, "layers": cfg.n_layers,
                                 "remat": cfg.remat},
                      "train_step": {
                          "wall_ms": wall, "wall_ms_unprofiled": wall_unprofiled,
                          "device_busy_ms": busy if busy else "not measured",
                          "device_idle_share": 1.0 - busy / wall if busy else "not measured",
                          "kernels": n_kernels,
                          "stage_ms": {"forward": fwd, "backward": busy - fwd - opt,
                                       "optimizer": opt},
                          "device_ms_by_layer": dict(sorted(device_ms.items())),
                          "host_ms_by_layer": dict(sorted(host_ms.items())),
                          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "loss": float(held["metrics"]["loss"]),
                          "top_kernels": [{"name": name[:90], "ms": ms, "launches": n}
                                          for name, (ms, n) in top]}}))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--train", action="store_true",
                    help="profile one train step (batch x prompt-len tokens)")
    ap.add_argument("--n-micro", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_model_profile: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import MODEL_MOE_V2, MODEL_MOE_V3
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda", 0)
    cfg = configs.get(args.arch)
    cut = {m[0]: m[4] for m in (MODEL_MOE_V2, MODEL_MOE_V3)}
    if args.arch in cut:
        cfg = dataclasses.replace(cfg, n_layers=cut[args.arch])
    if args.train:
        return profile_train(args, cfg, dev)
    params = T.init_params(cfg, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
    # a prompt of tokens, or the frontend stubs' embeddings (qwen2-vl's in
    # place of the tokens; whisper's encoder input beside them), as
    # `run_model` draws them from seed 0
    inputs = serve.draw_inputs(cfg, args.batch, args.prompt_len, 0, dev)
    max_len = args.prompt_len + 2 * args.decode_steps + 2

    labels = label_layers()
    state = {}

    def do_prefill():
        state["logits"], state["cache"] = D.prefill(cfg, params, max_len=max_len,
                                                    **inputs)

    def do_decode():
        for _ in range(args.decode_steps):
            tok = torch.argmax(state["logits"], -1).to(torch.int32)
            state["logits"], state["cache"] = D.decode_step(
                cfg, params, state["cache"], tok)

    _timed(do_prefill)   # warm-up: kernel build and load, cuBLAS handles
    _timed(do_decode)
    out = {"config": {"arch": args.arch, "batch": args.batch,
                      "prompt_len": args.prompt_len,
                      "decode_steps": args.decode_steps, "dtype": cfg.dtype,
                      "layers": cfg.n_layers,
                      "full_layers": configs.get(args.arch).n_layers}}
    for phase, fn, per in (("prefill", do_prefill, 1),
                           ("decode", do_decode, args.decode_steps)):
        if phase == "decode":
            do_prefill()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            wall = _timed(fn)
        if phase == "decode":
            do_prefill()
        wall_unprofiled = _timed(fn)
        device_ms, host_ms, busy, n_kernels, top = _split(prof, labels)
        out[phase] = {
            "per": "prefill" if per == 1 else "decode step",
            "wall_ms": wall / per,
            "wall_ms_unprofiled": wall_unprofiled / per,
            "device_busy_ms": busy / per if busy else "not measured",
            "device_idle_share": 1.0 - busy / wall if busy else "not measured",
            "kernels": n_kernels / per,
            "device_ms_by_layer": {k: v / per for k, v in sorted(device_ms.items())},
            "host_ms_by_layer": {k: v / per for k, v in sorted(host_ms.items())},
            "top_kernels": [{"name": name[:90], "ms": ms / per, "launches": n / per}
                            for name, (ms, n) in top],
        }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
