#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc` (one
nvcc per source, all at once), then:

1. holds every kernel form (fp32, bf16, int8) against its plain PyTorch
   version on random tables with holes and a row of length 0, at the
   serving engine's default attention width (4 heads, 2 KV heads,
   head_dim 32) and at qwen3-14b's (40 heads, 8 KV heads, head_dim 128);
2. drives the serving engine's main path — `serving.engine.step` at
   qwen3-14b's attention width, 8 replicas, 32 steps — twice: fp32 pages
   unmetered, and int8 pages under a LINK_BW budget of 4 pages per step.
   The harvesting counts must equal the JAX reference's on the same
   configuration, the paged-attention kernel must have run once per step
   (its launch count is zeroed just before each run and read just after),
   and no step may synchronize with the host (`torch.cuda`'s sync debug
   mode raises on one);
3. times each kernel form on the inputs the main path gave it, beside its
   plain version and the least time the card could take (bytes over the
   memory rate or operations over the fp32 rate, whichever is larger);
4. checks the engine on the GPU against the same engine on the CPU (the
   plain path) on a small configuration.

Prints the card's name and power limit, a JSON line per phase (`build`,
`engine`, `gpu_vs_cpu_engine`), the `kernels` JSON line — per kernel form
its checks of step 1 and its numbers of step 3 — and last
`{"ok": true, "device": {...}}`. Any failure
exits non-zero before the last line. Needs one CUDA device; exits non-zero
without one, or when run outside a checkout.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

# the engine configuration of the main path: qwen3-14b attention width
# (src/repro/configs/qwen3_14b.py), 8 replicas under skewed arrivals
FULL_WIDTH = dict(n_replicas=8, seq_slots=64, shadow_slots=16,
                  pages_per_replica=48, page=16, max_pages=16,
                  n_heads=40, kv_heads=8, head_dim=128)
ARRIVALS = [16, 4, 0, 0, 0, 0, 0, 0]
STEPS = 32
# (redirected summed over the steps, offsite_pages and log_commits at the
# last step) of the JAX reference engine on the same configurations
PHASES = {
    "fp32": (dict(kv_quant="none"), (325, 88, 120)),
    "int8_metered": (dict(kv_quant="int8", link_pages_per_step=4), (12, 20, 52)),
}
# kernel vs plain version (the gates of tests/test_kernels.py)
TOL = {"fp32": 3e-5, "bf16": 3e-2, "int8": 1e-5}
# published H100 SXM rates (NVIDIA data sheet): HBM3 bytes/s and fp32
# FLOP/s outside the tensor cores (the kernel's math is fp32 throughout)
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def random_inputs(form, b, h, kv, d, page, mp, n_pages, seed, dev):
    """q, pools (and scales), a page table with holes inside the live
    range, lengths with the last row 0."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((b, h, d), generator=g)
    kp = torch.randn((n_pages, page, kv, d), generator=g)
    vp = torch.randn((n_pages, page, kv, d), generator=g)
    n = torch.randint(1, mp + 1, (b,), generator=g)
    table = torch.full((b, mp), -1, dtype=torch.int32)
    lengths = torch.zeros(b, dtype=torch.int32)
    for i in range(b):
        ni = int(n[i])
        table[i, :ni] = torch.randperm(n_pages, generator=g)[:ni].to(torch.int32)
        lengths[i] = int(torch.randint(1, ni * page + 1, (1,), generator=g))
        if ni > 1 and i % 3 == 0:
            table[i, int(torch.randint(0, ni - 1, (1,), generator=g))] = -1
    lengths[-1] = 0
    if form == "int8":
        scales = []
        planes = []
        for x in (kp, vp):
            s = x.abs().amax(dim=(1, 2, 3)) / 127.0
            planes.append(torch.clamp(torch.round(x / s[:, None, None, None]),
                                      -127, 127).to(torch.int8))
            scales.append(s)
        args = [q, planes[0], planes[1], table, lengths]
        kw = dict(k_scale=scales[0], v_scale=scales[1])
    else:
        dt = torch.float32 if form == "fp32" else torch.bfloat16
        args = [q.to(dt), kp.to(dt), vp.to(dt), table, lengths]
        kw = {}
    return ([a.to(dev) for a in args], {k: v.to(dev) for k, v in kw.items()})


def plain(ref, args, kw):
    if kw:
        q, k, v, t, n = args
        return ref.paged_attention_quant(q, k, v, kw["k_scale"], kw["v_scale"], t, n)
    return ref.paged_attention(*args)


def max_err(got, want, tol):
    """(max abs error, max abs error / max |want|, whether every element is
    within tol + tol * |want| and finite)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= tol + tol * want.abs()).all()) and bool(torch.isfinite(got).all())
    return float(err.max()), float(err.max() / want.abs().max().clamp(min=1e-30)), ok


def timed_ms(fn, iters, flush):
    """Mean device time of ``fn`` over ``iters`` launches, each timed by
    its own CUDA events after the L2 cache is flushed (the engine reads a
    pool it has just written, not one resident from the last launch)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def work(args, kw):
    """Bytes the call must move (each input read once, each output written
    once) and fp32 operations it must do, for THESE inputs. A row with a
    valid slot reads its q, the table columns below its length and the K
    and V of their mapped pages, and does 4 * H * D operations per valid
    token; a row with none (an inactive engine slot) does not depend on q:
    it averages V over every gathered row (holes read page 0), reading its
    whole table row and V only, with KV * D additions per gathered row.
    Every row writes its out and reads its length."""
    q, k, v, table, lengths = args
    b, h, d = q.shape
    n_pages, page, kv, _ = k.shape
    mp = table.shape[1]
    tab = table.cpu().numpy()
    lens = lengths.cpu().numpy()
    k_pages, v_pages = set(), set()
    tokens = mean_rows = q_rows = table_reads = 0
    for i in range(b):
        live = min(mp, -(-max(int(lens[i]), 0) // page))
        cols = [j for j in range(live) if tab[i, j] >= 0]
        if cols:
            k_pages.update(int(tab[i, j]) for j in cols)
            v_pages.update(int(tab[i, j]) for j in cols)
            tokens += sum(min(page, int(lens[i]) - j * page) for j in cols)
            q_rows += 1
            table_reads += live
        else:
            v_pages.update(int(max(p, 0)) for p in tab[i])
            mean_rows += 1
            table_reads += mp
    plane_bytes = page * kv * d * k.element_size() + (4 if kw else 0)
    row_bytes = h * d * q.element_size()
    nbytes = ((len(k_pages) + len(v_pages)) * plane_bytes
              + (q_rows + b) * row_bytes          # q of valid rows, every out
              + table_reads * 4 + lengths.numel() * 4)
    flops = 4 * h * d * tokens + mean_rows * kv * d * mp * page
    return nbytes, flops


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA device")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.serving import engine as E

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)

    t0 = time.perf_counter()
    _build.build()
    ptxas = [ln.strip() for log in _build.LOG.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(json.dumps({"build": {"seconds": round(time.perf_counter() - t0, 3),
                                "sources": list(_build.SOURCES), "ptxas": ptxas}}),
          flush=True)

    # ---- 1. every kernel form against its plain version, both widths
    checks = []
    shapes = {"engine_default": (40, 4, 2, 32, 16, 16, 256),
              "qwen3_14b_width": (640, 40, 8, 128, 16, 16, 384)}
    for form in ("fp32", "bf16", "int8"):
        for label, (b, h, kv, d, page, mp, n_pages) in shapes.items():
            args, kw = random_inputs(form, b, h, kv, d, page, mp, n_pages,
                                     seed=len(checks), dev=dev)
            got = pa.paged_attention(*args, **kw)
            torch.cuda.synchronize()
            err, rel, ok = max_err(got, plain(ref, args, kw), TOL[form])
            checks.append(dict(form=form, shape=label,
                               q=[b, h, d], pool=[n_pages, page, kv, d],
                               max_abs_err=err, max_rel_err=rel,
                               tol=TOL[form], ok=ok))
    bad = [c for c in checks if not c["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    # ---- 2. the main path: the engine at full width, two phases
    captured = {}
    dispatch = ops.paged_attention

    def capture(*args, **kw):
        captured["call"] = (args, kw)
        return dispatch(*args, **kw)

    E.kops.paged_attention = capture
    engine_out, main_inputs, launches = {}, {}, {}
    arrivals = torch.tensor(ARRIVALS, dtype=torch.int32, device=dev)
    for phase, (extra, expect) in PHASES.items():
        cfg = E.EngineConfig(**FULL_WIDTH, **extra)
        # warm-up on a throwaway state (cuBLAS handles, the kernel library)
        warm = E.init(cfg, device=dev)
        for _ in range(2):
            warm, _ = E.step(cfg, warm, arrivals)
        del warm
        state = E.init(cfg, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
        gen = torch.Generator(device=dev).manual_seed(7)
        torch.cuda.synchronize()
        redirected = torch.zeros((), dtype=torch.int32, device=dev)
        norms = []
        pa.paged_attention.launches = 0
        t0 = time.perf_counter()
        # the step reads nothing back to the host: any synchronizing CUDA
        # call inside it raises here
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(STEPS):
                state, stats = E.step(cfg, state, arrivals, generator=gen)
                redirected += stats["redirected"]
                norms.append(stats["attn_norm"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[phase] = pa.paged_attention.launches
        norms = torch.stack(norms).cpu()
        got = (int(redirected), int(stats["offsite_pages"]), int(stats["log_commits"]))
        engine_out[phase] = dict(
            redirected=got[0], offsite_pages=got[1], log_commits=got[2],
            expected=list(expect), launches=launches[phase],
            attn_norm_last=float(norms[-1]),
            attn_norm_finite=bool(torch.isfinite(norms).all()),
            ms_per_step=1e3 * seconds / STEPS)
        if got != expect:
            fail(f"{phase}: harvesting counts {got} != reference {expect}")
        if launches[phase] != STEPS:
            fail(f"{phase}: paged_attention launched {launches[phase]} times "
                 f"in {STEPS} steps")
        if not engine_out[phase]["attn_norm_finite"]:
            fail(f"{phase}: attn_norm not finite")
        main_inputs[phase] = captured.pop("call")
        del state
    E.kops.paged_attention = dispatch
    print(json.dumps({"engine": engine_out}), flush=True)

    # ---- 3. each kernel form on the inputs the main path gave it
    fp_args, _ = main_inputs["fp32"]
    int8_args, int8_kw = main_inputs["int8_metered"]
    forms = {
        "fp32": (list(fp_args), {}, launches["fp32"]),
        "bf16": ([fp_args[0].bfloat16(), fp_args[1].bfloat16(),
                  fp_args[2].bfloat16(), fp_args[3], fp_args[4]], {}, 0),
        "int8": (list(int8_args), dict(int8_kw), launches["int8_metered"]),
    }
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB > L2
    kernels = []
    for form, (args, kw, n_launch) in forms.items():
        got = pa.paged_attention(*args, **kw)
        want = plain(ref, args, kw)
        torch.cuda.synchronize()
        err, rel, ok = max_err(got, want, TOL[form])
        if form == "bf16":
            # the main path's outputs are small (rms about 0.04), so bf16's
            # absolute gate there is near a typical value: gate the error
            # relative to the largest output instead (the random-input
            # checks of step 1, with O(1) outputs, keep the absolute gate)
            ok = rel <= TOL[form] and bool(torch.isfinite(got).all())
        if not ok:
            fail(f"{form}: kernel disagrees with its plain version on the "
                 f"main path's inputs (max abs err {err}, relative {rel})")
        ms = timed_ms(lambda: pa.paged_attention(*args, **kw), 20, flush)
        plain_ms = timed_ms(lambda: plain(ref, args, kw), 5, flush)
        nbytes, flops = work(args, kw)
        t_bytes, t_ops = 1e3 * nbytes / HBM_BPS, 1e3 * flops / FP32_FLOPS
        kernels.append({
            "name": f"paged_attention[{form}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:123",
            "launches": n_launch,
            "on_main_path": form != "bf16",
            "shape": {"q": list(args[0].shape), "pool": list(args[1].shape),
                      "dtype": str(args[1].dtype).replace("torch.", "")},
            "max_abs_err": err, "max_rel_err": rel, "tol": TOL[form],
            "gate": ("max_abs_err / max|want| <= tol" if form == "bf16"
                     else "|err| <= tol * (1 + |want|) per element"),
            # random tables with holes and a row of length 0, both widths
            "checks": [c for c in checks if c["form"] == form],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops,
            # no single PyTorch call computes attention over a page table
            "library_ms": None,
        })

    # ---- 4. the engine on the GPU against the same engine on the CPU
    small = E.EngineConfig(n_replicas=4, seq_slots=4, shadow_slots=2,
                           pages_per_replica=32, page=8, max_pages=8,
                           kv_quant="int8")
    gs, cs = E.init(small, device=dev), E.init(small, device="cpu")
    cs = cs._replace(wq=gs.wq.cpu(), wk=gs.wk.cpu(), wv=gs.wv.cpu(), wo=gs.wo.cpu())
    xg = torch.Generator(device="cpu").manual_seed(3)
    for i in range(6):
        x = torch.randn((4, 6, 128), generator=xg) * 0.1
        arr = torch.tensor([5, 0, 0, 1], dtype=torch.int32)
        gs, gst = E.step(small, gs, arr, x=x)
        cs, cst = E.step(small, cs, arr, x=x)
        for key in cst:
            a, b = gst[key].cpu(), cst[key]
            same = (torch.equal(a, b) if not b.is_floating_point()
                    else bool(torch.allclose(a, b, rtol=2e-2 if key == "quant_err_norm" else 1e-4,
                                             atol=1e-6)))
            if not same:
                fail(f"GPU engine step {i} stat {key} {a} != CPU plain path {b}")
    print(json.dumps({"gpu_vs_cpu_engine": {"config": "4 replicas, int8",
                                            "steps": 6, "ok": True}}), flush=True)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
