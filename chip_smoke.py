#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc` (one
nvcc per source, all at once), then:

1. holds every paged-attention form (fp32, bf16, int8) against its plain
   PyTorch version (`PAGED_CHECKS`) on random tables with holes and a row
   of length 0, at the serving engine's default attention width (4 heads,
   2 KV heads, head_dim 32) and at qwen3-14b's (40 heads, 8 KV heads,
   head_dim 128); on the engine step's pattern at that width (640 rows,
   over half of length 0 with all-hole tables, the rest one page, one row
   of exactly 16 tokens and one of 17); on length-0 rows whose tables hold
   stale page ids; on pages of 1 and 32 slots, group 1 and 8, head_dim 64,
   80 and 256, head_dim 36 and 33 (rows off 16 bytes in bf16 and int8),
   and full 16-page rows with holes; each call repeated and equal bit for
   bit; and the flash-attention kernel (fp32, bf16) against its plain
   version on the sweep of tests/test_kernels.py under its three masks, head_dim
   80 and 16, a ragged non-causal length, queries offset against a longer
   key sequence, rows with no valid key, and the edges of the bf16
   kernel's tiles (S and T off the tile sizes, S = 1, head dims 32 to 256,
   windows with S < T), with the softmax statistics it saves for the
   backward against `ref.attention_stats` (STATS_TOL); the flash backward
   kernel (fp32, bf16) against its plain gradient (`ref.attention_bwd`) on
   FLASH_BWD_SHAPES (head dims 8 to 256, GQA groups 1, 4 and 8, its three
   masks, S < T, T off its key tiles, rows with no valid key), given the
   plain statistics, each call repeated bit for bit; and the
   RG-LRU and RWKV6 scan
   kernels (fp32, bf16) against theirs on the sweeps of
   tests/test_kernels.py, a ragged length, and an initial state (h0; s0
   with the final state), the RG-LRU kernel also across its chunks of 32
   steps and tiles of 64 channels (T = 1, 31, 32, 33; W = 40, 130 and
   9000, more blocks than SMs; B * W under one tile), with a = 0 and a = 1
   exactly and on views at an odd storage offset, each equal to its plain
   version bit for bit; the WKV kernel also across the bf16 kernel's
   16-row chunks (T = 1, 63, 64, 65, 129), K = 128 from s0, more blocks
   than SMs and decays with w = 0 and w = 1 exactly, down to e^-30 and
   near e^-1; each scan call repeated and equal bit for bit; and the MoE
   top-k router kernel against its
   plain version on the sweep of tests/test_kernels.py with and without
   bias, DeepSeek's expert counts (160 with k = 6, 256 with k = 8) at 1,
   4, 4096 and 1000 tokens, rows with exact ties, E = 31, 32, 33, 160,
   256 and 1024 with k = 1 and 16, rows of -0.0 and +0.0, rows of one
   value, a bias that makes every sel negative and rows off 16 bytes
   (indices exact; each call repeated and equal bit for bit); and the
   backward kernels of the scans and the router against their plain
   gradients (`scan_bwd_checks`, `router_bwd_checks`): the RG-LRU's value
   for value on the forward's sweep, with a = 1 and x = 0 (infinite and
   NaN gradients at the plain gradient's places), the WKV's per element
   under WKV_BWD_TOL on its sweep (w = 0 and w = 1 exactly, s0 and a
   final-state cotangent), both also at the training shapes (step 4's
   rows), and the router's
   under ROUTER_BWD_TOL with ties, k = E and picks summing below 1e-9, at
   DeepSeek's full widths too; each call repeated bit for bit;
1b. drives the FTL lookup (`kernels.ops.ftl_lookup`, its one entry point)
   at SSD scale: a burst of 2^20 LPNs against a 4 TB SSD's 1862-segment
   directory with half of its 524288-entry mapping pages cached (1.95 GB
   of PPNs up to 2^31 - 2). It must launch once, without a host sync, and
   give its plain version's PPNs and hits bit for bit, there and on the
   sweep of tests/test_kernels.py with out-of-range LPNs added (entries 8
   and 1000), N = 1, 3, 5 and 2^20 + 3, LPNs a view 1, 2 and 3 elements
   into their storage, a directory of 70 000 segments (280 KB, more than
   an SM holds) and entries = 1000 (each call repeated bit for bit);
2. drives the serving engine's main path — `serving.engine.step` at
   qwen3-14b's attention width, 8 replicas, 32 steps — in six phases:
   one shard with fp32 pages unmetered (`fp32`) and int8 pages under a
   LINK_BW budget of 4 pages per step (`int8_metered`); the hierarchical
   engine with 2 shards of 4 replicas and fp32 pages (`sharded2_fp32`),
   and with 4 shards of 2, two shards an enclosure, int8 pages, metered
   (`enclosure4_int8_metered`); the telemetry plane on one shard
   (`trace_fp32`: the page-access stream through the SHARDS window
   kernel, its want reserving lendable pages), and both the telemetry and
   the observability planes on the 4-shard hierarchy
   (`trace_enclosure4_int8_metered_obs`: metric rings of 32 windows, an
   event log of 4096 rows per shard). Each phase runs 3 times from the
   same seeds. The harvesting counts, requests exchanged across shards
   included (which must be > 0 with shards), must equal the JAX
   reference's on the same configuration, the paged-attention kernel must
   have run once per step (its launch count is zeroed just before each
   run and read just after; all shards' rows go to one launch), and with
   the telemetry plane the SHARDS window kernel too (all shards' nodes in
   one launch); each kernel must agree with its plain version on the last
   step's inputs (the window kernel bit for bit); the last step's
   want_pages must equal the reference's (`WANT_PAGES_LAST`, > 0 on the
   loaded replicas), the event log must hold rows and some of the
   exchange (level >= 1); and no step may synchronize with the host
   (`torch.cuda`'s sync debug mode raises on one);
2r. drives the multi-rank paths, each rank a spawned process of one gloo
   group on the one card (NCCL refuses two ranks on one GPU; gloo stages
   CUDA tensors through the host, so the ranks' times check values and
   are no figure for NCCL or several cards): `sharded2_fp32` on 2 ranks
   and `trace_enclosure4_int8_metered_obs` on 4 through
   `engine.make_sharded_step` (`engine_ranks_phase`), each rank's stats
   equal to every other rank's bit for bit and to one process's every
   step (floats within 1e-4 relative, RANK_STATS_RTOL), the joined final
   state the one process's (`same_state`), the harvesting counts the
   reference's, and each rank launching paged attention (and the SHARDS
   window) once a step, which collectives gloo takes for CUDA tensors
   probed and printed; then `mla_seq_sharded_v2` (`mla_ranks_phase`):
   deepseek-v2 at full width, 2 layers (1 dense + 1 MoE), batch 4,
   prompt 1024, 32 greedy tokens in one process, then on 2 and on 4
   ranks with the 2048-position latent cache split by sequence, fed the
   same tokens: layer 0's attention output, and the logits of every row
   whose MoE layer picked the one process's experts, within MLA_TOL of the
   one process's each step; a row whose router moved must be a near-tie
   of its scores, as must a token flip; the router launched once per MoE
   layer in the prefill and each step on every rank. Each prints its ms
   per step (or token) beside the one process's, its seconds and the
   backend;
2a. drives the JBOF simulator (`jbof.sim`) in three phases, each window
   loop (`sim.run_prepared`) under the sync debug mode: `sim_jbof12`,
   fig. 9's JBOF (12 SSDs: 6 busy with 64 KB sequential reads at QD 64,
   6 idle; 400 windows of 1 ms, 50 of warm-up) on all eight platforms,
   XBOF and XBOF+ SIM_REPEATS times and the others once, each platform's
   per-SSD throughput, latency, proc_util, miss_ratio and borrowed_seg
   within SIM_TOL of the JAX reference's values (`SIM_JBOF12_PINS`), XBOF
   and XBOF+ also against the port's CPU path on the same inputs with
   their descriptor tables equal, and fig. 9c's utilization gap and fig.
   12's BOM saving printed beside the paper's targets; `sim_trace8_obs`,
   fig. 20 at full length (4 busy SSDs whose working set bursts over
   windows 100-300, 4 idle, 480 windows; XBOF with 8 % of the DRAM),
   trace-driven with the observability plane, one `shards_window` launch
   a window (its count zeroed just before each run and read just after),
   the busy SSDs' borrowed segments back under 10 % of their burst peak
   within 40 windows of the burst's end, the card against the CPU path
   (tables, SHARDS tables and decoded events equal), and the window
   kernel against its plain version on the last window bit for bit;
   `sim_fleet4096`, fig. 22's fleet of 4096 SSDs in 256 enclosures of
   16, federated and isolated, the busy SSDs' mean latency within
   SIM_TOL of the reference's (`SIM_FLEET_PINS`), federation below
   isolation, the card against the CPU path (tables equal), and the same
   at 256 SSDs. Each prints its ms per window (median and spread), its
   windows per second and, from `torch.profiler`, its kernels per
   management window and per other window, beside the card line;
3. drives the model zoo's serve path through `launch.serve.run_model`:
   qwen3-14b at its full published width and depth (bf16, batch 4, prompt
   2048, 32 greedy tokens) and h2o-danube-1.8b at its full config (batch
   1, prompt 8192 past its 4096 sliding window, 16 tokens, so the window
   masks and the ring cache wraps), then the recurrent families at their
   full published configs (bf16, batch 4, prompt 2048, 32 greedy tokens):
   recurrentgemma-9b (26 RG-LRU layers and 12 local-attention layers of
   window 2048, whose ring wraps in decode) and rwkv6-3b (32 RWKV6
   layers); then the DeepSeek MoE/MLA family at full published width,
   depth cut to fit the card (bf16, batch 4, prompt 1024, 32 greedy
   tokens): deepseek-v2-236b's 1 dense + 7 MoE layers and
   deepseek-v3-671b's 3 dense + 2 MoE layers; then whisper-tiny whole
   (bf16: 16 clips of 1500 frames from the audio stub through its 4
   encoder layers, a 4-token decoder prompt, 128 greedy tokens through its
   4 decoder layers with cross-attention) and qwen2-vl-2b whole (bf16: 4 x
   2048 embedding positions from the vision stub, M-RoPE, 32 greedy
   tokens). Each kernel must run once
   per layer of its kind in the prefill (flash twice a decoder layer of an
   encoder-decoder, once an encoder layer), and the router once per MoE
   layer in every decode step too (every launch count zeroed just before
   the run, read just after; MLA launches no flash kernel), the logits
   must be finite, and decode must not synchronize with the host; the
   DeepSeek runs are repeated from the same seed and must give the same
   tokens and logits bit for bit. Each
   kernel is held against its plain version on the inputs the first and
   last layers of its kind gave it (the router also on the first decode
   step's; whisper's flash on its encoder's, its first decoder layer's
   self- and cross-attention's and its last cross-attention's), and each
   model line counts its flash calls by shape. Each model is freed before
   the next starts;
4. times each kernel form on the inputs the main path gave it, beside its
   plain version, one PyTorch library call computing the same function
   where there is one, and the least time the card could take (bytes over
   the memory rate or operations over the peak rate of their type,
   whichever is larger); the paged-attention rows also carry `ms_spun`,
   the time with a spin kernel queued ahead of each start event so that
   the wrapper's host time stays out of the window (`timed_spun_ms`; the
   run fails when that host time outlasts the spin; `ms`
   keeps the earlier events-around-the-wrapper method), the share of
   the bound reached (`of_bound`, bound / ms_spun), and whether a second
   call on the main path's inputs gave the same bits (`repeat_equal`,
   which must hold); so do the router rows (prefill, and `decode_` keys
   for the first decode step) and the FTL row, with `floor_ms`, the spun
   time of one trivial launch (`torch.cuda._sleep(1)`, printed once on
   the `kernels` line), and `of_bound_floor`, max(bound, floor_ms) /
   ms_spun; the router rows' `torch.topk` yardstick also spun
   (`library_ms_spun`); the FTL row also `gather_ms`, the spun time of one
   PyTorch gather (`index_select`) of the burst's hit entries, a yardstick
   of random 32-byte sectors beside `sector_bound_ms`, its bound counted
   in sectors; the flash and scan rows also carry the share of
   the bound reached (`of_bound`, bound / time), the flash rows the
   achieved TFLOP/s, the bf16 WKV row, whose products run on the tensor
   cores, its bound at the bf16 peak and, beside it, the bound at the fp32
   rate, and the RG-LRU rows whether they equal the plain version bit for
   bit (`bit_equal`, which must hold) and, as a yardstick of the memory's
   rate, the time of a `torch.add` that moves the same bytes (`stream_ms`);
   the flash backward's row (`flash_attention_bwd[bf16]`, not a TPU
   kernel: it stands for the reference's autodiff) at h2o-danube's
   training attention (FLASH_BWD_TRAIN), on the forward kernel's output
   and statistics, checked per element against the plain gradient in fp32
   with its fp32 form, spun, beside its plain gradient, the backward of
   `scaled_dot_product_attention` with the band as a mask and its bound
   (10 * D flops a pair and head at the bf16 peak; the design's 14 * D,
   16 * D at head dim 256, beside it), and the same at whisper-tiny's training cross-attention
   (FLASH_BWD_WHISPER), qwen2-vl-2b's (FLASH_BWD_QWEN2_VL) and
   recurrentgemma-9b's (FLASH_BWD_RECURRENTGEMMA);
   the flash rows at whisper's encoder and cross shapes and qwen2-vl's
   prefill, on their phases' inputs, with their launches at that shape; the
   scans' backward rows (`rglru_bwd[bf16]`, `rwkv6_wkv_bwd[bf16]`) on
   random inputs at their training shapes and the router's
   (`topk_router_bwd[v2]`, `[v3]`) at DeepSeek's full widths, each
   checked, spun, beside `floor_ms`, its plain gradient and its bound;
   The SHARDS window kernel's row (`shards_window`, not a TPU kernel: it
   stands for the reference's `lax.scan`; its launches count the
   simulator's `sim_trace8_obs` too) is timed on `trace_fp32`'s
   last window, spun and unspun, beside one run of its plain loop on the
   card and its byte bound;
3a. trains h2o-danube-1.8b at its full published config through
   `launch.train`'s `init`, `train` and `resume` (TRAIN: bf16, batch 2,
   seq 8192, 2 microbatches, 4 steps, remat): a checkpoint after step 1
   (18.3 GB, written to `train_ckpt/` in the checkout and removed after),
   restored into a fresh state whose steps 2 and 3 must give the
   uninterrupted run's losses and grad norms to rtol=1e-6; every step
   under the sync debug mode, with finite numbers and 96 forward and 48
   backward flash launches (`train_expected`); with ms a step, tokens/s,
   peak memory, the checkpoint's seconds and the step split by stage
   (`train_split`); then one train step on the card against the CPU path
   (`train_gpu_vs_cpu`: the full width at 2 layers in bf16, the narrow
   fp32 config and a bf16 twin, within TRAIN_TOL; each parameter's
   update, at TRAIN_VS_CPU_LR, against the CPU's); and whisper-tiny
   whole the same way (TRAIN_WHISPER: 16 clips x 448 decoder tokens over
   1500 frames, 2 microbatches, 3 steps, the restart at step 2; 48
   forward and 24 backward flash launches a step);
3b. trains the recurrent families at full published width, depth cut
   (TRAIN_FAMILIES: recurrentgemma-9b at one (rec, rec, attn) period,
   rwkv6-3b at 8 layers; and qwen2-vl-2b whole from its stub's
   embeddings; bf16, batch 2 x 4096, 2 microbatches, remat, 3 steps)
   through `launch.train`, each step under the sync debug mode with
   finite numbers and exactly `train_expected`'s launches of every forward
   and backward kernel (RG-LRU 8 and 4 a step with flash 4 and 2; WKV 32
   and 16), with ms a step, tokens/s, peak memory and `train_split`; then
   one step on the card against the CPU path for recurrentgemma-9b at 3
   layers in bf16 and rwkv6-3b at 2 in fp32 (batch 1, seq 512; rwkv6's
   within RWKV6_TRAIN_TOL), whisper-tiny whole (bf16, batch 1 x 448) and
   qwen2-vl-2b at 2 layers (bf16, batch 1 x 512), and for the
   recurrentgemma, rwkv6, deepseek-v2, deepseek-v3, whisper and qwen2-vl
   smoke configs (fp32), launches included;
5. checks the engine (4 replicas with int8 pages; and 8 replicas in 2
   shards, metered, with fp32 pages redirecting across shards and with
   int8 pages borrowing link bytes across shards, and the fp32 one
   trace-driven with the observability plane on, whose integer and bool
   state — the SHARDS table and clock, the rings' cursor and the event
   log's count included — must equal bit for bit every step), and seven narrow fp32 models (a dense one,
   recurrentgemma-smoke and rwkv6-smoke with a prompt of 128,
   deepseek-v2-smoke and deepseek-v3-smoke with a prompt of 1040, whose
   2080 tokens take the MoE's sorted dispatch, whisper-smoke and
   qwen2-vl-smoke with a prompt of 128 and their stubs' embeddings; 8
   decode steps), on the GPU
   against the same code on the CPU (the plain path).

The `build` line also carries nvcc's registers and spills of each flash,
WKV, RG-LRU, paged-attention, router, FTL and SHARDS window instantiation
and of each backward kernel, the count of HGMMA (wgmma)
instructions in the SASS of the flash library and of the flash
backward's, and of HMMA (mma.sync) in the WKV library's (cuobjdump); a
count of 0 fails the run.

Prints the card's name and power limit, a JSON line per phase (`build`,
`paged_checks`, `flash_checks`, `flash_bwd_checks`, `scan_checks`,
`router_checks`, `scan_bwd_checks`, `router_bwd_checks`, `ftl`, `engine`,
`engine_ranks`, `mla_seq_sharded_v2`, `sim_jbof12`, `sim_trace8_obs`, `sim_fleet4096`, `model`, `model_window`,
`model_hybrid`, `model_rwkv`, `model_moe_v2`, `model_moe_v3`,
`model_whisper_tiny`, `model_qwen2_vl_2b`, `train_h2o_danube`,
`train_whisper_tiny`, `train_recurrentgemma_9b`, `train_rwkv6_3b`,
`train_qwen2_vl_2b`, `train_gpu_vs_cpu`,
`gpu_vs_cpu_engine`, `gpu_vs_cpu_model`), the script's
own time (`run`, the build included, with `phase_end_s`: each phase's
end in seconds from the start), the `kernels` JSON line — per kernel form its checks and its numbers of step 4 — and
last `{"ok": true, "device": {...}}`. Any failure exits non-zero before
the last line. Needs one CUDA device; exits non-zero without one, or when
run outside a checkout.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent

# the engine configuration of the main path: qwen3-14b attention width
# (src/repro/configs/qwen3_14b.py), 8 replicas under skewed arrivals
FULL_WIDTH = dict(n_replicas=8, seq_slots=64, shadow_slots=16,
                  pages_per_replica=48, page=16, max_pages=16,
                  n_heads=40, kv_heads=8, head_dim=128)
ARRIVALS = [16, 4, 0, 0, 0, 0, 0, 0]
STEPS = 32
# each phase is driven this many times from the same seeds (every run held
# to the same counts), for the spread of its host-bound ms per step
REPEATS = 3
# the simulator's timed runs (`sim_jbof12`'s XBOF and XBOF+, `sim_trace8_obs`,
# `sim_fleet4096`'s federated fleets): one each, cut from REPEATS to keep the
# script's run near its length before the trainer's phases came (their gates
# and their CPU-path comparisons are unchanged; their spread is that of one run)
SIM_REPEATS = 1
# the reference's counts of the two trace-driven phases: the same as those
# of `fp32` and `enclosure4_int8_metered` (the want reserves pages only on
# replicas that lend none), so the telemetry plane's gate is the want
# itself: WANT_PAGES_LAST, the reference's want_pages at the last step
TRACE_FP32_COUNTS = (325, 88, 120, 0)
TRACE_ENCLOSURE_COUNTS = (0, 0, 16, 192)
WANT_PAGES_LAST = {
    "trace_fp32": [48.0, 48.0, 48.0, 48.0, 5.0, 0.0, 0.0, 0.0],
    "trace_enclosure4_int8_metered_obs": [48.0, 48.0] + [16.0] * 6,
}
# (redirected summed over the steps, offsite_pages and log_commits at the
# last step, cross_redirected summed over the steps) of the JAX reference
# engine on the same configurations: `repro.serving.engine.step` on the
# CPU, STEPS steps from `init(cfg, jax.random.key(0))` with ARRIVALS (the
# counts do not depend on the weights or the activations)
PHASES = {
    "fp32": (dict(kv_quant="none"), (325, 88, 120, 0)),
    "int8_metered": (dict(kv_quant="int8", link_pages_per_step=4), (12, 20, 52, 0)),
    # the hierarchical engine: 2 shards of 4 replicas, one flat exchange
    "sharded2_fp32": (dict(kv_quant="none", n_shards=2), (203, 64, 96, 128)),
    # depth 3: 4 shards of 2 replicas, 2 shards an enclosure, metered
    "enclosure4_int8_metered": (dict(kv_quant="int8", link_pages_per_step=4,
                                     n_shards=4, shards_per_enclosure=2),
                                (0, 0, 16, 192)),
    # the telemetry plane: one shard, the page-access stream through the
    # SHARDS window kernel, its want reserving lendable pages
    "trace_fp32": (dict(kv_quant="none", trace_driven=True), TRACE_FP32_COUNTS),
    # both planes on the depth-3 hierarchy: telemetry, and the metric rings
    # and grant-event log (the obs dict becomes the port's ObsConfig)
    "trace_enclosure4_int8_metered_obs": (
        dict(kv_quant="int8", link_pages_per_step=4, n_shards=4,
             shards_per_enclosure=2, trace_driven=True,
             obs=dict(enabled=True, ring_depth=32, event_capacity=4096)),
        TRACE_ENCLOSURE_COUNTS),
}
# the failure plane (ROADMAP queue 1 item 6): `serving.scenarios.drive_events`
# at FULL_WIDTH with track_failures, ARRIVALS for STEPS steps, then zero
# arrivals for up to 96 steps until every sequence finished. Each schedule
# hits replica 2, the lender holding the most offsite pages at step 16 in
# the reference's run of the same configuration (offsite pages per lender
# [0, 0, 16, 4, 4, 4, 4, 0] fp32, [0, 0, 8, 8, 4, 4, 4, 4] int8: the first
# of a tie). phase -> (config, (event kind, window, target), reclaim_lead,
# the JAX reference's FailoverRun: `repro.serving.scenarios.drive_events` on
# the CPU from `init(cfg, jax.random.key(0))`, equal at the full 40 heads
# and at 1 head of 8 (fp32) or 8 heads (int8, metered: the page's bytes
# price the link account): the counts do not depend on the weights or the
# activations; `scripts/failover_pins.py` recomputes both,
# tests/test_torch_failover.py the fp32 one)
FAILOVER = {
    "failover_fp32": (
        dict(kv_quant="none", track_failures=True), ("ssd_fail", 16, 2), 8,
        dict(completed=640, aborted=0, requeued=0, lost_tokens=208,
             lost_sequences=0, revoked=2, seq_steps=9808, migrated_pages=0,
             drained=True)),
    # the same crash planned (a hot remove with 4 windows of warning):
    # metered int8 pages, the reclaim predictor draining up to 4 pages a
    # step, the obs plane counting the moves
    "failover_int8_metered_migrate_obs": (
        dict(kv_quant="int8", link_pages_per_step=4, track_failures=True,
             migrate_pages_per_step=4,
             obs=dict(enabled=True, ring_depth=32, event_capacity=4096)),
        ("ssd_hot_remove", 16, 2), 4,
        dict(completed=640, aborted=0, requeued=0, lost_tokens=0,
             lost_sequences=0, revoked=2, seq_steps=9600, migrated_pages=8,
             drained=True)),
}
# `failover_fig23`: the reference's own fig. 23 scenario
# (benchmarks/fig23_failover.py:57-91, `scenarios.failover_scenario`) in its
# three runs; run -> (migrate, obs, (event kind, window, target) or None,
# reclaim_lead, (completed, lost_sequences, lost_tokens, requeued, revoked,
# seq_steps, migrated_pages) of benchmarks/baselines/fig23_failover.json)
FIG23_STEPS = 30
FIG23 = {
    "baseline": (0, False, None, 8, (12, 0, 0, 0, 0, 180, 0)),
    "unpredicted": (0, False, ("ssd_fail", 15, 2), 8, (12, 0, 18, 1, 2, 210, 0)),
    "predicted": (4, True, ("ssd_hot_remove", 15, 2), 2, (12, 0, 6, 1, 1, 198, 4)),
}
FIG23_SPIKES = {"unpredicted": 30, "predicted": 18}
# kernel vs plain version (the gates of tests/test_kernels.py)
TOL = {"fp32": 3e-5, "bf16": 3e-2, "int8": 1e-5}
# paged attention vs plain version, random inputs (`random_inputs`): label
# -> (b, h, kv, d, page, max_pages, pool pages, table pattern). The engine's
# default layer and qwen3-14b's width with random tables; the engine step's
# pattern at that width; length-0 rows with stale page ids; pages of 1 and
# 32 slots; group 1 and 8; head_dim 64, 80 and 256; head_dim 36 and 33,
# whose rows are not a multiple of 16 bytes in bf16 (72 and 66 bytes) nor
# in int8 (36 and 33); full 16-page rows with holes
PAGED_CHECKS = {
    "engine_default": (40, 4, 2, 32, 16, 16, 256, "random"),
    "qwen3_14b_width": (640, 40, 8, 128, 16, 16, 384, "random"),
    "main_path": (640, 40, 8, 128, 16, 16, 384, "main"),
    "stale_ids": (64, 40, 8, 128, 16, 16, 384, "stale"),
    "page1": (24, 8, 4, 64, 1, 40, 512, "random"),
    "page32": (12, 8, 2, 128, 32, 8, 64, "random"),
    "group1_d80": (16, 8, 8, 80, 16, 8, 96, "random"),
    "group8_d256": (16, 16, 2, 256, 16, 8, 96, "random"),
    "d64": (20, 8, 2, 64, 16, 8, 96, "random"),
    "d36": (20, 8, 2, 36, 16, 8, 96, "random"),
    "d33": (20, 8, 2, 33, 16, 8, 96, "random"),
    "full16": (64, 40, 8, 128, 16, 16, 384, "full"),
}
# the spin kernel ahead of each `timed_spun_ms` launch: about 1 ms of
# device clock, far longer than a kernel wrapper's host time
SPIN_CYCLES = 2_000_000
# published H100 SXM rates (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores and dense bf16 FLOP/s on the tensor cores
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

# the model zoo's serve path: (arch, batch, prompt, generated tokens)
MODEL = ("qwen3-14b", 4, 2048, 32)
MODEL_WINDOW = ("h2o-danube-1.8b", 1, 8192, 16)
MODEL_HYBRID = ("recurrentgemma-9b", 4, 2048, 32)
MODEL_RWKV = ("rwkv6-3b", 4, 2048, 32)
# the DeepSeek MoE/MLA family at full published width, depth cut to fit one
# card (the full models hold 2.357e11 and 6.717e11 parameters): (arch,
# batch, prompt, generated tokens, layers run). v2: its 1 dense + 7 MoE
# layers; v3: its 3 dense + 2 MoE layers. A prompt of 1024 keeps MLA's
# dense [B, 128, S, S] scores (below 4096 keys) to 1 GB in bf16.
MODEL_MOE_V2 = ("deepseek-v2-236b", 4, 1024, 32, 8)
MODEL_MOE_V3 = ("deepseek-v3-671b", 4, 1024, 32, 5)
# the encoder-decoder and the M-RoPE model at their full published configs
# (bf16): whisper-tiny (4 + 4 layers), 16 clips of 1500 frames (30 s of
# audio each, the audio stub's frame embeddings), a 4-token decoder prompt
# (the start-of-transcript sequence), 128 greedy tokens; qwen2-vl-2b (28
# layers), 4 x 2048 embedding positions (an image's patches and its text,
# through the vision stub), 32 greedy tokens, like qwen3-14b's phase
MODEL_WHISPER = ("whisper-tiny", 16, 4, 128)
MODEL_QWEN2_VL = ("qwen2-vl-2b", 4, 2048, 32)
# the trainer (`launch.train`'s functions): h2o-danube-1.8b at its full
# published config, bf16 (1.83e9 parameters: the largest config of the
# repo whose AdamW state fits one card): (arch, batch, seq, microbatches,
# steps). Its window of 4096 binds at seq 8192. A checkpoint after step 1
# is restored into a fresh state that runs steps 2 and 3 again.
TRAIN = ("h2o-danube-1.8b", 2, 8192, 2, 4)
TRAIN_CKPT_EVERY = 2
# whisper-tiny whole, through the same `init`, `train` and `resume`: 16
# clips of 1500 frames under 448 decoder tokens (whisper's full decoder
# window), 2 microbatches, remat, 3 steps; a checkpoint after step 1 is
# restored into a fresh state that runs step 2 again
TRAIN_WHISPER = ("whisper-tiny", 16, 448, 2, 3)
# the recurrent families' training at full published width, depth cut:
# phase -> (arch, layers, batch, seq, microbatches, steps). recurrentgemma-9b
# (src/repro/configs/recurrentgemma_9b.py) at one (rec, rec, attn) period
# of its 38 layers (1.705e9 parameters, 1.05e9 of them the tied embedding);
# rwkv6-3b (src/repro/configs/rwkv6_3b.py) at 8 of its 32 layers (1.044e9
# parameters; at 32 its AdamW state alone is ~76 GB). Each: batch 2 x 4096
# in 2 microbatches under remat, 3 steps
TRAIN_FAMILIES = {
    "train_recurrentgemma_9b": ("recurrentgemma-9b", 3, 2, 4096, 2, 3),
    "train_rwkv6_3b": ("rwkv6-3b", 8, 2, 4096, 2, 3),
    # qwen2-vl-2b (src/repro/configs/qwen2_vl_2b.py) whole, all 28 layers
    # (1.544e9 parameters; its AdamW state ~15 GB), from the vision stub's
    # embeddings: batch 2 x 4096 in 2 microbatches under remat, 3 steps
    "train_qwen2_vl_2b": ("qwen2-vl-2b", 28, 2, 4096, 2, 3),
}
# the trainer on the card against the CPU path: the full width at 2 layers
# (bf16, batch 1, seq 512), the narrow fp32 dense config and its bf16 twin
# (batch 2, seq 128). Gates: fp32 loss and grad norm within 1e-5, moments
# within 1e-4 (m) and 2e-4 (v) of their leaf's largest magnitude; bf16 loss
# within 1e-2 and grad norm within 3e-2 relative, m within 3e-2 and v
# within 6e-2 of their leaf's largest magnitude (v is a square). The
# parameters by their update, new - old (`update_close`): AdamW moves an
# element by lr_t * (d + wd * p), d = m_hat / (sqrt(v_hat) + eps) from the
# side's own moments, so the two sides' updates differ by lr_t * |d_card -
# d_cpu| (2 * lr_t where a gradient near zero takes the other sign, ~0
# elsewhere) plus the rounding of the new value, p_rel * |new| (an ulp:
# 2^-7 in bf16, 1e-5 for fp32), plus lr_t * 1e-5 (d's own fp32 rounding).
# The step takes TRAIN_VS_CPU_LR, so that the first step's lr_t, 1e-3, is
# 8 bf16 ulps of a weight of 0.02 (at the default 3e-4 the first update,
# 3e-6, rounds away in bf16): a missing or sign-flipped update fails
TRAIN_VS_CPU = (1, 512)
TRAIN_TOL = {"fp32": dict(loss=1e-5, grad_norm=1e-5, m=1e-4, v=2e-4, p_rel=1e-5),
             "bf16": dict(loss=1e-2, grad_norm=3e-2, m=3e-2, v=6e-2, p_rel=2 ** -7)}
TRAIN_VS_CPU_LR = 0.1    # lr_t = 0.1 * 1 / 100 at the first of 100 warm-up steps
# rwkv6-3b at full width, 2 layers, runs in fp32 (batch 1, seq 512): in
# bf16 the card's step differs from the CPU's by 0.155 (m) with the kernels
# and by 0.086 with the plain WKV scan on the card, which says nothing of
# the kernels. RWKV6_TRAIN_TOL is set from the fp32 readings of
# scripts/torch_train_tolerance.py (H100, PERF.md): over seeds 21-23 the
# kernel step differs from the CPU's by at most 1.93e-4 (m), 2.28e-4 (v)
# and 1.39e-5 (grad norm), the plain scan on the card by 1.67e-4, 2.08e-4
# and 1.46e-5, the kernel step from the plain one on the card by 3.1e-5
# (m): the rest of the card's arithmetic, not the kernels, passes
# TRAIN_TOL's 1e-4. The limits are about twice the largest of these; each
# WKV backward output scaled by 1 + 1e-3 reads m 5.26e-4 to 1.46e-3 and v
# 1.05e-3 to 2.58e-3, past them
RWKV6_TRAIN_TOL = dict(TRAIN_TOL["fp32"], grad_norm=3e-5, m=4e-4, v=5e-4)
ADAMW = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, warmup=100)  # the defaults
# the JBOF simulator (`jbof.sim.simulate`, ROADMAP queue 1 item 4), three
# phases. `sim_jbof12`: the paper's JBOF of fig. 9
# (benchmarks/fig09_processor.py:18): 6 SSDs busy with 64 KB sequential
# reads at QD 64, 6 idle, 400 windows of 1 ms, all eight platforms static
SIM_JBOF12 = dict(windows=400, warmup=50, seed=0, busy=6, idle=6, io_kb=64.0)
SIM_JBOF12_METRICS = ("throughput_bps", "latency_s", "proc_util", "miss_ratio",
                      "borrowed_seg")
# platforms driven SIM_REPEATS times (the others once) and held against
# the port's CPU path on the same inputs
SIM_REPEATED = ("XBOF", "XBOF+")
# per-SSD values of `repro.jbof.sim.simulate` on the CPU on sim_jbof12's
# inputs (tests/test_torch_sim.py recomputes them and asserts these pins)
SIM_JBOF12_PINS = {
    'Conv': {
        'throughput_bps': [12677822464.0, 12677822464.0, 12677822464.0, 12677822464.0, 12677822464.0, 12677822464.0, 236583280.0, 237972080.0, 238175520.0, 239186192.0, 239112192.0, 238655616.0],
        'latency_s': [0.0003308369778096676, 0.0003308369778096676, 0.0003308369778096676, 0.0003308369778096676, 0.0003308369778096676, 0.0003308369778096676, 4.698588600149378e-05, 4.6886008931323886e-05, 4.687147156801075e-05, 4.679961784859188e-05, 4.6804863814031705e-05, 4.683727092924528e-05],
        'proc_util': [1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 0.016300557181239128, 0.016396230086684227, 0.016410253942012787, 0.016479892656207085, 0.01647479459643364, 0.016443340107798576],
        'miss_ratio': [0.0665285736322403, 0.0665285736322403, 0.0665285736322403, 0.0665285736322403, 0.0665285736322403, 0.0665285736322403, 0.035643186420202255, 0.035643186420202255, 0.035643186420202255, 0.035643186420202255, 0.035643186420202255, 0.035643186420202255],
        'borrowed_seg': [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    },
    'OC': {
        'throughput_bps': [5748560384.0, 5748560384.0, 5748560384.0, 5748560384.0, 5748560384.0, 5748560384.0, 236312112.0, 237620304.0, 238116240.0, 238905696.0, 238662592.0, 238333200.0],
        'latency_s': [0.0007296248804777861, 0.0007296248804777861, 0.0007296248804777861, 0.0007296248804777861, 0.0007296248804777861, 0.0007296248804777861, 4.809902748093009e-05, 4.800357419298962e-05, 4.796771099790931e-05, 4.7910849389154464e-05, 4.7928322601364926e-05, 4.7952064051060006e-05],
        'proc_util': [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        'miss_ratio': [0.17274875938892365, 0.17274875938892365, 0.17274875938892365, 0.17274875938892365, 0.17274875938892365, 0.17274875938892365, 0.0960189700126648, 0.0960189700126648, 0.0960189700126648, 0.0960189700126648, 0.0960189700126648, 0.0960189700126648],
        'borrowed_seg': [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    },
    'Shrunk': {
        'throughput_bps': [6338846720.0, 6338846720.0, 6338846720.0, 6338846720.0, 6338846720.0, 6338846720.0, 236583280.0, 237972080.0, 238175520.0, 239186192.0, 239112192.0, 238655616.0],
        'latency_s': [0.0006616807077080011, 0.0006616807077080011, 0.0006616807077080011, 0.0006616807077080011, 0.0006616807077080011, 0.0006616807077080011, 4.707610423793085e-05, 4.697621625382453e-05, 4.69616825284902e-05, 4.688982153311372e-05, 4.689506386057474e-05, 4.69274673378095e-05],
        'proc_util': [1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 0.03263004496693611, 0.03282159939408302, 0.032849639654159546, 0.03298903629183769, 0.03297882899641991, 0.0329158678650856],
        'miss_ratio': [0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384],
        'borrowed_seg': [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    },
    'VH': {
        'throughput_bps': [6338846720.0, 6338846720.0, 6338846720.0, 6338846720.0, 6338846720.0, 6338846720.0, 236609536.0, 237919712.0, 238218960.0, 239114448.0, 239067600.0, 238640256.0],
        'latency_s': [0.0006616807077080011, 0.0006616807077080011, 0.0006616807077080011, 0.0006616807077080011, 0.0006616807077080011, 0.0006616807077080011, 4.9414880777476355e-05, 4.9319587560603395e-05, 4.929951319354586e-05, 4.923353480990045e-05, 4.923986125504598e-05, 4.926758265355602e-05],
        'proc_util': [1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 0.032633669674396515, 0.0328143872320652, 0.03285565227270126, 0.032979149371385574, 0.032972682267427444, 0.03291374444961548],
        'miss_ratio': [0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384],
        'borrowed_seg': [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    },
    'VH(ideal)': {
        'throughput_bps': [6338846720.0, 6338846720.0, 6338846720.0, 6338846720.0, 6338846720.0, 6338846720.0, 236609536.0, 237919712.0, 238218960.0, 239114448.0, 239067600.0, 238640256.0],
        'latency_s': [0.0006616807077080011, 0.0006616807077080011, 0.0006616807077080011, 0.0006616807077080011, 0.0006616807077080011, 0.0006616807077080011, 4.9414880777476355e-05, 4.9319587560603395e-05, 4.929951319354586e-05, 4.923353480990045e-05, 4.923986125504598e-05, 4.926758265355602e-05],
        'proc_util': [1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 0.032633669674396515, 0.0328143872320652, 0.03285565227270126, 0.032979149371385574, 0.032972682267427444, 0.03291374444961548],
        'miss_ratio': [0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384],
        'borrowed_seg': [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    },
    'ProcH': {
        'throughput_bps': [12347696128.0, 12347696128.0, 12347839488.0, 12347839488.0, 12347516928.0, 12347516928.0, 236583280.0, 237972080.0, 238175552.0, 239186272.0, 239112208.0, 238655600.0],
        'latency_s': [0.00033968218485824764, 0.00033968218485824764, 0.000339678255841136, 0.000339678255841136, 0.0003396871325094253, 0.0003396871325094253, 4.7086090489756316e-05, 4.698620978160761e-05, 4.706994877778925e-05, 4.689982233685441e-05, 4.6905086492188275e-05, 4.6937471779529005e-05],
        'proc_util': [1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179],
        'miss_ratio': [0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384],
        'borrowed_seg': [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    },
    'XBOF': {
        'throughput_bps': [12347696128.0, 12347696128.0, 12347839488.0, 12347839488.0, 12347516928.0, 12347516928.0, 236583280.0, 237972080.0, 238175552.0, 239186272.0, 239112208.0, 238655600.0],
        'latency_s': [0.00033968218485824764, 0.00033968218485824764, 0.000339678255841136, 0.000339678255841136, 0.0003396871325094253, 0.0003396871325094253, 4.7086090489756316e-05, 4.698620978160761e-05, 4.706994877778925e-05, 4.689982961281203e-05, 4.6905086492188275e-05, 4.6937471779529005e-05],
        'proc_util': [1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179],
        'miss_ratio': [0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384],
        'borrowed_seg': [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    },
    'XBOF+': {
        'throughput_bps': [12347696128.0, 12347696128.0, 12347839488.0, 12347839488.0, 12347516928.0, 12347516928.0, 236583248.0, 237972112.0, 238175600.0, 239186176.0, 239112256.0, 238655600.0],
        'latency_s': [0.00033968218485824764, 0.00033968218485824764, 0.000339678255841136, 0.000339678255841136, 0.0003396871325094253, 0.0003396871325094253, 4.708609412773512e-05, 4.708455526269972e-05, 4.706993786385283e-05, 4.689984780270606e-05, 4.6905075578251854e-05, 4.693745722761378e-05],
        'proc_util': [1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179, 1.0000032186508179],
        'miss_ratio': [0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.1220116913318634, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384, 0.06571394205093384],
        'borrowed_seg': [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    },
}
# the paper's targets printed beside the port's numbers: fig. 9c's
# utilization gain of XBOF over Shrunk (benchmarks/fig09_processor.py:24-27)
# and fig. 12's BOM saving of XBOF against Conv (fig12_bom.py:13-16)
PAPER_UTIL_GAP = 0.504
PAPER_BOM_SAVING = -0.190
# `sim_trace8_obs`: fig. 20's scenario at full length
# (benchmarks/fig20_adaptive.py:36-68): 4 SSDs of random 4 KB reads at QD 8
# whose mapping-page working set bursts from 12 to 360 segments over
# windows 100-300, 4 idle; XBOF with 8 % of the DRAM; trace-driven, with
# the observability plane on
SIM_TRACE8 = dict(busy=4, idle=4, refs=48, windows=480, burst=(100, 300),
                  ws_burst_segments=360, ws_base_segments=12, dram_frac=0.08,
                  seed=0, lag_windows=40, ring_depth=64, event_capacity=1024)
# `sim_fleet4096`: fig. 22's scale-out (benchmarks/fig22_fabric.py:49-67):
# enclosures of 16 SSDs, half of them random 4 KB writers at 900 MB/s, the
# other half trickle reads; XBOF with the fabric tier at 1 extra hop,
# federated and isolated; 4096 SSDs, and 256 for the scaling
SIM_FLEET = dict(ssds=4096, small=256, per_enclosure=16, windows=200, warmup=50,
                 busy_bps=900e6, idle_bps=1e6, extra_hops=1.0)
# the busy SSDs' mean latency (seconds, float64 mean of the float32 values)
# of `repro.jbof.sim.simulate` on the CPU at 256 SSDs; the scenario is the
# same at every fleet size (tests/test_torch_sim_fabric_obs.py asserts it)
SIM_FLEET_PINS = {"federated": 2.0748524548253044e-05, "isolated": 3.2564621506026015e-05}
# `sim_events8_obs`: fig. 23's simulator run (benchmarks/fig23_failover.py:
# 93-131): 8 SSDs, 4 random 4 KB writers at 900 MB/s and 4 random readers,
# the loads of lenders 4 and 5 ramping to 3.2 GB/s over the 12 windows
# before their forced reclaims at windows 50 and 70 (16 windows each), SSD
# 6 failing at 90; XBOF, 120 windows, obs on. Its gates are the
# reference's (benchmarks/baselines/fig23_failover.json): the PROCESSOR
# withdraws of the reclaiming lenders, the reclaim predictor's (precision,
# recall, mean lead) replayed over their proc-util rings, and the
# revoked-grant ring's sum
SIM_EVENTS8 = dict(nodes=8, windows=120, busy_bps=900e6, ramp_bps=3.2e9,
                   events=(("lender_reclaim", 50, 4, 16),
                           ("lender_reclaim", 70, 5, 16), ("ssd_fail", 90, 6)),
                   withdraws=[(50, 4), (70, 5)], score=(1.0, 1.0, 3.0), revoked=6.0)
# `sim_fleet_events`: sim_fleet4096's federated fleet under a schedule of
# every kind the simulator takes: an idle lender reclaimed over windows
# 60-75, a busy SSD failing at 80, a busy enclosure dropping off the fabric
# at 100 and an idle one at 120 (node and enclosure ids valid at 256 and
# at 4096 SSDs); cut to the first 130 of sim_fleet4096's 200 windows, past
# the last event, so the CPU path it is held against stays short
SIM_FLEET_EVENTS = dict(windows=130, events=(
    ("lender_reclaim", 60, 200, 16), ("ssd_fail", 80, 20),
    ("enclosure_drop", 100, 3), ("enclosure_drop", 120, 10)))
# the float64 sum of `repro.jbof.sim.simulate`'s rings["revoked_grants"] on
# the CPU at 256 SSDs under SIM_FLEET_EVENTS (descriptor slots and the
# dropped enclosures' fabric grants; tests/test_torch_sim_events.py asserts
# it)
SIM_FLEET_EVENTS_PIN = 22602.5703125
# card against the JAX reference's pins and against the port's CPU path:
# floats within this relative error (with a floor of it times the
# field's largest value); host_util within SIM_HOST_TOL (the mean scale
# over the SSDs, tests/test_torch_sim.py)
SIM_TOL = 1e-4
SIM_HOST_TOL = 1e-3
# router kernel vs plain version: indices exact, weights within this
ROUTER_W_TOL = 1e-6
# (t, e, k): the sweep of tests/test_kernels.py, then DeepSeek-v2's (160,
# 6) and -v3's (256, 8) experts at a decode step's 4 tokens, a prefill's
# 4096 and a ragged 1000
ROUTER_CHECKS = [(256, 128, 6), (512, 256, 8), (128, 160, 2)] + [
    (t, e, k) for e, k in ((160, 6), (256, 8)) for t in (1, 4, 4096, 1000)]
# (t, e, k, pattern): the edges of the router kernel — E around a lane's
# slot count (31, 32, 33), DeepSeek's 160 and 256, the limit of 1024, each
# with k = 1 and 16; then rows of -0.0 and +0.0 with ties among them
# ("zeros"), rows of one value ("equal"), a bias that makes every sel
# negative ("negbias"), and scores a view one element into their storage,
# so rows of E % 4 == 0 off 16 bytes ("offset")
ROUTER_EDGES = [(1000, e, k, "random") for e in (31, 32, 33, 160, 256, 1024)
                for k in (1, 16)] + [
    (t, e, k, pattern) for t, e, k in ((64, 160, 6), (64, 256, 8), (64, 33, 16),
                                       (37, 1024, 16))
    for pattern in ("zeros", "equal", "negbias", "offset")]
# the FTL lookup at SSD scale: a 4 TB SSD's mapping table in 2 MB segments
# (src/repro_torch/jbof/ssd.py), half of its segments cached in DRAM (the
# shrunk DRAM of XBOF), a burst of 2^20 uniform LPNs
FTL_BURST = 1 << 20
# (n_seg, n_slots, entries, n): the sweep of tests/test_kernels.py
FTL_SWEEP = [(64, 16, 128, 512), (128, 32, 256, 1024), (16, 4, 512, 256)]
# (label, n_seg, n_slots, entries, n, offset): the edges of the FTL kernel
# — N of 1, 3 and 5 and past a whole number of blocks; lpns a view 1, 2
# and 3 elements into its storage (off 16 bytes); a directory of 70 000
# segments (280 KB, more than an SM holds); entries not a power of two
FTL_EDGES = [("n1", 64, 16, 128, 1, 0), ("n3", 64, 16, 128, 3, 0),
             ("n5", 64, 16, 128, 5, 0), ("n2^20+3", 1862, 931, 512, (1 << 20) + 3, 0),
             ("offset1", 1862, 931, 512, 100_003, 1), ("offset2", 64, 16, 128, 4097, 2),
             ("offset3", 64, 16, 128, 10, 3), ("dir70000", 70_000, 4096, 64, 100_003, 0),
             ("entries1000", 300, 64, 1000, 50_001, 0)]
# scan kernels vs plain versions: the RG-LRU kernel repeats the plain
# version's IEEE operations in fp32, the RWKV6 kernel sums K terms in
# another order; bf16 outputs may differ by one rounding of the fp32 result
SCAN_TOL = {"rglru": {"fp32": 1e-5, "bf16": 3e-2},
            "rwkv6_wkv": {"fp32": 1e-4, "bf16": 3e-2}}
# random inputs: the sweeps of tests/test_kernels.py, then a ragged T from
# an initial state; rwkv6 also at the smoke configs' width (16)
# (b, t, w, h0[, a[, offset]]); after the sweep, the edges of the RG-LRU
# kernel's tiles (chunks of 32 steps, 64 channels): T = 1, 31, 32 and 33, W
# = 40 and 130 from h0 (bf16 rows of 80 and 260 bytes), more blocks than
# SMs, B * W under one tile, an `a` with a quarter exactly 0 and a quarter
# exactly 1 ("zero-one"), and x and a as views an odd number of elements
# into their storage (the narrowest copies)
RGLRU_CHECKS = [(2, 256, 64, False), (1, 512, 128, False), (3, 128, 256, False),
                (2, 200, 96, True),
                (2, 1, 64, True), (1, 31, 64, False), (2, 32, 128, True),
                (3, 33, 64, False), (2, 75, 40, True), (3, 70, 130, True),
                (1, 66, 9000, True), (1, 45, 24, False),
                (2, 100, 96, True, "zero-one"), (1, 65, 130, False, "zero-one"),
                (2, 70, 130, True, "sigmoid", 1)]
# (b, t, h, k, s0[, decay]); then the bf16 kernel's chunks of 16 rows (T
# = 1, 63, 64, 65, 129), K = 128 from s0, more blocks than SMs, and the
# decays of `wkv_decay` (w = 0 and w = 1 exactly, down to e^-30, near e^-1)
RWKV6_CHECKS = [(1, 256, 2, 64, False), (2, 128, 4, 128, False),
                (2, 200, 3, 32, True), (3, 70, 4, 16, True),
                (2, 1, 3, 64, True), (1, 63, 2, 64, False), (1, 64, 2, 32, True),
                (2, 65, 2, 64, True), (1, 129, 4, 16, True), (2, 97, 2, 128, True),
                (2, 512, 80, 64, False),
                (2, 200, 3, 64, True, "zero-one"), (1, 65, 2, 16, False, "zero-one"),
                (1, 130, 2, 128, True, "near0"), (2, 77, 3, 32, False, "near0"),
                (2, 300, 4, 64, True, "main")]
# flash kernel vs plain version, random inputs: (b, s, t, h, kv, d,
# causal, window) — the sweep of tests/test_kernels.py under its three
# masks, then head_dim 80 and 16, a ragged non-causal length, queries
# offset against a longer key sequence (S < T), and rows with no valid
# key (causal with S > T)
FLASH_SWEEP = [(2, 256, 4, 2, 128), (1, 384, 6, 6, 128), (2, 128, 8, 1, 128),
               (1, 512, 2, 2, 256)]
FLASH_SHAPES = [(b, s, s, h, kv, d, c, w) for b, s, h, kv, d in FLASH_SWEEP
                for c, w in ((True, 0), (True, 128), (False, 0))] + [
    (2, 256, 256, 32, 8, 80, True, 0), (1, 300, 300, 32, 8, 80, True, 96),
    (3, 70, 70, 4, 2, 16, True, 0), (1, 200, 200, 4, 2, 128, False, 0),
    (2, 64, 256, 8, 2, 128, True, 0), (1, 256, 64, 4, 2, 128, True, 0)] + [
    # the edges of the bf16 wgmma kernel's tiles (128 query rows, 128 or 80
    # keys, boxes of 16, 32 or 64 columns): ragged S and T, S = 1, head
    # dims 32, 64 and 96, recurrentgemma-9b's layout cut down (16 heads,
    # one KV head, head_dim 256, window 128), head_dim 80 with S < T
    (1, 129, 191, 4, 2, 128, True, 0), (2, 191, 129, 4, 2, 64, False, 0),
    (1, 1, 77, 4, 2, 96, True, 0), (2, 1, 300, 8, 1, 256, True, 128),
    (1, 300, 300, 4, 2, 32, True, 64), (2, 256, 256, 8, 8, 64, True, 0),
    (1, 200, 200, 6, 3, 96, False, 0), (1, 300, 300, 16, 1, 256, True, 128),
    (1, 200, 300, 32, 8, 80, True, 96),
    # more work items than SMs: each persistent block walks several
    (2, 1100, 1100, 16, 4, 64, True, 0), (1, 650, 650, 48, 2, 256, True, 200),
    # the model zoo's enc-dec and M-RoPE shapes: whisper-tiny's causal
    # encoder over 1500 frames, its cross-attention (4 decoder queries over
    # 1500 keys, unmasked, the last key tile ragged) and its decoder's
    # 4-token self-attention, 16 clips at head_dim 64; qwen2-vl-2b's
    # prefill (12 query heads over 2 KV heads of 128)
    (16, 1500, 1500, 6, 6, 64, True, 0), (16, 4, 1500, 6, 6, 64, False, 0),
    (16, 4, 4, 6, 6, 64, True, 0), (4, 2048, 2048, 12, 2, 128, True, 0)]
# the flash backward kernel vs its plain version (`ref.attention_bwd`),
# random inputs: (b, s, t, h, kv, d, causal, window) — head dims 64, 80,
# 128 and 256 (and 8, 16 and 40: any multiple of 8), GQA groups 1, 4 and
# 8, causal, non-causal and causal with a window, S = T and S < T, T off
# the kernel's key tiles (64 keys, 32 at D > 128), rows with no valid key
FLASH_BWD_SHAPES = [
    (2, 256, 256, 4, 4, 64, True, 0), (1, 200, 200, 8, 2, 64, False, 0),
    (1, 300, 300, 32, 8, 80, True, 96), (2, 100, 300, 8, 1, 80, True, 0),
    (1, 130, 333, 16, 2, 128, True, 100), (2, 128, 128, 4, 4, 128, False, 0),
    (1, 190, 190, 8, 2, 256, True, 0), (1, 200, 260, 8, 1, 256, True, 64),
    (1, 70, 150, 2, 2, 256, False, 0), (1, 97, 97, 4, 2, 40, True, 0),
    (1, 80, 50, 4, 2, 16, True, 0), (1, 33, 33, 2, 1, 8, True, 0),
    # the trainers' enc-dec and M-RoPE shapes: a microbatch of
    # whisper-tiny's cross-attention (448 decoder tokens over 1500 frames,
    # unmasked) and encoder (causal over 1500), qwen2-vl-2b's causal 4096
    (8, 448, 1500, 6, 6, 64, False, 0), (8, 1500, 1500, 6, 6, 64, True, 0),
    (1, 4096, 4096, 12, 2, 128, True, 0)]
# the gates, per element of each gradient: |got - want| <= c1 * |want| + c2
# * rms(want), (c1, c2) from a table by form. Two wants, both in fp32 of
# the inputs (bf16 ones widened: the kernel widens them and sums in fp32
# too): the plain gradient, `ref.attention_bwd` (BWD_TOL), and the
# backward's formulas with delta = rowsum(dO * o) taken from the o handed
# to the kernel (`bwd_given_o`, BWD_O_TOL). c1 is the output's rounding
# (half a bf16 ulp, 2^-8; for fp32 a few ulps); c2 takes what spreads over
# a row or a column: the order of the sums, and against the plain
# gradient bf16's o, whose rounding enters every dS of its row through
# delta (a row of one key has dq = 0 exactly, yet a rounded o gives it
# dS = dO . (v - o)), so that gate is wide; given the same o, only the
# sums' order and the output's rounding are left, and that gate holds
# every row, those of a 4096-key band included, to about bf16's rounding.
# c2 from the errors measured on an H100 (this sweep and FLASH_BWD_TRAIN):
# plain 0.162 bf16 (0.092 on the sweep), 2.8e-4 fp32; given o 5.7e-5 bf16,
# 3.5e-4 fp32 (fp32 errors sit near 4e-6 of the largest values)
#
# Since the backward runs bf16 on the tensor cores (every head dim), it
# rounds P and dS to bf16 before the three products, as the forward rounds
# P; the given-o want then does the same (`bwd_given_o(operands="bf16")`,
# the kernel's `flash_attention.bwd_operands`), so that BWD_O_TOL still
# holds the sums' order and the output's rounding alone; the error against
# the fp32-operand want is printed beside it, without a gate. The kernel
# rounds its own fp32 P and dS, which differ from the want's in their last
# bits (other sums' order, a MUFU exp2, the saved statistics): where the
# want's fp32 value lies that close to a bf16 rounding midpoint, the
# kernel may round to the other neighbour, one bf16 ulp of the term away.
# On an H100 such flips alone came to 0.007-0.02 of rms (and noise of 1e-6
# in P does the same on the CPU), so the want carries, per element,
# the sum of those terms' ulps times their partners' magnitudes
# (`bwd_given_o`'s allowance; 0 where no rounding is in doubt), and the
# gate is |err| <= c1 |want| + c2 rms(want) + allowance with (c1, c2) =
# BWD_O_TOL unchanged. The doubt radius is the worst case of the two fp32
# computations' difference: a D-term sum taken in two orders differs by
# at most 2 D 2^-24 of its terms' magnitudes (q.k in P's exponent; dP and
# delta in dS), and ROUND_DELTA relative more in P covers the rest (the
# exponent's products, the exp2's 2 ulps, the statistics, measured within
# 4e-6 under STATS_TOL); dS takes P's relative radius times |dS| plus P
# times its sums' radius. An allowance is at most 2^-7 of the sum of its
# element's terms' magnitudes, so a wrong term still shows.
BWD_TOL = {"fp32": (1e-6, 1e-3), "bf16": (2 ** -8, 0.25)}
BWD_O_TOL = {"fp32": (1e-6, 1e-3), "bf16": (2 ** -8, 2e-4)}
ROUND_DELTA = 2 ** -16
# the forward's softmax statistics against `ref.attention_stats` (fp32 of
# the widened inputs): m within STATS_TOL * (1 + |m|), l within STATS_TOL
# * l (the scores' sums in another order, the bf16 kernel's base-2
# exponent and its MUFU exp2); a row with no valid key keeps m = NEG_INF
# exactly
STATS_TOL = 1e-4
# h2o-danube-1.8b's training attention: one microbatch of 8192 tokens, 32
# query heads and 8 KV heads of 80, its sliding window of 4096
FLASH_BWD_TRAIN = (1, 8192, 8192, 32, 8, 80, True, 4096)
# whisper-tiny's training cross-attention: a microbatch of 8 clips, 448
# decoder queries over 1500 encoder keys, 6 heads of 64, unmasked
FLASH_BWD_WHISPER = (8, 448, 1500, 6, 6, 64, False, 0)
# qwen2-vl-2b's (a microbatch of 4096 tokens, 12 query heads over 2 KV
# heads of 128, causal) and recurrentgemma-9b's (4096 tokens, 16 query
# heads over one KV head of 256, its local window of 2048)
FLASH_BWD_QWEN2_VL = (1, 4096, 4096, 12, 2, 128, True, 0)
FLASH_BWD_RECURRENTGEMMA = (1, 4096, 4096, 16, 1, 256, True, 2048)
# the backward kernels of the scans and the router against their plain
# gradients (`ref.rglru_bwd`, `ref.rwkv6_wkv_bwd`, `ref.topk_router_bwd`:
# autograd of the plain forward, in the inputs' dtype as the trainer runs
# them). The RG-LRU kernel does the plain gradient's IEEE operations in its
# order: value for value, NaN where it has NaN (`same_values`). The WKV and
# router kernels sum in another order: per element |err| <= c1 |want| + c2
# rms(want) (`grad_gate`), c1 a rounding of the output (bf16: one ulp,
# 2^-7 of the value, where the two fp32 sums straddle a rounding; the
# router's fp32 a few ulps), c2 what a sum's order spreads over a row;
# non-finite wants at the same places with the same values. The router's
# c2: its sum over the picks, in another order, errs by ulps of the
# largest term, dw / max(s, 1e-9) (10 dw for a softmax's picks summing
# to 0.1), and rms over [T, E] is sqrt(k / E) of the picks' own (0.19 at
# k = 6 of 160); the first card run measured 1.56e-06
WKV_BWD_TOL = {"fp32": (1e-5, 1e-4), "bf16": (2 ** -7, 1e-3)}
ROUTER_BWD_TOL = (1e-6, 1e-5)
# the sweeps: the forward checks' shapes; the RG-LRU's also with a = 1 on
# a quarter of the elements and x = 0 on half of those ("one-x0": da =
# -inf, and NaN where x = 0); the WKV's ("zero-one": w = 0 and w = 1
# exactly) with a final-state cotangent wherever s0 is given; each last
# entry with its inputs and dout as views 3 elements into their storage
# (the 7th field: off 16 bytes in both forms, so the WKV kernels take
# plain loads in place of cp.async, and the RG-LRU chains copy 2 bf16 or
# 4 fp32 bytes at a time)
RGLRU_BWD_CHECKS = RGLRU_CHECKS + [(2, 70, 130, True, "one-x0"),
                                   (1, 33, 64, False, "one-x0"),
                                   (2, 70, 130, True, "one-x0", 0, 3)]
RWKV6_BWD_CHECKS = RWKV6_CHECKS + [(2, 70, 2, 64, True, "main", 3)]
# CUDA kernels a backward call launches (`bwd_row` counts them under
# torch.profiler): the RG-LRU's chains and groups; the WKV's chains,
# groups and du's sum
SCAN_BWD_KERNELS = {"rglru": 2, "rwkv6_wkv": 3}
# (t, e, k, pattern, bias): the router's sweep and DeepSeek's widths, rows
# with exact ties, k = E, rows whose picked scores sum below 1e-9 ("tiny":
# the clamp's branch) and rows of -0.0 and +0.0
ROUTER_BWD_CHECKS = [(t, e, k, "random", bias) for t, e, k in ROUTER_CHECKS
                     for bias in (False, True)] + [
    (64, 160, 6, "ties", False), (64, 256, 8, "ties", True), (64, 8, 8, "random", False),
    (37, 16, 16, "ties", True), (64, 160, 6, "tiny", False), (64, 33, 16, "zeros", True)]
# the training shapes: a microbatch of recurrentgemma-9b's RG-LRU (x, a [1,
# 4096, 4096]) and of rwkv6-3b's WKV ([1, 4096, 40, 64]), bf16; the router
# at DeepSeek's full widths and a prefill's 4096 tokens
RGLRU_BWD_TRAIN = (1, 4096, 4096)
WKV_BWD_TRAIN = (1, 4096, 40, 64)
ROUTER_BWD_FULL = [("v2", 4096, 160, 6, False), ("v3", 4096, 256, 8, True)]
# the narrow fp32 config of gpu_vs_cpu_model: head_dim 128 with a prompt
# of 128, the shape at which the JAX prefill reaches its Pallas kernel
NARROW = dict(name="narrow-d128", family="dense", n_layers=2, d_model=256,
              n_heads=4, n_kv_heads=2, d_head=128, d_ff=512, vocab=512,
              dtype="float32")


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def random_inputs(form, b, h, kv, d, page, mp, n_pages, seed, dev,
                  pattern="random"):
    """q, pools (and scales), a page table with holes inside the live
    range, lengths with the last row 0; then per ``pattern``: "main", the
    engine step's (rows 16k .. 16k + 8 of length 0 with all-hole tables, the
    rest one page, one row of exactly ``page`` tokens and one of page + 1,
    which takes a second page); "stale", every other row of length 0 with
    stale page ids (>= 0) in its table; "full", every row mp pages of which
    3 are holes, its length inside the last page."""
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
    if pattern == "main":
        table.fill_(-1)
        lengths = torch.randint(1, page + 1, (b,), generator=g, dtype=torch.int32)
        table[:, 0] = torch.randint(0, n_pages, (b,), generator=g, dtype=torch.int32)
        idle = torch.arange(b) % 16 < 9
        lengths[idle] = 0
        table[idle] = -1
        lengths[1], lengths[2] = page, page + 1
        table[1, 0], table[2, :2] = 1, torch.tensor([2, 3], dtype=torch.int32)
    elif pattern == "stale":
        lengths[::2] = 0
        table[::2] = torch.randint(0, n_pages, (len(table[::2]), mp), generator=g,
                                   dtype=torch.int32)
    elif pattern == "full":
        for i in range(b):
            table[i] = torch.randperm(n_pages, generator=g)[:mp].to(torch.int32)
            table[i, torch.randperm(mp, generator=g)[:3]] = -1
        lengths = (mp - 1) * page + torch.randint(1, page + 1, (b,), generator=g,
                                                  dtype=torch.int32)
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


def timed_spun_ms(fn, iters, flush):
    """Mean device time of ``fn`` over ``iters`` launches, each between its
    own CUDA events after the L2 cache is flushed, as `timed_ms`, but with a
    spin kernel (`torch.cuda._sleep`, SPIN_CYCLES) queued after the flush
    and before the start event: the card still spins while the host runs
    ``fn``'s Python wrapper, so the window holds the launch and not the
    host's gap before it. Returns (ms, the spin's own device ms, the
    longest host ms from the start event's record to the end event's):
    the window is sound when the spin outlasts that host time."""
    fn()
    torch.cuda.synchronize()
    spin = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    spin[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    spin[1].record()
    spin[1].synchronize()
    total = host = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        host = max(host, 1e3 * (time.perf_counter() - t0))
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters, spin[0].elapsed_time(spin[1]), host


SPUN_ATTEMPTS = 3


def spun_ms(label, fn, iters, flush):
    """`timed_spun_ms`, taken again (up to SPUN_ATTEMPTS times in all) when
    the host's time outlasted the spin, since the window would then hold
    the host's gap before the launch (a pause of the host, such as a
    garbage collection, spoils one measurement); fails the run when no
    attempt kept the host inside the spin. Returns the first sound
    attempt's numbers and the attempts taken (1 when the first was
    sound), which each timed row prints as ``spun_attempts``."""
    for attempt in range(1, SPUN_ATTEMPTS + 1):
        ms, spin_ms, host_ms = timed_spun_ms(fn, iters, flush)
        if host_ms < spin_ms:
            return ms, spin_ms, host_ms, attempt
    fail(f"{label}: the wrapper's host time ({host_ms} ms) outlasted the spin "
         f"({spin_ms} ms) in {SPUN_ATTEMPTS} attempts, so ms_spun would hold the "
         "host's gap")


def launch_floor_ms(flush) -> float:
    """The least time a launch takes on this card: `timed_spun_ms` of one
    trivial kernel (`torch.cuda._sleep(1)`), the host kept out of the window."""
    return spun_ms("floor_ms", lambda: torch.cuda._sleep(1), 50, flush)[0]


def exact_err(got, want) -> float:
    """The largest absolute difference between two calls' outputs (tuples
    of integer, bool or float tensors), each element taken as float64:
    0.0 exactly when they agree value for value."""
    return max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
               for a, b in zip(got, want))


def same_bits(got, again) -> bool:
    """Whether two calls' outputs (a tensor or a tuple) hold the same bits."""
    got = got if isinstance(got, tuple) else (got,)
    again = again if isinstance(again, tuple) else (again,)
    return all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(got, again))


def work(args, kw):
    """Bytes the call must move (each input read once, each output written
    once) and fp32 operations it must do, for THESE inputs. A row with a
    valid slot reads its q, the table columns below its length and the K
    and V rows of the tokens below its length in their mapped pages (a
    page's used tokens are a prefix of its slots: a page read by several
    rows counts its longest prefix once), with one scale per page and plane
    for int8, and does 4 * H * D operations per valid token; a row with
    none (an inactive engine slot) does not depend on q: it averages V
    over every gathered row (holes read page 0), reading its whole table
    row and every V row of its pages only, with KV * D additions per
    gathered row. Every row writes its out and reads its length."""
    q, k, v, table, lengths = args
    b, h, d = q.shape
    n_pages, page, kv, _ = k.shape
    mp = table.shape[1]
    tab = table.cpu().numpy()
    lens = lengths.cpu().numpy()
    k_used, v_used = {}, {}   # page id -> token slots read, a prefix
    tokens = mean_rows = q_rows = table_reads = 0
    for i in range(b):
        live = min(mp, -(-max(int(lens[i]), 0) // page))
        cols = [j for j in range(live) if tab[i, j] >= 0]
        if cols:
            for j in cols:
                pid, n = int(tab[i, j]), min(page, int(lens[i]) - j * page)
                k_used[pid] = max(k_used.get(pid, 0), n)
                v_used[pid] = max(v_used.get(pid, 0), n)
                tokens += n
            q_rows += 1
            table_reads += live
        else:
            for p in tab[i]:
                v_used[int(max(p, 0))] = page   # every slot of the page
            mean_rows += 1
            table_reads += mp
    token_bytes = kv * d * k.element_size()
    scale_bytes = 4 if kw else 0
    row_bytes = h * d * q.element_size()
    nbytes = ((sum(k_used.values()) + sum(v_used.values())) * token_bytes
              + (len(k_used) + len(v_used)) * scale_bytes
              + (q_rows + b) * row_bytes          # q of valid rows, every out
              + table_reads * 4 + lengths.numel() * 4)
    flops = 4 * h * d * tokens + mean_rows * kv * d * mp * page
    return nbytes, flops


def ptxas_rows(log: str, kernels: str) -> list[dict]:
    """Registers and spills of each kernel instantiation in nvcc's report,
    for the kernels of the regex alternation ``kernels``: e.g.
    `hopper_kernel<D, CHUNK, BN>` of csrc/flash_attention.cu, or
    `rwkv6_kernel<float, K>` of csrc/rwkv6_scan.cu (a bool parameter
    prints as 1 or 0), or a kernel that is no template (`ftl_kernel` of
    csrc/ftl_lookup.cu)."""
    rows, name = [], None
    for ln in log.splitlines():
        m = re.search(rf"Compiling entry function '\w*?({kernels})(?:I(\w*?)EEE?v|E)", ln)
        if m and m.group(2) is None:
            name = m.group(1)
            rows.append({"kernel": name})
        elif m:
            dtype = (["float"] if m.group(2).startswith("f") else
                     ["bf16"] if "bfloat16" in m.group(2) else
                     ["int8"] if m.group(2).startswith("a") else [])
            name = f"{m.group(1)}<{', '.join(dtype + re.findall(r'L[ib](\d+)E', m.group(2) + 'E'))}>"
            rows.append({"kernel": name})
        elif name and "spill stores" in ln:
            st, ld = re.findall(r"(\d+) bytes spill", ln)
            rows[-1].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "Used" in ln and "registers" in ln:
            rows[-1]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
            name = None
    return rows


def bench_builds(sources: dict, kernels: str, tool: str) -> tuple[dict, float]:
    """The benches' builds of several sources of a kernel (a parent's and
    a change's, say) side by side: every source of ``sources`` ({key: .cu
    path}; a key is a build's name or a (kernel, name) pair) compiled at
    once with the kernels' nvcc flags (`kernels/_build.py`) into
    `kernels/build/bench/`, and loaded. Returns ({key: (library, ptxas
    rows of the kernels of the regex alternation ``kernels``)}, the
    seconds of the build); exits naming ``tool`` when nvcc fails. Hand a
    library to the kernel's wrapper with `_build.use`."""
    import ctypes
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "bench"   # ignored by git, as the kernels' builds
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for key, src in sources.items():
        so = out_dir / f"{'-'.join(key) if isinstance(key, tuple) else key}.so"
        procs[key] = (so, subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                                            str(src)], stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True))
    logs = {}
    for key, (so, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"{tool}: nvcc failed on {sources[key]}:\n{err}")
        logs[key] = out + err
    seconds = time.perf_counter() - t0
    return {key: (ctypes.CDLL(str(so)), ptxas_rows(logs[key], kernels))
            for key, (so, _) in procs.items()}, seconds


def walk(names, rounds):
    """A bench's order of builds, as (round, name): per round forward, then
    back (parent, change, change, parent for two), so that a drift of the
    card's clock over the run falls on every build alike."""
    for rnd in range(rounds):
        for name in list(names) + list(names)[::-1]:
            yield rnd, name


def bench_train_walk(libs, source, phase, rounds, dev) -> None:
    """A bench's `train_split` of a TRAIN_FAMILIES phase with each build of
    ``libs`` ({name: library of ``csrc/<source>.cu``}, handed to its
    wrapper with `_build.use`): the phase's model at its depth, weights
    from seed 0, one warm-up step each, then per round the builds walked
    forward and back (`walk`), each split from the same state and batch.
    Prints a `train` line each and last a `train_summary` line, per build
    the mean of each stage."""
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.kernels import _build
    from repro_torch.launch import train as L
    arch, n_layers, batch, seq, n_micro, _ = TRAIN_FAMILIES[phase]
    cfg = dataclasses.replace(configs.get(arch), name=f"{arch}-{n_layers}-layers",
                              n_layers=n_layers)
    state = L.init(cfg, seed=0, device=dev)
    data = pipeline.batch_for_step(cfg, 0, batch, seq, 0, device=dev)
    for lib in libs.values():
        _build.use(source, lib)
        train_split(cfg, state, data, n_micro)
    splits = {}
    for rnd, name in walk(list(libs), rounds):
        _build.use(source, libs[name])
        split = train_split(cfg, state, data, n_micro)
        splits.setdefault(name, []).append(split)
        print(json.dumps({"train": {"round": rnd, "build": name, **split}}), flush=True)
    print(json.dumps({"train_summary": {
        name: {key: sum(s[key] for s in runs) / len(runs)
               for key in ("step_ms", "forward_ms", "backward_ms", "optimizer_ms")}
        for name, runs in splits.items()}}), flush=True)


def kernel_name(key: str) -> str:
    """A profiler key cut to the kernel's name and template arguments."""
    m = re.search(r"(\w+(?:<[^()]*>)?)\(", key.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else key[:80]


def profile_kernels(fn) -> tuple[int, dict]:
    """One call of ``fn`` (called once before, outside the profile) under
    `torch.profiler` with CUDA activity: (the kernels it launched, counted
    at its calls to the CUDA APIs' launch functions, cudaLaunch* and
    cuLaunch*; {kernel name (`kernel_name`): {"ms": its device ms,
    "launches": its count}} from the device's activity records, each
    kernel, copy or fill that ran on the card). The device records can
    miss kernels: with torch 2.11 a profile of the WKV backward held all
    three of its kernels in one process, only du's sum in another and
    none in this script's run. So the launches are counted at the calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launched, rows = 0, {}
    for e in prof.key_averages():
        if re.match(r"cudaLaunch|cuLaunch", e.key):
            launched += e.count
        elif e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0:
            row = rows.setdefault(kernel_name(e.key), {"ms": 0.0, "launches": 0})
            row["ms"] += e.device_time_total / 1e3
            row["launches"] += e.count
    return launched, rows


def sass_count(build, source: str, opcode: str) -> int:
    """Instructions of ``opcode`` (e.g. HGMMA, wgmma; HMMA, mma.sync) in the
    SASS of the library built from ``csrc/<source>.cu``, by the toolkit's
    cuobjdump beside nvcc."""
    cuobjdump = Path(build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path(source))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    return sum(opcode in ln for ln in sass.splitlines())


def flash_inputs(shape, dtype, seed, dev):
    b, s, t, h, kv, d, _, _ = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(sh, generator=g).to(dtype).to(dev)
            for sh in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d))]


def stats_check(got, q, k, causal, window) -> dict:
    """The forward's statistics ``got`` ([2, B, H, S]) against
    `ref.attention_stats` under STATS_TOL: the largest error of m over
    STATS_TOL * (1 + |m|) and of l over STATS_TOL * l (ok when both <= 1),
    rows with no valid key at exactly NEG_INF."""
    from repro_torch.kernels import ref
    want = ref.attention_stats(q, k, causal=causal, window=window)
    none = want[0] == ref.NEG_INF
    m_over = float(((got[0] - want[0]).abs() / (STATS_TOL * (1 + want[0].abs())))
                   .masked_fill(none, 0).max())
    l_over = float(((got[1] - want[1]).abs() / (STATS_TOL * want[1])).max())
    none_exact = bool((got[0][none] == ref.NEG_INF).all())
    return dict(m_over_tol=m_over, l_over_tol=l_over, no_key_rows=int(none.sum()),
                no_key_m_exact=none_exact,
                ok=bool(torch.isfinite(got).all()) and m_over <= 1 and l_over <= 1
                and none_exact)


def flash_checks(dev) -> list[dict]:
    """The flash kernel against its plain version on random inputs, per
    element within tol * (1 + |want|); the same call writes the softmax
    statistics (`stats_check`), and a call without them gives the same
    output bit for bit."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    checks = []
    for form, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for shape in FLASH_SHAPES:
            q, k, v = flash_inputs(shape, dtype, len(checks), dev)
            b, s, _, h = shape[:4]
            causal, window = shape[6], shape[7]
            stats = torch.empty((2, b, h, s), dtype=torch.float32, device=dev)
            got = fa.flash_attention(q, k, v, causal=causal, window=window, stats=stats)
            plain_out = fa.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err, rel, ok = max_err(got, ref.attention(q, k, v, causal=causal,
                                                      window=window), TOL[form])
            st = stats_check(stats, q, k, causal, window)
            same = same_bits((got,), (plain_out,))
            checks.append(dict(form=form, shape=list(shape[:6]), causal=causal,
                               window=window, max_abs_err=err, max_rel_err=rel,
                               tol=TOL[form], stats=st, same_without_stats=same,
                               ok=ok and st["ok"] and same))
    return checks


def flash_bwd_inputs(shape, dtype, seed, dev):
    """q, k, v, the plain forward's output o and statistics, and a
    cotangent dout."""
    from repro_torch.kernels import ref
    b, s, t, h, kv, d, causal, window = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v, dout = [torch.randn(sh, generator=g).to(dtype).to(dev)
                     for sh in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d), (b, s, h, d))]
    o = ref.attention(q, k, v, causal=causal, window=window).contiguous()
    stats = ref.attention_stats(q, k, causal=causal, window=window)
    return q, k, v, o, stats, dout


def bwd_compare(got, want, tol, allow=None):
    """(dq, dk, dv) against ``want`` (fp32) under ``tol`` = (c1, c2): (max
    abs error, max abs error / max |want|, the largest (|err| - c1 *
    |want| - allow) / rms(want), which must stay <= c2, ok), over the three
    gradients; every output finite. ``allow``: per element, the want's
    rounding allowance (`bwd_given_o`), or none."""
    c1, c2 = tol
    errs, rels, over, ok = [], [], [], True
    for i, (g_, w_) in enumerate(zip(got, want)):
        err = (g_.float() - w_).abs()
        if allow is not None:
            err = err - allow[i]
        rms = float(w_.square().mean().sqrt())
        errs.append(float((g_.float() - w_).abs().max()))
        rels.append(errs[-1] / max(float(w_.abs().max()), 1e-30))
        over.append(float((err - c1 * w_.abs()).max()) / max(rms, 1e-30))
        ok &= bool(torch.isfinite(g_).all()) and over[-1] <= c2
    return max(errs), max(rels), max(over), ok


def bf16_flip(x, radius):
    """Per element of fp32 ``x``: one bf16 ulp of x where x lies within
    ``radius`` of a bf16 rounding midpoint (a value that close may round to
    either neighbour), else 0."""
    bits = x.contiguous().view(torch.int32)
    ulp32 = torch.ldexp(torch.ones_like(x), ((bits >> 23) & 0xFF).clamp(min=1) - 150)
    dist = ((bits & 0xFFFF) - 0x8000).abs() * ulp32
    return torch.where(dist <= radius, 65536 * ulp32, 0.0)


def bwd_given_o(q, k, v, o, dout, causal, window, operands="fp32"):
    """((dq, dk, dv), allowance) in fp32 by the backward's formulas on the
    inputs widened, with delta = rowsum(dO * o) from the ``o`` given: P
    from the masked scaled scores (a row with no valid key spreads 1 / T),
    dv = P^T dO, dS = P * (dO V^T - delta) on unmasked pairs and 0 on
    masked ones, dq = scale dS K, dk = scale dS^T Q. One KV head at a time.
    With ``operands="fp32"`` the allowance is None. With ``"bf16"`` P and
    dS (dS from the unrounded P) are rounded to bf16 before the three
    products, as the tensor-core kernel rounds them
    (`flash_attention.bwd_operands`), and the allowance (dq, dk, dv) is
    each element's sum of |the other neighbour - the rounded term| times
    its partner's magnitude over the terms whose rounding a difference of
    the kernel's fp32 P or dS within the doubt radius could flip
    (`bf16_flip`; the note above BWD_TOL)."""
    if operands not in ("fp32", "bf16"):
        raise ValueError(f"operands must be 'fp32' or 'bf16'; got {operands!r}")
    from repro_torch.kernels import ref
    q, k, v, o, dout = (x.float() for x in (q, k, v, o, dout))
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g, scale = h // kv, d ** -0.5
    pos = torch.arange(s, device=q.device) + (t - s)
    cols = torch.arange(t, device=q.device)
    mask = torch.ones(s, t, dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols[None, :] <= pos[:, None]
    if window:
        mask &= cols[None, :] > pos[:, None] - window
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    allow = None
    if operands == "bf16":
        allow = tuple(torch.empty_like(x) for x in (q, k, v))
    for j in range(kv):
        heads = slice(j * g, (j + 1) * g)
        qj, oj, doj = (x[:, :, heads].transpose(1, 2) for x in (q, o, dout))  # [b, g, s, d]
        kj, vj = k[:, None, :, j], v[:, None, :, j]                         # [b, 1, t, d]
        p = torch.softmax(torch.where(mask, qj @ kj.transpose(-1, -2) * scale,
                                      ref.NEG_INF), dim=-1)
        delta = (doj * oj).sum(-1, keepdim=True)
        ds = torch.where(mask, p * (doj @ vj.transpose(-1, -2) - delta), 0.0)
        if operands == "bf16":
            # the doubt radii (the note above BWD_TOL), then the flips' ulps
            two_orders = 2 * d * 2 ** -24
            rel = two_orders * scale * (qj.abs() @ kj.abs().transpose(-1, -2)) + ROUND_DELTA
            w_p = bf16_flip(p, rel * p)
            sums = doj.abs() @ vj.abs().transpose(-1, -2) + (doj * oj).abs().sum(-1, keepdim=True)
            r_ds = torch.where(mask, rel * ds.abs() + p * two_orders * sums, 0.0)
            del sums, rel
            w_ds = bf16_flip(ds, r_ds)
            del r_ds
            allow[0][:, :, heads] = (w_ds @ kj.abs() * scale).transpose(1, 2)
            allow[1][:, :, j] = (w_ds.transpose(-1, -2) @ qj.abs() * scale).sum(1)
            allow[2][:, :, j] = (w_p.transpose(-1, -2) @ doj.abs()).sum(1)
            del w_ds, w_p
            p, ds = p.bfloat16().float(), ds.bfloat16().float()
        dq[:, :, heads] = (ds @ kj * scale).transpose(1, 2)
        dk[:, :, j] = (ds.transpose(-1, -2) @ qj * scale).sum(1)
        dv[:, :, j] = (p.transpose(-1, -2) @ doj).sum(1)
        del p, ds
    return (dq, dk, dv), allow


def bwd_check(got, q, k, v, o, dout, causal, window, form) -> dict:
    """The backward's outputs ``got`` against the plain gradient in fp32
    (BWD_TOL) and against `bwd_given_o` with the kernel's operands
    (`flash_attention.bwd_operands`; BWD_O_TOL); where those are bf16, also
    against the fp32-operand want (`given_o_fp32_operands`, printed without
    a gate). `bwd_ok` reads the gates."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    operands = fa.bwd_operands(q.dtype)
    wants = [("plain", lambda: (ref.attention_bwd(
                  q.float(), k.float(), v.float(), None, None, dout.float(), causal=causal,
                  window=window), None), BWD_TOL[form]),
             ("given_o", lambda: bwd_given_o(q, k, v, o, dout, causal, window, operands),
              BWD_O_TOL[form])]
    if operands == "bf16":
        wants.append(("given_o_fp32_operands",
                      lambda: bwd_given_o(q, k, v, o, dout, causal, window), BWD_O_TOL[form]))
    out = {}
    for key, want_fn, tol in wants:
        want, allow = want_fn()
        err, rel, over, ok = bwd_compare(got, want, tol, allow)
        extra = {}
        if key == "given_o":
            extra["operands"] = operands
        if allow is not None:
            # the allowance beside the gate: its largest share of rms
            extra["allowance_over_rms"] = max(
                float(a.max()) / max(float(w_.square().mean().sqrt()), 1e-30)
                for a, w_ in zip(allow, want))
            # and the same comparison without it
            extra["err_over_rms_without_allowance"] = bwd_compare(got, want, tol)[2]
        del want, allow
        out[key] = dict(max_abs_err=err, max_rel_err=rel, err_over_rms=over, tol=tol,
                        **extra, **({"ok": ok} if key != "given_o_fp32_operands"
                                    else {"within_tol": ok, "gated": False}))
    return out


def bwd_ok(gates) -> bool:
    """Both gates of `bwd_check` hold."""
    return gates["plain"]["ok"] and gates["given_o"]["ok"]


def flash_bwd_checks(dev) -> list[dict]:
    """The backward kernel on FLASH_BWD_SHAPES, fp32 and bf16, through
    `bwd_check`, each call repeated and equal bit for bit."""
    from repro_torch.kernels import flash_attention as fa
    checks = []
    for form, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for shape in FLASH_BWD_SHAPES:
            q, k, v, o, stats, dout = flash_bwd_inputs(shape, dtype, len(checks), dev)
            causal, window = shape[6], shape[7]
            got = fa.flash_attention_bwd(q, k, v, o, stats, dout, causal=causal, window=window)
            again = fa.flash_attention_bwd(q, k, v, o, stats, dout, causal=causal,
                                           window=window)
            torch.cuda.synchronize()
            gates = bwd_check(got, q, k, v, o, dout, causal, window, form)
            same = same_bits(tuple(got), tuple(again))
            checks.append(dict(form=form, shape=list(shape[:6]), causal=causal,
                               window=window, **gates, repeat_equal=same,
                               ok=bwd_ok(gates) and same))
    return checks


def flash_bwd_work(q, k, causal, window, per_pair=10):
    """Bytes the backward must move (q, k, v, o and dout read once, the
    statistics' 8 bytes a row; dq, dk and dv written once) and operations
    it must do for THESE shapes: 10 * D per unmasked (query, key) pair and
    query head (q.k, dO.v, P^T dO, dS^T q, dS k); a row with no valid key
    (causal, S > T) only adds its uniform weights' dO into dv, 2 * D per
    key and head. ``per_pair=14`` counts what the kernels' design does
    instead (q.k and dO.v twice: once for dq, once for dk and dv; 16 where
    dk and dv are two walks, at head dim 256)."""
    b, s, h, d = q.shape
    t = k.shape[1]
    _, fwd_flops = flash_work(q, k, causal, window)
    pos = torch.arange(s) + (t - s)
    no_key_rows = int((pos < 0).sum()) if causal else 0
    pair_flops = fwd_flops - no_key_rows * b * h * t * d     # 4 * D per pair
    flops = pair_flops // 4 * per_pair + 2 * no_key_rows * b * h * t * d
    nbytes = (5 * q.numel() + 4 * k.numel()) * q.element_size() + 8 * b * h * s
    return nbytes, flops


def flash_bwd_row(dev, flush, checks, launches, extra, shape=FLASH_BWD_TRAIN,
                  name="flash_attention_bwd[bf16]") -> dict:
    """The `kernels` entry of the backward kernel at a training attention
    shape (h2o-danube-1.8b's, FLASH_BWD_TRAIN, whisper-tiny's
    cross-attention, FLASH_BWD_WHISPER, qwen2-vl-2b's or
    recurrentgemma-9b's; bf16), on the forward kernel's output and
    statistics (checked, `stats_check`): checked per element
    (`bwd_check`), as is its fp32 form at the same shape, and timed spun
    (`spun_ms`) beside the plain gradient and the library yardstick, the
    backward of one `scaled_dot_product_attention` with the band as a
    boolean mask, or no mask where nothing is masked (timed only: the port
    never calls it)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    b, s, t, h, kv, d, causal, window = shape
    g = torch.Generator(device="cpu").manual_seed(25)
    q, k, v, dout = [torch.randn(sh, generator=g).to(torch.bfloat16).to(dev)
                     for sh in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d), (b, s, h, d))]
    stats = torch.empty((2, b, h, s), dtype=torch.float32, device=dev)
    o = fa.flash_attention(q, k, v, causal=causal, window=window, stats=stats)
    stats_gate = stats_check(stats, q, k, causal, window)
    got = fa.flash_attention_bwd(q, k, v, o, stats, dout, causal=causal, window=window)
    again = fa.flash_attention_bwd(q, k, v, o, stats, dout, causal=causal, window=window)
    torch.cuda.synchronize()
    gates = bwd_check(got, q, k, v, o, dout, causal, window, "bf16")
    repeat_equal = same_bits(tuple(got), tuple(again))
    del again
    # the fp32 form at the same shape, on the same inputs widened
    q32, k32, v32, dout32 = (x.float() for x in (q, k, v, dout))
    stats32 = torch.empty_like(stats)
    o32 = fa.flash_attention(q32, k32, v32, causal=causal, window=window, stats=stats32)
    got32 = fa.flash_attention_bwd(q32, k32, v32, o32, stats32, dout32, causal=causal,
                                   window=window)
    gates32 = bwd_check(got32, q32, k32, v32, o32, dout32, causal, window, "fp32")
    del got32, q32, k32, v32, o32, dout32, stats32
    if not (bwd_ok(gates) and bwd_ok(gates32) and repeat_equal and stats_gate["ok"]):
        fail(f"{name} at the training shape {shape}: bf16 {gates}, fp32 {gates32}, "
             f"repeat_equal {repeat_equal}, stats {stats_gate}")
    ms, spin_ms, host_ms, attempts = spun_ms(
        "flash_attention_bwd",
        lambda: fa.flash_attention_bwd(q, k, v, o, stats, dout, causal=causal, window=window),
        5, flush)
    plain_ms = timed_ms(lambda: ref.attention_bwd(q, k, v, o, stats, dout, causal=causal,
                                                  window=window), 2, flush)
    # the library yardstick: SDPA's backward over the same inputs in its
    # [B, H, S, D] layout, the band as an explicit boolean mask
    pos = torch.arange(s, device=dev)[:, None] + (t - s)
    cols = torch.arange(t, device=dev)[None, :]
    mask = None
    if causal or window:
        mask = (cols <= pos) if causal else torch.ones_like(cols <= pos)
        if window:
            mask &= cols > pos - window
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, enable_gqa=True)
    dout_t = dout.transpose(1, 2)
    library = lambda: torch.autograd.grad(out, leaves, dout_t, retain_graph=True)
    lib_err = max(float((a.transpose(1, 2).float() - w_.float()).abs().max())
                  for a, w_ in zip(library(), got))
    library_ms = timed_ms(library, 5, flush)
    library_call = ("autograd.grad of scaled_dot_product_attention(attn_mask="
                    f"{'band' if mask is not None else 'None'}, enable_gqa=True)")
    del out, leaves, mask
    nbytes, flops = flash_bwd_work(q, k, causal, window)
    # the design's count: 14 * D a pair, 16 * D where dk and dv are two walks
    _, design_flops = flash_bwd_work(q, k, causal, window, per_pair=14 if d <= 128 else 16)
    n_split = fa.bwd_split(q.dtype, b, t, kv, torch.cuda.get_device_properties(dev)
                           .multi_processor_count)
    t_bytes, t_ops = 1e3 * nbytes / HBM_BPS, 1e3 * flops / BF16_FLOPS
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        # no TPU kernel: it stands for XLA's autodiff of the reference's
        # jnp attention oracle, the reference's training gradient
        "replaces": "src/repro/kernels/ref.py:25 (autodiff of attention; no pallas_call)",
        "launches": launches,
        "kernels_per_launch": fa.bwd_kernels_per_call(q.dtype, d, n_split), "n_split": n_split,
        "shape": {"q": list(q.shape), "k": list(k.shape), "causal": causal,
                  "window": window, "dtype": "bfloat16"},
        "max_abs_err": gates["plain"]["max_abs_err"],
        "max_rel_err": gates["plain"]["max_rel_err"],
        "err_over_rms": gates["plain"]["err_over_rms"], "tol": BWD_TOL["bf16"],
        "given_o": gates["given_o"],
        "given_o_fp32_operands": gates.get("given_o_fp32_operands"),
        "forward_stats": stats_gate,
        "gate": "|err| <= tol[0] * |want| + tol[1] * rms(want) per element and "
                "gradient, want the plain gradient in fp32 of the inputs widened; "
                "given_o: the same against `bwd_given_o` with the kernel's operands "
                "under BWD_O_TOL",
        "fp32_at_this_shape": gates32,
        "repeat_equal": repeat_equal,
        "checks": checks,
        "ms": ms, "spin_ms": spin_ms, "host_ms_max": host_ms, "spun_attempts": attempts,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops, "peak_flops": BF16_FLOPS,
        "tflops": flops / ms / 1e9, "of_bound": max(t_bytes, t_ops) / ms,
        "design_flops": design_flops, "design_tflops": design_flops / ms / 1e9,
        "library_ms": library_ms,
        "library_call": library_call,
        "library_max_abs_err": lib_err,
        **extra,
    }


def flash_work(q, k, causal, window):
    """Bytes the call must move (q, k and v read once, out written once)
    and operations it must do for THESE shapes: 4 * D per unmasked
    (query, key) pair and query head (the q.k and p.v products); a row
    with no valid key (causal, S > T) averages V over all T keys instead,
    D additions per key and head."""
    b, s, h, d = q.shape
    t = k.shape[1]
    pos = torch.arange(s) + (t - s)            # key position of each row
    if causal:
        lo = (pos - window + 1).clamp(min=0) if window else torch.zeros_like(pos)
        pairs = int((pos.clamp(max=t - 1) - lo + 1).clamp(min=0).sum())
        no_key_rows = int((pos < 0).sum())
    else:
        pairs, no_key_rows = s * t, 0
    flops = 4 * d * b * h * pairs + no_key_rows * b * h * t * d
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return nbytes, flops


def kernel_table() -> dict:
    """Per kernel of the model zoo's path: the dispatcher in
    `kernels.ops` that the models call, the kernel's wrapper (which counts
    its launches) and its plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_router as mr
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as wkv
    return {"flash_attention": ("attention", fa.flash_attention, ref.attention),
            "rglru": ("rglru", rg.rglru, ref.rglru),
            "rwkv6_wkv": ("rwkv6_wkv", wkv.rwkv6_wkv, ref.rwkv6_wkv),
            "topk_router": ("topk_router", mr.topk_router, ref.topk_router)}


def prefill_launches(cfg) -> dict:
    """Launches of each kernel in one prefill: one per layer of its kind.
    MLA attends in plain PyTorch (as the reference does), so a DeepSeek
    model launches no flash kernel; its router runs once per MoE layer. An
    encoder-decoder launches flash once per encoder layer and twice per
    decoder layer (self-attention, then cross-attention)."""
    kinds = cfg.layer_kinds()
    n_rec = kinds.count("rec")
    flash = kinds.count("attn") if cfg.mla is None else 0
    if cfg.is_encdec:
        flash = cfg.n_enc_layers + 2 * cfg.n_layers
    return {"flash_attention": flash,
            "rglru": n_rec if cfg.recurrent == "rglru" else 0,
            "rwkv6_wkv": n_rec if cfg.recurrent == "rwkv6" else 0,
            "topk_router": (cfg.n_layers - cfg.moe.first_k_dense
                            if cfg.moe is not None else 0)}


def flash_roles(cfg) -> dict:
    """The flash calls of one prefill that `model_phase` holds against the
    plain version, by call index: the first and the last layer's; for an
    encoder-decoder the encoder's first, the first decoder layer's self-
    and cross-attention and the last call (the last cross-attention)."""
    n = prefill_launches(cfg)["flash_attention"]
    if cfg.is_encdec:
        e = cfg.n_enc_layers
        return {0: "encoder", e: "decoder_self", e + 1: "cross", n - 1: "last_cross"}
    return {0: "first_layer", n - 1: "last_layer"}


def by_shape(counts) -> list:
    """A flash wrapper's ``launches_by_shape`` as JSON rows."""
    return [dict(q=list(q), k=list(k), causal=c, window=w, calls=n)
            for (q, k, c, w), n in counts.items()]


def shape_calls(rows, q_shape, k_shape, causal, window) -> int:
    """The launches at one shape among `by_shape`'s rows."""
    return sum(r["calls"] for r in rows
               if [r["q"], r["k"], r["causal"], r["window"]]
               == [list(q_shape), list(k_shape), causal, window])


def expected_launches(cfg, gen) -> dict:
    """Launches of each kernel in a prefill and ``gen`` decode steps. Decode
    runs the plain single-step forms of attention and the scans (no TPU
    kernel backs them), but routes every MoE layer through the router
    kernel: n_moe_layers * (1 + gen) launches."""
    out = prefill_launches(cfg)
    out["topk_router"] *= 1 + gen
    return out


def router_compare(got, want):
    """(max abs weight error, indices equal, ok): indices exact, weights
    within ROUTER_W_TOL."""
    (w, idx), (w_want, idx_want) = got, want
    err = float((w - w_want).abs().max()) if w.numel() else 0.0
    same = torch.equal(idx, idx_want)
    return err, same, same and err <= ROUTER_W_TOL and bool(torch.isfinite(w).all())


def compare(got, want, tol):
    """max_err over a kernel's outputs (a tensor or a tuple of them): the
    worst (max abs error, max abs error / max |want|) and whether every
    element of every output passed."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = [max_err(g, w, tol) for g, w in zip(got, want)]
    return (max(e[0] for e in errs), max(e[1] for e in errs),
            all(e[2] for e in errs))


def model_phase(arch, batch, prompt, gen, dev, n_layers=None,
                repeat=False) -> tuple[dict, dict]:
    """Drive `launch.serve.run_model` at the arch's full config (its depth
    cut to ``n_layers`` when given; with ``repeat``, a second run from the
    same seed must give the same tokens and logits bit for bit); return
    its JSON line and, per kernel,
    the (args, kwargs) its dispatcher got, by call index: from the first
    and last layers of its kind in the prefill (for flash the calls of
    `flash_roles`) and, for the router, from the first MoE layer of the
    first decode step. The line also gives the flash launches by shape,
    as the wrapper counts them where it launches the kernel."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import decode as D
    full = configs.get(arch)
    cfg = full if n_layers is None else dataclasses.replace(full, n_layers=n_layers)
    table, expect = kernel_table(), expected_launches(cfg, gen)
    per_prefill = prefill_launches(cfg)
    saved = {name: getattr(ops, attr) for name, (attr, _, _) in table.items()}
    captured = {name: {} for name in table}
    roles = flash_roles(cfg)
    flash = table["flash_attention"][1]
    decode_step = D.decode_step

    def capture(name):
        n = per_prefill[name]
        keep = {0, n - 1} | ({n} if name == "topk_router" and gen else set())
        if name == "flash_attention":
            keep = set(roles)
        dispatch, calls = saved[name], [0]

        def wrapper(*args, **kw):
            if calls[0] in keep:
                captured[name][calls[0]] = (args, kw)
            calls[0] += 1
            return dispatch(*args, **kw)
        return wrapper

    def checked_step(*args, **kw):
        # the decode step reads nothing back to the host: any
        # synchronizing CUDA call inside it raises here
        torch.cuda.set_sync_debug_mode("error")
        try:
            return decode_step(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for name, (attr, kernel, _) in table.items():
        setattr(ops, attr, capture(name))
        kernel.launches = 0
    flash.launches_by_shape.clear()
    D.decode_step = checked_step
    try:
        out = serve.run_model(arch, batch, prompt, gen, seed=0, device=dev,
                              cfg=cfg)
    finally:
        for name, (attr, _, _) in table.items():
            setattr(ops, attr, saved[name])
        D.decode_step = decode_step
    launches = {name: kernel.launches for name, (_, kernel, _) in table.items()}
    flash_shapes = dict(flash.launches_by_shape)
    logits = out["logits"]
    line = dict(arch=arch, layers=cfg.n_layers, kinds=cfg.layer_kinds(),
                d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
                head_dim=cfg.head_dim if cfg.mla is None else None,
                d_ff=cfg.d_ff, vocab=cfg.vocab,
                window=cfg.sliding_window or cfg.local_window,
                recurrent=cfg.recurrent, dtype=cfg.dtype,
                n_params=cfg.n_params(), n_params_tensors=out["n_params"],
                full_layers=full.n_layers,
                mla=dataclasses.asdict(cfg.mla) if cfg.mla else None,
                moe=dataclasses.asdict(cfg.moe) if cfg.moe else None,
                enc_layers=cfg.n_enc_layers, enc_seq=cfg.enc_seq if cfg.is_encdec else None,
                frontend=cfg.frontend, mrope_sections=list(cfg.mrope_sections),
                inputs=("tokens" if not cfg.frontend else
                        "enc_embeds [B, enc_seq, D] + decoder tokens" if cfg.is_encdec
                        else "input_embeds [B, prompt, D]"),
                batch=batch, prompt=prompt, gen=gen, launches=launches,
                expected_launches=expect,
                flash_calls_by_shape=by_shape(flash_shapes),
                prefill_ms=out["prefill_ms"],
                decode_ms_per_token=out["decode_ms_per_token"],
                tok_per_s=out["tok_per_s"],
                logits_shape=list(logits.shape),
                logits_finite=bool(torch.isfinite(logits).all()),
                logits_max_abs=float(logits.float().abs().max()),
                tokens_shape=list(out["tokens"].shape),
                sample=out["tokens"][0, :8].tolist(),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                decode_host_syncs="none (sync debug mode 'error')")
    first = (out["tokens"], logits)
    del out, logits
    if launches != expect:
        fail(f"{arch}: kernel launches in the run {launches} != one per layer "
             f"of each kind in the prefill, and one per MoE layer and decode "
             f"step for the router: {expect}")
    if not line["logits_finite"]:
        fail(f"{arch}: logits not finite")
    if line["tokens_shape"] != [batch, gen]:
        fail(f"{arch}: greedy tokens {line['tokens_shape']} != {[batch, gen]}")
    if repeat:
        again = serve.run_model(arch, batch, prompt, gen, seed=0, device=dev,
                                cfg=cfg)
        line["repeat_equal"] = bool(torch.equal(again["tokens"], first[0])
                                    and torch.equal(again["logits"], first[1]))
        del again
        if not line["repeat_equal"]:
            fail(f"{arch}: a second run from the same seed gave other tokens "
                 "or logits")
    del first
    # each kernel against its plain version on the main path's inputs.
    # Attention's outputs are small, so bf16 is gated there by max abs
    # error / max |want|; the scans' by element, at tol * (1 + |want|)
    line["checks"] = []
    for name, calls in captured.items():
        _, kernel, plain_fn = table[name]
        for layer, (args, kw) in sorted(calls.items()):
            got, want = kernel(*args, **kw), plain_fn(*args, **kw)
            torch.cuda.synchronize()
            if name == "flash_attention":
                tol = TOL["bf16"]
                err, rel, _ = compare(got, want, tol)
                ok = rel <= tol and bool(torch.isfinite(got).all())
            elif name == "topk_router":
                tol = ROUTER_W_TOL
                err, _, ok = router_compare(got, want)
                rel = err
            else:
                tol = SCAN_TOL[name]["bf16"]
                err, rel, ok = compare(got, want, tol)
            line["checks"].append(dict(kernel=name, call=layer,
                                       role=roles.get(layer) if name == "flash_attention"
                                       else None,
                                       shapes=[list(a.shape) for a in args
                                               if torch.is_tensor(a)],
                                       kw={k: v for k, v in kw.items()
                                           if not torch.is_tensor(v)},
                                       max_abs_err=err, max_rel_err=rel,
                                       tol=tol, ok=ok))
            if not ok:
                fail(f"{arch} {name} call {layer}: kernel disagrees "
                     f"with its plain version (max abs err {err}, relative {rel})")
            del got, want
    # the first layer's inputs (and the router's at the first decode step;
    # an encoder-decoder's first cross-attention's) are kept, for the
    # kernels line
    line_calls = {name: {0} | ({per_prefill[name]} if name == "topk_router" else set())
                  for name in table}
    line_calls["flash_attention"] |= {i for i, r in roles.items() if r == "cross"}
    captured = {name: {i: c for i, c in calls.items() if i in line_calls[name]}
                for name, calls in captured.items() if calls}
    torch.cuda.empty_cache()
    return line, captured


def gpu_vs_cpu_model(dev, cfg, seed, prompt=128) -> dict:
    """A narrow fp32 model, the same weights on both devices: prefill a
    prompt of ``prompt`` (batch 2; a frontend's embeddings, an
    encoder-decoder's encoder input too: `launch.serve.draw_inputs`, drawn
    on the CPU), then 8 greedy
    decode steps. The CUDA run (kernels) and
    the CPU run (plain versions) must give equal tokens, and logits within
    1e-4 * (1 + |want|); the CUDA run must launch each kernel once per
    layer of its kind in the prefill, and the router once per MoE layer
    and step. For a MoE model the line gives the smallest gap, over the
    CUDA run's router calls, between a token's k-th and (k+1)-th
    selection score: a CPU and a GPU product may order two scores closer
    than that differently, and then pick another expert."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    table, expect = kernel_table(), expected_launches(cfg, 8)
    cpu_params = T.init_params(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(seed))

    def to_dev(node):
        return ({k: to_dev(x) for k, x in node.items()} if isinstance(node, dict)
                else node.to(dev))

    inputs = serve.draw_inputs(cfg, 2, prompt, seed + 1, "cpu")
    route, gaps = ops.topk_router, []

    def gap_recorder(scores, k, bias=None):
        sel = scores if bias is None else scores + bias
        top = torch.topk(sel, min(k + 1, sel.shape[-1]), dim=-1).values
        if top.shape[-1] > k:
            gaps.append((top[:, k - 1] - top[:, k]).min())
        return route(scores, k, bias=bias)

    runs = {}
    for name, params, args in (("cuda", to_dev(cpu_params), to_dev(inputs)),
                               ("cpu", cpu_params, inputs)):
        for _, kernel, _ in table.values():
            kernel.launches = 0
        ops.topk_router = gap_recorder if name == "cuda" else route
        try:
            logits, cache = D.prefill(cfg, params, max_len=prompt + 8, **args)
            steps = [logits.cpu()]
            greedy = []
            for _ in range(8):
                tok = torch.argmax(logits, -1).to(torch.int32)
                greedy.append(tok.cpu())
                logits, cache = D.decode_step(cfg, params, cache, tok)
                steps.append(logits.cpu())
        finally:
            ops.topk_router = route
        runs[name] = (steps, torch.stack(greedy, 1),
                      {k: kern.launches for k, (_, kern, _) in table.items()})
    gap = float(torch.stack(gaps).min()) if gaps else None
    (g_logits, g_tok, g_launch), (c_logits, c_tok, c_launch) = runs["cuda"], runs["cpu"]
    if g_launch != expect or any(c_launch.values()):
        fail(f"gpu_vs_cpu_model {cfg.name}: launches {g_launch} (CUDA), "
             f"{c_launch} (CPU); want {expect} and none")
    if not torch.equal(g_tok, c_tok):
        fail(f"gpu_vs_cpu_model {cfg.name}: greedy tokens {g_tok.tolist()} != "
             f"CPU {c_tok.tolist()} (smallest router gap between the k-th and "
             f"(k+1)-th score: {gap})")
    worst = 0.0
    for i, (a, b) in enumerate(zip(g_logits, c_logits)):
        err = (a - b).abs()
        worst = max(worst, float(err.max()))
        if not bool((err <= 1e-4 * (1 + b.abs())).all()):
            fail(f"gpu_vs_cpu_model {cfg.name}: logits of step {i} differ by up "
                 f"to {float(err.max())} from the CPU plain path (smallest "
                 f"router gap between the k-th and (k+1)-th score: {gap})")
    return {"config": cfg.name, "batch": 2, "prompt": prompt, "decode_steps": 8,
            "launches": g_launch, "tokens_equal": True,
            "max_abs_logit_err": worst, "tol": "1e-4 * (1 + |want|)",
            "router_min_gap": gap, "ok": True}


def train_kernels() -> dict:
    """The launch counters the trainer's path reads: each kernel's forward
    and backward wrapper (a flash backward call is several CUDA kernels,
    a WKV backward call three: the chains, the groups, du's sum)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_router as mr
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as wkv
    return {"flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "rglru": rg.rglru, "rglru_bwd": rg.rglru_bwd,
            "rwkv6_wkv": wkv.rwkv6_wkv, "rwkv6_wkv_bwd": wkv.rwkv6_wkv_bwd,
            "topk_router": mr.topk_router, "topk_router_bwd": mr.topk_router_bwd}


def train_expected(cfg, n_micro) -> dict:
    """Launches of one train step: each kernel's forward twice a layer of
    its kind and microbatch under remat (the forward, then its
    recomputation in the backward pass), its backward once. The router
    runs in every MoE layer (DeepSeek-v3's MTP block has a dense MLP, no
    router); MLA launches no flash kernel."""
    per_layer = prefill_launches(cfg)
    out = {}
    for name in ("flash_attention", "rglru", "rwkv6_wkv", "topk_router"):
        out[name] = per_layer[name] * n_micro * (2 if cfg.remat else 1)
        out[f"{name}_bwd"] = per_layer[name] * n_micro
    return out


def train_split(cfg, state, batch, n_micro) -> dict:
    """One `train_step` split by stage between CUDA events: around each of
    its calls to `lm_loss` (the forward, summed over the microbatches) and
    to `optimizer.update`; the backward is the step's time less those two
    (``torch.autograd.grad``, the layers' recomputation included, and the
    fp32 gradient sums). Each stage's peak of allocated memory is read at
    its end (the allocator's count: no sync); the backward's is the peak
    between a forward's end and the next stage's start."""
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_step as TS
    spans = {"forward": [], "optimizer": []}
    peak = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    real = {"forward": T.lm_loss, "optimizer": opt.update}

    def read_peak(stage):
        peak[stage] = max(peak[stage], torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()

    def timed(stage):
        def call(*args, **kw):
            read_peak("backward")          # since the last forward's end
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = real[stage](*args, **kw)
            ev[1].record()
            spans[stage].append(ev)
            read_peak(stage)
            return out
        return call

    step = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    T.lm_loss, opt.update = timed("forward"), timed("optimizer")
    try:
        step[0].record()
        out = TS.train_step(cfg, state, batch, n_micro=n_micro)
        step[1].record()
    finally:
        T.lm_loss, opt.update = real["forward"], real["optimizer"]
    torch.cuda.synchronize()
    del out
    ms = {stage: sum(a.elapsed_time(b) for a, b in evs) for stage, evs in spans.items()}
    total = step[0].elapsed_time(step[1])
    return {"step_ms": total, "forward_ms": ms["forward"],
            "backward_ms": total - ms["forward"] - ms["optimizer"],
            "optimizer_ms": ms["optimizer"], "peak_mem_gb": peak}


def checked_steps(step_fn, kernels):
    """(a `train_step` that runs ``step_fn`` under the sync debug mode,
    between synchronizations, recording its wall ms and the launches of
    each of ``kernels`` it made; the list of ms; the list of launches)."""
    step_ms, per_step = [], []

    def checked_step(*args, **kw):
        before = {name: k.launches for name, k in kernels.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = step_fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        per_step.append({name: k.launches - before[name] for name, k in kernels.items()})
        return out

    return checked_step, step_ms, per_step


def train_family_phase(dev, phase) -> dict:
    """A recurrent family's training at its full published width, depth
    cut (TRAIN_FAMILIES): `launch.train`'s `init` and `train`, each step
    under the sync debug mode, with finite losses and grad norms and
    exactly `train_expected`'s launches every step (counts zeroed just
    before the run); ms a step (median and spread of the steps after the
    first), tokens/s, peak memory and the last state's `train_split`."""
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.launch import train as L
    from repro_torch.models import transformer as T
    from repro_torch.training import train_step as TS
    from repro_torch.training import tree as tr
    arch, n_layers, batch, seq, n_micro, steps = TRAIN_FAMILIES[phase]
    full = configs.get(arch)
    cfg = dataclasses.replace(full, name=f"{arch}-{n_layers}-layers", n_layers=n_layers)
    kernels, expect = train_kernels(), train_expected(cfg, n_micro)
    step_fn = TS.train_step
    checked_step, step_ms, per_step = checked_steps(step_fn, kernels)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    TS.train_step = checked_step
    try:
        for k in kernels.values():
            k.launches = 0
        metrics = []
        for state, m in L.train(cfg, L.init(cfg, seed=0, device=dev), 0, steps, batch=batch,
                                seq=seq, n_micro=n_micro, seed=0, device=dev, log=print):
            metrics.append(m)
    finally:
        TS.train_step = step_fn
    run_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [(float(m["loss"]), float(m["grad_norm"])) for m in metrics]
    split = train_split(cfg, state, pipeline.batch_for_step(cfg, steps, batch, seq, 0,
                                                            device=dev), n_micro)
    del state, metrics
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses).ravel()):
        fail(f"{phase}: a loss or grad norm is not finite: {losses}")
    if any(got != expect for got in per_step):
        fail(f"{phase}: kernel launches per step {per_step} != {expect}")
    steady = sorted(step_ms[1:])
    med = steady[len(steady) // 2]
    return dict(
        arch=arch, config=f"src/repro/configs/{arch.replace('-', '_').replace('.', '_')}.py",
        layers=n_layers, layers_published=full.n_layers,
        cut=(f"depth {full.n_layers} -> {n_layers} layers; every width as published"
             if n_layers < full.n_layers else "none: every layer and width as published"),
        layer_kinds=cfg.layer_kinds(), d_model=cfg.d_model,
        heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=cfg.head_dim, d_ff=cfg.d_ff,
        lru_width=cfg.lru_width, window=cfg.local_window, vocab=cfg.vocab, dtype=cfg.dtype,
        frontend=cfg.frontend, mrope_sections=list(cfg.mrope_sections),
        remat=cfg.remat, n_params=cfg.n_params(),
        n_params_tensors=sum(t.numel() for t in tr.leaves(T.abstract_params(cfg))),
        batch=batch, seq=seq, n_micro=n_micro, steps=steps,
        losses=[m[0] for m in losses], grad_norms=[m[1] for m in losses],
        step_ms=step_ms, step_ms_median=med, step_ms_spread=[steady[0], steady[-1]],
        step_ms_over="the steps after the first", tokens_per_s=batch * seq / (med / 1e3),
        peak_mem_gb=peak_gb, run_s=run_s, launches=launches, launches_per_step=per_step[0],
        expected_per_step=expect, split=split,
        host_syncs="none (sync debug mode 'error' around each step)")


def train_phase(dev, spec=TRAIN) -> dict:
    """The main path of training at full width: `launch.train`'s `init`,
    `train` and `resume` on ``spec`` (TRAIN, or TRAIN_WHISPER). Steps 0-1,
    a checkpoint, steps 2 on (the uninterrupted run); then the state is
    freed, a fresh state (other weights) takes the checkpoint through
    `resume`, and steps 2 on run again:
    their losses and grad norms must equal the uninterrupted run's to
    rtol=1e-6 (the reference's tests/test_training.py). Each step runs
    under the sync debug mode (no host sync inside a step), must give a
    finite loss and grad norm, and must launch the flash kernels
    `train_expected` times (counts zeroed just before the run, read after
    each step). The line gives the uninterrupted run's flash launches by
    shape, as the wrappers count them."""
    import shutil
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as L
    from repro_torch.models import transformer as T
    from repro_torch.training import train_step as TS
    from repro_torch.training import tree as tr
    arch, batch, seq, n_micro, steps = spec
    cfg = configs.get(arch)
    kernels, expect = train_kernels(), train_expected(cfg, n_micro)
    ckpt_dir = ROOT / "train_ckpt"
    step_fn = TS.train_step
    checked_step, step_ms, per_step = checked_steps(step_fn, kernels)

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = dict(batch=batch, seq=seq, n_micro=n_micro, seed=0, device=dev, log=print)
    n_tensors = sum(t.numel() for t in tr.leaves(T.abstract_params(cfg)))
    TS.train_step = checked_step
    try:
        for k in kernels.values():
            k.launches = 0
        for name in ("flash_attention", "flash_attention_bwd"):
            kernels[name].launches_by_shape.clear()
        # steps 0 and 1 with a checkpoint after step 1, then steps 2 and 3
        # from the state in memory (no name here keeps a handed-over state)
        t0 = time.perf_counter()
        metrics = []
        for state, m in L.train(cfg, L.init(cfg, seed=0, device=dev), 0, 2,
                                ckpt_dir=ckpt_dir, ckpt_every=TRAIN_CKPT_EVERY, **run):
            metrics.append(m)
        # the first run's time outside its steps: the weights' draw and the
        # checkpoint's save (copy to the host, write, sync)
        save_s = time.perf_counter() - t0 - 1e-3 * sum(step_ms)
        rest = L.train(cfg, state, 2, steps, **run)
        del state
        for state, m in rest:
            metrics.append(m)
        launches = {name: k.launches for name, k in kernels.items()}
        flash_shapes = {name: by_shape(kernels[name].launches_by_shape)
                        for name in ("flash_attention", "flash_attention_bwd")}
        whole = [(float(m["loss"]), float(m["grad_norm"])) for m in metrics]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ckpt_gb = sum(f.stat().st_size for f in ckpt_dir.rglob("*") if f.is_file()) / 1e9
        del state, rest
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        state, start = L.resume(ckpt_dir, L.init(cfg, seed=1, device=dev))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        rerun = L.train(cfg, state, start, steps, **run)
        del state
        again = []
        for state, m in rerun:
            again.append(m)
    finally:
        TS.train_step = step_fn
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    resumed = [(float(m["loss"]), float(m["grad_norm"])) for m in again]
    split = train_split(cfg, state, pipeline.batch_for_step(cfg, steps, batch, seq, 0,
                                                            device=dev), n_micro)
    del state, again
    torch.cuda.empty_cache()
    if start != 2 or len(resumed) != steps - 2:
        fail(f"train {arch}: resumed at step {start} with {len(resumed)} steps; want 2 "
             f"and {steps - 2}")
    if not all(np.isfinite(whole + resumed).ravel()):
        fail(f"train {arch}: a loss or grad norm is not finite: {whole}, resumed {resumed}")
    bad = [i for i, got in enumerate(per_step) if got != expect]
    if bad:
        fail(f"train {arch}: kernel launches per step {per_step} != {expect}")
    if not np.allclose(resumed, whole[start:], rtol=1e-6, atol=0):
        fail(f"train {arch}: the resumed steps {resumed} != the uninterrupted run's "
             f"{whole[start:]} (rtol 1e-6)")
    steady = sorted(step_ms[1:])
    med = steady[len(steady) // 2]
    return dict(
        arch=arch, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=cfg.head_dim, d_ff=cfg.d_ff,
        vocab=cfg.vocab, window=cfg.sliding_window, dtype=cfg.dtype, remat=cfg.remat,
        enc_layers=cfg.n_enc_layers, enc_seq=cfg.enc_seq if cfg.is_encdec else None,
        n_params=cfg.n_params(), n_params_tensors=n_tensors, batch=batch, seq=seq,
        n_micro=n_micro, steps=steps, losses=[m[0] for m in whole],
        grad_norms=[m[1] for m in whole], resumed_from=start - 1,
        resumed_losses=[m[0] for m in resumed], resumed_grad_norms=[m[1] for m in resumed],
        resumed_bit_equal=resumed == whole[start:],
        step_ms=step_ms, step_ms_median=med, step_ms_spread=[steady[0], steady[-1]],
        step_ms_over="the steps after the first of both runs",
        tokens_per_s=batch * seq / (med / 1e3), peak_mem_gb=peak_gb,
        init_and_ckpt_save_s=save_s, ckpt_restore_s=restore_s, ckpt_gb=ckpt_gb,
        launches=launches, launches_per_step=per_step[0], expected_per_step=expect,
        flash_calls_by_shape=flash_shapes,
        backward_cuda_kernels_per_step=bwd_cuda_kernels(
            flash_shapes["flash_attention_bwd"], getattr(torch, cfg.dtype), dev) / steps,
        split=split, host_syncs="none (sync debug mode 'error' around each step)")


def bwd_cuda_kernels(rows, dtype, dev) -> int:
    """The CUDA kernels of the flash backward calls in `by_shape`'s
    ``rows``: each call `flash_attention.bwd_kernels_per_call` at its
    shape and split."""
    from repro_torch.kernels import flash_attention as fa
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sum(r["calls"] * fa.bwd_kernels_per_call(
        dtype, r["q"][3], fa.bwd_split(dtype, r["k"][0], r["k"][1], r["k"][2], sms))
        for r in rows)


def adamw_direction(m, v, step):
    """AdamW's d = m_hat / (sqrt(v_hat) + eps) of an element after ``step``
    steps, in float64, from the moments in its state."""
    m, v = m.double(), v.double()
    return (m / (1 - ADAMW["b1"] ** step)) / (
        (v / (1 - ADAMW["b2"] ** step)).sqrt() + ADAMW["eps"])


def update_close(new, old, ref_new, ref_old, m, v, ref_m, ref_v, step, lr, p_rel):
    """The largest excess of |(new - old) - (ref_new - ref_old)| over its
    bound, lr_t * (|d - d_ref| + wd * |old - ref_old|) + p_rel * max(|new|,
    |ref_new|) + lr_t * 1e-5 (TRAIN_TOL's note), and the largest
    difference of the updates, over one leaf. <= 0 passes."""
    lr_t = lr * min(1.0, step / ADAMW["warmup"])
    new, old, ref_new, ref_old = (x.double() for x in (new, old, ref_new, ref_old))
    diff = ((new - old) - (ref_new - ref_old)).abs()
    bound = lr_t * ((adamw_direction(m, v, step) - adamw_direction(ref_m, ref_v, step)).abs()
                    + ADAMW["weight_decay"] * (old - ref_old).abs() + 1e-5) \
        + p_rel * torch.maximum(new.abs(), ref_new.abs())
    return float((diff - bound).max()), float(diff.max())


def leaf_names(tree, path="") -> list[str]:
    """The '/'-joined key path of each leaf of a parameter tree, in the
    leaves' order (`training.tree`: dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{path}/{k}")]
    return [path]


def rel_diffs(got_m, got_state, want_m, want_state) -> dict:
    """Two train steps' relative differences: of the loss and the grad
    norm, and of each moment's leaves, the largest over leaves of max|got
    - want| / max|want| (the leaf named)."""
    from repro_torch.training import tree as tr
    out = {key: abs(float(got_m[key]) - float(want_m[key])) / abs(float(want_m[key]))
           for key in ("loss", "grad_norm")}
    for name in ("m", "v"):
        worst, where = 0.0, None
        for path, g, c in zip(leaf_names(want_state.params),
                              tr.leaves(getattr(got_state.opt, name)),
                              tr.leaves(getattr(want_state.opt, name))):
            rel = float((g.to(c.device) - c).abs().max() / c.abs().max().clamp(min=1e-30))
            if rel >= worst:
                worst, where = rel, path
        out[name], out[f"{name}_worst_leaf"] = worst, where
    return out


def train_vs_cpu(dev, cfg, seed, batch, seq, n_micro=1, tol=None) -> dict:
    """One `train_step` of ``cfg`` on the card and on the CPU (the plain
    path) from the same weights and batch, at TRAIN_VS_CPU_LR: loss, grad
    norm, the moments and every parameter's update within ``tol`` (by
    default TRAIN_TOL of the config's form); the card's launches one
    step's."""
    from repro_torch.data import pipeline
    from repro_torch.models import transformer as T
    from repro_torch.training import train_step as TS
    from repro_torch.training import tree as tr
    form = "bf16" if cfg.param_dtype == torch.bfloat16 else "fp32"
    tol = dict(tol or TRAIN_TOL[form])
    cpu_params = T.init_params(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(seed))
    kernels = train_kernels()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    g_state, g_m = TS.train_step(
        cfg, TS.init_state(cfg, tr.tree_map(lambda t: t.to(dev), cpu_params)),
        pipeline.batch_for_step(cfg, 0, batch, seq, seed, device=dev), n_micro=n_micro,
        lr=TRAIN_VS_CPU_LR)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    t0 = time.perf_counter()
    c_state, c_m = TS.train_step(cfg, TS.init_state(cfg, cpu_params),
                                 pipeline.batch_for_step(cfg, 0, batch, seq, seed,
                                                         device="cpu"), n_micro=n_micro,
                                 lr=TRAIN_VS_CPU_LR)
    cpu_s = time.perf_counter() - t0
    if launches != train_expected(cfg, n_micro) or any(k.launches != launches[n]
                                                      for n, k in kernels.items()):
        fail(f"train_vs_cpu {cfg.name}: launches {launches}; want "
             f"{train_expected(cfg, n_micro)} on the card and none on the CPU")
    errs = rel_diffs(g_m, g_state, c_m, c_state)
    for key in ("loss", "grad_norm"):
        if not (np.isfinite(float(g_m[key])) and errs[key] <= tol[key]):
            fail(f"train_vs_cpu {cfg.name}: {key} {float(g_m[key])} vs CPU "
                 f"{float(c_m[key])}")
    for name in ("m", "v"):
        if errs[name] > tol[name]:
            fail(f"train_vs_cpu {cfg.name}: {name} differs by {errs[name]} of its largest "
                 f"value (leaf {errs[f'{name}_worst_leaf']})")
    excess, upd_err, moved, n_el = -np.inf, 0.0, 0, 0
    for leaf in zip(*(tr.leaves(t) for t in (
            g_state.params, cpu_params, c_state.params, cpu_params, g_state.opt.m,
            g_state.opt.v, c_state.opt.m, c_state.opt.v))):
        flat = [x.reshape(-1) for x in leaf]
        # in pieces: float64 copies of a 1e9-element embedding's eight
        # leaves would not fit the card
        for lo in range(0, flat[0].numel(), 1 << 25):
            piece = [x[lo:lo + (1 << 25)].to(dev) for x in flat]
            e, d = update_close(*piece, step=1, lr=TRAIN_VS_CPU_LR, p_rel=tol["p_rel"])
            excess, upd_err = max(excess, e), max(upd_err, d)
            moved += int((piece[2] != piece[3]).sum())
        n_el += flat[3].numel()
    if excess > 0:
        fail(f"train_vs_cpu {cfg.name}: a parameter's update differs from the CPU's "
             f"by {excess} past its bound")
    return {"config": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "dtype": cfg.dtype, "batch": batch, "seq": seq, "n_micro": n_micro,
            "lr": TRAIN_VS_CPU_LR, "loss": float(g_m["loss"]), "loss_cpu": float(c_m["loss"]),
            "rel_err": errs, "max_abs_update_err": upd_err,
            "update_err_over_bound": excess, "moved_share_cpu": moved / n_el, "tol": tol,
            "launches": launches, "gpu_s": gpu_s, "cpu_s": cpu_s, "ok": True}


def scan_inputs(name, shape, dtype, seed, dev):
    """Random (args, kwargs) of a scan kernel: rglru (b, t, w, h0) or
    rwkv6_wkv (b, t, h, k, s0), the latter with the final state."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    rnd = lambda *sh: torch.randn(sh, generator=g)
    if name == "rglru":
        b, t, w, h0 = shape[:4]
        kind = shape[4] if len(shape) > 4 else "sigmoid"
        offset = shape[5] if len(shape) > 5 else 0
        x, a = rnd(b, t, w), torch.sigmoid(rnd(b, t, w))
        if kind == "zero-one":
            pick = torch.rand((b, t, w), generator=g)
            a = torch.where(pick < 0.25, 0.0, torch.where(pick > 0.75, 1.0, a))
        elif kind == "one-x0":
            pick = torch.rand((b, t, w), generator=g)
            a = torch.where(pick < 0.25, 1.0, a)
            x = torch.where(pick < 0.125, 0.0, x)
        kw = {"h0": rnd(b, w)} if h0 else {}
        if offset:  # contiguous views `offset` elements into their storage
            bufs = [torch.empty(x.numel() + offset, dtype=dtype, device=dev)
                    for _ in (x, a)]
            for buf, v in zip(bufs, (x, a)):
                buf[offset:] = v.flatten().to(dtype)
            return ([buf[offset:].view(x.shape) for buf in bufs],
                    {k: v.to(dev) for k, v in kw.items()})
        args = [x.to(dtype), a.to(dtype)]
    else:
        b, t, h, k, s0 = shape[:5]
        args = [(rnd(b, t, h, k) * 0.5).to(dtype) for _ in range(3)]
        args += [wkv_decay((b, t, h, k), shape[5] if len(shape) > 5 else "sigmoid",
                           g).to(dtype), rnd(h, k) * 0.1]
        kw = {"return_state": True}
        if s0:
            kw["s0"] = rnd(b, h, k, k) * 0.5
    return ([a.to(dev) for a in args],
            {k: v.to(dev) if torch.is_tensor(v) else v for k, v in kw.items()})


def wkv_decay(shape, kind, g):
    """w of a WKV check: the sweeps' sigmoid(N + 2); "main", exp(-exp(N /
    10)) near e^-1 as rwkv6-3b's zero-initialised w_base gives; "near0",
    exp(-U(0, 30)), down to e^-30; "zero-one", sigmoid(N + 2) with a
    quarter exactly 0 and a quarter exactly 1."""
    z = torch.randn(shape, generator=g)
    if kind == "main":
        return torch.exp(-torch.exp(0.1 * z))
    if kind == "near0":
        return torch.exp(-30.0 * torch.rand(shape, generator=g))
    w = torch.sigmoid(z + 2)
    if kind == "zero-one":
        pick = torch.rand(shape, generator=g)
        w = torch.where(pick < 0.25, 0.0, torch.where(pick > 0.75, 1.0, w))
    return w


def scan_checks(dev) -> list[dict]:
    """The scan kernels against their plain versions on random inputs, per
    element within tol * (1 + |want|); each gives the same bits on a second
    call, and the RG-LRU kernel the plain version's bits."""
    table = kernel_table()
    checks = []
    for name, shapes in (("rglru", RGLRU_CHECKS), ("rwkv6_wkv", RWKV6_CHECKS)):
        _, kernel, plain_fn = table[name]
        for form, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            for shape in shapes:
                args, kw = scan_inputs(name, shape, dtype, len(checks), dev)
                got = kernel(*args, **kw)
                torch.cuda.synchronize()
                tol = SCAN_TOL[name][form]
                want = plain_fn(*args, **kw)
                err, rel, ok = compare(got, want, tol)
                row = dict(kernel=name, form=form, shape=list(shape),
                           max_abs_err=err, max_rel_err=rel, tol=tol, ok=ok)
                again = kernel(*args, **kw)
                row["repeats"] = all(torch.equal(a, b) for a, b in zip(got, again))
                row["ok"] = ok and row["repeats"]
                if name == "rglru":
                    row["bit_equal"] = all(torch.equal(a, b) for a, b in zip(got, want))
                    row["ok"] = row["ok"] and row["bit_equal"]
                checks.append(row)
    return checks


def scan_work(name, args, kw):
    """Bytes a scan must move (each input read once, each output written
    once) and the operations it must do, for THESE inputs. rglru: x
    and a in, out written, h0 if given; 7 operations per element (a * a,
    1 - that, the clamp, sqrt, times x, a * h, the sum). rwkv6_wkv: r, k, v,
    w and u in, out written, s0 and the final state if there; per step and
    head 5 per (K, V) pair (r . S, a multiply-add; w * S + k * v, a multiply
    and a multiply-add) and 3 K + 2 V for the bonus, which factors as
    (sum_i r_i u_i k_i) * v_j."""
    if name == "rglru":
        x, _ = args
        nbytes = 3 * x.numel() * x.element_size()
        if kw.get("h0") is not None:
            nbytes += kw["h0"].numel() * kw["h0"].element_size()
        return nbytes, 7 * x.numel()
    r, k, v, w, u = args
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    es = r.element_size()
    nbytes = (3 * r.numel() + 2 * v.numel()) * es + u.numel() * u.element_size()
    if kw.get("s0") is not None:
        nbytes += kw["s0"].numel() * kw["s0"].element_size()
    if kw.get("return_state"):
        nbytes += b * h * dk * dv * es
    return nbytes, (5 * dk * dv + 3 * dk + 2 * dv) * b * t * h


def scan_row(name, form, args, kw, launches, flush, checks, extra) -> dict:
    """One `kernels` entry for a scan kernel on the inputs the main path
    gave it (cast to ``form``'s dtype)."""
    _, kernel, plain_fn = kernel_table()[name]
    got, want = kernel(*args, **kw), plain_fn(*args, **kw)
    torch.cuda.synchronize()
    tol = SCAN_TOL[name][form]
    err, rel, ok = compare(got, want, tol)
    if not ok:
        fail(f"{name}[{form}]: kernel disagrees with its plain version on the "
             f"main path's inputs (max abs err {err}, relative {rel})")
    if name == "rglru":  # the plain version's IEEE operations, in its order
        extra = {**extra, "bit_equal": all(torch.equal(a, b) for a, b in zip(got, want))}
        if not extra["bit_equal"]:
            fail(f"rglru[{form}]: kernel not bit-equal to its plain version on "
                 "the main path's inputs")
    del got, want
    ms = timed_ms(lambda: kernel(*args, **kw), 10, flush)
    plain_ms = timed_ms(lambda: plain_fn(*args, **kw), 2, flush)
    if name == "rglru":
        # what the card's memory gives a stream of the same bytes: one
        # torch.add reading x and a and writing a tensor of out's size (not
        # the same function, so not `library_ms`)
        x, a = args
        sink = torch.empty_like(x)
        extra = {**extra, "stream_ms": timed_ms(lambda: torch.add(x, a, out=sink), 10, flush)}
        del sink
    nbytes, flops = scan_work(name, args, kw)
    # the bf16 WKV kernel runs its products on the tensor cores; the RG-LRU
    # scan and every fp32 form do their math in fp32 on the CUDA cores
    tensor_cores = name == "rwkv6_wkv" and form == "bf16"
    peak = BF16_FLOPS if tensor_cores else FP32_FLOPS
    t_bytes, t_ops = 1e3 * nbytes / HBM_BPS, 1e3 * flops / peak
    extra = {**extra, "of_bound": max(t_bytes, t_ops) / ms}
    if tensor_cores:
        extra["bound_ms_at_fp32_rate"] = max(t_bytes, 1e3 * flops / FP32_FLOPS)
    source = "rglru_scan" if name == "rglru" else "rwkv6_scan"
    return {
        "name": f"{name}[{form}]", "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}.cu",
        "replaces": ("src/repro/kernels/rglru_scan.py:47" if name == "rglru"
                     else "src/repro/kernels/rwkv6_scan.py:50"),
        "launches": launches,
        "shape": {"args": [list(a.shape) for a in args],
                  "kw": sorted(kw), "dtype": str(args[0].dtype).replace("torch.", "")},
        "max_abs_err": err, "max_rel_err": rel, "tol": tol,
        "gate": "|err| <= tol * (1 + |want|) per element",
        "checks": [c for c in checks if c["kernel"] == name and c["form"] == form],
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops, "peak_flops": peak,
        # no single PyTorch call computes this linear recurrence
        "library_ms": None,
        **extra,
    }


def same_values(got, want) -> bool:
    """Whether two tuples of tensors (None skipped) hold the same values in
    each element, NaN where the other has NaN (-0.0 and +0.0 alike)."""
    for g_, w_ in zip(got, want):
        if w_ is None:
            if g_ is not None:
                return False
            continue
        g_, w_ = g_.float(), w_.float()
        if not bool(((g_ == w_) | (g_.isnan() & w_.isnan())).all()):
            return False
    return True


def grad_gate(got, want, tol) -> dict:
    """Gradients ``got`` against ``want`` (tuples, None skipped) under
    ``tol`` = (c1, c2): where want is finite, |got - want| <= c1 * |want|
    + c2 * rms(want), rms over the finite elements; where it is not, got
    holds the same value (the same infinity, or NaN). Returns the worst
    max abs error, err_over_rms (the largest (|err| - c1 |want|) /
    rms(want), which must stay <= c2) and whether every output passed."""
    c1, c2 = tol
    errs, over, ok = [0.0], [-np.inf], True
    for g_, w_ in zip(got, want):
        if w_ is None:
            ok &= g_ is None
            continue
        g_, w_ = g_.float(), w_.float()
        fin = torch.isfinite(w_)
        ok &= bool(((g_ == w_) | (g_.isnan() & w_.isnan()))[~fin].all())
        ok &= bool(torch.isfinite(g_[fin]).all())
        if not bool(fin.any()):
            continue
        err = (g_ - w_).abs()[fin]
        rms = max(float(w_[fin].square().mean().sqrt()), 1e-30)
        errs.append(float(err.max()))
        over.append(float((err - c1 * w_[fin].abs()).max()) / rms)
        ok &= over[-1] <= c2
    return dict(max_abs_err=max(errs), err_over_rms=max(over), tol=tol, ok=ok)


def scan_bwd_inputs(name, shape, dtype, seed, dev):
    """A scan's forward inputs (`scan_inputs`) and cotangents: rglru (x, a,
    h0, dout); rwkv6_wkv (r, k, v, w, u, s0, dout, ds_final), the final
    state's cotangent given where s0 is. Where ``shape`` has a 7th field,
    the inputs of [B, T, ...] and dout (rglru: x, a, dout; rwkv6_wkv: r, k,
    v, w, dout) are views that many elements into their storage."""
    args, kw = scan_inputs(name, shape, dtype, seed, dev)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    offset = shape[6] if len(shape) > 6 else 0
    if name == "rglru":
        x, a = args
        dout = torch.randn(x.shape, generator=g).to(dtype).to(dev)
        if offset:
            x, a, dout = (storage_view(t, offset) for t in (x, a, dout))
        return x, a, kw.get("h0"), dout
    v, s0 = args[2], kw.get("s0")
    dout = (torch.randn(v.shape, generator=g) * 0.5).to(dtype).to(dev)
    ds_final = (None if s0 is None
                else (torch.randn(s0.shape, generator=g) * 0.5).to(dtype).to(dev))
    r, k, v, w, u = args
    if offset:
        r, k, v, w, dout = (storage_view(x, offset) for x in (r, k, v, w, dout))
    return r, k, v, w, u, s0, dout, ds_final


def storage_view(x, offset):
    """A contiguous view holding ``x``'s values ``offset`` elements into
    its storage."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    buf[offset:] = x.flatten()
    return buf[offset:].view(x.shape)


def scan_bwd_fns(name):
    """(the backward kernel's wrapper, its plain gradient) of a scan."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import rwkv6_scan as wkv
    return ((rg.rglru_bwd, ref.rglru_bwd) if name == "rglru"
            else (wkv.rwkv6_wkv_bwd, ref.rwkv6_wkv_bwd))


def scan_bwd_check(name, form, args, got) -> dict:
    """A scan backward's outputs against its plain gradient: the RG-LRU's
    value for value (`same_values`), the WKV's under WKV_BWD_TOL."""
    want = scan_bwd_fns(name)[1](*args)
    if name == "rglru":
        gate = grad_gate(got, want, (0.0, 0.0))
        gate["values_equal"] = same_values(got, want)
        gate["ok"] = gate["values_equal"]
    else:
        gate = grad_gate(got, want, WKV_BWD_TOL[form])
    gate["nonfinite"] = sum(int((~torch.isfinite(w_)).sum()) for w_ in want if w_ is not None)
    return gate


def scan_bwd_checks(dev) -> list[dict]:
    """The scans' backward kernels against their plain gradients on
    RGLRU_BWD_CHECKS and RWKV6_BWD_CHECKS, fp32 and bf16, each call
    repeated and equal bit for bit (`bwd_row` checks the training
    shapes)."""
    checks = []
    for name, shapes in (("rglru", RGLRU_BWD_CHECKS), ("rwkv6_wkv", RWKV6_BWD_CHECKS)):
        kernel = scan_bwd_fns(name)[0]
        for shape, form in ((s, f) for f in ("fp32", "bf16") for s in shapes):
            dtype = torch.float32 if form == "fp32" else torch.bfloat16
            args = scan_bwd_inputs(name, shape, dtype, len(checks), dev)
            got, again = kernel(*args), kernel(*args)
            torch.cuda.synchronize()
            gate = scan_bwd_check(name, form, args, got)
            same = same_bits(tuple(x for x in got if x is not None),
                             tuple(x for x in again if x is not None))
            ok = gate.pop("ok") and same
            checks.append(dict(kernel=f"{name}_bwd", form=form, shape=list(shape), **gate,
                               repeat_equal=same, off_16_bytes=args[0].data_ptr() % 16 != 0,
                               ok=ok))
            del args, got, again
    return checks


def router_bwd_checks(dev) -> list[dict]:
    """The router's backward kernel against its plain gradient on
    ROUTER_BWD_CHECKS and at DeepSeek's full widths (ROUTER_BWD_FULL), on
    the forward kernel's indices, under ROUTER_BWD_TOL; each call repeated
    and equal bit for bit."""
    from repro_torch.kernels import moe_router as mr
    from repro_torch.kernels import ref
    checks = []
    cases = ROUTER_BWD_CHECKS + [(t, e, k, "random", bias)
                                 for _, t, e, k, bias in ROUTER_BWD_FULL]
    for t, e, k, pattern, bias in cases:
        scores, b = router_inputs(t, e, bias, len(checks), dev, pattern)
        _, idx = mr.topk_router(scores, k, bias=b)
        dw = torch.randn((t, k), generator=torch.Generator().manual_seed(len(checks))).to(dev)
        got, again = mr.topk_router_bwd(scores, idx, dw), mr.topk_router_bwd(scores, idx, dw)
        torch.cuda.synchronize()
        gate = grad_gate((got,), (ref.topk_router_bwd(scores, idx, dw),), ROUTER_BWD_TOL)
        same = same_bits(got, again)
        ok = gate.pop("ok") and same
        checks.append(dict(shape=[t, e, k], bias=bias, pattern=pattern, **gate,
                           repeat_equal=same, ok=ok))
    return checks


def scan_bwd_work(name, x) -> tuple[int, int]:
    """Bytes a scan's backward call must move and fp32 operations it must
    do, its first input ``x`` given: RG-LRU (x, a and dout read, dx and da
    written: 10 B an element in bf16; some 20 operations an element); WKV
    (r, k, v, w and dout read, dr, dk, dv, dw written: 18 B an element in
    bf16, and u read, du written; 10 K V operations a (b, t, h))."""
    es = x.element_size()
    if name == "rglru":
        return 5 * x.numel() * es, 20 * x.numel()
    b, t, h, dk = x.shape
    return 9 * x.numel() * es + 2 * h * dk * 4, 10 * dk * dk * b * t * h


def bwd_row(name, form, shape, source, launches, flush, checks, floor_ms, extra) -> dict:
    """The `kernels` entry of a scan's backward kernel (name "rglru" or
    "rwkv6_wkv") on random inputs at its training shape: checked against
    the plain gradient (`scan_bwd_check`), timed spun (`spun_ms`) beside
    `floor_ms`, one run of the plain gradient, the bound (the larger of
    `scan_bwd_work`'s bytes and fp32 operations) and the CUDA kernels of
    one call under torch.profiler (`profile_kernels`), which must number
    SCAN_BWD_KERNELS."""
    kernel, plain_fn = scan_bwd_fns(name)
    dtype = torch.bfloat16 if form == "bf16" else torch.float32
    kind = "one-x0" if name == "rglru" else "main"
    args = scan_bwd_inputs(name, (*shape, False, kind), dtype, 26, dev=flush.device)
    got = kernel(*args)
    torch.cuda.synchronize()
    gate = scan_bwd_check(name, form, args, got)
    if not gate["ok"]:
        fail(f"{name}_bwd[{form}] at the training shape: {gate}")
    del got
    ms, spin_ms, host_ms, attempts = spun_ms(f"{name}_bwd", lambda: kernel(*args), 5,
                                             flush)
    plain_ms = timed_ms(lambda: plain_fn(*args), 1, flush)
    per_call = profile_kernels(lambda: kernel(*args))[0]
    if per_call != SCAN_BWD_KERNELS[name]:
        fail(f"{name}_bwd[{form}]: one call launched {per_call} kernels, "
             f"want {SCAN_BWD_KERNELS[name]}")
    nbytes, flops = scan_bwd_work(name, args[0])
    t_bytes, t_ops = 1e3 * nbytes / HBM_BPS, 1e3 * flops / FP32_FLOPS
    return {
        "name": f"{name}_bwd[{form}]", "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}.cu",
        # no TPU kernel: it stands for XLA's autodiff of the reference's
        # jnp oracle, the reference's training gradient
        "replaces": ("src/repro/kernels/ref.py:271 (autodiff of rglru; no pallas_call)"
                     if name == "rglru" else
                     "src/repro/kernels/ref.py:228 (autodiff of rwkv6_wkv; no pallas_call)"),
        "launches": launches,
        # counted under torch.profiler (`profile_kernels`)
        "kernels_per_launch": per_call,
        "shape": {"args": [list(a.shape) for a in args if a is not None],
                  "dtype": str(dtype).replace("torch.", "")},
        **{key: gate[key] for key in ("max_abs_err", "err_over_rms", "tol")},
        "values_equal": gate.get("values_equal"), "nonfinite": gate["nonfinite"],
        "gate": ("value for value, NaN where the plain gradient has NaN"
                 if name == "rglru" else
                 "|err| <= tol[0] * |want| + tol[1] * rms(want) per element"),
        "checks": [c for c in checks if c["kernel"] == f"{name}_bwd"],
        "ms": ms, "spin_ms": spin_ms, "host_ms_max": host_ms, "spun_attempts": attempts,
        "floor_ms": floor_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops, "peak_flops": FP32_FLOPS,
        "of_bound": max(t_bytes, t_ops) / ms,
        # no single PyTorch call computes this recurrence's gradient
        "library_ms": None,
        **extra,
    }


def router_bwd_row(form, launches, flush, checks, floor_ms, extra) -> dict:
    """The `kernels` entry of the router's backward kernel at DeepSeek's
    full width (ROUTER_BWD_FULL, ``form`` "v2" or "v3"), on the forward
    kernel's indices: checked, timed spun beside `floor_ms` and the plain
    gradient, and its byte bound (idx, dw and the picked scores read, the
    [T, E] gradient written)."""
    from repro_torch.kernels import moe_router as mr
    from repro_torch.kernels import ref
    _, t, e, k, bias = next(c for c in ROUTER_BWD_FULL if c[0] == form)
    scores, b = router_inputs(t, e, bias, 26, flush.device)
    _, idx = mr.topk_router(scores, k, bias=b)
    dw = torch.randn((t, k), generator=torch.Generator().manual_seed(26)).to(flush.device)
    got = mr.topk_router_bwd(scores, idx, dw)
    gate = grad_gate((got,), (ref.topk_router_bwd(scores, idx, dw),), ROUTER_BWD_TOL)
    if not gate["ok"]:
        fail(f"topk_router_bwd[{form}] at the full width: {gate}")
    ms, spin_ms, host_ms, attempts = spun_ms(
        f"topk_router_bwd {form}", lambda: mr.topk_router_bwd(scores, idx, dw), 50, flush)
    plain_ms = timed_ms(lambda: ref.topk_router_bwd(scores, idx, dw), 10, flush)
    nbytes = t * k * 12 + t * e * 4
    t_bytes, t_ops = 1e3 * nbytes / HBM_BPS, 1e3 * 8 * t * k / FP32_FLOPS
    return {
        "name": f"topk_router_bwd[{form}]", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_router_bwd.cu",
        "replaces": "src/repro/kernels/ref.py:214 (autodiff of topk_router; no pallas_call)",
        "launches": launches,
        "shape": {"scores": [t, e], "k": k, "bias": bias},
        **{key: gate[key] for key in ("max_abs_err", "err_over_rms", "tol")},
        "gate": "|err| <= tol[0] * |want| + tol[1] * rms(want) per element",
        "checks": checks,
        "ms": ms, "spin_ms": spin_ms, "host_ms_max": host_ms, "spun_attempts": attempts,
        "floor_ms": floor_ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "of_bound": max(t_bytes, t_ops) / ms,
        "of_bound_floor": max(t_bytes, t_ops, floor_ms) / ms,
        # no single PyTorch call computes this gradient from (scores, idx, dw)
        "library_ms": None,
        **extra,
    }


def flash_row(name, form, q, k, v, causal, window, launches, flush, checks,
              extra) -> dict:
    """One `kernels` entry for the flash kernel on the inputs the main path
    gave it."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err, rel, _ = max_err(got, want, TOL[form])
    ok = rel <= TOL[form] and bool(torch.isfinite(got).all())
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version on the main "
             f"path's inputs (max abs err {err}, relative {rel})")
    # the library yardstick: one scaled_dot_product_attention call over the
    # same inputs in its [B, H, S, D] layout (views, not copies). The
    # windowed shape passes its band as an explicit boolean mask.
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    s, t = q.shape[1], k.shape[1]
    if window:
        pos = torch.arange(s, device=q.device)[:, None] + (t - s)
        cols = torch.arange(t, device=q.device)[None, :]
        mask = (cols <= pos) & (cols > pos - window)
        library = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
        library_call = "scaled_dot_product_attention(attn_mask=band, enable_gqa=True)"
    else:
        library = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
        library_call = f"scaled_dot_product_attention(is_causal={causal}, enable_gqa=True)"
    lib_err = float((library().transpose(1, 2).float() - want.float()).abs().max())
    ms = timed_ms(lambda: fa.flash_attention(q, k, v, causal=causal, window=window),
                  5, flush)
    # spun (`spun_ms`): the window holds the launch and not the host's gap
    # before it, which the shortest shapes (whisper's cross-attention) need
    ms_spun, spin_ms, host_ms, attempts = spun_ms(
        name, lambda: fa.flash_attention(q, k, v, causal=causal, window=window), 5, flush)
    plain_ms = timed_ms(lambda: ref.attention(q, k, v, causal=causal, window=window),
                        3, flush)
    library_ms = timed_ms(library, 10, flush)
    nbytes, flops = flash_work(q, k, causal, window)
    peak = BF16_FLOPS if form == "bf16" else FP32_FLOPS
    t_bytes, t_ops = 1e3 * nbytes / HBM_BPS, 1e3 * flops / peak
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:76",
        "launches": launches,
        "shape": {"q": list(q.shape), "k": list(k.shape), "causal": causal,
                  "window": window, "dtype": str(q.dtype).replace("torch.", "")},
        "max_abs_err": err, "max_rel_err": rel, "tol": TOL[form],
        "gate": "max_abs_err / max|want| <= tol",
        "checks": [c for c in checks if c["form"] == form],
        "ms": ms, "ms_spun": ms_spun, "spin_ms": spin_ms, "host_ms_max": host_ms,
        "spun_attempts": attempts, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "flops": flops,
        "peak_flops": peak,
        # achieved rate and the share of the bound this run reached
        "tflops": flops / ms / 1e9, "of_bound": max(t_bytes, t_ops) / ms,
        "of_bound_spun": max(t_bytes, t_ops) / ms_spun,
        "library_ms": library_ms, "library_call": library_call,
        "library_max_abs_err": lib_err,
        **extra,
    }


def router_inputs(t, e, bias, seed, dev, pattern="random"):
    """Random router inputs: softmax scores and a bias of scale 0.1; per
    ``pattern`` "ties", four values per row (every row has exact ties);
    "zeros", rows of -0.0 and +0.0 with a small positive score every 7th
    expert (k past those picks ties between the two zeros); "equal", rows
    of one value; "negbias", sigmoid scores and a bias near -2 (every sel
    negative); "tiny", scores below 1e-12 (a row's picks sum below 1e-9);
    "offset", the scores a view one element into their storage."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    if pattern == "ties":
        scores = torch.randint(0, 4, (t, e), generator=g).float() / 8
    elif pattern == "zeros":
        scores = torch.where(torch.rand((t, e), generator=g) < 0.5,
                             torch.tensor(-0.0), torch.tensor(0.0))
        scores[:, ::7] = torch.rand((t, (e + 6) // 7), generator=g) * 0.01
    elif pattern == "equal":
        scores = torch.full((t, e), 1.0 / e)
    elif pattern == "negbias":
        scores = torch.sigmoid(torch.randn((t, e), generator=g))
    elif pattern == "tiny":
        scores = torch.rand((t, e), generator=g) * 1e-12
    else:
        scores = torch.softmax(torch.randn((t, e), generator=g), -1)
    b = torch.randn((e,), generator=g) * 0.1 if bias else None
    if b is not None and pattern == "negbias":
        b -= 2.0
    scores = scores.to(dev)
    if pattern == "offset":
        store = torch.empty(t * e + 1, dtype=torch.float32, device=dev)
        store[1:] = scores.view(-1)
        scores = store[1:].view(t, e)
    return scores, None if b is None else b.to(dev)


def router_checks(dev) -> list[dict]:
    """The router kernel against its plain version on random inputs, with
    and without bias, on rows with exact ties and on ROUTER_EDGES: indices
    exact, weights within ROUTER_W_TOL; each call repeated and equal bit
    for bit."""
    from repro_torch.kernels import moe_router as mr
    from repro_torch.kernels import ref
    checks = []
    shapes = ([(t, e, k, "random") for t, e, k in ROUTER_CHECKS]
              + [(64, 160, 6, "ties"), (64, 256, 8, "ties")] + ROUTER_EDGES)
    for t, e, k, pattern in shapes:
        for bias in (False, True):
            scores, b = router_inputs(t, e, bias, len(checks), dev, pattern)
            got = mr.topk_router(scores, k, bias=b)
            again = mr.topk_router(scores, k, bias=b)
            torch.cuda.synchronize()
            err, same, ok = router_compare(got, ref.topk_router(scores, k, bias=b))
            repeat = same_bits(got, again)
            checks.append(dict(shape=[t, e, k], bias=bias, pattern=pattern,
                               max_abs_err=err, idx_equal=same, repeat_equal=repeat,
                               ok=ok and repeat))
    return checks


def router_bound(t, e, k, bias):
    """(bound ms, bound_by, bytes, flops) of one router call: scores read
    once, the bias once, w (fp32) and idx (int32) written; the bias add per
    score, then per pick a sum and a division."""
    nbytes = t * e * 4 + (e * 4 if bias else 0) + t * k * 8
    flops = (t * e if bias else 0) + 2 * t * k
    t_bytes, t_ops = 1e3 * nbytes / HBM_BPS, 1e3 * flops / FP32_FLOPS
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def router_row(name, scores, k, bias, decode_in, launches, flush, checks,
               floor_ms, extra) -> dict:
    """One `kernels` entry for the router kernel on the scores the first
    MoE layer of a prefill gave it, and (the `decode_` keys) on the first
    decode step's. Each is held against its plain version and repeated bit
    for bit; `ms` times events around the wrapper, `ms_spun` a spin kernel
    ahead of the start event (the run fails when the host's time outlasts
    the spin); `of_bound` is bound / ms_spun, `of_bound_floor` max(bound,
    floor_ms) / ms_spun."""
    from repro_torch.kernels import moe_router as mr
    from repro_torch.kernels import ref
    (d_args, d_kw) = decode_in
    row = {}
    for pre, (s, kw) in (("", (scores, {"bias": bias})), ("decode_", (d_args[0], d_kw))):
        got = mr.topk_router(s, k, **kw)
        err, same, ok = router_compare(got, ref.topk_router(s, k, **kw))
        if not ok:
            fail(f"{name}: kernel disagrees with its plain version on the main "
                 f"path's {pre or 'prefill_'}inputs (max abs weight err {err}, "
                 f"indices equal {same})")
        repeat = same_bits(got, mr.topk_router(s, k, **kw))
        if not repeat:
            fail(f"{name}: a second call on the main path's {pre or 'prefill_'}inputs "
                 "gave other bits")
        ms = timed_ms(lambda: mr.topk_router(s, k, **kw), 20, flush)
        ms_spun, spin_ms, host_ms, attempts = spun_ms(
            f"{name} {pre or 'prefill'}", lambda: mr.topk_router(s, k, **kw), 50, flush)
        bound, bound_by, nbytes, flops = router_bound(*s.shape, k, kw.get("bias") is not None)
        row.update({f"{pre}shape": list(s.shape), f"{pre}max_abs_err": err,
                    f"{pre}idx_equal": same, f"{pre}repeat_equal": repeat,
                    f"{pre}ms": ms, f"{pre}ms_spun": ms_spun, f"{pre}spin_ms": spin_ms,
                    f"{pre}host_ms_max": host_ms, f"{pre}spun_attempts": attempts,
                    f"{pre}bound_ms": bound,
                    f"{pre}bound_by": bound_by, f"{pre}bytes": nbytes,
                    f"{pre}flops": flops, f"{pre}of_bound": bound / ms_spun,
                    f"{pre}of_bound_floor": max(bound, floor_ms) / ms_spun})
    plain_ms = timed_ms(lambda: ref.topk_router(scores, k, bias=bias), 10, flush)
    # the library yardstick covers the selection only: torch.topk on the
    # same sel (its tie order is not promised, and it gives no weights)
    sel = scores if bias is None else scores + bias
    library_ms = timed_ms(lambda: torch.topk(sel, k, dim=-1), 20, flush)
    library_ms_spun = spun_ms(f"{name} torch.topk", lambda: torch.topk(sel, k, dim=-1),
                              20, flush)[0]
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moe_router.cu",
        "replaces": "src/repro/kernels/moe_router.py:43",
        "launches": launches,
        **row,
        "shape": {"scores": row["shape"], "k": k, "bias": bias is not None},
        "tol": ROUTER_W_TOL, "gate": "indices exact, |w err| <= tol",
        "checks": checks,
        "plain_ms": plain_ms, "floor_ms": floor_ms,
        "library_ms": library_ms, "library_ms_spun": library_ms_spun,
        "library_call": "torch.topk(scores + bias, k) (selection only, no weights)",
        **extra,
    }


def ftl_tables(n_seg, n_slots, entries, n, seed, offset=0, out_of_range=False):
    """Random FTL inputs on the CPU: a directory with 40 % misses, PPNs in
    [0, 2^31 - 1), n + ``offset`` LPNs (the caller takes the last n as a
    view ``offset`` elements into their storage); with ``out_of_range``
    the LPNs span [-2 * n_seg * entries, 2 * n_seg * entries) with int32's
    extremes, and the directory holds slots below -1 and past the cache."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    d = torch.where(torch.rand((n_seg,), generator=g) < 0.6,
                    torch.randint(0, n_slots, (n_seg,), generator=g), -1)
    span = n_seg * entries
    lo, hi = (-2 * span, 2 * span) if out_of_range else (0, span)
    lp = torch.randint(max(lo, -2**31), min(hi, 2**31 - 1), (n + offset,), generator=g)
    if out_of_range:
        d[::5], d[1::7] = -7, n_slots + 3
        lp[:2] = torch.tensor([-2**31, 2**31 - 1][:n + offset])
    c = torch.randint(0, 2**31 - 1, (n_slots, entries), generator=g)
    return [x.to(torch.int32) for x in (lp, d, c)]


def ftl_burst(dev):
    """The FTL lookup's main-path inputs, from a seed: (lpns, directory,
    mapping_cache, entries) of a burst of FTL_BURST uniform LPNs against a
    4 TB SSD's 1862-segment directory, half of its segments cached (931
    mapping pages of 524288 PPNs in [0, 2^31 - 1), 1.95 GB)."""
    from repro_torch.jbof import ssd
    entries = ssd.SEGMENT_BYTES // 4          # 4-byte entries per 2 MB segment
    n_seg = ssd.SEGMENTS_FULL
    n_slots = n_seg // 2
    g = torch.Generator(device=dev).manual_seed(11)
    directory = torch.full((n_seg,), -1, dtype=torch.int32, device=dev)
    cached = torch.randperm(n_seg, generator=g, device=dev)[:n_slots]
    directory[cached] = torch.arange(n_slots, dtype=torch.int32, device=dev)
    cache = torch.randint(0, 2**31 - 1, (n_slots, entries), generator=g,
                          device=dev, dtype=torch.int32)
    lpns = torch.randint(0, n_seg * entries, (FTL_BURST,), generator=g,
                         device=dev, dtype=torch.int32)
    return lpns, directory, cache, entries


def ftl_hit_positions(lpns, directory, entries):
    """The flat positions in the mapping cache of the burst's hits (int64;
    in-range LPNs), for the gather yardstick."""
    slot = directory[lpns // entries].long()
    return (slot * entries + (lpns % entries))[slot >= 0]


def ftl_bytes(n, n_seg, hits, per_gather=4):
    """The least bytes a burst of ``n`` LPNs with ``hits`` hits needs: each
    LPN read and its PPN and hit byte written (9 B per LPN), the directory
    read once (4 B per segment), ``per_gather`` bytes per hit's mapping
    entry (a miss reads none): 4 for the entry itself, 32 for the whole
    sector a random gather fetches."""
    return n * 9 + n_seg * 4 + per_gather * hits


def ftl_phase(dev, flush, floor_ms) -> tuple[dict, dict]:
    """The FTL lookup's path at SSD scale: `kernels.ops.ftl_lookup`, its
    one entry point, on a burst of 2^20 uniform LPNs against a 4 TB SSD's
    directory of 1862 segments, half of them cached (931 mapping pages of
    524288 random PPNs in [0, 2^31 - 1), 1.95 GB). The launch count is
    zeroed just before the burst and read just after; the burst runs
    under sync debug mode "error". The kernel must give its plain
    version's result bit for bit, and the same bits again on a second
    call, there, on the sweep of tests/test_kernels.py with out-of-range
    LPNs added (entries 8 and 1000), and on FTL_EDGES. Times: `ms` (events
    around the wrapper), `ms_spun` (a spin ahead of the start event; the
    run fails when the host's time outlasts it), and as a yardstick of
    the card's rate for random 32-byte sectors, `gather_ms`: one PyTorch
    gather (`index_select`) of the burst's hit entries from the mapping
    cache. Returns the phase's line and its `kernels` entry; frees its
    tensors."""
    from repro_torch.kernels import ftl_lookup as fk
    from repro_torch.kernels import ops, ref
    lpns, directory, cache, entries = ftl_burst(dev)
    n_seg, n_slots = directory.numel(), cache.shape[0]
    torch.cuda.synchronize()
    fk.ftl_lookup.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        ppn, hit = ops.ftl_lookup(lpns, directory, cache, entries)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = fk.ftl_lookup.launches
    want_ppn, want_hit = ref.ftl_lookup(lpns, directory, cache, entries)
    torch.cuda.synchronize()
    exact = torch.equal(ppn, want_ppn) and torch.equal(hit, want_hit)
    burst_err = exact_err((ppn, hit), (want_ppn, want_hit))
    repeat_equal = same_bits((ppn, hit), fk.ftl_lookup(lpns, directory, cache, entries))
    n_hits = int(hit.sum())
    big = int((ppn >= 1 << 24).sum())
    if launches != 1:
        fail(f"ftl: ftl_lookup launched {launches} times in one lookup")
    if not exact:
        fail("ftl: the kernel's PPNs or hits differ from its plain version's "
             "on the SSD-scale burst")
    if not repeat_equal:
        fail("ftl: a second call on the burst gave other bits")
    # random sweep, out-of-range LPNs (negative, past the table: floored
    # //, a wrap, then clamps) at entries 8 and 1000, then the edges
    cases = [(f"sweep{i}", ftl_tables(*shape, seed=100 + i), 0, False)
             for i, shape in enumerate(FTL_SWEEP)]
    cases.append(("out_of_range", [
        torch.tensor([-100, -57, -56, -9, -1, 0, 5, 15, 31, 39, 55, 56, 57, 1000,
                      2**31 - 1, -2**31], dtype=torch.int32),
        torch.tensor([2, 0, -1, 1, 5, 2, -7], dtype=torch.int32),
        torch.randint(0, 2**31 - 1, (3, 8), generator=torch.Generator().manual_seed(99),
                      dtype=torch.int32)], 0, True))
    cases.append(("out_of_range_entries1000",
                  ftl_tables(50, 9, 1000, 4099, seed=98, out_of_range=True), 0, True))
    cases += [(label, ftl_tables(ns, nsl, ent, n, seed=200 + i, offset=off), off, False)
              for i, (label, ns, nsl, ent, n, off) in enumerate(FTL_EDGES)]
    sweep = []
    for label, (lp, d, c), off, out_of_range in cases:
        d, c = d.to(dev), c.to(dev)
        lp = lp.to(dev)[off:]          # a view ``off`` elements into its storage
        got = fk.ftl_lookup(lp, d, c, c.shape[1])
        again = fk.ftl_lookup(lp, d, c, c.shape[1])
        want = ref.ftl_lookup(lp, d, c, c.shape[1])
        torch.cuda.synchronize()
        sweep.append(dict(case=label, shape=[d.numel(), *c.shape, lp.numel()],
                          lpns_offset=lp.storage_offset(), out_of_range=out_of_range,
                          exact=torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                          repeat_equal=same_bits(got, again)))
    if not all(c["exact"] and c["repeat_equal"] for c in sweep):
        fail(f"ftl: kernel differs from its plain version on the sweep: {sweep}")
    ms = timed_ms(lambda: fk.ftl_lookup(lpns, directory, cache, entries), 20, flush)
    ms_spun, spin_ms, host_ms, attempts = spun_ms(
        "ftl", lambda: fk.ftl_lookup(lpns, directory, cache, entries), 20, flush)
    plain_ms = timed_ms(lambda: ref.ftl_lookup(lpns, directory, cache, entries),
                        10, flush)
    # the yardstick of random 32-byte sectors: the burst's hit entries
    # gathered from the mapping cache by one PyTorch call. It fetches what
    # the kernel's gathers fetch, but it does not compute the lookup (no
    # directory walk, no misses), so it is no library_ms
    flat = ftl_hit_positions(lpns, directory, entries)
    gather_ms, gather_spin_ms, gather_host_ms, gather_attempts = spun_ms(
        "ftl gather", lambda: cache.view(-1).index_select(0, flat), 20, flush)
    # the least bytes THIS burst needs, and the same with a whole sector
    # per mapping gather
    nbytes = ftl_bytes(FTL_BURST, n_seg, n_hits)
    t_bytes = 1e3 * nbytes / HBM_BPS
    sector_bytes = ftl_bytes(FTL_BURST, n_seg, n_hits, per_gather=32)
    line = dict(n_seg=n_seg, n_slots=n_slots, entries=entries,
                mapping_cache_gb=cache.numel() * 4 / 1e9, lpns=FTL_BURST,
                launches=launches, exact=exact, repeat_equal=repeat_equal,
                hit_rate=n_hits / FTL_BURST, ppns_past_2_24=big, sweep=sweep, ms=ms,
                ms_spun=ms_spun, gather_ms=gather_ms, plain_ms=plain_ms,
                lookups_per_s=FTL_BURST / (ms_spun / 1e3))
    row = {
        "name": "ftl_lookup", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ftl_lookup.cu",
        "replaces": "src/repro/kernels/ftl_lookup.py:54",
        "launches": launches,
        "shape": {"lpns": FTL_BURST, "directory": n_seg,
                  "mapping_cache": [n_slots, entries]},
        "max_abs_err": burst_err, "gate": "bit for bit (PPNs and hits)",
        "checks": sweep, "repeat_equal": repeat_equal,
        "ms": ms, "ms_spun": ms_spun, "spin_ms": spin_ms, "host_ms_max": host_ms,
        "spun_attempts": attempts, "plain_ms": plain_ms, "floor_ms": floor_ms,
        # integer work: a division, a few compares per LPN
        "bound_ms": t_bytes, "bound_by": "bytes",
        "of_bound": t_bytes / ms_spun, "of_bound_floor": max(t_bytes, floor_ms) / ms_spun,
        "bytes": nbytes, "hits": n_hits,
        "sector_bound_ms": 1e3 * sector_bytes / HBM_BPS, "sector_bytes": sector_bytes,
        "gather_ms": gather_ms, "gather_spin_ms": gather_spin_ms,
        "gather_host_ms_max": gather_host_ms, "gather_spun_attempts": gather_attempts,
        "gather_call": "mapping_cache.view(-1).index_select(0, hit positions) "
                       "(the hit entries only: a yardstick, not the lookup)",
        # no single PyTorch call computes the two-level translation
        "library_ms": None,
    }
    del directory, cache, lpns, ppn, hit, want_ppn, want_hit, flat
    torch.cuda.empty_cache()
    return line, row


def engine_phase(E, pa, phase, dev) -> tuple[dict, dict]:
    """One phase of the main path: `serving.engine.step` at FULL_WIDTH for
    STEPS steps from fixed seeds, after a warm-up on a throwaway state,
    driven REPEATS times. Each time the kernels' launch counts are zeroed
    just before the run and read just after. Returns the phase's line
    (harvesting counts, launches, the last attention norm, host ms per
    step: the median and every run's) and the last step's kernel calls
    {name: (args, kw)}, which each kernel must also compute as its plain
    version does. Fails on counts other than the JAX reference's, on a
    launch count other than one a step (paged attention; with
    trace_driven also the SHARDS window), on a non-finite norm, on a host
    sync inside a step, and on a phase with shards that exchanged no
    request; with trace_driven on a last-step want other than the
    reference's (WANT_PAGES_LAST), or none on a loaded replica; with obs
    on an empty event log or one without a row of the exchange (level
    >= 1)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import shards_window as sw

    cfg, expect = engine_cfg(E, phase)
    arrivals = torch.tensor(ARRIVALS, dtype=torch.int32, device=dev)
    # warm-up on a throwaway state (cuBLAS handles, the kernel library)
    warm = E.init(cfg, device=dev)
    for _ in range(2):
        warm, _ = E.step(cfg, warm, arrivals)
    del warm
    captured = {}
    dispatch = E.kops.paged_attention
    window = E.kops.shards_window

    def capture(*args, **kw):
        captured["paged_attention"] = (args, kw)
        return dispatch(*args, **kw)

    def capture_window(*args, **kw):
        captured["shards_window"] = (args, kw)
        return window(*args, **kw)

    runs = []
    for _ in range(REPEATS):
        state = E.init(cfg, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
        gen = torch.Generator(device=dev).manual_seed(7)
        redirected = torch.zeros((), dtype=torch.int32, device=dev)
        cross = torch.zeros((), dtype=torch.float32, device=dev)
        norms = []
        torch.cuda.synchronize()
        E.kops.paged_attention = capture
        E.kops.shards_window = capture_window
        pa.paged_attention.launches = 0
        sw.shards_window.launches = 0
        t0 = time.perf_counter()
        # the step reads nothing back to the host: any synchronizing CUDA
        # call inside it raises here
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(STEPS):
                state, stats = E.step(cfg, state, arrivals, generator=gen)
                redirected += stats["redirected"]
                cross += stats["cross_redirected"]
                norms.append(stats["attn_norm"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
            E.kops.paged_attention = dispatch
            E.kops.shards_window = window
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = pa.paged_attention.launches
        window_launches = sw.shards_window.launches
        norms = torch.stack(norms).cpu()
        got = (int(redirected), int(stats["offsite_pages"]),
               int(stats["log_commits"]), int(cross))
        runs.append(dict(got=got, launches=launches, window_launches=window_launches,
                         norm=float(norms[-1]),
                         finite=bool(torch.isfinite(norms).all()),
                         ms_per_step=1e3 * seconds / STEPS))
        if got != expect:
            fail(f"{phase}: harvesting counts {got} != reference {expect}")
        if launches != STEPS:
            fail(f"{phase}: paged_attention launched {launches} times in {STEPS} steps")
        if window_launches != (STEPS if cfg.trace_driven else 0):
            fail(f"{phase}: shards_window launched {window_launches} times in "
                 f"{STEPS} steps")
        if not runs[-1]["finite"]:
            fail(f"{phase}: attn_norm not finite")
        planes = {}
        if cfg.trace_driven:
            want = stats["want_pages"].cpu().tolist()
            loaded = [i for i, a in enumerate(ARRIVALS) if a > 0]
            if want != WANT_PAGES_LAST[phase] or min(want[i] for i in loaded) <= 0:
                fail(f"{phase}: want_pages at the last step {want} != the "
                     f"reference's {WANT_PAGES_LAST[phase]}")
            planes["want_pages_last"] = want
        if cfg.obs.enabled:
            records, dropped = E.obs_events(state)
            level1 = sum(r["level"] >= 1 for r in records)
            if not records or not level1:
                fail(f"{phase}: the event log holds {len(records)} rows, "
                     f"{level1} of the exchange")
            history = E.obs_history(state)
            planes.update(events=len(records), events_level_ge1=level1,
                          events_dropped=dropped,
                          event_count=state.obs.events.count.cpu().tolist(),
                          ring_windows=int(history["util"].shape[0]),
                          obs_cursor=state.obs.metrics.cursor.cpu().tolist())
        runs[-1]["planes"] = planes
        del state
    if cfg.n_shards > 1 and expect[3] <= 0:
        fail(f"{phase}: no request crossed shards")
    args, kw = captured["paged_attention"]
    err, _, ok = max_err(pa.paged_attention(*args, **kw), plain(ref, args, kw),
                         TOL["int8" if kw else "fp32"])
    if not ok:
        fail(f"{phase}: kernel disagrees with its plain version on the phase's "
             f"last step (max abs err {err})")
    window_equal = None
    if cfg.trace_driven:
        args, kw = captured["shards_window"]
        got_w, want_w = sw.shards_window(*args, **kw), ref.shards_window(*args, **kw)
        window_equal = all(torch.equal(a, b) for a, b in zip(got_w, want_w))
        if not window_equal:
            fail(f"{phase}: the shards_window kernel differs from its plain "
                 "version on the phase's last window")
    ms = sorted(r["ms_per_step"] for r in runs)
    got = runs[0]["got"]
    line = dict(redirected=got[0], offsite_pages=got[1], log_commits=got[2],
                cross_redirected=got[3], expected=list(expect),
                n_shards=cfg.n_shards,
                shards_per_enclosure=cfg.shards_per_enclosure,
                launches=runs[0]["launches"],
                launches_each_run=[r["launches"] for r in runs],
                shards_window_launches=runs[0]["window_launches"],
                shards_window_bit_equal=window_equal,
                **runs[0]["planes"],
                attn_norm_last=runs[0]["norm"],
                attn_norm_finite=all(r["finite"] for r in runs),
                kernel_max_abs_err=err,
                # host clock, from a synchronize to a synchronize
                ms_per_step=ms[len(ms) // 2],
                ms_per_step_runs=[r["ms_per_step"] for r in runs],
                ms_per_step_spread=[ms[0], ms[-1]])
    return line, captured


def drive_on_card(E, pa, cfg, state, sched, arrivals_fn, steps) -> dict:
    """`serving.scenarios.drive_events` on the card with every `E.step`
    call wrapped: the sync debug mode raises on a host sync inside a step
    (`drive_events`' surgery between steps — `fail_replica`, the pins, its
    read-back of each step's counts — may sync, as the reference's does),
    the steps are counted, and the last step's paged-attention call is
    kept. The kernel's launch count is zeroed just before the run and read
    just after. Returns the run, its steps, launches, wall seconds (from a
    synchronize to a synchronize), host seconds inside the steps, and the
    last paged call."""
    from repro_torch.serving import scenarios as SC
    step, dispatch = E.step, E.kops.paged_attention
    seen = {"steps": 0, "host_s": 0.0}

    def guarded(*args, **kw):
        seen["steps"] += 1
        t = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return step(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            seen["host_s"] += time.perf_counter() - t

    def capture(*args, **kw):
        seen["paged_attention"] = (args, kw)
        return dispatch(*args, **kw)

    torch.cuda.synchronize()
    E.step, E.kops.paged_attention = guarded, capture
    pa.paged_attention.launches = 0
    t0 = time.perf_counter()
    try:
        run = SC.drive_events(cfg, state, sched, arrivals_fn, steps)
    finally:
        E.step, E.kops.paged_attention = step, dispatch
    torch.cuda.synchronize()
    return dict(run=run, steps=seen["steps"], launches=pa.paged_attention.launches,
                seconds=time.perf_counter() - t0, host_s=seen["host_s"],
                call=seen["paged_attention"])


def paged_against_plain(pa, where, call) -> float:
    """The paged kernel against its plain version on a phase's last step."""
    from repro_torch.kernels import ref
    args, kw = call
    err, _, ok = max_err(pa.paged_attention(*args, **kw), plain(ref, args, kw),
                         TOL["int8" if kw else "fp32"])
    if not ok:
        fail(f"{where}: kernel disagrees with its plain version on the last "
             f"step (max abs err {err})")
    return err


def failover_phase(E, pa, phase, dev) -> dict:
    """One failure-plane phase at FULL_WIDTH, run once: `drive_events`
    under the phase's schedule (`drive_on_card`). Fails unless every
    FailoverRun field equals the reference's (FAILOVER), no sequence is
    lost, the crash truncated tokens (an unwarned failure) or the drain
    moved pages (migration on), paged attention launched once a step, no
    host sync inside a step, and the kernel equals its plain version on
    the last step."""
    from repro_torch.core import events as EV
    extra, (kind, t, target), lead, expect = FAILOVER[phase]
    if "obs" in extra:
        extra = {**extra, "obs": E.obs_m.ObsConfig(**extra["obs"])}
    cfg = E.EngineConfig(**FULL_WIDTH, **extra)
    arrivals = torch.tensor(ARRIVALS, dtype=torch.int32, device=dev)
    warm = E.init(cfg, device=dev)
    for _ in range(2):
        warm, _ = E.step(cfg, warm, arrivals)
    del warm
    state = E.init(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    out = drive_on_card(E, pa, cfg, state,
                        EV.schedule(getattr(EV, kind)(t, target), reclaim_lead=lead),
                        lambda _: np.asarray(ARRIVALS), STEPS)
    got = out["run"]._asdict()
    if got != expect:
        fail(f"{phase}: FailoverRun {got} != the reference's {expect}")
    if got["lost_sequences"] or not (got["lost_tokens"] if kind == "ssd_fail"
                                     else got["migrated_pages"]):
        fail(f"{phase}: lost sequences, or nothing truncated / drained: {got}")
    if out["launches"] != out["steps"]:
        fail(f"{phase}: paged_attention launched {out['launches']} times in "
             f"{out['steps']} steps")
    err = paged_against_plain(pa, phase, out["call"])
    return dict(run=got, schedule=[kind, t, target], reclaim_lead=lead,
                steps=out["steps"], launches=out["launches"], kernel_max_abs_err=err,
                # host clock over the driven run, `drive_events`' surgery and its
                # read-back of each step's counts included; and the host's
                # time inside the steps alone
                ms_per_step=1e3 * out["seconds"] / out["steps"],
                step_host_ms=1e3 * out["host_s"] / out["steps"])


def failover_fig23_phase(E, pa, dev) -> dict:
    """fig. 23's serving runs on the card through the port's own
    `failover_scenario` and `drive_events`: the baseline table (FIG23)
    exactly, both spikes, one paged launch a step, no host sync inside a
    step, the kernel against its plain version on each run's last step."""
    from repro_torch.core import events as EV
    from repro_torch.serving import scenarios as SC

    def arrivals(t):
        a = np.zeros(4, np.int64)
        if t in (0, 2):
            a[0] = a[1] = 3
        return a

    out, launches = {}, {}
    for name, (migrate, obs, event, lead, expect) in FIG23.items():
        cfg, state = SC.failover_scenario(migrate=migrate, obs=obs, device=dev)
        sched = EV.schedule(*(() if event is None else
                              (getattr(EV, event[0])(*event[1:]),)), reclaim_lead=lead)
        res = drive_on_card(E, pa, cfg, state, sched, arrivals, FIG23_STEPS)
        r = res["run"]
        got = (r.completed, r.lost_sequences, r.lost_tokens, r.requeued, r.revoked,
               r.seq_steps, r.migrated_pages)
        if got != expect or not r.drained:
            fail(f"failover_fig23 {name}: {got} != the baseline's {expect}")
        if res["launches"] != res["steps"]:
            fail(f"failover_fig23 {name}: paged_attention launched "
                 f"{res['launches']} times in {res['steps']} steps")
        launches[name] = res["launches"]
        out[name] = dict(run=r._asdict(), steps=res["steps"], launches=res["launches"],
                         kernel_max_abs_err=paged_against_plain(
                             pa, f"failover_fig23 {name}", res["call"]),
                         ms_per_step=1e3 * res["seconds"] / res["steps"])
    base = out["baseline"]["run"]["seq_steps"]
    spikes = {n: out[n]["run"]["seq_steps"] - base for n in FIG23_SPIKES}
    if spikes != FIG23_SPIKES or not spikes["predicted"] < spikes["unpredicted"]:
        fail(f"failover_fig23: spikes {spikes} != {FIG23_SPIKES}")
    out["spikes"] = spikes
    out["launches"] = sum(launches.values())
    return out


def window_bytes(args) -> int:
    """Bytes one SHARDS window must move: the references (int64) and the
    mask (one byte) read once, the state (table int64 + int32 per row,
    histogram, clock, cold, total) read once and written once."""
    addrs, _, _, hist = args[:4]
    refs = args[6]
    n, k = addrs.shape
    state = n * (k * 12 + hist.shape[1] * 4 + 12)
    return refs.numel() * 9 + 2 * state


def window_row(call, by_phase, flush, floor_ms) -> dict:
    """The `kernels` entry of the SHARDS window kernel on the main path's
    last window (`trace_fp32`): equal to its plain version bit for bit,
    repeated bit for bit, its time spun and unspun beside `floor_ms`, and
    the plain loop's time once on the card as a yardstick (it launches
    some 30 kernels per reference)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import shards_window as sw
    args, kw = call
    got = sw.shards_window(*args, **kw)
    want = ref.shards_window(*args, **kw)
    again = sw.shards_window(*args, **kw)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    err = exact_err(got, want)
    repeat_equal = same_bits(got, again)
    if not (equal and repeat_equal):
        fail(f"shards_window: kernel differs from its plain version ({equal}) or "
             f"from itself ({repeat_equal}) on the main path's last window")
    ms = timed_ms(lambda: sw.shards_window(*args, **kw), 20, flush)
    ms_spun, spin_ms, host_ms, attempts = spun_ms(
        "shards_window", lambda: sw.shards_window(*args, **kw), 20, flush)
    plain_ms = timed_ms(lambda: ref.shards_window(*args, **kw), 1, flush)
    nbytes = window_bytes(args)
    t_bytes = 1e3 * nbytes / HBM_BPS
    refs, mask = args[6], args[7]
    return {
        "name": "shards_window", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/shards_window.cu",
        # not a TPU kernel: the reference's lax.scan of the SHARDS update
        "replaces": "src/repro/core/shards_mrc.py:115",
        "replaces_kind": "lax.scan (no Pallas kernel)",
        "launches": sum(by_phase.values()), "launches_by_phase": by_phase,
        "on_main_path": True,
        "shape": {"nodes": int(refs.shape[0]), "refs": int(refs.shape[1]),
                  "valid_refs": int(mask.sum()), "k": int(args[0].shape[1]),
                  "buckets": int(args[3].shape[1])},
        "max_abs_err": err, "gate": "bit for bit (all six state tensors)",
        "repeat_equal": repeat_equal,
        "ms": ms, "ms_spun": ms_spun, "spin_ms": spin_ms, "host_ms_max": host_ms,
        "spun_attempts": attempts, "plain_ms": plain_ms, "floor_ms": floor_ms,
        # a serial chain of warp reductions per sampled reference: bytes are
        # the only bound the table gives, and the kernel is far from it
        "bound_ms": t_bytes, "bound_by": "bytes", "bytes": nbytes,
        "of_bound": t_bytes / ms_spun,
        "of_bound_floor": max(t_bytes, floor_ms) / ms_spun,
        # no single PyTorch call computes a SHARDS scan
        "library_ms": None,
    }


def same_state(got, want, where: str) -> None:
    """Fails unless two engine states agree: integer and bool leaves bit
    for bit, int8 K/V codes within one step (a float32 product rounded on
    the other side of .5), float leaves within 1e-4 relative. The K/V
    planes' last page is scratch (masked writes land there), not state."""
    items = want.items() if isinstance(want, dict) else zip(want._fields, want)
    for name, b in items:
        a = got[name] if isinstance(got, dict) else getattr(got, name)
        if b is None:
            continue
        if hasattr(b, "_fields") or isinstance(b, dict):
            same_state(a, b, f"{where}.{name}")
            continue
        a = a.cpu()
        if name in ("k", "v"):
            a, b = a[:-1], b[:-1]
        if b.dtype == torch.int8 and name in ("k", "v"):
            ok = int((a.int() - b.int()).abs().max()) <= 1
        elif b.is_floating_point():
            ok = bool(torch.allclose(a, b, rtol=1e-4, atol=1e-5))
        else:
            ok = torch.equal(a, b)
        if not ok:
            fail(f"GPU engine {where}.{name} differs from the CPU plain path")


def gpu_vs_cpu_engine(E, dev, cfg, arrivals, steps, check_state=False,
                      pressured=()) -> dict:
    """`serving.engine.step` on the GPU against the same code on the CPU
    (the plain path) from the same state and activations: every stat each
    step (integer stats equal, float stats within 1e-4 relative, the int8
    read-back error within 2e-2), and with ``check_state`` the whole state.
    ``pressured`` replicas start memory-full with two 16-token sequences
    each. Returns the run's summed cross-shard stats."""
    gs, cs = E.init(cfg, device=dev), E.init(cfg, device="cpu")
    cs = cs._replace(wq=gs.wq.cpu(), wk=gs.wk.cpu(), wv=gs.wv.cpu(), wo=gs.wo.cpu())
    rows = list(pressured)
    if rows:
        def pressure(state):
            used, act = state.pool.used.clone(), state.pool.seq_active.clone()
            rem = state.remaining.clone()
            used[rows] = True
            act[rows, :2] = True
            rem[rows, :2] = 16
            return state._replace(pool=state.pool._replace(used=used, seq_active=act),
                                  remaining=rem)
        gs, cs = pressure(gs), pressure(cs)
    xg = torch.Generator(device="cpu").manual_seed(3)
    arr = torch.tensor(arrivals, dtype=torch.int32)
    totals = {"cross_redirected": 0.0, "cross_link_borrowed_bytes": 0.0}
    for i in range(steps):
        x = torch.randn((cfg.n_replicas, cfg.seq_slots + cfg.shadow_slots,
                         cfg.n_heads * cfg.head_dim), generator=xg) * 0.1
        gs, gst = E.step(cfg, gs, arr, x=x)
        cs, cst = E.step(cfg, cs, arr, x=x)
        for key in cst:
            a, b = gst[key].cpu(), cst[key]
            same = (torch.equal(a, b) if not b.is_floating_point()
                    else bool(torch.allclose(a, b, rtol=2e-2 if key == "quant_err_norm" else 1e-4,
                                             atol=1e-6)))
            if not same:
                fail(f"GPU engine step {i} stat {key} {a} != CPU plain path {b}")
        if check_state:
            same_state(gs, cs, f"step {i}")
        for key in totals:
            totals[key] += float(cst[key])
    return totals


# ------------------------------------------------------ the multi-rank paths
# The engine's sharded step (`engine.make_sharded_step`) and the sequence-
# sharded MLA decode (`attention.mla_decode_seq_sharded`) run as ranks of
# one process group, spawned processes on the one card. NCCL refuses two
# ranks on one GPU, so the group is gloo's, which stages CUDA tensors
# through the host: the ranks' times check their values, they are no
# figure for NCCL or for several cards. The port's collectives are
# all-reduces only, which both backends take for CUDA tensors.
RANK_BACKEND = "gloo"
RANK_TIMEOUT_S = 600
# phase -> (the single-process phase it repeats on ranks, ranks)
RANK_PHASES = {"sharded2_fp32_ranks": ("sharded2_fp32", 2),
               "trace_enclosure4_int8_metered_obs_ranks":
                   ("trace_enclosure4_int8_metered_obs", 4)}
# deepseek-v2 at full width cut to its first 2 layers (1 dense + 1 MoE):
# (arch, layers, batch, prompt, generated tokens, latent-cache positions,
# rank counts). The prompt fills positions 0-1023; the decode writes
# 1024-1055: rank 1's span over 2 ranks, rank 2's over 4 (rank 3's stays
# empty)
MLA_RANKS = ("deepseek-v2-236b", 2, 4, 1024, 32, 2048, (2, 4))
# the sequence-sharded decode against the one-process decode, per step and
# row (bf16 products and caches: a few roundings of 2^-8 through the
# combine, the up-projection and the head; the combine itself is fp32):
# layer 0's attention output, whose inputs are the same in both runs, and
# the logits of a row whose MoE layer picked the same experts, each within
# MLA_TOL of its largest value. A row whose router picked another expert
# (a near-tie moved by the attention's last bits: the scores' relative gap
# at the k-th pick within MLA_TOL) is reported with its logits' error
MLA_TOL = 2 ** -5
# the engine's stats and state across ranks against one process on the
# card, as `gpu_vs_cpu_engine` holds the GPU to the CPU: floats within 1e-4
# relative (the K/V products run at another row count, which may pick
# another cuBLAS kernel), the int8 read-back error within 2e-2
RANK_STATS_RTOL = {"quant_err_norm": 2e-2}


def engine_cfg(E, phase):
    """`PHASES[phase]`'s configuration at FULL_WIDTH and its counts."""
    extra, expect = PHASES[phase]
    if "obs" in extra:
        extra = {**extra, "obs": E.obs_m.ObsConfig(**extra["obs"])}
    return E.EngineConfig(**FULL_WIDTH, **extra), expect


def run_ranks(worker, world: int, payload) -> list:
    """``worker(rank, world, payload)`` in ``world`` spawned processes on
    the one card, each a rank of one RANK_BACKEND group (a FileStore in a
    temporary directory). Returns their results in rank order; a rank that
    fails fails the run, and every rank still running is killed."""
    import queue as queue_mod
    import tempfile
    import torch.multiprocessing as tmp_mp
    ctx = tmp_mp.get_context("spawn")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        results, inbox = ctx.Queue(), ctx.Queue()
        procs = [ctx.Process(target=rank_main, daemon=True,
                             args=(worker, r, world, str(Path(tmp) / "store"),
                                   inbox, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        for _ in procs:
            inbox.put(payload)
        try:
            for _ in procs:
                try:
                    rank, ok, res = results.get(timeout=RANK_TIMEOUT_S)
                except queue_mod.Empty:
                    fail(f"{worker.__name__}: a rank of {world} gave no result "
                         f"in {RANK_TIMEOUT_S} s")
                if not ok:
                    fail(f"{worker.__name__}: rank {rank} of {world} failed:\n{res}")
                out[rank] = res
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world)]


def rank_main(worker, rank, world, store, inbox, results) -> None:
    import datetime
    import traceback
    import torch.distributed as dist
    try:
        sys.path.insert(0, str(ROOT / "src"))
        torch.set_num_threads(1)   # the ranks share the host's cores
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(RANK_BACKEND, store=dist.FileStore(store, world),
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        try:
            res = worker(rank, world, inbox.get(timeout=RANK_TIMEOUT_S))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, res))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def probe_collectives(dev) -> dict:
    """Which collectives the group's backend takes for CUDA tensors."""
    import torch.distributed as dist
    world = dist.get_world_size()
    x = lambda dtype=torch.float32: torch.ones(4 * world, dtype=dtype, device=dev)
    tries = {
        "all_reduce_sum_float32": lambda: dist.all_reduce(x()),
        "all_reduce_max_float32": lambda: dist.all_reduce(x(), op=dist.ReduceOp.MAX),
        "all_reduce_sum_float64": lambda: dist.all_reduce(x(torch.float64)),
        "all_reduce_sum_int32": lambda: dist.all_reduce(x(torch.int32)),
        "broadcast": lambda: dist.broadcast(x(), 0),
        "all_gather": lambda: dist.all_gather([x() for _ in range(world)], x()),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * world * world, device=dev), x()),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), x()),
    }
    out = {}
    for name, call in tries.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = "accepted"
        except (RuntimeError, ValueError) as err:
            out[name] = f"refused: {str(err).splitlines()[0][:160]}"
        dist.barrier()
    return out


def to_numpy_tree(E, tree):
    return E._tree_map(lambda t: t.detach().cpu().numpy(), tree)


def engine_rank_worker(rank, world, phase) -> dict:
    """One rank of a RANK_PHASES phase: `PHASES[base]` at FULL_WIDTH
    through `make_sharded_step` for STEPS steps from the seeds of
    `engine_phase` (after a warm-up on a throwaway block), its block
    split from the full state (`split_state`). The counts of the kernels
    are zeroed just before the run and read just after."""
    import torch.distributed as dist
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import shards_window as sw
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import engine as E
    dev = torch.device("cuda", 0)
    cfg, _ = engine_cfg(E, RANK_PHASES[phase][0])
    step = E.make_sharded_step(cfg, make_serving_mesh(world))
    arrivals = torch.tensor(ARRIVALS, dtype=torch.int32, device=dev)
    probe = probe_collectives(dev) if phase == next(iter(RANK_PHASES)) else None
    warm = E.split_state(cfg, E.init(cfg, device=dev), rank)
    for _ in range(2):
        warm, _ = step(warm, arrivals)
    del warm
    state = E.split_state(cfg, E.init(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)), rank)
    gen = torch.Generator(device=dev).manual_seed(7)
    stats = []
    torch.cuda.synchronize()
    dist.barrier()
    pa.paged_attention.launches = 0
    sw.shards_window.launches = 0
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, st = step(state, arrivals, generator=gen)
        stats.append(st)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return dict(stats=[{k: v.cpu().numpy() for k, v in st.items()} for st in stats],
                block=to_numpy_tree(E, state), backend=dist.get_backend(),
                launches=dict(paged_attention=pa.paged_attention.launches,
                              shards_window=sw.shards_window.launches),
                ms_per_step=1e3 * seconds / STEPS, probe=probe)


def engine_ranks_phase(E, phase, dev) -> dict:
    """A RANK_PHASES phase: the single-process `step` at FULL_WIDTH for
    STEPS steps (`engine_phase`'s seeds, every step's stats kept), then
    the same steps on the phase's ranks (`engine_rank_worker`). Fails
    unless every rank's stats equal each other's bit for bit and the
    single process's each step (integer stats equal, floats within 1e-4
    relative, RANK_STATS_RTOL), the joined final state is the single
    process's (`same_state`), the harvesting counts are the reference's
    (PHASES), and every rank launched paged attention (and with
    trace_driven the SHARDS window) once a step."""
    base, world = RANK_PHASES[phase]
    cfg, expect = engine_cfg(E, base)
    arrivals = torch.tensor(ARRIVALS, dtype=torch.int32, device=dev)
    warm = E.init(cfg, device=dev)
    for _ in range(2):
        warm, _ = E.step(cfg, warm, arrivals)
    del warm
    state = E.init(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(7)
    single = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, st = E.step(cfg, state, arrivals, generator=gen)
        single.append(st)
    torch.cuda.synchronize()
    single_ms = 1e3 * (time.perf_counter() - t0) / STEPS
    single = [{k: v.cpu() for k, v in st.items()} for st in single]
    single_state = E._tree_map(lambda t: t.cpu(), state)
    del state
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_ranks(engine_rank_worker, world, phase)
    seconds = time.perf_counter() - t0
    worst = 0.0
    for r, res in enumerate(ranks):
        for i, (got, want) in enumerate(zip(res["stats"], single)):
            if sorted(got) != sorted(want):
                fail(f"{phase}: rank {r} step {i} stats keys {sorted(got)}")
            for key, w in want.items():
                g = torch.from_numpy(got[key])
                if not torch.equal(g, torch.from_numpy(ranks[0]["stats"][i][key])):
                    fail(f"{phase}: step {i} {key} differs between rank {r} and rank 0")
                if w.is_floating_point():
                    rtol = RANK_STATS_RTOL.get(key, 1e-4)
                    if not torch.allclose(g, w, rtol=rtol, atol=1e-6):
                        fail(f"{phase}: rank {r} step {i} {key} {g} != one process {w}")
                    worst = max(worst, float(((g - w).abs() / w.abs().clamp(min=1e-6)).max()))
                elif not torch.equal(g, w):
                    fail(f"{phase}: rank {r} step {i} {key} {g} != one process {w}")
    stats = ranks[0]["stats"]
    got = (int(sum(s["redirected"] for s in stats)), int(stats[-1]["offsite_pages"]),
           int(stats[-1]["log_commits"]), int(sum(s["cross_redirected"] for s in stats)))
    if got != expect:
        fail(f"{phase}: harvesting counts {got} != reference {expect}")
    joined = E.join_states(cfg, [E._tree_map(torch.from_numpy, r["block"]) for r in ranks])
    same_state(joined, single_state, f"{phase} final state (ranks against one process)")
    launches = {name: [r["launches"][name] for r in ranks]
                for name in ("paged_attention", "shards_window")}
    want_window = STEPS if cfg.trace_driven else 0
    if launches["paged_attention"] != [STEPS] * world or \
            launches["shards_window"] != [want_window] * world:
        fail(f"{phase}: launches on the ranks {launches}, want {STEPS} paged "
             f"and {want_window} SHARDS windows a rank")
    line = dict(base_phase=base, ranks=world, backend=ranks[0]["backend"],
                backend_note="gloo stages CUDA tensors through the host: a check of "
                             "values, no figure for NCCL or several cards",
                redirected=got[0], offsite_pages=got[1], log_commits=got[2],
                cross_redirected=got[3], expected=list(expect),
                stats_equal_across_ranks=True, stats_max_rel_err_float=worst,
                state_equal=True,
                launches={name: sum(v) for name, v in launches.items()},
                launches_per_rank=launches,
                ms_per_step_ranks=max(r["ms_per_step"] for r in ranks),
                ms_per_step_each_rank=[r["ms_per_step"] for r in ranks],
                ms_per_step_one_process=single_ms, seconds=seconds)
    if ranks[0]["probe"] is not None:
        line["collectives_cuda"] = ranks[0]["probe"]
    return line


def mla_cfg():
    from repro_torch import configs
    arch, layers = MLA_RANKS[:2]
    return dataclasses.replace(configs.get(arch), n_layers=layers)


def mla_decode_traced(cfg, params, cache, first, fed=None):
    """MLA_RANKS' decode steps from the token ``first`` [B]: greedy, or
    fed the tokens ``fed`` [gen, B] (each step's input). Captures, per
    step, the logits, layer 0's attention output and the MoE layer's
    router scores and picks. Returns (the input tokens [gen, B], those
    four stacked, ms per token)."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    from repro_torch.models import decode as D
    gen = MLA_RANKS[4]
    mla, router = A.mla_decode, ops.topk_router
    seen = {}

    def mla_traced(*args, **kw):
        y, c = mla(*args, **kw)
        seen.setdefault("attn0", y)
        return y, c

    def router_traced(scores, k, bias=None):
        w, idx = router(scores, k, bias=bias)
        seen["router"] = (scores, idx)
        return w, idx

    tok, steps = first, []
    A.mla_decode, ops.topk_router = mla_traced, router_traced
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for i in range(gen):
            tok = tok if fed is None else fed[i]
            seen.clear()
            logits, cache = D.decode_step(cfg, params, cache, tok)
            steps.append((tok, logits, seen["attn0"], *seen["router"]))
            tok = torch.argmax(logits, -1).to(torch.int32)
        torch.cuda.synchronize()
    finally:
        A.mla_decode, ops.topk_router = mla, router
    ms = 1e3 * (time.perf_counter() - t0) / gen
    out = [torch.stack(x).cpu() for x in zip(*steps)]
    return out[0], out[1].float(), out[2].float(), out[3], out[4], ms, cache


def mla_compare(got, want) -> dict:
    """A rank's decode (`mla_decode_traced`'s logits, attention, scores,
    picks) against the one process's, per step and row, under MLA_TOL."""
    logits, attn, scores, idx = got
    w_logits, w_attn, w_scores, w_idx = want
    k = idx.shape[-1]
    rel = lambda a, b: ((a - b).abs().flatten(2).amax(-1)
                        / b.abs().flatten(2).amax(-1).clamp(min=1e-30))
    attn_err = rel(attn.reshape(*attn.shape[:2], -1), w_attn.reshape(*attn.shape[:2], -1))
    logit_err = rel(logits[..., None, :], w_logits[..., None, :])      # [gen, B]
    same = (idx.sort(-1).values == w_idx.sort(-1).values).all(-1)      # [gen, B]
    top = w_scores.topk(k + 1, dim=-1).values
    gap = (top[..., k - 1] - top[..., k]) / top[..., k - 1]            # one process's
    moved = [dict(step=int(i), row=int(b), logits_rel_err=float(logit_err[i, b]),
                  score_gap_rel=float(gap[i, b]),
                  experts=sorted(map(int, idx[i, b])), one_process=sorted(map(int, w_idx[i, b])))
             for i, b in zip(*torch.nonzero(~same, as_tuple=True))]
    flips = [dict(step=int(i), row=int(b), token=int(w_logits[i, b].argmax()),
                  rank_token=int(logits[i, b].argmax()), router_same=bool(same[i, b]),
                  gap_rel=float((w_logits[i, b].max() - w_logits[i, b, logits[i, b].argmax()])
                                / w_logits[i, b].abs().max()))
             for i, b in zip(*torch.nonzero(logits.argmax(-1) != w_logits.argmax(-1),
                                            as_tuple=True))]
    bad = []
    if float(attn_err.max()) > MLA_TOL:
        bad.append(f"layer 0's attention off by {float(attn_err.max())} of its largest")
    if same.any() and float(logit_err[same].max()) > MLA_TOL:
        bad.append(f"logits of rows with the same experts off by "
                   f"{float(logit_err[same].max())} of their largest")
    bad += [f"router moved off a non-tie: {m}" for m in moved if m["score_gap_rel"] > MLA_TOL]
    bad += [f"token flip off a near-tie: {f}" for f in flips
            if f["router_same"] and f["gap_rel"] > MLA_TOL]
    return dict(attn_rel_err=float(attn_err.max()),
                attn_rel_err_each_step=attn_err.amax(-1).tolist(),
                logits_rel_err_same_experts=float(logit_err[same].max()) if same.any() else None,
                logits_rel_err=float(logit_err.max()),
                rows_router_moved=moved, token_flips=flips, failures=bad)


def mla_rank_worker(rank, world, payload) -> dict:
    """One rank of `mla_seq_sharded_v2`: the model from `run_model`'s seed,
    the prefill (every rank runs it whole), this rank's span of the latent
    cache, then the decode under a (1, world) ("data", "model") serve mesh
    fed the one-process run's tokens (`mla_decode_traced`), held against
    that run's (`mla_compare`). The router's count is zeroed just before
    the prefill and read after the decode."""
    import torch.distributed as dist
    from repro_torch.kernels import moe_router as mr
    from repro_torch.launch import runtime, serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    tokens, want = payload
    _, _, batch, prompt, gen, cache_len, _ = MLA_RANKS
    dev = torch.device("cuda", 0)
    cfg = mla_cfg()
    params = T.init_params(cfg, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
    inputs = serve.draw_inputs(cfg, batch, prompt, 0, dev)
    mesh = make_mesh((1, world), ("data", "model"))
    torch.cuda.synchronize()
    dist.barrier()
    mr.topk_router.launches = 0
    logits, cache = D.prefill(cfg, params, max_len=cache_len, **inputs)
    first = torch.argmax(logits, -1).to(torch.int32)
    span = cache_len // world
    local = {k: v[:, :, rank * span:(rank + 1) * span].clone()
             if k in ("c_kv", "k_rope") else v for k, v in cache.items()}
    del cache, logits
    torch.cuda.empty_cache()
    fed = torch.from_numpy(tokens).to(dev)
    runtime.set_serve_mesh(mesh)
    try:
        _, *got, ms, local = mla_decode_traced(cfg, params, local, first, fed)
    finally:
        runtime.set_serve_mesh(None)
    return dict(**mla_compare(got, [torch.from_numpy(w) for w in want]),
                first_token_equal=bool((first.cpu().numpy() == tokens[0]).all()),
                cache_span=[rank * span, (rank + 1) * span],
                length=int(local["length"]), launches=mr.topk_router.launches,
                ms_per_token=ms, backend=dist.get_backend(),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def mla_ranks_phase(dev) -> dict:
    """`mla_seq_sharded_v2`: deepseek-v2 (MLA_RANKS) prefilled and decoded
    greedily in this process (`mla_decode_traced`), then on 2 and on 4
    ranks with the latent cache split by sequence, fed the same tokens
    (`mla_rank_worker`). Fails unless every rank passes `mla_compare`'s
    gates (MLA_TOL), each rank's first token and cache length are the one
    process's, and every rank launched the router once per MoE layer in
    the prefill and in each decode step. The phase's line is printed
    before a failure."""
    from repro_torch.launch import serve
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    arch, layers, batch, prompt, gen, cache_len, worlds = MLA_RANKS
    cfg = mla_cfg()
    params = T.init_params(cfg, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
    inputs = serve.draw_inputs(cfg, batch, prompt, 0, dev)
    logits, cache = D.prefill(cfg, params, max_len=cache_len, **inputs)
    first = torch.argmax(logits, -1).to(torch.int32)
    tokens, *want, one_ms, _ = mla_decode_traced(cfg, params, cache, first)
    payload = (tokens.numpy(), [w.numpy() for w in want])
    del params, cache, logits
    torch.cuda.empty_cache()
    n_moe = cfg.n_layers - cfg.moe.first_k_dense
    line = dict(arch=arch, layers=layers, kinds=cfg.layer_kinds(), batch=batch,
                prompt=prompt, gen=gen, cache_positions=cache_len,
                d_model=cfg.d_model, heads=cfg.n_heads, dtype=cfg.dtype, tol=MLA_TOL,
                backend_note="gloo stages CUDA tensors through the host: a check of "
                             "values, no figure for NCCL or several cards",
                ms_per_token_one_process=one_ms, ranks={})
    bad = []
    for world in worlds:
        t0 = time.perf_counter()
        res = run_ranks(mla_rank_worker, world, payload)
        seconds = time.perf_counter() - t0
        for r, out in enumerate(res):
            bad += [f"rank {r} of {world}: {b}" for b in out["failures"]]
            if not out["first_token_equal"] or out["length"] != prompt + gen:
                bad.append(f"rank {r} of {world}: prefill token or cache length "
                           f"{out['length']} off the one-process run")
            if out["launches"] != n_moe * (1 + gen):
                bad.append(f"rank {r} of {world} launched the router {out['launches']} "
                           f"times, want {n_moe * (1 + gen)}")
        line["ranks"][str(world)] = dict(
            backend=res[0]["backend"], seconds=seconds,
            ms_per_token=max(o["ms_per_token"] for o in res),
            ms_per_token_each_rank=[o["ms_per_token"] for o in res],
            **{key: max(o[key] for o in res)
               for key in ("attn_rel_err", "logits_rel_err")},
            logits_rel_err_same_experts=max(
                (o["logits_rel_err_same_experts"] for o in res
                 if o["logits_rel_err_same_experts"] is not None), default=None),
            attn_rel_err_each_step=res[0]["attn_rel_err_each_step"],
            rows_router_moved=[dict(m, rank=r) for r, o in enumerate(res)
                               for m in o["rows_router_moved"]],
            token_flips=[dict(f, rank=r) for r, o in enumerate(res) for f in o["token_flips"]],
            cache_spans=[o["cache_span"] for o in res],
            launches_topk_router=sum(o["launches"] for o in res),
            peak_gb_each_rank=[o["peak_gb"] for o in res])
    line["launches_topk_router"] = sum(v["launches_topk_router"]
                                       for v in line["ranks"].values())
    if bad:
        print(json.dumps({"mla_seq_sharded_v2": line}), flush=True)
        fail("mla_seq_sharded_v2: " + "; ".join(bad))
    return line


# ------------------------------------------------------- the mesh trainer
# `training.train_step` on DTensor state placed by `launch.sharding`
# (`state_specs`, `batch_specs`, `place`), each rank a spawned process of
# one gloo group on the one card (`run_ranks`). phase -> (arch, layers (None:
# the smoke config), batch, seq, microbatches, [(mesh, fsdp)]).
# `train_ranks_h2o`: h2o-danube-1.8b at full width, 4 of its 24 layers,
# bf16 with remat, batch 4 x 4096 in 2 microbatches, on (2, 1) with FSDP
# and on (2, 2) with FSDP and tensor parallelism. `train_ranks_moe`:
# deepseek-v2's smoke config (fp32) with its experts over "model" on 2
# ranks, batch 2 x 128 (full-width v2's experts with AdamW, ~90 GB a MoE
# layer, cannot fit two ranks on one 80 GB card)
TRAIN_RANKS = {
    "train_ranks_h2o": ("h2o-danube-1.8b", 4, 4, 4096, 2, [((2, 1), True), ((2, 2), True)]),
    "train_ranks_moe": ("deepseek-v2-236b", None, 2, 128, 1, [((1, 2), False)]),
}
# the dry run's predicted peak (`launch.dryrun.run_step`'s ``peak_bytes``,
# rank 0's) against the card's `torch.cuda.max_memory_allocated` over the
# same step: within DRYRUN_MEMORY_TOL of the measured peak
DRYRUN_MEMORY_TOL = 0.15
# one train_4k cell on the 16 x 16 fake mesh at its first probe depth
# (`launch.specs.probe_variants`, one microbatch), traced with fake CUDA
# tensors and with fake CPU tensors: the two records equal
DRYRUN_DEVICE_CELL = ("whisper-tiny", "train_4k")


class GlooCollectives(TorchDispatchMode):
    """DTensor's functional collectives (``torch.ops._c10d_functional``)
    on CUDA tensors hang in a gloo group (on an H100: a Shard-to-Replicate
    redistribution of a [4, 4] tensor on 2 ranks gave no result in 150
    s), while the c10d calls themselves run (`probe_collectives`). Around
    the ranks' steps on the one card this dispatch mode
    runs each functional collective through the c10d call
    (`gloo_collective`), and `wait_tensor` returns its tensor: the same
    values, each collective finished where it is issued."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        name = func.__name__.split(".")[0]
        if func.namespace != "_c10d_functional" or name not in GLOO_COLLECTIVES:
            return func(*args, **(kwargs or {}))
        return gloo_collective(name, args)


GLOO_COLLECTIVES = ("wait_tensor", "all_gather_into_tensor", "reduce_scatter_tensor",
                    "all_reduce", "all_to_all_single")


def gloo_collective(name, args):
    """One functional collective through the c10d API (`GlooCollectives`)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    ops = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.AVG, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}
    if name == "wait_tensor":
        return args[0]
    x = args[0].contiguous()
    if name == "all_gather_into_tensor":
        g, pg = args[1], _resolve_process_group(args[2])
        out = x.new_empty((x.shape[0] * g, *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=pg)
        return out
    if name == "reduce_scatter_tensor":
        op, g, pg = ops[args[1].lower()], args[2], _resolve_process_group(args[3])
        out = x.new_empty((x.shape[0] // g, *x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, op=op, group=pg)
        return out
    if name == "all_reduce":
        op, pg = ops[args[1].lower()], _resolve_process_group(args[2])
        out = x.clone()
        dist.all_reduce(out, op=op, group=pg)
        return out
    if name == "all_to_all_single":
        out_splits, in_splits, pg = args[1], args[2], _resolve_process_group(args[3])
        g, me = pg.size(), dist.get_rank(pg)
        in_splits = list(in_splits) if in_splits else [x.shape[0] // g] * g
        out_splits = list(out_splits) if out_splits else [x.shape[0] // g] * g
        splits = torch.tensor(in_splits, dtype=torch.int64, device=x.device)
        every = splits.new_empty((g * g,))
        dist.all_gather_into_tensor(every, splits, group=pg)
        every = every.reshape(g, g).tolist()          # every[r]: rank r's in_splits
        rows = max(sum(r) for r in every)
        pad = x.new_zeros((rows, *x.shape[1:]))
        pad[:x.shape[0]] = x
        gathered = x.new_empty((g * rows, *x.shape[1:]))
        dist.all_gather_into_tensor(gathered, pad, group=pg)
        parts = [gathered[r * rows + sum(every[r][:me]):][:every[r][me]] for r in range(g)]
        assert [p.shape[0] for p in parts] == out_splits
        return torch.cat(parts)
    raise AssertionError(name)


def train_ranks_cfg(phase):
    from repro_torch import configs
    arch, layers, batch, seq, n_micro, _ = TRAIN_RANKS[phase]
    cfg = (configs.smoke(arch) if layers is None else dataclasses.replace(
        configs.get(arch), name=f"{arch}-{layers}-layers", n_layers=layers))
    return cfg, batch, seq, n_micro


def train_rank_worker(rank, world, payload) -> dict:
    """One rank of a TRAIN_RANKS phase on one mesh: the seeded weights and
    batch placed by the specs, one `train_step` at TRAIN_VS_CPU_LR with the
    kernels' counts zeroed just before it and the card's peak memory
    counted over it; then rank 0 runs the same step on the same batch in
    one process and holds the whole new state against it (`rel_diffs`,
    `update_close`)."""
    from repro_torch.launch.mesh import make_mesh
    phase, shape, fsdp, seed = payload
    cfg, batch, seq, n_micro = train_ranks_cfg(phase)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def progress(stage):   # on stderr: where a slow or stuck rank is
        print(f"[{phase} {shape} rank {rank}] {stage} "
              f"{time.perf_counter() - t_start:.1f} s", file=sys.stderr, flush=True)

    mesh = make_mesh(shape, ("data", "model"))
    with GlooCollectives():
        return placed_step(rank, phase, shape, fsdp, seed, cfg, batch, seq, n_micro, dev,
                           mesh, progress)


def placed_step(rank, phase, shape, fsdp, seed, cfg, batch, seq, n_micro, dev, mesh,
                progress) -> dict:
    """`train_rank_worker`'s step and checks, under `GlooCollectives`."""
    import torch.distributed as dist
    from repro_torch.data import pipeline
    from repro_torch.launch import sharding as SH
    from repro_torch.models import transformer as T
    from repro_torch.training import train_step as TS
    from repro_torch.training import tree as tr

    def fresh():
        params = T.init_params(cfg, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(seed))
        return TS.init_state(cfg, params), pipeline.batch_for_step(cfg, 0, batch, seq, seed,
                                                                    device=dev)

    state, b = fresh()
    placed = SH.place(state, SH.state_specs(cfg, state, mesh, fsdp), mesh)
    pb = SH.place(b, SH.batch_specs(cfg, b, mesh), mesh)
    del state, b
    torch.cuda.empty_cache()
    progress("placed")
    kernels = train_kernels()
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    new, m = TS.train_step(cfg, placed, pb, n_micro=n_micro, lr=TRAIN_VS_CPU_LR)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    progress("stepped")
    launches = {name: k.launches for name, k in kernels.items()}
    sizes = [(x.to_local().numel(), x.numel()) for x in tr.leaves(placed.params)]
    del placed, pb
    # every rank joins each leaf's gather and only rank 0 keeps the whole
    # leaf: a whole state on each of 4 ranks does not fit beside the
    # ranks' own on the one card
    flat, treedef = tr.flatten(new)
    del new
    kept = []
    while flat:
        leaf = flat.pop(0).full_tensor()
        kept.append(leaf if rank == 0 else None)
        del leaf
    whole = tr.unflatten(treedef, kept) if rank == 0 else None
    del kept
    torch.cuda.empty_cache()
    progress("gathered")
    out = dict(rank=rank, shape=list(shape), fsdp=fsdp, backend=dist.get_backend(),
               peak_bytes=peak, seconds=seconds, launches=launches,
               params_local=sum(s[0] for s in sizes), params_whole=sum(s[1] for s in sizes),
               largest_leaf_local_over_whole=[(lo, wh) for lo, wh in sizes
                                              if wh == max(s[1] for s in sizes)][0],
               loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
    if rank != 0:
        return out
    torch.cuda.empty_cache()
    state, b = fresh()
    ref, ref_m = TS.train_step(cfg, state, b, n_micro=n_micro, lr=TRAIN_VS_CPU_LR)
    progress("one process")
    form = "bf16" if cfg.param_dtype == torch.bfloat16 else "fp32"
    tol = TRAIN_TOL[form]
    errs = rel_diffs(m, whole, ref_m, ref)
    excess, upd_err = -np.inf, 0.0
    for leaf in zip(*(tr.leaves(t) for t in (
            whole.params, state.params, ref.params, state.params, whole.opt.m,
            whole.opt.v, ref.opt.m, ref.opt.v))):
        flat = [x.reshape(-1) for x in leaf]
        for lo in range(0, flat[0].numel(), 1 << 25):
            e, d = update_close(*(x[lo:lo + (1 << 25)] for x in flat), step=1,
                                lr=TRAIN_VS_CPU_LR, p_rel=tol["p_rel"])
            excess, upd_err = max(excess, e), max(upd_err, d)
    bad = [f"{key} differs by {errs[key]} (tol {tol[key]})"
           for key in ("loss", "grad_norm", "m", "v") if not errs[key] <= tol[key]]
    if excess > 0:
        bad.append(f"a parameter's update differs by {excess} past its bound")
    if int(whole.opt.step) != int(ref.opt.step):
        bad.append(f"step {int(whole.opt.step)} != {int(ref.opt.step)}")
    return dict(out, rel_err=errs, max_abs_update_err=upd_err, update_err_over_bound=excess,
                tol=tol, loss_one_process=float(ref_m["loss"]), failures=bad)


def train_ranks_phase(phase) -> dict:
    """A TRAIN_RANKS phase: each of its meshes on its ranks
    (`train_rank_worker`). Fails unless rank 0's whole new state passes
    the gates against one process, every rank launched exactly
    `train_expected`'s kernels in the step, and every rank's parameters
    are split (rank 0's shard of the largest leaf smaller than the whole,
    and at most 3/4 of all the elements)."""
    arch, layers, batch, seq, n_micro, meshes = TRAIN_RANKS[phase]
    cfg, *_ = train_ranks_cfg(phase)
    expect = train_expected(cfg, n_micro)
    line = dict(arch=arch, layers=cfg.n_layers, d_model=cfg.d_model,
                heads=[cfg.n_heads, cfg.n_kv_heads], dtype=cfg.dtype, remat=cfg.remat,
                batch=batch, seq=seq, n_micro=n_micro, lr=TRAIN_VS_CPU_LR,
                expected_per_rank=expect,
                backend_note="gloo stages CUDA tensors through the host: a check of "
                             "values, no figure for NCCL or several cards",
                meshes={})
    bad = []
    for shape, fsdp in meshes:
        world = shape[0] * shape[1]
        t0 = time.perf_counter()
        res = run_ranks(train_rank_worker, world, (phase, shape, fsdp, 43))
        label = f"{shape[0]}x{shape[1]}" + ("_fsdp" if fsdp else "")
        for r in res:
            if r["launches"] != expect:
                bad.append(f"{label} rank {r['rank']}: launches {r['launches']} != {expect}")
            lo, wh = r["largest_leaf_local_over_whole"]
            if not (lo < wh and r["params_local"] <= 0.75 * r["params_whole"]):
                bad.append(f"{label} rank {r['rank']}: parameters not split "
                           f"({r['params_local']} of {r['params_whole']})")
        bad += [f"{label}: {b}" for b in res[0]["failures"]]
        line["meshes"][label] = dict(
            world=world, seconds=time.perf_counter() - t0,
            step_s_each_rank=[r["seconds"] for r in res],
            peak_gb_each_rank=[r["peak_bytes"] / 1e9 for r in res],
            peak_bytes_each_rank=[r["peak_bytes"] for r in res],
            launches_each_rank=[r["launches"] for r in res],
            params_local_over_whole=[r["params_local"] / r["params_whole"] for r in res],
            **{k: res[0][k] for k in ("loss", "loss_one_process", "grad_norm", "rel_err",
                                      "max_abs_update_err", "update_err_over_bound",
                                      "tol", "backend")})
    line["launches"] = {name: sum(sum(r[name] for r in m["launches_each_rank"])
                                  for m in line["meshes"].values())
                        for name in expect}
    if bad:
        print(json.dumps({phase: line}), flush=True)
        fail(f"{phase}: " + "; ".join(bad))
    return line


def dryrun_memory_phase(dev, train_line, ranks_h2o) -> dict:
    """The dry run's predicted peak for the steps the card just ran against
    their measured peaks (within DRYRUN_MEMORY_TOL): `train_h2o_danube`'s
    step (the whole model, its batch, mesh (1, 1); measured: its
    `train_split`'s largest stage peak) and each mesh of `train_ranks_h2o`
    (rank 0's prediction against every rank's peak). Then the
    DRYRUN_DEVICE_CELL at its probe depth on the 16 x 16 mesh, traced
    with fake CUDA and fake CPU tensors: the records must be equal. The
    dry run's HBM constant must be this card's total memory."""
    from repro_torch import configs
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import specs as SP
    total = torch.cuda.get_device_properties(dev).total_memory
    line = dict(total_memory=total, hbm_bytes_constant=DR.H100_HBM_BYTES,
                tol=DRYRUN_MEMORY_TOL, steps={})
    bad = []
    if total != DR.H100_HBM_BYTES:
        bad.append(f"launch.dryrun.H100_HBM_BYTES {DR.H100_HBM_BYTES} != this card's "
                   f"{total}")
    arch, batch, seq, n_micro, _ = TRAIN
    cases = [("train_h2o_danube", configs.get(arch), batch, seq, n_micro, (1, 1), False,
              [1e9 * max(train_line["split"]["peak_mem_gb"].values())])]
    rcfg, rbatch, rseq, rmicro = train_ranks_cfg("train_ranks_h2o")
    for (shape, fsdp), (label, m) in zip(TRAIN_RANKS["train_ranks_h2o"][5],
                                         ranks_h2o["meshes"].items()):
        cases.append((f"train_ranks_h2o_{label}", rcfg, rbatch, rseq, rmicro, shape, fsdp,
                      m["peak_bytes_each_rank"]))
    for name, cfg, b, s, nm, shape, fsdp, measured in cases:
        t0 = time.perf_counter()
        rec = DR.run_step(cfg, SP.Shape(name, s, b, "train"), mesh_shape=shape, fsdp=fsdp,
                          n_micro=nm, device_type="cuda", replication=False)
        pred = rec["memory"]["peak_bytes"]
        rel = [(pred - x) / x for x in measured]
        line["steps"][name] = dict(mesh=list(shape), fsdp=fsdp, batch=b, seq=s, n_micro=nm,
                                   predicted_peak_bytes=pred, measured_peak_bytes=measured,
                                   rel_err=rel, memory=rec["memory"],
                                   trace_s=time.perf_counter() - t0)
        if max(abs(r) for r in rel) > DRYRUN_MEMORY_TOL:
            bad.append(f"{name}: predicted peak {pred} vs measured {measured} "
                       f"(rel {rel}, tol {DRYRUN_MEMORY_TOL})")
    arch, shape_name = DRYRUN_DEVICE_CELL
    variant, _ = SP.probe_variants(configs.get(arch), SP.SHAPES[shape_name].kind)[0]
    recs = {}
    for device_type in ("cuda", "cpu"):
        t0 = time.perf_counter()
        rec = DR.run_cell(arch, shape_name, False, cfg_override=variant, n_micro_override=1,
                          quiet=True, device_type=device_type, replication=False)
        recs[device_type] = {k: v for k, v in rec.items()
                             if k not in ("trace_s", "trace_unsharded_s", "device_type")}
        line[f"cell_{device_type}_s"] = time.perf_counter() - t0
    line["cell"] = dict(arch=arch, shape=shape_name, layers=variant.n_layers,
                        equal=recs["cuda"] == recs["cpu"],
                        memory=recs["cuda"]["memory"], flops=recs["cuda"]["flops"],
                        collectives=recs["cuda"]["collectives"]["counts"])
    if recs["cuda"] != recs["cpu"]:
        bad.append(f"{arch} {shape_name}: the fake-CUDA record differs from the fake-CPU "
                   f"one: {recs}")
    if bad:
        print(json.dumps({"dryrun_memory": line}), flush=True)
        fail("dryrun_memory: " + "; ".join(bad))
    return line


# ------------------------------------------------------ the JBOF simulator
def sim_loop(S, prepared):
    """`sim.run_prepared` (the window loop) on the card with no host sync
    allowed (the sync debug mode raises on one). Returns (trajectory,
    seconds), from a synchronize to a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        traj = S.run_prepared(prepared)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return traj, time.perf_counter() - t0


def sim_kernels_per_window(S, plat, wls, arr, cfg, dev, windows=20) -> dict:
    """Device kernels per window on the first ``windows`` windows, from
    `torch.profiler`: each window inside a range named for its kind
    (`sim_mgmt_window` on management windows, `sim_window` on the others),
    every kernel counted in the range whose span on the device timeline
    holds it; the fabric level and the loop's own work fall in `other`.
    "not measured" where the profiler records no device activity."""
    import bisect
    step = S._window_step

    def labelled(run, state, a, t, i, *rest):
        kind = "sim_mgmt_window" if i % plat.mgmt_interval == 0 else "sim_window"
        with torch.profiler.record_function(kind):
            return step(run, state, a, t, i, *rest)

    cfg = dataclasses.replace(cfg, traces=None if cfg.traces is None
                              else cfg.traces[:windows])
    prepared = S.prepare(plat, wls, arr[:windows], cfg, device=dev)
    S._window_step = labelled
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            S.run_prepared(prepared)
            torch.cuda.synchronize()
    finally:
        S._window_step = step
    labels = ("sim_mgmt_window", "sim_window")
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in device if e.name in labels)
    starts = [a for a, _, _ in spans]
    counts = {"sim_mgmt_window": 0, "sim_window": 0, "other": 0}
    for e in device:
        if e.name in labels:
            continue
        owner = "other"
        j = bisect.bisect_right(starts, e.time_range.start) - 1
        if j >= 0 and e.time_range.end <= spans[j][1]:
            owner = spans[j][2]
        counts[owner] += 1
    n_mgmt = sum(1 for i in range(windows) if i % plat.mgmt_interval == 0)
    if not spans or not sum(counts.values()):
        return {"windows": windows, "per_mgmt_window": "not measured",
                "per_window": "not measured"}
    return {"windows": windows,
            "per_mgmt_window": counts["sim_mgmt_window"] / n_mgmt,
            "per_window": counts["sim_window"] / (windows - n_mgmt),
            "other_per_window": counts["other"] / windows,
            "per_window_all": sum(counts.values()) / windows}


def sim_close(got, want, where, *, arr, warmup, qd, cmd_count, window_s=1e-3,
              fields=None) -> float:
    """Fails unless two simulator results agree: each float field within
    SIM_TOL relative (a floor of SIM_TOL times its largest value), host_util
    within SIM_HOST_TOL, latency_s within SIM_TOL plus qd x window_s for
    each measured window without arrivals at an SSD over its command count
    (its backlog is then a rounding residue, whose latency is rounding
    noise on either side: tests/test_torch_sim.py). ``want`` may be a
    dict of pins. Returns the largest relative error of the fields."""
    k = (np.asarray(arr)[warmup:].sum(axis=-1) == 0).sum(axis=0)
    worst = 0.0
    names = fields or [f for f in want._fields
                       if getattr(want, f) is not None and f not in ("rings", "obs")]
    for name in names:
        w = np.asarray(want[name] if isinstance(want, dict) else
                       getattr(want, name).cpu(), np.float64)
        g = getattr(got, name).cpu().numpy().astype(np.float64)
        diff = np.abs(g - w)
        scale = float(np.max(np.abs(w))) if w.size else 0.0
        if name == "host_util":
            bound = SIM_HOST_TOL * np.abs(w)
        else:
            bound = SIM_TOL * np.maximum(np.abs(w), scale)
        if name == "latency_s":
            bound = SIM_TOL * np.abs(w) + qd * window_s * k / np.maximum(cmd_count, 1.0)
        if not (diff <= bound + 1e-30).all():
            fail(f"{where}: {name} {g} != {w}")
        worst = max(worst, float(np.max(diff / np.maximum(np.abs(w), 1e-30))))
    return worst


def sim_same_table(got, want, where) -> None:
    """The descriptor tables' integer and bool leaves equal bit for bit."""
    for name in ("valid", "rtype", "borrower_id", "info_a", "info_b"):
        if not torch.equal(getattr(got, name).cpu(), getattr(want, name).cpu()):
            fail(f"{where}: descriptor table {name} differs")


def sim_events8_inputs(W) -> tuple[list, np.ndarray]:
    """fig. 23's simulator inputs (SIM_EVENTS8) from a workloads module (the
    port's, or the reference's in the tests)."""
    c = SIM_EVENTS8
    n, windows = c["nodes"], c["windows"]
    wls = ([W.micro(read=False, io_kb=4, qd=4, random_access=True)] * (n // 2)
           + [W.micro(read=True, io_kb=4, qd=4, random_access=True)] * (n // 2))
    arr = np.zeros((windows, n, 2), np.float32)
    arr[:, : n // 2, 1] = c["busy_bps"] * 1e-3
    for lender, t0 in ((n // 2, 50), (n // 2 + 1, 70)):
        arr[t0 - 12:t0, lender, 0] = (
            np.linspace(0.0, c["ramp_bps"], 12, dtype=np.float32) * 1e-3)
    return wls, arr


def sim_events8_gates(res, evaluate) -> tuple:
    """fig. 23's simulator gates as benchmarks/fig23_failover.py reads them
    off a result: the reclaiming lenders' PROCESSOR withdraws, the reclaim
    predictor's (precision, recall, mean lead) over their proc-util rings
    (``evaluate``: either package's `telemetry.reclaim.evaluate`), and the
    revoked-grant ring's sum."""
    n = SIM_EVENTS8["nodes"]
    withdraws = sorted({
        (r["t"], r["lender"]) for r in res.obs["events"]
        if r["event"] == "withdraw" and r["rtype"] == "PROCESSOR"
        and r["lender"] in (n // 2, n // 2 + 1)})
    util = np.asarray(res.obs["metrics"]["proc_util"])
    score = evaluate(util[:, n // 2:], [(t, l - n // 2) for t, l in withdraws])
    ring = res.rings["revoked_grants"]
    ring = ring.cpu().numpy() if isinstance(ring, torch.Tensor) else np.asarray(ring)
    return withdraws, tuple(score), float(ring.astype(np.float64).sum())


def fleet_inputs(W, n) -> tuple[list, np.ndarray, int]:
    """fig. 22's fleet of ``n`` SSDs (SIM_FLEET): enclosures of 16, the
    first half of them random 4 KB writers, the rest trickle readers.
    Returns (workloads, arrivals [windows, n, 2], busy SSDs)."""
    c = SIM_FLEET
    e = n // c["per_enclosure"]
    n_busy = (e // 2) * c["per_enclosure"]
    wls = ([W.micro(read=False, io_kb=4, qd=4, random_access=True)] * n_busy
           + [W.micro(read=True, io_kb=128, qd=1)] * (n - n_busy))
    arr = np.zeros((c["windows"], n, 2), np.float32)
    arr[:, :n_busy, 1] = c["busy_bps"] * 1e-3
    arr[:, n_busy:, 0] = c["idle_bps"] * 1e-3
    return wls, arr, n_busy


def sim_events8_obs_phase(dev) -> dict:
    """fig. 23's simulator run on the card, once: the reference's gates
    (SIM_EVENTS8), the descriptor tables, revoked-grant ring and decoded
    events equal to the port's CPU path, per-SSD metrics within SIM_TOL of
    it, no host sync in the window loop; ms and kernels per window."""
    from repro_torch.core import events as EV
    from repro_torch.jbof import platforms as P, sim as S, workloads as W
    from repro_torch.obs import metrics as obs_m
    from repro_torch.telemetry import reclaim as RC
    c = SIM_EVENTS8
    wls, arr = sim_events8_inputs(W)
    plat = P.xbof()
    cfg = S.SimConfig(events=EV.schedule(*(getattr(EV, k)(*a) for k, *a in c["events"])),
                      obs=obs_m.ObsConfig(enabled=True, ring_depth=c["windows"]))
    traj, sec = sim_loop(S, S.prepare(plat, wls, arr, cfg, device=dev))
    res = S.summarize(plat, cfg, traj)
    gates = sim_events8_gates(res, RC.evaluate)
    if gates != (c["withdraws"], c["score"], c["revoked"]):
        fail(f"sim_events8_obs: withdraws, score, revoked {gates} != the "
             f"reference's {(c['withdraws'], c['score'], c['revoked'])}")
    cpu_traj = S.run_prepared(S.prepare(plat, wls, arr, cfg, device="cpu"))
    cpu = S.summarize(plat, cfg, cpu_traj)
    sim_same_table(traj.state.table, cpu_traj.state.table, "sim_events8_obs")
    if not torch.equal(res.rings["revoked_grants"].cpu(), cpu.rings["revoked_grants"]):
        fail("sim_events8_obs: revoked_grants differs from the CPU path")
    ev_cols = ("t", "event", "rtype", "level", "lender", "borrower", "lane")
    if [tuple(r[k] for k in ev_cols) for r in res.obs["events"]] != \
            [tuple(r[k] for k in ev_cols) for r in cpu.obs["events"]]:
        fail("sim_events8_obs: the decoded events differ from the CPU path")
    err = sim_close(res, cpu, "sim_events8_obs vs the CPU path", arr=arr,
                    warmup=traj.warmup, qd=np.array([w.qd for w in wls]),
                    cmd_count=traj.state.cmd_count.reshape(-1).cpu().numpy())
    return dict(windows=c["windows"], ms_per_window=1e3 * sec / c["windows"],
                windows_per_s=c["windows"] / sec, withdraws=gates[0],
                predictor_score=list(gates[1]), revoked_grants=gates[2],
                events=len(res.obs["events"]), max_rel_err_vs_cpu=err,
                kernels=sim_kernels_per_window(S, plat, wls, arr, cfg, dev))


def sim_fleet_events_phase(dev) -> dict:
    """sim_fleet4096's federated fleet under SIM_FLEET_EVENTS, once per
    size: at 4096 SSDs against the port's CPU path (tables and the
    revoked-grant ring equal, metrics within SIM_TOL), at 256 the
    revoked-grant sum against the reference's pin; no host sync in the
    window loop; ms per window at both sizes."""
    from repro_torch.core import events as EV
    from repro_torch.jbof import platforms as P, sim as S, workloads as W
    c, ce = SIM_FLEET, SIM_FLEET_EVENTS
    plat = P.xbof()._replace(fabric_extra_hops=c["extra_hops"])
    sched = EV.schedule(*(getattr(EV, k)(*a) for k, *a in ce["events"]))
    out = {}
    for n in (c["ssds"], c["small"]):
        wls, arr, _ = fleet_inputs(W, n)
        arr = arr[:ce["windows"]]
        cfg = S.SimConfig(warmup=c["warmup"], n_enclosures=n // c["per_enclosure"],
                          events=sched)
        traj, sec = sim_loop(S, S.prepare(plat, wls, arr, cfg, device=dev))
        res = S.summarize(plat, cfg, traj)
        ring = res.rings["revoked_grants"].cpu()
        line = dict(windows=ce["windows"], ms_per_window=1e3 * sec / ce["windows"],
                    windows_per_s=ce["windows"] / sec,
                    revoked_grants=float(ring.double().sum()),
                    revoked_windows=torch.nonzero(ring).flatten().tolist())
        if n == c["small"] and line["revoked_grants"] != SIM_FLEET_EVENTS_PIN:
            fail(f"sim_fleet_events n={n}: revoked_grants {line['revoked_grants']} "
                 f"!= the reference's {SIM_FLEET_EVENTS_PIN}")
        if n == c["ssds"]:
            cpu_traj = S.run_prepared(S.prepare(plat, wls, arr, cfg, device="cpu"))
            sim_same_table(traj.state.table, cpu_traj.state.table, "sim_fleet_events")
            if not torch.equal(ring, cpu_traj.revoked):
                fail("sim_fleet_events: revoked_grants differs from the CPU path")
            line["max_rel_err_vs_cpu"] = sim_close(
                res, S.summarize(plat, cfg, cpu_traj), "sim_fleet_events vs the CPU path",
                arr=arr, warmup=traj.warmup, qd=np.array([w.qd for w in wls]),
                cmd_count=traj.state.cmd_count.reshape(-1).cpu().numpy())
        out[f"n{n}"] = line
    return out


def sim_jbof12_phase(dev) -> dict:
    """The paper's JBOF on every platform: ms per window (XBOF and XBOF+
    SIM_REPEATS times, the others once), kernels per window, each platform's
    per-SSD metrics against the JAX reference's pins, XBOF and XBOF+
    against the port's CPU path (tables equal), and fig. 9c's utilization
    gap and fig. 12's BOM saving beside the paper's."""
    from repro_torch.jbof import bom, platforms as P, sim as S, workloads as W
    c = SIM_JBOF12
    wls = [W.micro(True, c["io_kb"])] * c["busy"] + [W.idle()] * c["idle"]
    arr = W.arrivals(wls, c["windows"], seed=c["seed"])
    cfg = S.SimConfig(warmup=c["warmup"])
    qd = np.array([w.qd for w in wls])
    out, results = {}, {}
    for name, make in P.ALL.items():
        plat = make()
        runs = []
        for _ in range(SIM_REPEATS if name in SIM_REPEATED else 1):
            traj, sec = sim_loop(S, S.prepare(plat, wls, arr, cfg, device=dev))
            runs.append(1e3 * sec / c["windows"])
        res = S.summarize(plat, cfg, traj)
        results[name] = res
        cmd = traj.state.cmd_count.reshape(-1).cpu().numpy()
        err_ref = sim_close(res, SIM_JBOF12_PINS[name], f"sim_jbof12 {name} vs reference",
                            arr=arr, warmup=traj.warmup, qd=qd, cmd_count=cmd,
                            fields=SIM_JBOF12_METRICS)
        ms = sorted(runs)
        line = dict(ms_per_window=ms[len(ms) // 2], ms_per_window_runs=runs,
                    ms_per_window_spread=[ms[0], ms[-1]],
                    windows_per_s=1e3 / ms[len(ms) // 2],
                    max_rel_err_vs_reference=err_ref)
        if name in SIM_REPEATED:
            cpu = S.run_prepared(S.prepare(plat, wls, arr, cfg, device="cpu"))
            sim_same_table(traj.state.table, cpu.state.table, f"sim_jbof12 {name}")
            line["max_rel_err_vs_cpu"] = sim_close(
                res, S.summarize(plat, cfg, cpu), f"sim_jbof12 {name} vs the CPU path",
                arr=arr, warmup=traj.warmup, qd=qd, cmd_count=cmd)
            line["kernels"] = sim_kernels_per_window(S, plat, wls, arr, cfg, dev)
        line["claimed_slots_end"] = int((traj.state.table.valid
                                         & (traj.state.table.borrower_id != 0xFF)).sum())
        out[name] = line
    util = {n: float((results[n].proc_util[:c["busy"]].mean()
                      + results[n].proc_util[c["busy"]:].mean()) / 2)
            for n in ("Shrunk", "XBOF")}
    conv = bom.platform_cost("Conv")["total"]
    saving = bom.platform_cost("XBOF")["total"] / conv - 1.0
    out["fig9c_util"] = dict(util, gap=util["XBOF"] - util["Shrunk"],
                             paper_gap=PAPER_UTIL_GAP)
    out["fig12_bom"] = dict(xbof_vs_conv=saving, paper=PAPER_BOM_SAVING)
    return out


def sim_trace8_obs_phase(dev) -> tuple[dict, int, tuple]:
    """fig. 20 at full length, trace-driven with the observability plane:
    one `shards_window` launch a window (its count zeroed just before the
    run and read just after), the busy SSDs' borrowed segments back under
    10 % of their burst peak within `lag_windows` of the burst's end, the
    card against the port's CPU path (tables, rings and decoded events),
    and the window kernel against its plain version on the last window.
    Returns the line, the kernel's launches in the first run, and that
    window's call."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import shards_window as sw
    from repro_torch.jbof import platforms as P, sim as S, workloads as W
    from repro_torch.obs import metrics as obs_m
    from repro_torch.telemetry import traces as T
    c = SIM_TRACE8
    n = c["windows"]
    busy = W.micro(True, 4.0, qd=8, random_access=True)
    wls = [busy] * c["busy"] + [W.idle()] * c["idle"]
    arr = W.arrivals(wls, n, seed=c["seed"])
    sched = [T.phase_change(n, c["burst"][0], c["burst"][1],
                            T.segments(c["ws_burst_segments"]),
                            T.segments(c["ws_base_segments"]), c["refs"])
             for _ in range(c["busy"])] + [[]] * c["idle"]
    traces = T.synth_trace(n, sched, c["refs"], seed=c["seed"] + 1)
    plat = P.xbof(dram_frac=c["dram_frac"])
    cfg = S.SimConfig(traces=traces, obs=obs_m.ObsConfig(
        enabled=True, ring_depth=c["ring_depth"], event_capacity=c["event_capacity"]))
    captured = {}
    window = ops.shards_window

    def capture(*args, **kw):
        captured["call"] = (args, kw)
        return window(*args, **kw)

    runs, launches = [], []
    for _ in range(SIM_REPEATS):
        prepared = S.prepare(plat, wls, arr, cfg, device=dev)
        ops.shards_window = capture
        sw.shards_window.launches = 0
        try:
            traj, sec = sim_loop(S, prepared)
        finally:
            ops.shards_window = window
        launches.append(sw.shards_window.launches)
        runs.append(1e3 * sec / n)
        if launches[-1] != n:
            fail(f"sim_trace8_obs: shards_window launched {launches[-1]} times in "
                 f"{n} windows")
    res = S.summarize(plat, cfg, traj)
    bh = res.rings["borrowed_seg"].cpu().numpy()
    busy_b = bh[:, :c["busy"]].sum(axis=1)
    b0, b1 = c["burst"]
    peak = float(busy_b[b0:b1].max())
    tail = busy_b[b1 + c["lag_windows"]:]
    under = busy_b[b1:] <= 0.1 * peak
    lag = int(np.argmax(under)) if under.any() else -1
    if peak < 50.0 or (tail.size and float(tail.max()) > 0.1 * peak):
        fail(f"sim_trace8_obs: borrowed segments peak {peak}, tail max "
             f"{float(tail.max())}: not back under 10 % within "
             f"{c['lag_windows']} windows")
    cpu_traj = S.run_prepared(S.prepare(plat, wls, arr, cfg, device="cpu"))
    cpu = S.summarize(plat, cfg, cpu_traj)
    sim_same_table(traj.state.table, cpu_traj.state.table, "sim_trace8_obs")
    for name in ("addrs", "last_seen", "clock"):
        if not torch.equal(getattr(traj.state.mrc, name).cpu(),
                           getattr(cpu_traj.state.mrc, name)):
            fail(f"sim_trace8_obs: SHARDS {name} differs from the CPU path")
    qd = np.array([w.qd for w in wls])
    err = sim_close(res, cpu, "sim_trace8_obs vs the CPU path", arr=arr,
                    warmup=traj.warmup, qd=qd,
                    cmd_count=traj.state.cmd_count.reshape(-1).cpu().numpy())
    ev_cols = ("t", "event", "rtype", "level", "lender", "borrower", "lane")
    same_events = [tuple(r[k] for k in ev_cols) for r in res.obs["events"]] == \
        [tuple(r[k] for k in ev_cols) for r in cpu.obs["events"]]
    if not same_events or not res.obs["events"]:
        fail(f"sim_trace8_obs: {len(res.obs['events'])} events, the CPU path "
             f"{len(cpu.obs['events'])} (or they differ)")
    args, kw = captured["call"]
    got_w, want_w = sw.shards_window(*args, **kw), ref.shards_window(*args, **kw)
    if not all(torch.equal(a, b) for a, b in zip(got_w, want_w)):
        fail("sim_trace8_obs: the shards_window kernel differs from its plain "
             "version on the last window")
    ms = sorted(runs)
    line = dict(windows=n, ms_per_window=ms[len(ms) // 2], ms_per_window_runs=runs,
                ms_per_window_spread=[ms[0], ms[-1]],
                windows_per_s=1e3 / ms[len(ms) // 2],
                shards_window_launches_each_run=launches,
                shards_window_bit_equal=True,
                borrowed_peak=peak, return_lag_windows=lag,
                lag_bound=c["lag_windows"], events=len(res.obs["events"]),
                events_dropped=res.obs["events_dropped"],
                ring_windows=int(res.obs["metrics"]["miss"].shape[0]),
                max_rel_err_vs_cpu=err,
                kernels=sim_kernels_per_window(S, plat, wls, arr, cfg, dev))
    return line, launches[0], captured["call"]


def sim_fleet_phase(dev) -> dict:
    """fig. 22's fleet: 4096 SSDs in 256 enclosures of 16, federated and
    isolated, the busy SSDs' mean latency against the JAX reference's pin
    (at 256 SSDs: the scenario is the same at every size), federation
    below isolation, the card against the port's CPU path (tables equal),
    and ms per window at 4096 SSDs beside 256."""
    from repro_torch.jbof import platforms as P, sim as S, workloads as W
    c = SIM_FLEET
    plat = P.xbof()._replace(fabric_extra_hops=c["extra_hops"])
    out = {}
    for n in (c["ssds"], c["small"]):
        e = n // c["per_enclosure"]
        wls, arr, n_busy = fleet_inputs(W, n)
        qd = np.array([w.qd for w in wls])
        lat = {}
        for mode, fed in (("federated", True), ("isolated", False)):
            cfg = S.SimConfig(warmup=c["warmup"], n_enclosures=e, fabric_federation=fed)
            runs = []
            for _ in range(SIM_REPEATS if fed else 1):
                traj, sec = sim_loop(S, S.prepare(plat, wls, arr, cfg, device=dev))
                runs.append(1e3 * sec / c["windows"])
            res = S.summarize(plat, cfg, traj)
            lat[mode] = float(res.latency_s[:n_busy].cpu().double().mean())
            if abs(lat[mode] - SIM_FLEET_PINS[mode]) > SIM_TOL * SIM_FLEET_PINS[mode]:
                fail(f"sim_fleet n={n} {mode}: busy latency {lat[mode]} != the "
                     f"reference's {SIM_FLEET_PINS[mode]}")
            ms = sorted(runs)
            line = dict(ms_per_window=ms[len(ms) // 2], ms_per_window_runs=runs,
                        ms_per_window_spread=[ms[0], ms[-1]],
                        windows_per_s=1e3 / ms[len(ms) // 2],
                        busy_latency_s=lat[mode], reference=SIM_FLEET_PINS[mode],
                        far_segments=float(res.borrowed_far.sum()))
            if n == c["ssds"]:
                cpu = S.run_prepared(S.prepare(plat, wls, arr, cfg, device="cpu"))
                sim_same_table(traj.state.table, cpu.state.table, f"sim_fleet {mode}")
                line["max_rel_err_vs_cpu"] = sim_close(
                    res, S.summarize(plat, cfg, cpu), f"sim_fleet {mode} vs the CPU path",
                    arr=arr, warmup=traj.warmup, qd=qd,
                    cmd_count=traj.state.cmd_count.reshape(-1).cpu().numpy())
                if fed:
                    line["kernels"] = sim_kernels_per_window(S, plat, wls, arr, cfg, dev)
            out[f"n{n}_{mode}"] = line
        if not lat["federated"] < lat["isolated"]:
            fail(f"sim_fleet n={n}: federation did not relieve the busy SSDs {lat}")
        out[f"n{n}_benefit"] = (lat["isolated"] - lat["federated"]) / lat["isolated"]
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a CUDA device")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.serving import engine as E

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)

    start = t0 = time.perf_counter()
    laps = {}   # each phase's end, seconds from the start (the `run` line)

    def lap(name):
        laps[name] = time.perf_counter() - start

    _build.build()
    ptxas = [ln.strip() for log in _build.LOG.values() for ln in log.splitlines()
             if "entry function" in ln or "registers" in ln or "spill" in ln]
    hgmma = sass_count(_build, "flash_attention", "HGMMA")
    bwd_hgmma = sass_count(_build, "flash_attention_bwd", "HGMMA")
    hmma = sass_count(_build, "rwkv6_scan", "HMMA")
    serialized, bwd_serialized = (
        sum("wgmma.mma_async instructions are serialized" in ln
            for ln in _build.LOG.get(src, "").splitlines())
        for src in ("flash_attention", "flash_attention_bwd"))
    print(json.dumps({"build": {"seconds": round(time.perf_counter() - t0, 3),
                                "sources": list(_build.SOURCES), "ptxas": ptxas,
                                "flash_ptxas": ptxas_rows(_build.LOG.get("flash_attention", ""),
                                                          "hopper_kernel|simt_kernel"),
                                "flash_hgmma": hgmma,
                                "flash_wgmma_serialized_reports": serialized,
                                "wkv_ptxas": ptxas_rows(_build.LOG.get("rwkv6_scan", ""),
                                                        "wkv_chunk_kernel|rwkv6_kernel"),
                                "rglru_ptxas": ptxas_rows(_build.LOG.get("rglru_scan", ""),
                                                          "rglru_kernel"),
                                "paged_ptxas": ptxas_rows(_build.LOG.get("paged_attention", ""),
                                                          "paged_decode_kernel"),
                                "router_ptxas": ptxas_rows(_build.LOG.get("moe_router", ""),
                                                           "router_kernel"),
                                "ftl_ptxas": ptxas_rows(_build.LOG.get("ftl_lookup", ""),
                                                        "ftl_kernel"),
                                "window_ptxas": ptxas_rows(_build.LOG.get("shards_window", ""),
                                                           "shards_window_kernel"),
                                "flash_bwd_ptxas": ptxas_rows(
                                    _build.LOG.get("flash_attention_bwd", ""),
                                    "dq_hopper|dkdv_hopper|prep_kernel|sum_kernel|dq_kernel|dkdv_kernel"),
                                "flash_bwd_hgmma": bwd_hgmma,
                                "flash_bwd_wgmma_serialized_reports": bwd_serialized,
                                "rglru_bwd_ptxas": ptxas_rows(
                                    _build.LOG.get("rglru_scan_bwd", ""),
                                    "rglru_bwd_chains|rglru_bwd_groups"),
                                "wkv_bwd_ptxas": ptxas_rows(
                                    _build.LOG.get("rwkv6_scan_bwd", ""),
                                    "wkv_bwd_chains|wkv_bwd_groups|wkv_bwd_du_kernel"),
                                "router_bwd_ptxas": ptxas_rows(
                                    _build.LOG.get("moe_router_bwd", ""), "router_bwd_kernel"),
                                "wkv_hmma": hmma}}),
          flush=True)
    if hgmma == 0:
        fail("the flash library holds no HGMMA instruction: its bf16 kernel is "
             "not on the tensor cores")
    if bwd_hgmma == 0:
        fail("the flash backward's library holds no HGMMA instruction: its bf16 "
             "kernels are not on the tensor cores")
    if hmma == 0:
        fail("the WKV library holds no HMMA instruction: its bf16 kernel is "
             "not on the tensor cores")
    lap("build")

    # ---- 1. every kernel form against its plain version; each call
    # repeated, and equal bit for bit
    checks = []
    for form in ("fp32", "bf16", "int8"):
        for label, (b, h, kv, d, page, mp, n_pages, pattern) in PAGED_CHECKS.items():
            args, kw = random_inputs(form, b, h, kv, d, page, mp, n_pages,
                                     seed=len(checks), dev=dev, pattern=pattern)
            got = pa.paged_attention(*args, **kw)
            again = pa.paged_attention(*args, **kw)
            torch.cuda.synchronize()
            err, rel, ok = max_err(got, plain(ref, args, kw), TOL[form])
            same = torch.equal(got, again)
            checks.append(dict(form=form, shape=label, pattern=pattern,
                               q=[b, h, d], pool=[n_pages, page, kv, d], mp=mp,
                               max_abs_err=err, max_rel_err=rel,
                               tol=TOL[form], repeat_equal=same, ok=ok and same))
    print(json.dumps({"paged_checks": {
        "n": len(checks), "ok": all(c["ok"] for c in checks),
        "max_abs_err": {f: max(c["max_abs_err"] for c in checks if c["form"] == f)
                        for f in TOL}}}), flush=True)
    bad = [c for c in checks if not c["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    fchecks = flash_checks(dev)
    print(json.dumps({"flash_checks": {
        "n": len(fchecks), "ok": all(c["ok"] for c in fchecks),
        "max_abs_err": {f: max(c["max_abs_err"] for c in fchecks if c["form"] == f)
                        for f in ("fp32", "bf16")},
        "stats": {f: {key: max(c["stats"][key] for c in fchecks if c["form"] == f)
                      for key in ("m_over_tol", "l_over_tol", "no_key_rows")}
                  for f in ("fp32", "bf16")},
        "stats_tol": STATS_TOL,
        "same_without_stats": all(c["same_without_stats"] for c in fchecks)}}), flush=True)
    bad = [c for c in fchecks if not c["ok"]]
    if bad:
        fail(f"flash kernel disagrees with its plain version: {bad}")
    bchecks = flash_bwd_checks(dev)
    print(json.dumps({"flash_bwd_checks": {
        "n": len(bchecks), "ok": all(c["ok"] for c in bchecks),
        "repeat_equal": all(c["repeat_equal"] for c in bchecks),
        **{key: {f: {m: max(c[key][m] for c in bchecks if c["form"] == f and key in c)
                     for m in ("max_abs_err", "err_over_rms")}
                 for f in BWD_TOL if any(key in c for c in bchecks if c["form"] == f)}
           for key in ("plain", "given_o", "given_o_fp32_operands")},
        "given_o_operands": {f: sorted({c["given_o"]["operands"] for c in bchecks
                                        if c["form"] == f}) for f in BWD_TOL}}}), flush=True)
    bad = [c for c in bchecks if not c["ok"]]
    if bad:
        fail(f"flash backward kernel disagrees with its plain version: {bad}")
    schecks = scan_checks(dev)
    print(json.dumps({"scan_checks": {
        "n": len(schecks), "ok": all(c["ok"] for c in schecks),
        "max_abs_err": {f"{n}[{f}]": max(c["max_abs_err"] for c in schecks
                                         if c["kernel"] == n and c["form"] == f)
                        for n in SCAN_TOL for f in ("fp32", "bf16")}}}), flush=True)
    bad = [c for c in schecks if not c["ok"]]
    if bad:
        fail(f"scan kernel disagrees with its plain version: {bad}")
    rchecks = router_checks(dev)
    print(json.dumps({"router_checks": {
        "n": len(rchecks), "ok": all(c["ok"] for c in rchecks),
        "idx_equal": all(c["idx_equal"] for c in rchecks),
        "repeat_equal": all(c["repeat_equal"] for c in rchecks),
        "max_abs_err": max(c["max_abs_err"] for c in rchecks)}}), flush=True)
    bad = [c for c in rchecks if not c["ok"]]
    if bad:
        fail(f"router kernel disagrees with its plain version: {bad}")
    sbchecks = scan_bwd_checks(dev)
    print(json.dumps({"scan_bwd_checks": {
        "n": len(sbchecks), "ok": all(c["ok"] for c in sbchecks),
        "repeat_equal": all(c["repeat_equal"] for c in sbchecks),
        "rglru_values_equal": all(c.get("values_equal", True) for c in sbchecks),
        "nonfinite_wants": sum(c["nonfinite"] for c in sbchecks),
        **{f"{n}[{f}]": {m: max(c[m] for c in sbchecks if c["kernel"] == n and c["form"] == f)
                         for m in ("max_abs_err", "err_over_rms")}
           for n in ("rglru_bwd", "rwkv6_wkv_bwd") for f in ("fp32", "bf16")}}}), flush=True)
    bad = [c for c in sbchecks if not c["ok"]]
    if bad:
        fail(f"scan backward kernel disagrees with its plain gradient: {bad}")
    rbchecks = router_bwd_checks(dev)
    print(json.dumps({"router_bwd_checks": {
        "n": len(rbchecks), "ok": all(c["ok"] for c in rbchecks),
        "repeat_equal": all(c["repeat_equal"] for c in rbchecks),
        **{m: max(c[m] for c in rbchecks) for m in ("max_abs_err", "err_over_rms")}}}),
        flush=True)
    bad = [c for c in rbchecks if not c["ok"]]
    if bad:
        fail(f"router backward kernel disagrees with its plain gradient: {bad}")
    lap("checks")

    # ---- 1b. the FTL lookup at SSD scale (frees its tables when done)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB > L2
    floor_ms = launch_floor_ms(flush)
    ftl_line, ftl_row = ftl_phase(dev, flush, floor_ms)
    print(json.dumps({"ftl": ftl_line}), flush=True)
    lap("ftl")

    # ---- 2. the main path: the engine at full width, four phases (one
    # shard and the hierarchical engine, fp32 and int8 pages)
    engine_out, main_inputs = {}, {}
    for phase in PHASES:
        engine_out[phase], main_inputs[phase] = engine_phase(E, pa, phase, dev)
    # each paged form's launches: the phases whose pages it reads
    by_form = {form: {phase: line["launches"] for phase, line in engine_out.items()
                      if (PHASES[phase][0]["kv_quant"] == "int8") == (form == "int8")}
               for form in ("fp32", "int8")}
    launches = {form: sum(v.values()) for form, v in by_form.items()}
    by_window = {phase: line["shards_window_launches"]
                 for phase, line in engine_out.items() if line["shards_window_launches"]}
    print(json.dumps({"engine": engine_out}), flush=True)
    lap("engine")
    card = card_line()

    # ---- 2r. the multi-rank paths (ranks of one gloo group on the one
    # card): the engine's sharded step on 2 and on 4 ranks against one
    # process, then deepseek-v2's sequence-sharded MLA decode
    ranks_out = {phase: engine_ranks_phase(E, phase, dev) for phase in RANK_PHASES}
    for phase, line in ranks_out.items():
        form = "int8" if engine_cfg(E, RANK_PHASES[phase][0])[0].kv_quant == "int8" else "fp32"
        by_form[form][phase] = line["launches"]["paged_attention"]
        launches[form] += line["launches"]["paged_attention"]
        if line["launches"]["shards_window"]:
            by_window[phase] = line["launches"]["shards_window"]
    print(json.dumps({"engine_ranks": ranks_out, "card": card}), flush=True)
    lap("engine_ranks")
    mla_line = mla_ranks_phase(dev)
    print(json.dumps({"mla_seq_sharded_v2": mla_line, "card": card}), flush=True)
    lap("mla_seq_sharded_v2")

    # ---- 2'. the failure plane: the failover phases at full width, then
    # fig. 23's own scenario, each driven once through `drive_events`
    failover = {phase: failover_phase(E, pa, phase, dev) for phase in FAILOVER}
    failover["failover_fig23"] = failover_fig23_phase(E, pa, dev)
    for phase, line in failover.items():
        form = "int8" if FAILOVER.get(phase, ({},))[0].get("kv_quant") == "int8" else "fp32"
        by_form[form][phase] = line["launches"]
        launches[form] += line["launches"]
    print(json.dumps({"failover": failover, "card": card}), flush=True)
    lap("failover")

    # ---- 2a. the JBOF simulator: the paper's JBOF on every platform,
    # fig. 20 trace-driven with both planes, fig. 22's 4096-SSD fleet
    t_sim = time.perf_counter()
    print(json.dumps({"sim_jbof12": sim_jbof12_phase(dev), "card": card}), flush=True)
    lap("sim_jbof12")
    trace8, by_window["sim_trace8_obs"], _ = sim_trace8_obs_phase(dev)
    print(json.dumps({"sim_trace8_obs": trace8, "card": card}), flush=True)
    lap("sim_trace8_obs")
    fleet = sim_fleet_phase(dev)
    print(json.dumps({"sim_fleet4096": fleet, "card": card,
                      "sim_seconds": time.perf_counter() - t_sim}), flush=True)
    lap("sim_fleet4096")
    # the failure plane on the simulator: fig. 23's run, the fleet's events
    t_ev = time.perf_counter()
    print(json.dumps({"sim_events8_obs": sim_events8_obs_phase(dev), "card": card}),
          flush=True)
    print(json.dumps({"sim_fleet_events": sim_fleet_events_phase(dev), "card": card,
                      "sim_events_seconds": time.perf_counter() - t_ev}), flush=True)
    lap("sim_events")

    # ---- 2b. the model zoo's serve path at full width, a sliding window
    # past its size, then the recurrent families (each model is freed
    # when its run returns)
    model_line, model_in = model_phase(*MODEL, dev)
    print(json.dumps({"model": model_line}), flush=True)
    window_line, window_in = model_phase(*MODEL_WINDOW, dev)
    print(json.dumps({"model_window": window_line}), flush=True)
    hybrid_line, hybrid_in = model_phase(*MODEL_HYBRID, dev)
    print(json.dumps({"model_hybrid": hybrid_line}), flush=True)
    rwkv_line, rwkv_in = model_phase(*MODEL_RWKV, dev)
    print(json.dumps({"model_rwkv": rwkv_line}), flush=True)
    moe_v2_line, moe_v2_in = model_phase(*MODEL_MOE_V2[:4], dev,
                                         n_layers=MODEL_MOE_V2[4], repeat=True)
    print(json.dumps({"model_moe_v2": moe_v2_line}), flush=True)
    moe_v3_line, moe_v3_in = model_phase(*MODEL_MOE_V3[:4], dev,
                                         n_layers=MODEL_MOE_V3[4], repeat=True)
    print(json.dumps({"model_moe_v3": moe_v3_line}), flush=True)
    lap("models")
    # the encoder-decoder (frame embeddings through the encoder, decoder
    # tokens with cross-attention) and the M-RoPE model (patch embeddings)
    whisper_line, whisper_in = model_phase(*MODEL_WHISPER, dev)
    print(json.dumps({"model_whisper_tiny": whisper_line, "card": card}), flush=True)
    lap("model_whisper_tiny")
    qwen2_vl_line, qwen2_vl_in = model_phase(*MODEL_QWEN2_VL, dev)
    print(json.dumps({"model_qwen2_vl_2b": qwen2_vl_line, "card": card}), flush=True)
    lap("model_qwen2_vl_2b")

    # ---- 2c. the trainer's main path at full width (h2o-danube-1.8b),
    # with a checkpoint and a restart; the recurrent families at full width
    # and cut depth; then one step on the card against the CPU path
    from repro_torch import configs
    from repro_torch.models.config import ArchConfig
    train_line = train_phase(dev)
    print(json.dumps({"train_h2o_danube": train_line, "card": card}), flush=True)
    lap("train_h2o_danube")
    whisper_train = train_phase(dev, TRAIN_WHISPER)
    print(json.dumps({"train_whisper_tiny": whisper_train, "card": card}), flush=True)
    lap("train_whisper_tiny")
    family_lines = {}
    for phase in TRAIN_FAMILIES:
        family_lines[phase] = train_family_phase(dev, phase)
        print(json.dumps({phase: family_lines[phase], "card": card}), flush=True)
        lap(phase)
    cut = lambda arch, n, dtype="bfloat16": dataclasses.replace(
        configs.get(arch), name=f"{arch}-{n}-layers", n_layers=n, dtype=dtype)
    narrow = ArchConfig(**NARROW)
    vs_cpu = [train_vs_cpu(dev, cut(TRAIN[0], 2), 13, *TRAIN_VS_CPU),
              train_vs_cpu(dev, cut("recurrentgemma-9b", 3), 19, *TRAIN_VS_CPU),
              train_vs_cpu(dev, cut("rwkv6-3b", 2, "float32"), 21, *TRAIN_VS_CPU,
                           tol=RWKV6_TRAIN_TOL),
              train_vs_cpu(dev, narrow, 15, 2, 128),
              train_vs_cpu(dev, dataclasses.replace(narrow, name="narrow-d128-bf16",
                                                    dtype="bfloat16"), 17, 2, 128)]
    # the recurrent and MoE smoke configs (fp32), which trained on the CPU
    # path only before their kernels had backward kernels
    vs_cpu += [train_vs_cpu(dev, configs.smoke(arch), seed, 2, 128)
               for seed, arch in ((23, "recurrentgemma-9b"), (25, "rwkv6-3b"),
                                  (27, "deepseek-v2-236b"), (29, "deepseek-v3-671b"))]
    # whisper-tiny whole at its decoder's window over 1500 frames,
    # qwen2-vl-2b at 2 layers (bf16), and their smoke configs (fp32)
    vs_cpu += [train_vs_cpu(dev, configs.get("whisper-tiny"), 31, 1, 448),
               train_vs_cpu(dev, cut("qwen2-vl-2b", 2), 33, *TRAIN_VS_CPU)]
    vs_cpu += [train_vs_cpu(dev, configs.smoke(arch), seed, 2, 128)
               for seed, arch in ((35, "whisper-tiny"), (37, "qwen2-vl-2b"))]
    print(json.dumps({"train_gpu_vs_cpu": {"steps": vs_cpu}, "card": card}), flush=True)
    lap("train_gpu_vs_cpu")

    # ---- 2d. the mesh trainer on gloo ranks on the card, against one
    # process; then the dry run's predicted peaks against the measured ones
    ranks_train = {}
    torch.cuda.empty_cache()   # the ranks share the card with this process
    for phase in TRAIN_RANKS:
        ranks_train[phase] = train_ranks_phase(phase)
        print(json.dumps({phase: ranks_train[phase], "card": card,
                          "this_process_reserved_bytes": torch.cuda.memory_reserved()}),
              flush=True)
        lap(phase)
    dry = dryrun_memory_phase(dev, train_line, ranks_train["train_ranks_h2o"])
    print(json.dumps({"dryrun_memory": dry, "card": card}), flush=True)
    lap("dryrun_memory")
    train_gpu_cpu_launches = {name: sum(c["launches"][name] for c in vs_cpu)
                              for name in train_kernels()}

    # ---- 3. each kernel form on the inputs the main path gave it
    fp_args, _ = main_inputs["fp32"]["paged_attention"]
    int8_args, int8_kw = main_inputs["int8_metered"]["paged_attention"]
    forms = {
        "fp32": (list(fp_args), {}, launches["fp32"]),
        "bf16": ([fp_args[0].bfloat16(), fp_args[1].bfloat16(),
                  fp_args[2].bfloat16(), fp_args[3], fp_args[4]], {}, 0),
        "int8": (list(int8_args), dict(int8_kw), launches["int8"]),
    }
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
        repeat_equal = torch.equal(got, pa.paged_attention(*args, **kw))
        if not repeat_equal:
            fail(f"{form}: a second call on the main path's inputs gave other bits")
        ms = timed_ms(lambda: pa.paged_attention(*args, **kw), 20, flush)
        ms_spun, spin_ms, host_ms, attempts = spun_ms(
            form, lambda: pa.paged_attention(*args, **kw), 20, flush)
        plain_ms = timed_ms(lambda: plain(ref, args, kw), 5, flush)
        nbytes, flops = work(args, kw)
        t_bytes, t_ops = 1e3 * nbytes / HBM_BPS, 1e3 * flops / FP32_FLOPS
        kernels.append({
            "name": f"paged_attention[{form}]",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:123",
            "launches": n_launch,
            "launches_by_phase": by_form.get(form, {}),
            "on_main_path": form != "bf16",
            "shape": {"q": list(args[0].shape), "pool": list(args[1].shape),
                      "dtype": str(args[1].dtype).replace("torch.", "")},
            "max_abs_err": err, "max_rel_err": rel, "tol": TOL[form],
            "gate": ("max_abs_err / max|want| <= tol" if form == "bf16"
                     else "|err| <= tol * (1 + |want|) per element"),
            # random tables with holes and a row of length 0, both widths
            "checks": [c for c in checks if c["form"] == form],
            # `ms` as before (events around the wrapper); `ms_spun`
            # with a spin kernel ahead of the start event, so the host's
            # time before the launch stays out of the window
            "ms": ms, "ms_spun": ms_spun, "spin_ms": spin_ms,
            "host_ms_max": host_ms, "spun_attempts": attempts, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "of_bound": max(t_bytes, t_ops) / ms_spun,
            "repeat_equal": repeat_equal,
            "bytes": nbytes, "flops": flops,
            # no single PyTorch call computes attention over a page table
            "library_ms": None,
        })

    # the SHARDS window kernel on the trace-driven phases' last window
    kernels.append(window_row(main_inputs["trace_fp32"]["shards_window"],
                              by_window, flush, floor_ms))

    # ---- 4. the engine on the GPU against the same engine on the CPU:
    # one shard (stats), then the hierarchical engine (stats and state)
    small = E.EngineConfig(n_replicas=4, seq_slots=4, shadow_slots=2,
                           pages_per_replica=32, page=8, max_pages=8,
                           kv_quant="int8")
    gpu_vs_cpu_engine(E, dev, small, [5, 0, 0, 1], 6)
    sharded = E.EngineConfig(n_replicas=8, n_shards=2, seq_slots=2,
                             shadow_slots=2, pages_per_replica=8, max_pages=8,
                             link_pages_per_step=1)
    cross = gpu_vs_cpu_engine(E, dev, sharded, [5, 5, 5, 5, 0, 0, 0, 0], 8,
                              check_state=True)
    borrowed = gpu_vs_cpu_engine(E, dev, sharded._replace(kv_quant="int8"),
                                 [3, 3, 0, 0, 0, 0, 0, 0], 8, check_state=True,
                                 pressured=range(4, 8))
    # both planes: the SHARDS state (table, clock, histogram), the rings'
    # cursor and the event log's count compared as state
    planes = gpu_vs_cpu_engine(E, dev, sharded._replace(
        trace_driven=True, obs=E.obs_m.ObsConfig(enabled=True, ring_depth=8,
                                                 event_capacity=256)),
        [5, 5, 5, 5, 0, 0, 0, 0], 8, check_state=True)
    if cross["cross_redirected"] <= 0 or borrowed["cross_link_borrowed_bytes"] <= 0 \
            or planes["cross_redirected"] <= 0:
        fail(f"gpu_vs_cpu_engine: the sharded runs exchanged nothing ({cross}, "
             f"{borrowed}, {planes})")
    print(json.dumps({"gpu_vs_cpu_engine": {
        "configs": ["4 replicas, int8 (stats)",
                    "8 replicas in 2 shards, metered, fp32 (stats and state)",
                    "the same, int8, shard 1 memory-full (stats and state)",
                    "the fp32 2-shard config, trace-driven with obs (stats and state)"],
        "steps": [6, 8, 8, 8], "sharded_totals": [cross, borrowed, planes], "ok": True}}),
        flush=True)
    # the DeepSeek smoke configs at a prompt of 1040: 2080 tokens take the
    # MoE's sorted-capacity dispatch in the prefill, the one-hot in decode
    model_checks = {cfg.name: gpu_vs_cpu_model(dev, cfg, seed, prompt)
                    for seed, cfg, prompt in (
                        (3, ArchConfig(**NARROW), 128),
                        (5, configs.smoke("recurrentgemma-9b"), 128),
                        (7, configs.smoke("rwkv6-3b"), 128),
                        (9, configs.smoke("deepseek-v2-236b"), 1040),
                        (11, configs.smoke("deepseek-v3-671b"), 1040),
                        (39, configs.smoke("whisper-tiny"), 128),
                        (41, configs.smoke("qwen2-vl-2b"), 128))}
    print(json.dumps({"gpu_vs_cpu_model": model_checks}), flush=True)
    lap("gpu_vs_cpu")
    gpu_cpu_launches = {name: sum(c["launches"][name] for c in model_checks.values())
                        for name in kernel_table()}

    # ---- 5. the flash kernel on the inputs the model runs gave its first
    # layer: qwen3-14b (bf16, and the same inputs in fp32, a form the main
    # path does not run), h2o-danube's sliding window and recurrentgemma's
    # local attention (head_dim 256, one KV head)
    def flash_in(captured):
        (q, k, v), kw = captured["flash_attention"][0]
        return q, k, v, kw["causal"], kw["window"]

    q, k, v, causal, window = flash_in(model_in)
    kernels.append(flash_row(
        "flash_attention[bf16]", "bf16", q, k, v, causal, window,
        model_line["launches"]["flash_attention"], flush, fchecks,
        {"on_main_path": True, "phase": "model"}))
    kernels.append(flash_row(
        "flash_attention[fp32]", "fp32", q.float(), k.float(), v.float(), causal,
        window, 0, flush, fchecks,
        {"on_main_path": False, "phase": "model (inputs cast to fp32)",
         "launches_gpu_vs_cpu_model": gpu_cpu_launches["flash_attention"]}))
    del model_in, q, k, v
    q, k, v, causal, window = flash_in(window_in)
    kernels.append(flash_row(
        "flash_attention[bf16,window]", "bf16", q, k, v, causal, window,
        window_line["launches"]["flash_attention"], flush, fchecks,
        {"on_main_path": True, "phase": "model_window",
         # the same kernel at the same shapes on the trainer's path
         "launches_train_h2o_danube": train_line["launches"]["flash_attention"],
         "launches_train_gpu_vs_cpu": train_gpu_cpu_launches["flash_attention"],
         # the mesh trainer's ranks (h2o-danube at 4 layers, batch 4 x 4096)
         "launches_train_ranks_h2o":
             ranks_train["train_ranks_h2o"]["launches"]["flash_attention"]}))
    del window_in, q, k, v
    q, k, v, causal, window = flash_in(hybrid_in)
    kernels.append(flash_row(
        "flash_attention[bf16,hybrid]", "bf16", q, k, v, causal, window,
        hybrid_line["launches"]["flash_attention"], flush, fchecks,
        {"on_main_path": True, "phase": "model_hybrid"}))
    del q, k, v

    # the backward kernel at the trainer's attention shape
    # whisper-tiny's encoder (causal over 1500 frames) and cross-attention
    # (4 decoder queries over 1500 keys, unmasked), qwen2-vl-2b's prefill
    # (12 query heads over 2 KV heads of 128): launches at each shape
    # (the wrappers' counts at the shape: one an encoder layer, one a
    # decoder layer, one a layer)
    wcfg = configs.get(MODEL_WHISPER[0])
    roles = flash_roles(wcfg)
    for label, line, captured, call, want in (
            ("whisper_encoder", whisper_line, whisper_in, 0, wcfg.n_enc_layers),
            ("whisper_cross", whisper_line, whisper_in,
             next(i for i, r in roles.items() if r == "cross"), wcfg.n_layers),
            ("qwen2_vl", qwen2_vl_line, qwen2_vl_in, 0, qwen2_vl_line["layers"])):
        (q, k, v), kw = captured["flash_attention"][call]
        n = shape_calls(line["flash_calls_by_shape"], q.shape, k.shape, kw["causal"],
                        kw["window"])
        if n != want:
            fail(f"flash_attention[bf16,{label}]: {n} launches at its shape in "
                 f"{line['arch']}'s run, want {want}")
        kernels.append(flash_row(
            f"flash_attention[bf16,{label}]", "bf16", q, k, v, kw["causal"], kw["window"],
            n, flush, fchecks,
            {"on_main_path": True, "phase": line["arch"].replace("-", "_"),
             "launches_all_shapes": line["launches"]["flash_attention"]}))
        del q, k, v
    del whisper_in, qwen2_vl_in

    kernels.append(flash_bwd_row(
        dev, flush, bchecks, train_line["launches"]["flash_attention_bwd"],
        {"on_main_path": True, "phase": "train_h2o_danube",
         "launches_train_recurrentgemma_9b":
             family_lines["train_recurrentgemma_9b"]["launches"]["flash_attention_bwd"],
         "launches_train_gpu_vs_cpu": train_gpu_cpu_launches["flash_attention_bwd"],
         "launches_train_ranks_h2o":
             ranks_train["train_ranks_h2o"]["launches"]["flash_attention_bwd"]}))
    # whisper-tiny's training cross-attention: one backward a decoder layer
    # and microbatch in each step of the uninterrupted run (the steps the
    # line's `launches` count), as the wrapper counted them at the shape
    b, s, t, h, kv, d, causal, window = FLASH_BWD_WHISPER
    n = shape_calls(whisper_train["flash_calls_by_shape"]["flash_attention_bwd"],
                    (b, s, h, d), (b, t, kv, d), causal, window)
    want = wcfg.n_layers * TRAIN_WHISPER[3] * TRAIN_WHISPER[4]
    if n != want:
        fail(f"flash_attention_bwd[bf16,whisper_cross]: {n} launches at its shape in "
             f"train_whisper_tiny's uninterrupted run, want {want}")
    kernels.append(flash_bwd_row(
        dev, flush, bchecks, n,
        {"on_main_path": True, "phase": "train_whisper_tiny",
         "launches_all_shapes": whisper_train["launches"]["flash_attention_bwd"]},
        shape=FLASH_BWD_WHISPER, name="flash_attention_bwd[bf16,whisper_cross]"))
    # qwen2-vl-2b's and recurrentgemma-9b's training attention: every
    # backward call of their phases is at this shape
    for label, shape, phase in (("qwen2_vl", FLASH_BWD_QWEN2_VL, "train_qwen2_vl_2b"),
                                ("recurrentgemma", FLASH_BWD_RECURRENTGEMMA,
                                 "train_recurrentgemma_9b")):
        kernels.append(flash_bwd_row(
            dev, flush, bchecks, family_lines[phase]["launches"]["flash_attention_bwd"],
            {"on_main_path": True, "phase": phase}, shape=shape,
            name=f"flash_attention_bwd[bf16,{label}]"))

    # the scans' backward kernels at their training shapes (random bf16
    # inputs), launched by the recurrent families' train phases
    for name, shape, source, phase in (
            ("rglru", RGLRU_BWD_TRAIN, "rglru_scan_bwd", "train_recurrentgemma_9b"),
            ("rwkv6_wkv", WKV_BWD_TRAIN, "rwkv6_scan_bwd", "train_rwkv6_3b")):
        kernels.append(bwd_row(
            name, "bf16", shape, source, family_lines[phase]["launches"][f"{name}_bwd"],
            flush, sbchecks, floor_ms,
            {"on_main_path": True, "phase": phase,
             "launches_train_gpu_vs_cpu": train_gpu_cpu_launches[f"{name}_bwd"]}))
    # the RG-LRU backward in fp32 at the same shape (a form no trainer of
    # the smoke runs: its time on record), and the forward kernel at the
    # training microbatch's shape (random bf16 inputs; the serving rows of
    # step 6 are at the prefill's [4, 2048, 4096]), launched 8 times a step
    # by train_recurrentgemma_9b (2 RG-LRU layers x 2 microbatches, forward
    # and remat)
    kernels.append(bwd_row(
        "rglru", "fp32", RGLRU_BWD_TRAIN, "rglru_scan_bwd", 0, flush, sbchecks, floor_ms,
        {"on_main_path": False, "phase": "train_recurrentgemma_9b's shape in fp32"}))
    args, kw = scan_inputs("rglru", (*RGLRU_BWD_TRAIN, False), torch.bfloat16, 26, dev)
    kernels.append({**scan_row(
        "rglru", "bf16", args, kw,
        family_lines["train_recurrentgemma_9b"]["launches"]["rglru"], flush, schecks,
        {"on_main_path": True, "phase": "train_recurrentgemma_9b"}), "name": "rglru[bf16,train]"})
    del args, kw

    # ---- 6. the scan kernels on the inputs the recurrent models gave their
    # first layer (bf16), and the same inputs in fp32 (a form the main path
    # does not run; the narrow fp32 models of step 4 launch it)
    for name, line, captured, phase in (("rglru", hybrid_line, hybrid_in, "model_hybrid"),
                                        ("rwkv6_wkv", rwkv_line, rwkv_in, "model_rwkv")):
        args, kw = captured[name][0]
        kernels.append(scan_row(name, "bf16", args, kw, line["launches"][name],
                                flush, schecks, {"on_main_path": True, "phase": phase}))
        args32 = [a.float() for a in args]
        kernels.append(scan_row(name, "fp32", args32, kw, 0, flush, schecks, {
            "on_main_path": False, "phase": f"{phase} (inputs cast to fp32)",
            "launches_gpu_vs_cpu_model": gpu_cpu_launches[name]}))
        del args, args32
    del hybrid_in, rwkv_in

    # ---- 7. the router on the scores the DeepSeek models' first MoE layer
    # gave it in the prefill (v2: softmax, no bias; v3: sigmoid with the
    # aux-free bias), and on the first decode step's; then the FTL lookup
    # on its SSD-scale burst
    n_v2 = prefill_launches(dataclasses.replace(configs.get(MODEL_MOE_V2[0]),
                                                n_layers=MODEL_MOE_V2[4]))["topk_router"]
    n_v3 = prefill_launches(dataclasses.replace(configs.get(MODEL_MOE_V3[0]),
                                                n_layers=MODEL_MOE_V3[4]))["topk_router"]
    for form, line, captured, n_moe in (("v2", moe_v2_line, moe_v2_in, n_v2),
                                        ("v3", moe_v3_line, moe_v3_in, n_v3)):
        (scores, k), kw = captured["topk_router"][0]
        # v2's row also counts the ranks of `mla_seq_sharded_v2` (the same
        # expert count and k, its decode rows)
        ranks_launches = mla_line["launches_topk_router"] if form == "v2" else 0
        kernels.append(router_row(
            f"topk_router[{form}]", scores, k, kw.get("bias"),
            captured["topk_router"][n_moe], line["launches"]["topk_router"] + ranks_launches,
            flush, rchecks, floor_ms,
            {"on_main_path": True, "phase": f"model_moe_{form}",
             "launches_by_phase": {f"model_moe_{form}": line["launches"]["topk_router"],
                                   **({"mla_seq_sharded_v2": ranks_launches}
                                      if ranks_launches else {})},
             "scores": "sigmoid + aux-free bias" if kw.get("bias") is not None
             else "softmax",
             "launches_gpu_vs_cpu_model": gpu_cpu_launches["topk_router"],
             # the mesh trainer's ranks (deepseek-v2's smoke config)
             "launches_train_ranks_moe":
                 ranks_train["train_ranks_moe"]["launches"]["topk_router"]}))
    del moe_v2_in, moe_v3_in
    # the router's backward kernel at DeepSeek's full widths (random
    # scores), launched by the DeepSeek smoke configs' train steps
    for form in ("v2", "v3"):
        kernels.append(router_bwd_row(
            form, train_gpu_cpu_launches["topk_router_bwd"], flush, rbchecks, floor_ms,
            {"on_main_path": True, "phase": "train_gpu_vs_cpu (deepseek smoke configs)",
             "launches_train_ranks_moe":
                 ranks_train["train_ranks_moe"]["launches"]["topk_router_bwd"]}))
    kernels.append({**ftl_row, "on_main_path": True, "phase": "ftl"})

    # the script's own time, from the card line to here, the build included
    lap("kernel_rows")
    print(json.dumps({"run": {"seconds": time.perf_counter() - start,
                              "phase_end_s": laps}}), flush=True)
    # floor_ms: one trivial launch, spun (`launch_floor_ms`)
    print(json.dumps({"kernels": kernels, "floor_ms": floor_ms}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
