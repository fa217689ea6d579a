"""Windowed JBOF simulation: a Python loop over 1 ms windows.

Port of `repro.jbof.sim`. Fluid queueing model: per window and per SSD the
step computes resource *time* demands (compute-end clocks, data-end
channel time, host clocks, link bytes) for the queued work, then serves
the feasible fraction, carrying backlog. Harvesting platforms redistribute
compute-end capacity, DRAM segments and — on XBOF+ — data-end channel time
(FLASH_BW) and CXL link bytes (LINK_BW) through the descriptor machinery
of `repro_torch.core`, the same code the serving engine runs: lenders
publish, borrowers claim in `ResourceManager.round()`, and the per-rtype
assist matrices turn claims into capacity transfers priced per op by
`core.costs` (the flat §5.3 constants behind `Platform.flat_sync=True`).

Latency is estimated per closed-loop I/O depth: a QD-q tester observes
latency ≈ max(unloaded service latency, q / throughput rate).

Layout: every state tensor carries a leading enclosure axis, ``[E, nl]``
per node and ``[E]`` per enclosure (the descriptor table ``[E, nl, S]``),
the port's counterpart of the reference's `jax.vmap` over enclosures; a
single JBOF is E = 1 with no fabric terms, the same code path. Sums over
nodes run over the last axis.

Where the reference's loop is one compiled `lax.scan`, the port's is a
Python loop of tensor operations that reads nothing back to the host: the
management gate and the warm-up mask are decided from the host's window
index, and the round runs only on management windows (the reference
computes it every window and keeps it only there; the round is a pure
function of the table and its inputs, so the table is the same). On a
trace-driven run each window is one launch of the SHARDS window kernel
(`kernels.ops.shards_window`) for every node of every enclosure.

The reference's compiled step divides by a constant as a product with its
float32 reciprocal; the port does the same (`_per`), so the quotients that
thresholds read land on the same values. Its other rewrites (FMA
contraction, folded constant factors, its order of sums) leave float
leaves an ulp or so apart.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from ..core import costs
from ..core import descriptors as desc
from ..core import events as ev_m
from ..core import harvest as hv
from ..core import manager as mgr
from ..core import shards_mrc
from ..core import topology as topo
from ..obs import export as obs_x
from ..obs import metrics as obs_m
from ..obs import spans as obs_s
from ..telemetry import want as tele_want
from ..telemetry import windows as tele_win
from . import ssd
from .platforms import Platform
from .workloads import Workload

_EPS = 1e-9
_PAGES_PER_SEGMENT = ssd.SEGMENT_BYTES // ssd.PAGE_BYTES
_INF = float("inf")

# Observability-plane registry (DESIGN.md §12), sim side: the per-window
# signals the rings capture without any host sync. All ring-only;
# counters record measured per-window deltas so their totals reconcile
# with the SimState accumulators.
SIM_METRICS = obs_m.MetricSet("jbof-sim")
for _nm in ("miss", "borrowed_seg", "spare_seg", "q_bytes",
            "proc_util", "flash_util", "link_util"):
    SIM_METRICS.gauge(_nm, per="node")
for _nm in ("served_bytes", "cxl_bytes", "log_commits"):
    SIM_METRICS.counter(_nm, per="node")
SIM_METRICS.counter("energy_j", per="scalar")
SIM_METRICS.histogram("latency", bins=16, lo=0.0, hi=4e-3)
del _nm

# Telemetry-plane defaults for trace-driven runs (DESIGN.md §7): segment-
# granular addresses, 1/4 spatial sampling and a ~6-window estimator
# memory so the want tracks phase changes.
SIM_TELEMETRY = tele_win.TelemetryConfig(
    k=128, buckets=64, sample_mod=4, sample_thresh=1, bucket_width=8,
    decay=0.85, min_total=4.0)
# The reference carries a one-entry dummy estimator through static runs
# (one pytree structure for its scan); the port carries none (`mrc=None`).
_NO_TELEMETRY = tele_win.TelemetryConfig(k=1, buckets=1)


def _per(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c`` as the compiled reference takes it:
    a product with the float32 reciprocal."""
    return x * mgr.recip32(c)


def _cdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c / x`` for a constant ``c`` as one float32 division (a Python
    number over a tensor would run as a reciprocal times the number)."""
    return torch.div(torch.full_like(x, c), x)


class WorkloadVec(NamedTuple):
    """Static per-SSD workload parameters as tensors [..., n]."""

    rb_cmd: torch.Tensor      # bytes per read command
    wb_cmd: torch.Tensor      # bytes per write command
    qd: torch.Tensor          # closed-loop I/O depth
    locality: torch.Tensor    # mapping-lookup rate per command
    mrc_c0: torch.Tensor
    mrc_beta: torch.Tensor
    mrc_cold: torch.Tensor
    uniform_mrc: torch.Tensor


def workload_vec(workloads: list[Workload], *, device=None) -> WorkloadVec:
    dev = resolve_device(device)

    def f(g):
        return torch.tensor(np.asarray([g(w) for w in workloads], np.float32),
                            device=dev)

    return WorkloadVec(
        rb_cmd=f(lambda w: max(w.read_kb, 0.1) * 1024.0),
        wb_cmd=f(lambda w: max(w.write_kb, 0.1) * 1024.0),
        qd=f(lambda w: w.qd),
        locality=f(lambda w: min(max(w.locality, 1.0 / 4096.0), 1.0)),
        mrc_c0=f(lambda w: w.mrc_c0),
        mrc_beta=f(lambda w: w.mrc_beta),
        mrc_cold=f(lambda w: w.mrc_cold),
        uniform_mrc=torch.tensor([w.uniform_mrc for w in workloads],
                                 dtype=torch.bool, device=dev),
    )


class FabricIn(NamedTuple):
    """Per-enclosure cross-fabric grants [E], settled one management round
    earlier (a one-round grant delay, as the descriptor tables inside one
    enclosure). PROCESSOR in lender-seconds, DRAM in segments."""

    proc_in: torch.Tensor   # lender-seconds granted to this enclosure
    proc_out: torch.Tensor  # lender-seconds drawn from this enclosure
    seg_in: torch.Tensor    # segments granted in across the fabric
    seg_out: torch.Tensor   # segments this enclosure lends out


class FabricOut(NamedTuple):
    """Per-enclosure post-local residuals [E] published to the fabric: spare
    it could still lend and want its local pool could not fill."""

    proc_spare: torch.Tensor
    proc_want: torch.Tensor
    seg_spare: torch.Tensor
    seg_want: torch.Tensor


def _pool_share(per_node: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    """Distribute a pool-level grant ``cap`` [E] over nodes [E, nl] ∝
    ``per_node`` (clipped at the pool total so nothing is conjured)."""
    pool = per_node.sum(dim=-1, keepdim=True)
    take = torch.minimum(cap[..., None], pool)
    return per_node * take / torch.clamp(pool, min=_EPS)


class SimState(NamedTuple):
    q_r: torch.Tensor           # [E, nl] read backlog bytes
    q_w: torch.Tensor           # [E, nl] write backlog bytes
    vh_debt: torch.Tensor       # [E, nl] bytes parked on lenders awaiting copyback
    borrowed_seg: torch.Tensor  # [E, nl] DRAM segments borrowed (XBOF §4.5)
    borrowed_far: torch.Tensor  # [E, nl] segments held across the fabric
    table: desc.IdleResourceTable  # [E, nl, S]
    # per-node windowed-SHARDS estimators ([E, nl, ...]) on trace-driven
    # runs, else None
    mrc: object
    # measured utilizations of the previous window (PMU polling): lend /
    # borrow triggers read OWN-work utilization, borrow gates EFFECTIVE
    # utilization (own + remote work over own + granted capacity)
    prev_proc_own: torch.Tensor   # [E, nl]
    prev_flash: torch.Tensor      # [E, nl] effective data-end util (PROCESSOR gate)
    prev_flash_own: torch.Tensor  # [E, nl] own-work data-end util (FLASH_BW trigger)
    prev_link: torch.Tensor       # [E, nl] effective link util (FLASH_BW gate)
    prev_link_own: torch.Tensor   # [E, nl] own-work link util (LINK_BW trigger)
    # accumulators
    served_r: torch.Tensor      # [E, nl] bytes
    served_w: torch.Tensor      # [E, nl] bytes
    proc_busy: torch.Tensor     # [E, nl] clock-seconds of compute-end work
    flash_busy: torch.Tensor    # [E, nl] channel-seconds
    host_busy: torch.Tensor     # [E] host clock-seconds
    flash_written: torch.Tensor  # [E, nl] bytes programmed (DWPD accounting)
    lat_sum: torch.Tensor       # [E, nl] sum(latency * served commands)
    cmd_count: torch.Tensor     # [E, nl] served commands
    log_commits: torch.Tensor   # [E, nl] WAL commits (XBOF)
    energy_j: torch.Tensor      # [E] total energy
    cxl_bytes: torch.Tensor     # [E, nl] inter-SSD traffic
    # (MetricsState, EventLog) with a leading [E] axis when the run has
    # ObsConfig(enabled=True), else None
    obs: object = None


class SimResult(NamedTuple):
    throughput_bps: torch.Tensor   # [n]
    read_bps: torch.Tensor         # [n]
    write_bps: torch.Tensor        # [n]
    latency_s: torch.Tensor        # [n] mean per-command latency
    proc_util: torch.Tensor        # [n]
    flash_util: torch.Tensor       # [n]
    miss_ratio: torch.Tensor       # [n] final mapping-table miss ratio
    dwpd: torch.Tensor             # [n] drive-writes-per-day equivalent
    energy_j: torch.Tensor
    host_util: torch.Tensor        # [] one enclosure, [E] several
    log_commits: torch.Tensor      # [n]
    cxl_bytes: torch.Tensor        # [n]
    borrowed_seg: torch.Tensor     # [n] final DRAM segments held via claims (§4.5)
    borrowed_far: torch.Tensor | None = None  # [n] final cross-fabric segments
    # per-window series {"borrowed_seg", "spare_seg"} [T, n]
    rings: dict | None = None
    # {"metrics", "totals", "events", "events_dropped"} with obs enabled
    obs: dict | None = None


def _miss_ratio(wv: WorkloadVec, cache_frac: torch.Tensor) -> torch.Tensor:
    param = torch.clamp(
        wv.mrc_cold + (1.0 - wv.mrc_cold)
        * torch.pow(1.0 + cache_frac / wv.mrc_c0, -wv.mrc_beta),
        0.0, 1.0)
    uniform = torch.minimum(torch.maximum(1.0 - cache_frac, wv.mrc_cold),
                            torch.ones_like(cache_frac))
    return torch.where(wv.uniform_mrc, uniform, param)


def static_want_frac(wv: WorkloadVec) -> torch.Tensor:
    """float32[..., n] — the §4.5 want fraction from the 33-point
    parametric MRC grid. Workload-static: evaluated once per run and fed to
    the step as data (trace-driven runs use the online estimate)."""
    grid = torch.linspace(0.0, 1.0, 33, dtype=torch.float32,
                          device=wv.rb_cmd.device)
    shape = (33,) + (1,) * wv.rb_cmd.dim()
    mgrid = _miss_ratio(wv, grid.reshape(shape).expand(33, *wv.rb_cmd.shape))
    return hv.want_fraction(mgrid, wv.locality, grid)


def _policies(plat: Platform) -> tuple[tuple[mgr.ResourcePolicy, ...], int]:
    """The platform's per-rtype policies: PROCESSOR slots first, then DRAM
    (XBOF, §4.5 segment lending), then FLASH_BW and LINK_BW (XBOF+), every
    harvested substrate through the same publish/claim machinery. Returns
    (policies, total_slots)."""
    pols = []
    s0 = 0
    if plat.harvest_proc:
        pols.append(mgr.ResourcePolicy(
            rtype=desc.PROCESSOR, slot0=0, slots=plat.n_slots,
            claim_rounds=plat.claim_rounds, watermark=plat.watermark,
            gate_watermark=plat.data_watermark,
            preserve_claims=True, gate_new_only=True))
        s0 = plat.n_slots
    if plat.harvest_dram:
        # DRAM "utilization" is the MRC-derived segment-need signal: > 1
        # iff the node wants segments; lenders publish their spare segments
        # as the amount; borrowing is gated on link headroom
        pols.append(mgr.ResourcePolicy(
            rtype=desc.DRAM, slot0=s0, slots=plat.dram_slots,
            claim_rounds=plat.claim_rounds, watermark=plat.watermark,
            gate_watermark=plat.link_watermark, min_amount=1.0,
            preserve_claims=True, gate_new_only=True))
        s0 += plat.dram_slots
    if plat.harvest_flash:
        pols.append(mgr.ResourcePolicy(
            rtype=desc.FLASH_BW, slot0=s0, slots=plat.flash_slots,
            claim_rounds=plat.claim_rounds, watermark=plat.watermark,
            gate_watermark=plat.link_watermark,
            preserve_claims=True, gate_new_only=True))
        s0 += plat.flash_slots
    if plat.harvest_link:
        pols.append(mgr.ResourcePolicy(
            rtype=desc.LINK_BW, slot0=s0, slots=plat.link_slots,
            claim_rounds=plat.claim_rounds, watermark=plat.watermark,
            preserve_claims=True, gate_new_only=True))
        s0 += plat.link_slots
    return tuple(pols), s0


def _manager(plat: Platform) -> mgr.ResourceManager:
    """The sim's management round: one ResourcePolicy per harvested rtype,
    `claim_rounds` sweeps each."""
    pols, total_slots = _policies(plat)
    return mgr.ResourceManager(mgr.ManagerConfig(
        n_slots=max(total_slots, 1), policies=pols))


def _any_harvest(plat: Platform) -> bool:
    return (plat.harvest_proc or plat.harvest_dram
            or plat.harvest_flash or plat.harvest_link)


def _unloaded_latency(wv: WorkloadVec, read: bool, miss, remote_frac,
                      offsite_frac, plat: Platform,
                      proc_ovh=ssd.SYNC_PROC_OVERHEAD,
                      far_frac=None, offsite_far=None):
    """Fig 14a decomposition: Host + Host-SSD + Processor + DRAM + Flash +
    Inter-SSD. ``proc_ovh``: fractional sync tax on redirected compute (the
    flat §5.3 constant under ``flat_sync``, else 0: the per-op model charges
    the §4.6 cost once, in the Inter-SSD term)."""
    io_bytes = wv.rb_cmd if read else wv.wb_cmd
    slices = torch.clamp(io_bytes / ssd.SLICE_BYTES, min=1.0)
    per_slice = ssd.C_READ_SLICE if read else ssd.C_WRITE_SLICE
    proc = _per(ssd.C_PARSE + slices * per_slice, ssd.CLOCK_HZ)
    proc = proc * (1.0 + proc_ovh * remote_frac)
    if plat.oc:
        proc = proc + ssd.C_HOST_FW / ssd.HOST_CLOCK_HZ
    remote_hit_s = costs.op_overhead_s(
        desc.DRAM, dequeue_s=plat.inter_ssd_op_s, hop_s=plat.cxl_hop_s)
    remote_hits_cmd = wv.locality * (1.0 - miss) * offsite_frac
    dram = ssd.DRAM_LOOKUP_S * slices + remote_hits_cmd * remote_hit_s
    far_extra_s = plat.fabric_extra_hops * plat.cxl_hop_s
    if offsite_far is not None:
        far_hits_cmd = wv.locality * (1.0 - miss) * offsite_far
        dram = dram + far_hits_cmd * far_extra_s
    xfer = _per(io_bytes, ssd.CHANNEL_BUS_BPS / ssd.N_CHANNELS)
    flash_t = ssd.T_READ_AVG if read else 8e-6  # write acks from PLP'd buffer
    flash = flash_t + xfer + miss * wv.locality * ssd.MAPPING_PAGE_READ_S
    inter = remote_frac * costs.op_overhead_s(
        desc.PROCESSOR, dequeue_s=plat.inter_ssd_op_s, hop_s=plat.cxl_hop_s)
    if far_frac is not None:
        inter = inter + far_frac * far_extra_s
    link = _per(io_bytes, ssd.CXL_BPS_PER_SSD) + ssd.T_HOST_SSD_CMD
    host = ssd.T_HOST_STACK + (
        plat.host_extra_clocks / ssd.HOST_CLOCK_HZ if not plat.oc else 0.0)
    return host + link + proc + dram + flash + inter


class _Run(NamedTuple):
    """Static knobs of one run's window step."""

    plat: Platform
    wv: WorkloadVec
    want_frac: torch.Tensor
    window_s: float
    warmup: int
    trace_driven: bool
    tcfg: tele_win.TelemetryConfig
    obs: obs_m.ObsConfig
    manager: mgr.ResourceManager
    # [E] int32 zeros: the event rows keep enclosure-local node ids (the
    # decode offsets them by lane), a tensor so no id is copied in the loop
    id_base: torch.Tensor | None = None


def _window_step(run: _Run, state: SimState, arr: torch.Tensor, trace,
                 step_idx: int, fabric: FabricIn | None = None,
                 ev: ev_m.NodeEvents | None = None):
    """One window for every enclosure ([E, nl] per node). ``arr``: [E, nl,
    2] byte arrivals; ``trace``: int64 [E, nl, A] mapping-page references
    (EMPTY_REF-padded) on trace-driven runs, else None; ``step_idx``: the
    window's index (a host integer: the management gate and the warm-up
    mask are decided on the host). ``fabric``: cross-enclosure grants, or
    None when the run is one enclosure (no fabric term at all). ``ev``:
    this window's failure/reclaim streams (bool [E, nl] each), or None
    when the run has no events (no event term at all): a dead node serves
    nothing, its capacities are zero and its standing descriptors and
    claims revoke in every window; a reclaiming lender is forced busy, so
    the ordinary §4.3/§4.4 machinery drains its grants.

    Returns ``(state, (miss, borrowed_seg, seg_spare, fabric_out,
    revoked))``, ``fabric_out`` None without a fabric and ``revoked``
    (int32 [E], descriptor slots revoked) None without events."""
    plat, wv, window_s = run.plat, run.wv, run.window_s
    nl = state.q_r.shape[-1]
    cfg = plat.ssd_config
    do_mgmt = step_idx % plat.mgmt_interval == 0

    # -------------------------------------------------- arrivals & backlog
    q_r = state.q_r + arr[..., 0]
    q_w = state.q_w + arr[..., 1]
    if ev is not None:
        # a dead SSD's backlog is lost with the device and it admits
        # nothing new; reclaiming lenders keep serving their own work
        q_r = torch.where(ev.dead, 0.0, q_r)
        q_w = torch.where(ev.dead, 0.0, q_w)
    # fluid backlog bound: 3x one-window peak capacity
    cap_bytes = (ssd.PEAK_READ_BPS + ssd.PEAK_WRITE_BPS) * window_s * 3.0
    q_r = torch.clamp(q_r, max=cap_bytes)
    q_w = torch.clamp(q_w, max=cap_bytes)

    cmds_r = q_r / wv.rb_cmd
    cmds_w = q_w / wv.wb_cmd
    slices_r = q_r / ssd.SLICE_BYTES
    slices_w = q_w / ssd.SLICE_BYTES

    # ------------------------------------------------------- DRAM / misses
    own_seg = float(cfg.dram_segments)
    seg_eff = own_seg + state.borrowed_seg
    if fabric is not None:
        seg_eff = seg_eff + state.borrowed_far
    mrc_state = state.mrc
    if run.trace_driven:
        # telemetry plane: fold this window's mapping-page references into
        # every node's windowed-SHARDS estimator at segment granularity and
        # read the miss ratio off the online curve at the current cache size
        with obs_x.scope("telemetry"):
            t_mask = trace != tele_win.EMPTY_REF
            seg_addr = torch.where(t_mask, trace // _PAGES_PER_SEGMENT, trace)
            mrc_state = tele_win.update_window(mrc_state, seg_addr, run.tcfg,
                                               mask=t_mask)
            miss = torch.clamp(
                tele_win.miss_at_batch(mrc_state, seg_eff, run.tcfg), 0.0, 1.0)
    else:
        cache_frac = torch.clamp(_per(seg_eff, float(ssd.SEGMENTS_FULL)), 0.0, 1.0)
        miss = _miss_ratio(wv, cache_frac)
    offsite_frac = torch.where(
        seg_eff > 0, state.borrowed_seg / torch.clamp(seg_eff, min=1.0), 0.0)
    offsite_far = None
    if fabric is not None:
        offsite_far = torch.where(
            seg_eff > 0, state.borrowed_far / torch.clamp(seg_eff, min=1.0), 0.0)
        offsite_frac = offsite_frac + offsite_far
    # mapping-table lookups that reach the cache, per command
    lookups = (cmds_r + cmds_w) * wv.locality
    miss_lookups = lookups * miss
    hit_lookups = lookups - miss_lookups

    # §4.5 MRC-derived lend/borrow amounts — the DRAM descriptors' inputs
    zeros = torch.zeros_like(q_r)
    seg_need = zeros
    seg_spare = zeros
    dram_util = zeros
    if plat.harvest_dram:
        min_keep = hv.DRAM_MIN_KEEP_SEGMENTS
        if run.trace_driven:
            # online want: the estimator's activity floor replaces the
            # arrival-rate test, so a node whose trace went quiet wants
            # min_keep again and returns its borrowed segments
            with obs_x.scope("telemetry"):
                est = tele_want.want_entries(mrc_state, run.tcfg,
                                             weight=wv.locality)
            want_seg = torch.clamp(est, min_keep, float(ssd.SEGMENTS_FULL))
            seg_need = torch.clamp(want_seg - own_seg, min=0.0)
        else:
            active = lookups > 1.0  # >1 mapping lookup per window
            want_seg = torch.where(active, run.want_frac * ssd.SEGMENTS_FULL,
                                   min_keep)
            seg_need = torch.where(
                active, torch.clamp(want_seg - own_seg, min=0.0), 0.0)
        seg_spare = torch.clamp(
            own_seg - torch.clamp(want_seg, min=min_keep), min=0.0)
        seg_spare_gross = seg_spare
        if fabric is not None:
            # segments already lent across the fabric are spoken for
            seg_spare = torch.clamp(
                seg_spare - _pool_share(seg_spare, fabric.seg_out), min=0.0)
        # the DRAM descriptors' "utilization": > watermark iff the node
        # wants segments, ordered by how starved it is
        dram_util = torch.where(
            seg_need > 0, 1.0 + _per(seg_need, float(ssd.SEGMENTS_FULL)), 0.0)
        if ev is not None:
            # a reclaiming (or dead) lender's segments are spoken for: zero
            # published spare drains its standing grants at this window's
            # transfer derivation; dead nodes also stop wanting
            force = ev.dead | ev.reclaim
            seg_spare = torch.where(force, 0.0, seg_spare)
            seg_spare_gross = torch.where(force, 0.0, seg_spare_gross)
            seg_need = torch.where(ev.dead, 0.0, seg_need)
            dram_util = torch.where(ev.dead, 0.0, dram_util)

    # ------------------------------------------------------ demand (times)
    ppc = (cmds_r * ssd.C_PARSE + slices_r * ssd.C_READ_SLICE
           + cmds_w * ssd.C_PARSE + slices_w * ssd.C_WRITE_SLICE
           + miss_lookups * ssd.C_MISS_EXTRA)
    ops = cmds_r + cmds_w
    ops_eps = torch.clamp(ops, min=_EPS)
    io_avg = (q_r + q_w) / ops_eps
    ppc_s = _per(ppc, ssd.CLOCK_HZ)
    proc_op_s = ppc_s / ops_eps
    # WAL commits for offsite metadata updates (writes touch the mapping)
    log_ops = slices_w * offsite_frac * (1.0 if plat.harvest_dram else 0.0)
    # a mapping-cache hit served from a borrowed segment pays the per-op
    # §4.6 DRAM price (CXL hop + remote dequeue/unwrap)
    remote_hit_s = costs.op_overhead_s(
        desc.DRAM, dequeue_s=plat.inter_ssd_op_s, hop_s=plat.cxl_hop_s)
    remote_hits = hit_lookups * offsite_frac
    proc_demand_s = ppc_s + log_ops * ssd.T_LOG_COMMIT + remote_hits * remote_hit_s
    remote_hits_far = None
    if fabric is not None:
        # a hit in a segment held across the fabric pays the tier-2 price
        remote_hits_far = hit_lookups * offsite_far
        far_hit_extra_s = (
            costs.tier_overhead_s(
                desc.DRAM, dequeue_s=plat.inter_ssd_op_s,
                hop_s=plat.cxl_hop_s, extra_hops=plat.fabric_extra_hops)
            - remote_hit_s)
        proc_demand_s = proc_demand_s + remote_hits_far * far_hit_extra_s

    pages_r = q_r / ssd.PAGE_BYTES
    small_w = wv.wb_cmd < ssd.PAGE_BYTES
    amp = torch.where(small_w, ssd.SLC_AMP_SMALL_WRITE, 1.0)
    pages_w = q_w / ssd.PAGE_BYTES * amp
    # WAL log-page flush-backs: every 512 commits flushes one 2 MB segment
    log_flush_pages = log_ops / 512.0 * (ssd.SEGMENT_BYTES / ssd.PAGE_BYTES)
    flash_time = (_per(pages_r, ssd.F_READ_PAGES)
                  + _per(pages_w, ssd.F_PROG_PAGES)
                  + _per(miss_lookups, ssd.F_READ_PAGES)   # mapping-page fetches
                  + _per(log_flush_pages, ssd.F_PROG_PAGES))

    host_clocks = (cmds_r + cmds_w) * (ssd.C_HOST_DRIVER + plat.host_extra_clocks)
    if plat.oc:  # firmware runs on the host pool, with kernel-stack inefficiency
        host_clocks = host_clocks + ppc * ssd.OC_HOST_INEFF
    # remote-lookup bytes ride the LINK_BW account (payload compresses at
    # the platform's ratio)
    lookup_bytes = costs.op_link_bytes(
        desc.DRAM, cmd_bytes=plat.remote_lookup_bytes * plat.payload_comp_ratio)
    link_time = _per(q_r + q_w + remote_hits * lookup_bytes, ssd.CXL_BPS_PER_SSD)
    far_lookup_extra_b = 0.0
    if fabric is not None:
        # fabric-tier lookups re-cross the port once per extra hop
        far_lookup_extra_b = (
            costs.tier_link_bytes(
                desc.DRAM,
                cmd_bytes=plat.remote_lookup_bytes * plat.payload_comp_ratio,
                extra_hops=plat.fabric_extra_hops)
            - lookup_bytes)
        link_time = link_time + _per(remote_hits_far * far_lookup_extra_b,
                                     ssd.CXL_BPS_PER_SSD)

    # -------------------------------------------------------- capacities
    proc_cap = (0.0 if plat.oc else cfg.proc_clocks_per_s / ssd.CLOCK_HZ) * window_s
    proc_cap_s = torch.full_like(q_r, proc_cap)
    flash_cap_s = torch.full_like(q_r, window_s)
    if ev is not None:
        proc_cap_s = torch.where(ev.dead, 0.0, proc_cap_s)
        flash_cap_s = torch.where(ev.dead, 0.0, flash_cap_s)

    # ---------------------------------- management round (§4.3, all rtypes)
    assist_in = zeros
    used_from = None
    remote_frac = zeros
    table = state.table
    revoked = None
    if ev is not None:
        # failure-forced §4.3 invalidation: a dead node's published slots
        # go invalid and its held claims release NOW, every window — not
        # at the next management round
        table, revoked = mgr.revoke_nodes(table, ev.dead)
    any_harvest = _any_harvest(plat)
    if any_harvest and do_mgmt:
        # trigger utilizations: measured (previous window); lender triggers
        # read OWN-work utilization
        proc_est, flash_est, link_est = (state.prev_proc_own, state.prev_flash,
                                         state.prev_link)
        flash_own, link_own = state.prev_flash_own, state.prev_link_own
        if ev is not None:
            # a reclaiming node reads saturated on every lend trigger; a
            # dead one on trigger AND gate, so it neither lends nor borrows
            force = ev.dead | ev.reclaim
            proc_est = torch.where(force, 1.0, proc_est)
            flash_own = torch.where(force, 1.0, flash_own)
            link_own = torch.where(force, 1.0, link_own)
            flash_est = torch.where(ev.dead, 1.0, flash_est)
            link_est = torch.where(ev.dead, 1.0, link_est)
        inputs = {}
        if plat.harvest_proc:
            inputs[desc.PROCESSOR] = mgr.RoundInputs(util=proc_est,
                                                     gate_util=flash_est)
        if plat.harvest_dram:
            inputs[desc.DRAM] = mgr.RoundInputs(
                util=dram_util, gate_util=link_est, amount=seg_spare)
        if plat.harvest_flash:
            inputs[desc.FLASH_BW] = mgr.RoundInputs(
                util=flash_own, gate_util=link_est,
                amount=torch.clamp(1.0 - flash_own, min=0.0) * window_s)
        if plat.harvest_link:
            inputs[desc.LINK_BW] = mgr.RoundInputs(
                util=link_own,
                amount=torch.clamp(1.0 - link_own, min=0.0) * window_s)
        table = run.manager.round(table, inputs)

    # ------------------------------------------ processor harvesting (§4.4)
    if plat.flat_sync:
        proc_ovh = ssd.SYNC_PROC_OVERHEAD
    else:
        proc_ovh = costs.overhead_frac(
            desc.PROCESSOR, proc_op_s,
            dequeue_s=plat.inter_ssd_op_s, hop_s=plat.cxl_hop_s)
    far_in = far_out = far_frac = None
    proc_resid_spare = proc_resid_want = None
    if plat.harvest_proc:
        M = run.manager.assist_matrix(table, desc.PROCESSOR)  # [E, lender, borrower]
        surplus = torch.clamp(proc_cap_s - proc_demand_s, min=0.0)
        deficit = torch.clamp(proc_demand_s - proc_cap_s, min=0.0)
        assist_in, used_from, proc_lent = mgr.fluid_transfer(
            M, surplus, deficit, proc_ovh, lent=True)
        remote_frac = torch.where(
            proc_demand_s > 0,
            assist_in / torch.clamp(proc_demand_s, min=_EPS), 0.0)
        if not plat.flat_sync:
            # §4.4 redirection command descriptors ride the LINK_BW account
            red_ops = assist_in / torch.clamp(proc_op_s, min=_EPS)
            link_time = link_time + _per(
                red_ops * costs.op_link_bytes(desc.PROCESSOR), ssd.CXL_BPS_PER_SSD)
        if fabric is not None:
            # the fabric level: grants settled one management round ago;
            # a far-redirected command pays extra traversals per op
            per_op_far = costs.tier_overhead_s(
                desc.PROCESSOR, dequeue_s=plat.inter_ssd_op_s,
                hop_s=plat.cxl_hop_s, extra_hops=plat.fabric_extra_hops)
            ovh_far = torch.clamp(
                _cdiv(per_op_far, torch.clamp(proc_op_s, min=_EPS)), 0.0, 1e3)
            out_rem = torch.where(
                state.prev_proc_own <= plat.watermark,
                torch.clamp(surplus - proc_lent, min=0.0), 0.0)
            far_out = _pool_share(out_rem, fabric.proc_out)
            resid_def = torch.clamp(deficit - assist_in, min=0.0)
            far_gross = _pool_share(resid_def * (1.0 + ovh_far), fabric.proc_in)
            far_in = far_gross / (1.0 + ovh_far)
            far_frac = torch.where(
                proc_demand_s > 0,
                far_in / torch.clamp(proc_demand_s, min=_EPS), 0.0)
            remote_frac = remote_frac + far_frac
            if not plat.flat_sync:
                red_far = far_in / torch.clamp(proc_op_s, min=_EPS)
                link_time = link_time + _per(
                    red_far * costs.tier_link_bytes(
                        desc.PROCESSOR, extra_hops=plat.fabric_extra_hops),
                    ssd.CXL_BPS_PER_SSD)
            # residuals GROSS of the held fabric grants: each management
            # round re-settles the whole assignment
            proc_resid_spare = out_rem.sum(dim=-1)
            proc_resid_want = resid_def.sum(dim=-1)

    # --------------------------------------------- DRAM harvesting (§4.5)
    borrowed_seg = state.borrowed_seg
    borrowed_far = state.borrowed_far
    seg_resid_spare = seg_resid_want = None
    if plat.harvest_dram:
        Md = run.manager.assist_matrix(table, desc.DRAM)  # [E, lender, borrower]
        if fabric is None:
            borrowed_seg, _ = mgr.fluid_transfer(Md, seg_spare, seg_need)
        else:
            borrowed_seg, _, seg_lent = mgr.fluid_transfer(
                Md, seg_spare, seg_need, lent=True)
            # fabric segments cover what the local round could not
            resid_need = torch.clamp(seg_need - borrowed_seg, min=0.0)
            borrowed_far = _pool_share(resid_need, fabric.seg_in)
            seg_resid_spare = torch.clamp(
                seg_spare_gross - seg_lent, min=0.0).sum(dim=-1)
            seg_resid_want = resid_need.sum(dim=-1)

    # ------------------------------------------------ VH write redirection
    vh_debt = state.vh_debt
    vh_extra_flash = zeros
    vh_redirect_bytes = zeros
    drain_bytes = zeros
    if plat.vh:
        flash_over = torch.clamp(flash_time - flash_cap_s, min=0.0)
        w_share = _per(pages_w, ssd.F_PROG_PAGES) / torch.clamp(flash_time, min=_EPS)
        overflow_w_time = flash_over * w_share
        overflow_bytes = overflow_w_time * ssd.F_PROG_PAGES * ssd.PAGE_BYTES
        lender_spare_t = torch.clamp(flash_cap_s - flash_time, min=0.0) * 0.9
        pool_t = lender_spare_t.sum(dim=-1, keepdim=True)
        frac = torch.clamp(
            pool_t / torch.clamp(overflow_w_time.sum(dim=-1, keepdim=True), min=_EPS),
            max=1.0)
        granted_t = overflow_w_time * frac
        vh_redirect_bytes = torch.where(overflow_w_time > 0, overflow_bytes * frac, 0.0)
        absorb = torch.where(
            pool_t > 0, lender_spare_t / torch.clamp(pool_t, min=_EPS), 0.0
        ) * granted_t.sum(dim=-1, keepdim=True)
        vh_extra_flash = absorb
        flash_time = flash_time - granted_t
        if plat.vh_copyback:
            vh_debt = vh_debt + vh_redirect_bytes
            # the hypervisor drains debt continuously, reserving up to 30 %
            # of the borrower backbone
            reserve_t = torch.minimum(
                _per(vh_debt / ssd.PAGE_BYTES, ssd.F_PROG_PAGES), flash_cap_s * 0.3)
            drain_bytes = reserve_t * ssd.F_PROG_PAGES * ssd.PAGE_BYTES
            drain_bytes = torch.minimum(drain_bytes, vh_debt)
            flash_time = flash_time + _per(drain_bytes / ssd.PAGE_BYTES,
                                           ssd.F_PROG_PAGES)
            vh_extra_flash = vh_extra_flash + _per(drain_bytes / ssd.PAGE_BYTES,
                                                   ssd.F_READ_PAGES)
            vh_debt = vh_debt - drain_bytes

    flash_time_total = flash_time + vh_extra_flash

    # ------------------------------- data-end (backbone) harvesting (§3/§4)
    flash_assist_in = zeros
    flash_used_from = None
    flash_cap_eff = flash_cap_s
    flash_rate = torch.full_like(q_r, ssd.FLASH_ASSIST_BPS)
    if plat.harvest_flash:
        Mf = run.manager.assist_matrix(table, desc.FLASH_BW)
        f_surplus = torch.clamp(flash_cap_s - flash_time_total, min=0.0)
        f_deficit = torch.clamp(flash_time_total - flash_cap_s, min=0.0)
        if plat.flat_sync:
            flash_ovh = ssd.SYNC_FLASH_OVERHEAD
        else:
            flash_op_s = flash_time_total / ops_eps
            flash_ovh = costs.overhead_frac(
                desc.FLASH_BW, flash_op_s,
                dequeue_s=plat.inter_ssd_op_s, hop_s=plat.cxl_hop_s)
            flash_rate = costs.assist_link_bps(
                desc.FLASH_BW, io_avg, flash_op_s,
                payload_ratio=plat.payload_comp_ratio)
        flash_assist_in, flash_used_from, f_out = mgr.fluid_transfer(
            Mf, f_surplus, f_deficit, flash_ovh, lent=True)
        flash_cap_eff = flash_cap_s + flash_assist_in - f_out
        # both endpoints' ports carry the redirected payload
        link_time = link_time + _per(
            flash_assist_in * flash_rate
            + torch.matmul(flash_used_from, flash_rate[..., None])[..., 0],
            ssd.CXL_BPS_PER_SSD)

    # ------------------------------------- CXL link harvesting (pooled BW)
    link_assist_in = zeros
    link_used_from = None
    link_cap_eff = torch.full_like(q_r, window_s)
    if plat.harvest_link:
        Ml = run.manager.assist_matrix(table, desc.LINK_BW)
        l_surplus = torch.clamp(window_s - link_time, min=0.0)
        l_deficit = torch.clamp(link_time - window_s, min=0.0)
        if plat.flat_sync:
            link_ovh = ssd.SYNC_LINK_OVERHEAD
        else:
            link_op_s = link_time / ops_eps
            link_ovh = costs.overhead_frac(
                desc.LINK_BW, link_op_s,
                dequeue_s=plat.inter_ssd_op_s, hop_s=plat.cxl_hop_s)
        link_assist_in, link_used_from, l_out = mgr.fluid_transfer(
            Ml, l_surplus, l_deficit, link_ovh, lent=True)
        link_cap_eff = link_cap_eff + link_assist_in - l_out

    # ------------------------------------------------------- joint service
    proc_cap_eff = proc_cap_s + assist_in
    if used_from is not None:
        proc_cap_eff = proc_cap_eff - proc_lent
    if fabric is not None and far_in is not None:
        proc_cap_eff = proc_cap_eff + far_in - far_out
    if plat.oc:
        s_proc = torch.full_like(q_r, _INF)
    else:
        s_proc = proc_cap_eff / torch.clamp(proc_demand_s, min=_EPS)
    s_flash = flash_cap_eff / torch.clamp(flash_time_total, min=_EPS)
    s_link = link_cap_eff / torch.clamp(link_time, min=_EPS)
    host_demand = _per(host_clocks.sum(dim=-1), ssd.HOST_CLOCKS_PER_S)   # [E]
    s_host = torch.where(host_demand > 0,
                         _cdiv(window_s, torch.clamp(host_demand, min=_EPS)), _INF)
    scale = torch.clamp(
        torch.minimum(torch.minimum(s_proc, s_flash),
                      torch.minimum(s_link, s_host[..., None])),
        0.0, 1.0)

    served_r = q_r * scale
    served_w = q_w * scale
    q_r = q_r - served_r
    q_w = q_w - served_w

    # ------------------------------------------------------ accounting
    # own capacity runs first, the overflow ran on lenders, donated time
    # charged by actual usage
    own_done, remote_done, out_done = _busy(
        proc_demand_s * scale, proc_cap_s, assist_in, used_from)
    proc_busy = own_done + out_done
    f_own_done, f_remote_done, f_out_done = _busy(
        flash_time_total * scale, flash_cap_s, flash_assist_in, flash_used_from)
    flash_busy = f_own_done + f_out_done
    l_own_done, l_remote_done, l_out_done = _busy(
        link_time * scale, torch.full_like(q_r, window_s),
        link_assist_in, link_used_from)
    link_busy = l_own_done + l_out_done

    srv_cmds = served_r / wv.rb_cmd + served_w / wv.wb_cmd
    lat_proc_ovh = ssd.SYNC_PROC_OVERHEAD if plat.flat_sync else 0.0
    far_lat = {} if fabric is None else dict(
        far_frac=far_frac if far_frac is not None else zeros,
        offsite_far=offsite_far)
    base_lat_r = _unloaded_latency(wv, True, miss, remote_frac, offsite_frac,
                                   plat, proc_ovh=lat_proc_ovh, **far_lat)
    base_lat_w = _unloaded_latency(wv, False, miss, remote_frac, offsite_frac,
                                   plat, proc_ovh=lat_proc_ovh, **far_lat)
    # closed-loop QD latency: lat = max(base, qd / per-cmd service rate)
    rate_cmds = torch.clamp(_per(srv_cmds, window_s), min=_EPS)
    lat_r = torch.maximum(base_lat_r, wv.qd / rate_cmds)
    lat_w = torch.maximum(base_lat_w, wv.qd / rate_cmds)
    lat = torch.where(
        srv_cmds > 0,
        (served_r / wv.rb_cmd * lat_r + served_w / wv.wb_cmd * lat_w)
        / torch.clamp(srv_cmds, min=_EPS),
        0.0)

    flash_written = (served_w * amp + drain_bytes + vh_redirect_bytes
                     + log_flush_pages * scale * ssd.PAGE_BYTES)

    # energy (coarse, §5.3 parameters)
    e_flash = (
        (served_r / ssd.PAGE_BYTES) * ssd.T_READ_AVG
        + (flash_written / ssd.PAGE_BYTES) * ssd.T_PROG_AVG
    ) * ssd.FLASH_V * ssd.I_READ
    e_proc = proc_busy * ssd.SSD_PROC_W_FULL * (
        cfg.cores / ssd.CONV_CORES if cfg.cores else 1.0)
    e_dram = (served_r + served_w) * 8 * ssd.E_DRAM_PJ_PER_BIT * 1e-12
    if plat.flat_sync:
        # pre-refactor accounting: 64 B per redirected slice
        proc_cmd_bytes = _per(remote_done * ssd.CLOCK_HZ,
                              max(ssd.C_READ_SLICE, 1.0)) * 64.0
    else:
        # per-op §4.6 accounting: command descriptors per redirected command
        proc_cmd_bytes = remote_done / torch.clamp(proc_op_s, min=_EPS) \
            * costs.op_link_bytes(desc.PROCESSOR)
    cxl_traffic = (proc_cmd_bytes
                   + log_ops * scale * 64.0 + vh_redirect_bytes + drain_bytes
                   + f_remote_done * flash_rate
                   + remote_hits * scale * lookup_bytes)
    if fabric is not None:
        # inter-JBOF traffic: far-redirected command descriptors at the
        # tier-2 byte price, plus the fabric re-crossings of far lookups
        far_cmd = zeros if far_in is None else far_in / torch.clamp(
            proc_op_s, min=_EPS) * costs.tier_link_bytes(
                desc.PROCESSOR, extra_hops=plat.fabric_extra_hops)
        cxl_traffic = cxl_traffic + scale * (
            far_cmd + remote_hits_far * far_lookup_extra_b)
    e_cxl = cxl_traffic * 8 * ssd.E_CXL_PJ_PER_BIT * 1e-12
    e_idle = (window_s * nl) * ssd.FLASH_V * ssd.I_BUSIDLE
    energy = (e_flash + e_proc + e_dram + e_cxl).sum(dim=-1) + e_idle   # [E]

    measure = step_idx >= run.warmup
    proc_own_util = torch.where(
        proc_cap_s > 0, own_done / torch.clamp(proc_cap_s, min=_EPS), 0.0)
    flash_eff_util = (flash_busy + f_remote_done) \
        / torch.clamp(flash_cap_s + flash_assist_in, min=_EPS)
    link_eff_util = (link_busy + l_remote_done) / (window_s + link_assist_in)

    # ------------------------------------------- observability (§12, opt-in)
    obs_state = state.obs
    if run.obs.enabled:
        with obs_x.scope("obs_record"):
            ms, elog = state.obs
            m = 1.0 if measure else 0.0
            ms = SIM_METRICS.record(ms, {
                "miss": miss,
                "borrowed_seg": borrowed_seg,
                "spare_seg": seg_spare,
                "q_bytes": q_r + q_w,
                "proc_util": proc_own_util,
                "flash_util": flash_eff_util,
                "link_util": link_eff_util,
                "served_bytes": m * (served_r + served_w),
                "cxl_bytes": m * cxl_traffic,
                "log_commits": m * (log_ops * scale),
                "energy_j": m * energy,
                "latency": lat,
            })
            if any_harvest and (do_mgmt or ev is not None):
                # grant lifecycle from the table diff (held windows without
                # events add no row: the table did not change)
                rows, emask = obs_s.table_event_rows(
                    state.table, table, step_idx, base=run.id_base)
                elog = obs_s.append(elog, rows, emask)
            obs_state = (ms, elog)

    def acc(total, delta):
        return total + delta if measure else total

    new_state = SimState(
        q_r=q_r, q_w=q_w, vh_debt=vh_debt, borrowed_seg=borrowed_seg,
        borrowed_far=borrowed_far, table=table,
        mrc=mrc_state,
        prev_proc_own=proc_own_util,
        prev_flash=flash_eff_util,
        prev_flash_own=f_own_done / torch.clamp(flash_cap_s, min=_EPS),
        prev_link=link_eff_util,
        prev_link_own=_per(l_own_done, window_s),
        obs=obs_state,
        served_r=acc(state.served_r, served_r),
        served_w=acc(state.served_w, served_w),
        proc_busy=acc(state.proc_busy, proc_busy),
        flash_busy=acc(state.flash_busy, flash_busy),
        host_busy=acc(state.host_busy,
                      host_demand * _per(scale.sum(dim=-1), nl)),
        flash_written=acc(state.flash_written, flash_written),
        lat_sum=acc(state.lat_sum, lat * srv_cmds),
        cmd_count=acc(state.cmd_count, srv_cmds),
        log_commits=acc(state.log_commits, log_ops * scale),
        energy_j=acc(state.energy_j, energy),
        cxl_bytes=acc(state.cxl_bytes, cxl_traffic),
    )
    fout = None
    if fabric is not None:
        z = torch.zeros_like(q_r[..., 0])
        fout = FabricOut(
            proc_spare=z if proc_resid_spare is None else proc_resid_spare,
            proc_want=z if proc_resid_want is None else proc_resid_want,
            seg_spare=z if seg_resid_spare is None else seg_resid_spare,
            seg_want=z if seg_resid_want is None else seg_resid_want)
    return new_state, (miss, borrowed_seg, seg_spare, fout, revoked)


def _busy(work, cap, assist_in, used_from):
    """`manager.busy_split`, or its value with no grant (used_from None:
    nothing was transferred, all work ran on own capacity)."""
    if used_from is None:
        remote = torch.minimum(torch.clamp(work - cap, min=0.0), assist_in)
        own = torch.minimum(torch.clamp(work - remote, min=0.0), cap)
        return own, remote, torch.zeros_like(work)
    return mgr.busy_split(work, cap, assist_in, used_from)


def _init_state(plat: Platform, e: int, nl: int, tcfg, trace_driven: bool,
                obs: obs_m.ObsConfig, device) -> SimState:
    """Fresh state for ``e`` enclosures of ``nl`` SSDs each."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def stack(x):
        return x.unsqueeze(0).expand(e, *x.shape).clone()

    obs_state = None
    if obs.enabled:
        ms = SIM_METRICS.init(nl, obs, device=device)
        log = obs_s.make_log(obs.event_capacity, device=device)
        obs_state = (obs_m.MetricsState(
            cursor=stack(ms.cursor),
            rings={k: stack(v) for k, v in ms.rings.items()},
            totals={k: stack(v) for k, v in ms.totals.items()}),
            obs_s.EventLog(buf=stack(log.buf), count=stack(log.count)))
    table = _manager(plat).init_table(nl, device=device)
    return SimState(
        obs=obs_state,
        q_r=z(e, nl), q_w=z(e, nl), vh_debt=z(e, nl),
        borrowed_seg=z(e, nl), borrowed_far=z(e, nl),
        table=desc.IdleResourceTable(*(stack(x) for x in table)),
        mrc=(shards_mrc.init(tcfg.k, tcfg.buckets, lead=(e, nl), device=device)
             if trace_driven else None),
        prev_proc_own=z(e, nl), prev_flash=z(e, nl), prev_flash_own=z(e, nl),
        prev_link=z(e, nl), prev_link_own=z(e, nl),
        served_r=z(e, nl), served_w=z(e, nl), proc_busy=z(e, nl),
        flash_busy=z(e, nl), host_busy=z(e), flash_written=z(e, nl),
        lat_sum=z(e, nl), cmd_count=z(e, nl), log_commits=z(e, nl),
        energy_j=z(e), cxl_bytes=z(e, nl),
    )


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """One frozen bundle for every `simulate` run knob."""

    window_s: float = 1e-3
    warmup: int = 50
    # mapping-page references [T, n, A] (uint32 values, EMPTY_REF-padded;
    # NumPy or a tensor), as `telemetry.traces.synth_trace` makes them
    traces: object = None
    telemetry: tele_win.TelemetryConfig = SIM_TELEMETRY
    n_enclosures: int = 1
    fabric_federation: bool = True
    obs: obs_m.ObsConfig = obs_m.ObsConfig()
    # failure/reclaim schedule (`core.events.schedule(...)`); None or an
    # empty schedule runs without an event term
    events: ev_m.EventSchedule | None = None


class Trajectory(NamedTuple):
    """What the window loop leaves: the final state ([E, nl] leaves), the
    per-window series [T, E, nl] and the fabric's grant log (None unless
    federated with obs on)."""

    state: SimState
    miss: torch.Tensor
    borrowed_seg: torch.Tensor
    spare_seg: torch.Tensor
    fabric_log: object
    warmup: int
    # float32 [T] descriptor slots plus fabric-grant units revoked a window
    # on runs with events, else None
    revoked: torch.Tensor | None = None


class Prepared(NamedTuple):
    """A run on its device, before its first window: the step's static
    knobs, the initial state and the inputs, every tensor already where
    the loop reads it (`prepare`)."""

    plat: Platform
    cfg: SimConfig
    run: _Run
    state: SimState
    arrivals: torch.Tensor   # [T, E, nl, 2]
    traces: object           # int64 [T, E, nl, A] on trace-driven runs, else None
    # `core.events.EventArrays` (reclaim, dead [T, E, nl]; drop [T, E]) on
    # runs with events, else None
    events: object = None


def prepare(plat: Platform, workloads: list[Workload], arrivals,
            cfg: SimConfig | None = None, *, device=None) -> Prepared:
    """Everything before the window loop: the workload vector, the static
    want grid, the initial state, and the arrivals, traces and event
    streams copied to ``device`` (the only host-to-device copies of a
    run)."""
    cfg = SimConfig() if cfg is None else cfg
    dev = resolve_device(device)
    arr = (arrivals if isinstance(arrivals, torch.Tensor)
           else torch.from_numpy(np.array(arrivals, dtype=np.float32)))
    arr = arr.to(device=dev, dtype=torch.float32)
    n_win, n = arr.shape[0], arr.shape[1]
    e = max(cfg.n_enclosures, 1)
    if n % e:
        raise ValueError(f"n_enclosures={e} must divide the {n} SSDs evenly")
    nl = n // e
    wv = WorkloadVec(*(x.reshape(e, nl) for x in workload_vec(workloads, device=dev)))
    trace_driven = cfg.traces is not None and plat.harvest_dram
    tcfg = cfg.telemetry if trace_driven else _NO_TELEMETRY
    want_frac = (static_want_frac(wv)
                 if plat.harvest_dram and not trace_driven
                 else torch.zeros((e, nl), dtype=torch.float32, device=dev))
    trc = None
    if trace_driven:
        t = cfg.traces
        t = (t.to(torch.int64) if isinstance(t, torch.Tensor)
             else torch.from_numpy(np.asarray(t).astype(np.int64)))
        trc = (t & 0xFFFFFFFF).to(dev).reshape(t.shape[0], e, nl, -1)
    run = _Run(plat=plat, wv=wv, want_frac=want_frac, window_s=cfg.window_s,
               warmup=min(cfg.warmup, max(n_win - 1, 0)),
               trace_driven=trace_driven, tcfg=tcfg, obs=cfg.obs,
               manager=_manager(plat),
               id_base=torch.zeros(e, dtype=torch.int32, device=dev))
    state = _init_state(plat, e, nl, tcfg, trace_driven, cfg.obs, dev)
    events = None
    if cfg.events:
        ev = ev_m.compile(cfg.events, n_win, n, e, device=dev)
        events = ev._replace(reclaim=ev.reclaim.reshape(n_win, e, nl),
                             dead=ev.dead.reshape(n_win, e, nl))
    return Prepared(plat=plat, cfg=cfg, run=run, state=state,
                    arrivals=arr.reshape(n_win, e, nl, -1), traces=trc,
                    events=events)


def run_prepared(p: Prepared) -> Trajectory:
    """The window loop: one `_window_step` a window, the fabric level every
    management interval. Copies nothing to or from the host."""
    plat, cfg, run, state = p.plat, p.cfg, p.run, p.state
    dev = state.q_r.device
    e = state.q_r.shape[0]
    fabric = None
    federate = e > 1 and cfg.fabric_federation
    flog = None
    if e > 1:
        fabric = FabricIn(*(torch.zeros(e, dtype=torch.float32, device=dev)
                            for _ in range(4)))
        ftopo = topo.flat(e)
        if cfg.obs.enabled and federate:
            # fabric-tier grant events ride their own single-lane log
            flog = obs_s.make_log(cfg.obs.event_capacity, device=dev)
        price_p = float(costs.tier_link_bytes(
            desc.PROCESSOR, extra_hops=plat.fabric_extra_hops))
        price_s = float(costs.tier_link_bytes(
            desc.DRAM, cmd_bytes=plat.remote_lookup_bytes * plat.payload_comp_ratio,
            extra_hops=plat.fabric_extra_hops))

    evs = p.events
    miss_h, bseg_h, spare_h, rev_h = [], [], [], []
    for i in range(p.arrivals.shape[0]):
        ne = dr = rev_fab = None
        if evs is not None:
            ne = ev_m.NodeEvents(reclaim=evs.reclaim[i], dead=evs.dead[i])
            if fabric is not None:
                # an enclosure dropping off the fabric invalidates its
                # standing inbound and outbound fabric grants; zeroing the
                # carry makes the tally tick exactly at the transition
                dr = evs.drop[i]
                rev_fab = 0
                for a in fabric:
                    rev_fab = rev_fab + torch.where(dr, a, 0.0).sum()
                fabric = FabricIn(*(torch.where(dr, 0.0, a) for a in fabric))
        state, (miss, bseg, sspare, fout, rev) = _window_step(
            run, state, p.arrivals[i], None if p.traces is None else p.traces[i],
            i, fabric, ne)
        miss_h.append(miss)
        bseg_h.append(bseg)
        spare_h.append(sspare)
        if dr is not None:
            # a dropped enclosure neither publishes upward nor draws back
            fout = FabricOut(*(torch.where(dr, 0.0, a) for a in fout))
        if federate and i % plat.mgmt_interval == 0:
            # the fabric level of the topology plane settles the
            # enclosures' residuals; grants hold for one management interval
            with obs_x.scope("fabric_exchange"):
                gp, rp = topo.hierarchical_exchange(fout.proc_spare, fout.proc_want, ftopo)
                gs, rs = topo.hierarchical_exchange(fout.seg_spare, fout.seg_want, ftopo)
                if dr is not None:
                    # exactly the dropped block's cross-level grants die
                    gp, rel_p = topo.invalidate_block_grants(gp, dr)
                    gs, rel_s = topo.invalidate_block_grants(gs, dr)
                    rp = torch.where(dr[None, :], 0.0, rp)
                    rs = torch.where(dr[None, :], 0.0, rs)
                    rev_fab = rev_fab + rel_p + rel_s
                fabric = FabricIn(proc_in=rp.sum(dim=0), proc_out=gp.sum(dim=(0, 2)),
                                  seg_in=rs.sum(dim=0), seg_out=gs.sum(dim=(0, 2)))
            if flog is not None:
                with obs_x.scope("obs_record"):
                    # lender/borrower columns carry ENCLOSURE ids
                    for grants, rt, pr in ((gp[0], desc.PROCESSOR, price_p),
                                           (gs[0], desc.DRAM, price_s)):
                        rows, gmask = obs_s.grant_event_rows(
                            grants, rtype=rt, level=2, t=i,
                            code=obs_s.FABRIC_GRANT, price=pr)
                        flog = obs_s.append(flog, rows, gmask)
        if rev is not None:
            rev = rev.sum(dtype=torch.int32).to(torch.float32)
            rev_h.append(rev if rev_fab is None else rev + rev_fab)
    return Trajectory(state=state, miss=torch.stack(miss_h),
                      borrowed_seg=torch.stack(bseg_h),
                      spare_seg=torch.stack(spare_h), fabric_log=flog,
                      warmup=run.warmup,
                      revoked=torch.stack(rev_h) if rev_h else None)


def simulate(plat: Platform, workloads: list[Workload], arrivals,
             cfg: SimConfig | None = None, *, device=None, **legacy) -> SimResult:
    """Run the platform over the arrival matrix (float32 [T, n, 2] byte
    demands, NumPy or a tensor); return per-SSD metrics.

    Run knobs ride one frozen `SimConfig` (``cfg=``), and nothing else:
    the reference's deprecated keyword shim is not carried over, so a bare
    run knob raises ``TypeError``. ``device``: where the run's tensors live
    (CUDA unless told otherwise; `repro_torch.resolve_device`).

    The first ``warmup`` windows are simulated but excluded from the
    accumulators. ``traces`` switches a DRAM-harvesting platform to
    trace-driven mode (the online windowed-SHARDS want; ignored on
    platforms without DRAM harvesting). ``obs`` records every
    `SIM_METRICS` metric into rings and the grant-lifecycle events into a
    bounded log, decoded into `SimResult.obs` at the end. ``n_enclosures``
    > 1 splits the SSDs into that many enclosures of ``n // n_enclosures``,
    each with its own descriptor machinery, federating (spare, want)
    residuals through the topology plane's fabric level once per
    management interval (``fabric_federation=False``: isolated).
    `SimResult.host_util` is then per enclosure ([E]) and `energy_j`
    summed.
    """
    if legacy:
        raise TypeError(
            f"simulate() takes its run knobs in cfg=SimConfig(...) only; got "
            f"keyword arguments {sorted(legacy)}")
    cfg = SimConfig() if cfg is None else cfg
    return summarize(plat, cfg, run_prepared(
        prepare(plat, workloads, arrivals, cfg, device=device)))


def summarize(plat: Platform, cfg: SimConfig, tr: Trajectory) -> SimResult:
    """`simulate`'s result from the window loop's `Trajectory`: rates over
    the measured windows, per-SSD fields flattened to [n], and the obs
    plane decoded on the host."""
    st = tr.state
    e, nl = st.q_r.shape
    n = e * nl
    window_s = cfg.window_s
    t_total = (tr.miss.shape[0] - tr.warmup) * window_s

    def fl(a):
        return a.reshape(n)

    served_r, served_w = fl(st.served_r), fl(st.served_w)
    total = served_r + served_w
    day_s = 86400.0
    proc_cap_rate = plat.ssd_config.proc_clocks_per_s / ssd.CLOCK_HZ
    if e > 1:
        energy, host_busy = st.energy_j.sum(), st.host_busy
    else:
        energy, host_busy = st.energy_j[0], st.host_busy[0]
    rings = {"borrowed_seg": tr.borrowed_seg.reshape(-1, n),
             "spare_seg": tr.spare_seg.reshape(-1, n)}
    if tr.revoked is not None:
        rings["revoked_grants"] = tr.revoked
    obs_out = None
    if cfg.obs.enabled:
        ms, elog = st.obs
        ms = obs_m.merge_lead(ms)
        elog = obs_s.EventLog(buf=elog.buf.reshape(-1, *elog.buf.shape[-2:]),
                              count=elog.count.reshape(-1))
        records, dropped = obs_s.decode(elog, id_stride=nl if e > 1 else 0)
        if tr.fabric_log is not None:
            frecs, fdrop = obs_s.decode(tr.fabric_log)
            records = sorted(records + frecs, key=lambda r: (r["t"], r["lane"]))
            dropped += fdrop
        obs_out = {
            "metrics": SIM_METRICS.history(ms),
            "totals": SIM_METRICS.totals(ms),
            "events": records,
            "events_dropped": dropped,
        }
    return SimResult(
        throughput_bps=total / t_total,
        read_bps=served_r / t_total,
        write_bps=served_w / t_total,
        latency_s=fl(st.lat_sum) / torch.clamp(fl(st.cmd_count), min=1.0),
        proc_util=(fl(st.proc_busy) / (proc_cap_rate * t_total)) if plat.cores
        else torch.zeros_like(total),
        flash_util=fl(st.flash_busy) / t_total,
        miss_ratio=tr.miss[-1].reshape(n),
        dwpd=(fl(st.flash_written) / t_total) * day_s / (ssd.SSD_CAPACITY_TB * 1e12),
        energy_j=energy,
        host_util=host_busy / t_total,
        log_commits=fl(st.log_commits),
        cxl_bytes=fl(st.cxl_bytes),
        borrowed_seg=fl(st.borrowed_seg),
        borrowed_far=fl(st.borrowed_far),
        rings=rings,
        obs=obs_out,
    )
