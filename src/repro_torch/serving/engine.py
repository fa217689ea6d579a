"""Continuous-batching serving engine with XBOF inter-replica harvesting.

Port of `repro.serving.engine`. The runtime maps the paper onto
data-parallel serving replicas:

  paper                         | engine
  ------------------------------+------------------------------------------
  idle-resource descriptors     | per-replica rows in core.descriptors table
  processor harvesting (§4.4)   | decode-slot redirection: overloaded
                                |   replicas send admitted requests to idle
                                |   replicas' SHADOW slots via the §4.4
                                |   load-balance split
  DRAM harvesting (§4.5)        | kv_pool peer-page spill + WAL; with
                                |   trace_driven, the page-access stream
                                |   feeds the telemetry plane's windowed
                                |   SHARDS and the online want reserves
                                |   lendable pages (DESIGN.md §7)
  link-bandwidth harvesting     | LINK_BW descriptors fund ONE byte account
                                |   per replica (§4.6 cost table): lender-
                                |   spill pages AND §4.4 redirect commands
                                |   debit it, commands first (DESIGN.md §8)
  10 ms descriptor poll         | every engine step
  CXL pool locality tiers       | the shard axis: full descriptor machinery
                                |   within a shard, one aggregate summary
                                |   across shards (DESIGN.md §9)

The management round is HIERARCHICAL (DESIGN.md §9, §11): with
``n_shards > 1`` the replicas split into shards of ``n_replicas /
n_shards``; each shard runs the full management round over its own pool
and descriptor table, and shards exchange one aggregate spare/want summary
per rtype, settled level by level through `core.topology.
hierarchical_exchange` (flat, or enclosures of ``shards_per_enclosure``
shards with a pricier fabric tier above them). Every cross-level assist
pays its tier's price, so nearer lenders win.

One `step` runs, in order: with ``trace_driven``, one SHARDS window over
every replica's page-access stream (`telemetry.windows`, one
`shards_window` kernel launch for all shards) and the online want; the
management round (`core.manager`); route; the LINK_BW account; the
exchange across shards; with ``migrate_pages_per_step > 0``, the reclaim
predictor (`telemetry.reclaim`) and one `kv_pool.drain_offsite` of the
pages on lenders it flags; admit; one `kv_pool.append_tokens` over every
active sequence (offsite grants WAL-committed); one paged attention over
the flattened (shard, replica, slot) batch — the hand-written CUDA
kernels on a GPU, their plain versions on the CPU (`kernels.ops`); with
``obs.enabled``, one record of the metric rings and one append of the
round's grant events to the bounded log (DESIGN.md §12). The model is one
paged-attention decode layer, the runtime's unit of work.

The reference runs the shards under `jax.vmap`; the port carries the same
leading shard axis through every function of the step ([S, nl, ...],
`_to_shards`), so one step launches the same kernels for any shard count
and its claim sweep walks ``nl`` node positions, not ``n_replicas``. Ids
the step stores are local to a shard, as the reference's are; ``home_of``
is global.

Across processes (the reference's `shard_map` on a mesh):
`make_sharded_step` gives each rank of a serving mesh's ``"shards"`` axis
(`launch.mesh.make_serving_mesh`) one shard's block of the state
(`split_state`; `join_states` merges the blocks, `state_partition_specs`
describes the split). A rank runs the same `_shard_step` with a shard axis
of 1; its exchange gathers every shard's spare/want summaries from the
other ranks, settles the whole exchange as one process does and keeps its
own rows; its stats gather every shard's rows, so every rank returns
`step`'s stats. Its global ids (``home_of``, the obs plane's lender and
borrower ids) start at its coordinate on the axis times ``nl``. The one
collective is an all-reduce, which gloo and NCCL both take for CUDA
tensors.

The step reads no value back to the host (no `.item()`, `int(t)` or
`bool(t)`), so it can later be captured in a CUDA graph. It updates the
pool's K/V planes in place: rebind the returned state and do not reuse the
old one (`step` in the reference donates its state for the same reason).

The failure plane (DESIGN.md §13): with ``track_failures`` the state
carries a dead-replica mask that the step honours every step (a dead
replica takes no arrivals, looks saturated to every trigger, publishes
nothing and offers no pages); `fail_replica` is the host-side surgery
between steps that kills a replica (§4.5 recovery: requeue, WAL
truncation, revocation). It refuses ``n_shards > 1``, where the
reference's recovery mixes global and shard-local ids (ROADMAP queue 3),
and so on the ranks of `make_sharded_step`.
Where the reference divides by a constant, the port multiplies by the
float32 reciprocal (`manager.recip32`), as XLA compiles the reference, so
every floor and threshold on such a quotient lands identically.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import costs
from repro_torch.core import descriptors as desc
from repro_torch.core import loadbalance as lb
from repro_torch.core import manager as mgr
from repro_torch.core import topology as topo
from repro_torch.kernels import ops as kops
from repro_torch.obs import export as obs_x
from repro_torch.obs import metrics as obs_m
from repro_torch.obs import spans as obs_s
from repro_torch.telemetry import reclaim as tele_reclaim
from repro_torch.telemetry import want as tele_want
from repro_torch.telemetry import windows as tele_win
from . import kv_pool as kvp

WATERMARK = 0.75
DRAM_MIN_PAGES = 4.0  # publish/consume threshold for lendable KV pages
REQUEST_TOKENS = 16   # tokens each admitted request decodes

# the reference's 1-entry estimator when trace_driven is off; the port
# carries no estimator then (``mrc`` None)
_NO_TELEMETRY = tele_win.TelemetryConfig(k=1, buckets=1)


def _telemetry(cfg: "EngineConfig") -> tele_win.TelemetryConfig:
    """Telemetry plane (DESIGN.md §7), engine side: the kv_pool page-access
    stream (every physical page the decode batch attends over) feeds a
    windowed-SHARDS estimator per replica at page granularity and full
    sample rate. Coverage comes from the pool geometry: the table holds
    every local page (k = pages_per_replica) and the curve spans the pool
    (buckets * bucket_width >= pages_per_replica). On the card the window
    kernel holds that table in shared memory, which bounds trace_driven at
    pages_per_replica <= 29,048 on an H100 (227 KB a block;
    `kernels.shards_window.MAX_K_H100`); past it the launch raises
    ValueError. The CPU path takes any size."""
    return tele_win.TelemetryConfig(
        k=cfg.pages_per_replica, buckets=16,
        bucket_width=max(-(-cfg.pages_per_replica // 16), 1),
        sample_mod=1, sample_thresh=1, decay=0.9, min_total=2.0)


class EngineConfig(NamedTuple):
    n_replicas: int = 4
    seq_slots: int = 8          # decode slots per replica (normal queue)
    shadow_slots: int = 2       # slots reserved for redirected work (§4.4)
    pages_per_replica: int = 64
    page: int = 16
    kv_heads: int = 2
    head_dim: int = 32
    n_heads: int = 4
    max_pages: int = 16
    shadow_weight: float = 1.0  # WRR weights
    normal_weight: float = 4.0
    # LINK_BW metering: per-step link allowance per replica in KV-page
    # transfers, kept as ONE byte account that lender-spill pages and §4.4
    # redirection commands both debit (commands first); 0 = unmetered
    link_pages_per_step: int = 0
    # telemetry-driven DRAM publishing: each replica's page want, from its
    # kv_pool page-access stream (windowed SHARDS), is reserved out of the
    # lendable amount (off: lend every free page)
    trace_driven: bool = False
    # hierarchical round: n_shards shards of n_replicas / n_shards replicas;
    # cross_shard=False keeps them independent (no exchange);
    # shards_per_enclosure (a proper divisor of n_shards) groups shards into
    # enclosures that settle before the fabric tier (0: one flat level)
    n_shards: int = 1
    cross_shard: bool = True
    shards_per_enclosure: int = 0
    # KV page storage: "none" = fp32 pages; "int8" = int8 codes + per-page
    # fp32 scales (rescale-on-write), ~4x smaller page_nbytes
    kv_quant: str = "none"
    # observability plane (DESIGN.md §12): metric rings + grant-lifecycle
    # event log in the state; off leaves the state without them (None)
    obs: obs_m.ObsConfig = obs_m.ObsConfig()
    # failure plane (DESIGN.md §13): carry a per-replica dead mask and
    # honour it every step (arrivals, publishing, claiming and hosting all
    # masked for dead replicas); off leaves state.dead None
    track_failures: bool = False
    # WAL-backed live migration (DESIGN.md §13): per-step page allowance
    # for draining offsite KV pages off lenders the reclaim predictor
    # flags (`kv_pool.drain_offsite`), debited from the same LINK_BW byte
    # account as spill and redirects when metered; 0 leaves state.reclaim
    # None
    migrate_pages_per_step: int = 0
    # reclaim-predictor knobs (telemetry/reclaim.py)
    reclaim: tele_reclaim.ReclaimConfig = tele_reclaim.ReclaimConfig()


class EngineState(NamedTuple):
    pool: kvp.PagedPool
    table: desc.IdleResourceTable
    home_of: torch.Tensor     # [R, S_total] int32 — original replica (global id)
    remaining: torch.Tensor   # [R, S_total] int32 — tokens left to decode
    queue: torch.Tensor       # [R] int32 — backlog of unadmitted requests
    step_count: torch.Tensor  # int32[]
    # per-replica windowed-SHARDS state over the page-access stream
    # (`core.shards_mrc.ShardsState`) when cfg.trace_driven, else None
    mrc: object
    # params of the demo decode layer (shared across replicas)
    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    obs: object = None        # EngineObs when cfg.obs.enabled, else None
    dead: object = None       # bool[R] dead replicas when cfg.track_failures
    # reclaim-predictor carry (`telemetry.reclaim.ReclaimState`, [R]) when
    # cfg.migrate_pages_per_step > 0
    reclaim: object = None


class EngineObs(NamedTuple):
    """Metric rings + grant-lifecycle event log (DESIGN.md §12). Node
    metrics lead with the replica axis, scalar metrics and event lanes
    with the shard axis, so they split by shard like any other field."""

    metrics: obs_m.MetricsState
    events: obs_s.EventLog


def total_slots(cfg: EngineConfig) -> int:
    return cfg.seq_slots + cfg.shadow_slots


def shard_topology(cfg: EngineConfig) -> topo.Topology:
    """The exchange tree above the shard-local rounds: flat unless
    ``shards_per_enclosure`` is a proper divisor of n_shards."""
    spe = cfg.shards_per_enclosure
    if spe and 1 < spe < cfg.n_shards:
        return topo.two_level(spe, cfg.n_shards // spe)
    return topo.flat(cfg.n_shards)


def local_replicas(cfg: EngineConfig) -> int:
    return cfg.n_replicas // cfg.n_shards


def _validate(cfg: EngineConfig) -> None:
    if cfg.n_shards < 1 or cfg.n_replicas % cfg.n_shards != 0:
        raise ValueError(
            f"n_shards={cfg.n_shards} must evenly divide "
            f"n_replicas={cfg.n_replicas}")
    if cfg.shards_per_enclosure and cfg.n_shards % cfg.shards_per_enclosure:
        raise ValueError(
            f"shards_per_enclosure={cfg.shards_per_enclosure} must "
            f"evenly divide n_shards={cfg.n_shards}")
    shard_topology(cfg).validate(cfg.n_shards)


def _copy(x, dtype, dev) -> torch.Tensor:
    """A fresh tensor on ``dev`` from a tensor or an array-like (uint32
    addresses widen to int64 values)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=dev, dtype=dtype, copy=True)
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.tensor(a, dtype=dtype, device=dev)


def _tree_map(fn, *trees):
    """``fn`` over the tensors of NamedTuples / dicts (None stays None)."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if hasattr(t, "_fields"):
        return type(t)(*(_tree_map(fn, *(getattr(x, f) for x in trees))
                         for f in t._fields))
    return fn(*trees)


def init(cfg: EngineConfig, weights: dict | None = None, *, device=None,
         generator: torch.Generator | None = None) -> EngineState:
    """Fresh engine state on ``device`` (CUDA when None; raises if there
    is none). ``weights``: optional {"wq", "wk", "wv", "wo"} arrays of the
    decode layer; otherwise they are drawn from ``generator`` (seed 0 when
    None), each N(0, 1) / sqrt(fan_in)."""
    _validate(cfg)
    dev = resolve_device(device)
    # the decode layer's float32 products run in full float32, as XLA's do
    torch.backends.cuda.matmul.allow_tf32 = False
    st = total_slots(cfg)
    d = cfg.n_heads * cfg.head_dim
    kvd = cfg.kv_heads * cfg.head_dim
    shapes = {"wq": (d, d), "wk": (d, kvd), "wv": (d, kvd), "wo": (d, d)}
    if weights is None:
        gen = generator
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(0)
        weights = {name: torch.randn(sh, generator=gen, device=gen.device)
                   * (sh[0] ** -0.5) for name, sh in shapes.items()}
    w = {name: _copy(weights[name], torch.float32, dev) for name in shapes}
    for name, sh in shapes.items():
        if tuple(w[name].shape) != sh:
            raise ValueError(f"{name} must have shape {sh}, got "
                             f"{tuple(w[name].shape)}")
    pool = kvp.make_pool(cfg.n_replicas, cfg.pages_per_replica, cfg.page,
                         cfg.kv_heads, cfg.head_dim, st, cfg.max_pages,
                         dtype=torch.float32, quant=cfg.kv_quant, device=dev)
    if cfg.n_shards > 1:
        # one WAL cost counter per shard, as the reference carries them
        pool = pool._replace(logs=pool.logs._replace(
            flushes=torch.zeros(cfg.n_shards, dtype=torch.int32, device=dev),
            commits=torch.zeros(cfg.n_shards, dtype=torch.int32, device=dev)))
    obs = None
    if cfg.obs.enabled:
        obs = EngineObs(
            metrics=ENGINE_METRICS.init(cfg.n_replicas, cfg.obs,
                                        lead=cfg.n_shards, device=dev),
            events=obs_s.make_log(cfg.obs.event_capacity, lead=cfg.n_shards,
                                  device=dev))
    return EngineState(
        pool=pool,
        table=_manager(cfg).init_table(cfg.n_replicas, device=dev),
        home_of=torch.full((cfg.n_replicas, st), -1, dtype=torch.int32,
                           device=dev),
        remaining=torch.zeros((cfg.n_replicas, st), dtype=torch.int32,
                              device=dev),
        queue=torch.zeros(cfg.n_replicas, dtype=torch.int32, device=dev),
        step_count=torch.zeros((), dtype=torch.int32, device=dev),
        mrc=(tele_win.init_batch(cfg.n_replicas, _telemetry(cfg), device=dev)
             if cfg.trace_driven else None),
        obs=obs,
        dead=(torch.zeros(cfg.n_replicas, dtype=torch.bool, device=dev)
              if cfg.track_failures else None),
        reclaim=(tele_reclaim.init(cfg.n_replicas, device=dev)
                 if cfg.migrate_pages_per_step > 0 else None),
        **w)


def state_from_numpy(cfg: EngineConfig, arrays, device=None) -> EngineState:
    """Port state holding the values of a reference `EngineState` whose
    leaves are numpy arrays (``jax.tree.map(np.asarray, state)``): the
    decode weights, the pool (K/V planes, scales, allocation, page table,
    lengths, WAL with its [n_shards] counters when sharded), the
    descriptor table, ``home_of``, ``remaining``, ``queue``,
    ``step_count``, and with ``trace_driven`` the SHARDS state ``mrc``
    (without it the reference carries a 1-entry estimator, which the port
    drops), with ``obs.enabled`` the rings and the event log, with
    ``track_failures`` the dead mask and with migration the predictor's
    carry. Read by attribute, so any object with the reference's field
    names will do."""
    state = init(cfg, {n: getattr(arrays, n) for n in ("wq", "wk", "wv", "wo")},
                 device=device)
    dev = state.queue.device

    def like(fresh, src, fields=None):
        """``fresh`` (a NamedTuple of tensors) holding ``src``'s values."""
        return fresh._replace(**{
            f: _copy(getattr(src, f), getattr(fresh, f).dtype, dev)
            for f in fields or fresh._fields})

    pool = state.pool
    # the reference's K/V planes are [R, P, page, KV, Dh]; the port's are
    # flat by global page id, with the scratch page after them
    planes = {}
    for f in ("k", "v"):
        fresh = getattr(pool, f)
        src = _copy(getattr(arrays.pool, f), fresh.dtype, dev)
        planes[f] = torch.cat([src.reshape(fresh[:-1].shape), fresh[-1:]])
    pool = pool._replace(**planes)
    pool = like(pool, arrays.pool, ("k_scale", "v_scale", "used", "owner_seq",
                                    "page_table", "seq_len", "seq_active"))
    pool = pool._replace(logs=like(pool.logs, arrays.pool.logs))
    state = state._replace(pool=pool, table=like(state.table, arrays.table))
    if cfg.trace_driven:
        state = state._replace(mrc=_tree_map(
            lambda fresh, src: _copy(src, fresh.dtype, dev), state.mrc, arrays.mrc))
    elif tuple(np.shape(arrays.mrc.addrs))[-1:] != (_NO_TELEMETRY.k,):
        raise ValueError("a reference state with an estimator beside a config "
                         "without trace_driven")
    for f in ("obs", "dead", "reclaim"):
        if getattr(state, f) is not None:
            state = state._replace(**{f: _tree_map(
                lambda fresh, src: _copy(src, fresh.dtype, dev),
                getattr(state, f), getattr(arrays, f))})
    return like(state, arrays, ("home_of", "remaining", "queue", "step_count"))


def utilization(cfg: EngineConfig, state: EngineState) -> torch.Tensor:
    """Processor-descriptor utilization = normal-slot occupancy (+queue)."""
    occ = state.pool.seq_active[..., : cfg.seq_slots].sum(dim=-1)
    util = (occ + torch.clamp(state.queue, max=4)).to(torch.float32)
    return torch.clamp(util * mgr.recip32(cfg.seq_slots), 0.0, 1.5)


def hbm_pressure(cfg: EngineConfig, state: EngineState) -> torch.Tensor:
    free = kvp.free_pages(state.pool).to(torch.float32)
    return 1.0 - free * mgr.recip32(cfg.pages_per_replica)


class FailureReport(NamedTuple):
    """What one `fail_replica` call cost, for the scenario driver."""

    lost_tokens: int   # KV tokens truncated off borrowers' tails (they
                       # re-decode: a latency spike, never sequence loss)
    requeued: int      # shadow sequences re-queued at their home replica
    aborted: int       # the dead replica's OWN sequences (client gone)
    revoked: int       # standing descriptor rows invalidated


# the reference's recovery under n_shards > 1 truncates against the wrong
# pool: it hands `kv_pool.lender_failure` the GLOBAL replica id, which it
# compares with the SHARD-LOCAL owner ids the page tables hold
_SHARDED_FAILURE = (
    "fail_replica with n_shards > 1 is refused: the reference passes the "
    "global replica id to kv_pool.lender_failure (src/repro/serving/"
    "engine.py:358-359), whose page tables hold shard-local owner ids "
    "(src/repro/serving/kv_pool.py:608-609), so borrowers keep pages in the "
    "freed pool (or lose pages of another shard's replica); the port makes "
    "up no semantics of its own there")


def fail_replica(cfg: EngineConfig, state: EngineState, failed: int,
                 ) -> tuple[EngineState, FailureReport]:
    """Kill one replica: the §4.5 recovery story, serving side.

    Four transitions, in crash-consistent order: (1) sequences HOSTED on
    the dead replica (shadow slots serving other homes) release their
    pages and re-queue at their home — the dead replica's own sequences
    abort (their client died with it); (2) borrowers whose offsite KV
    pages lived in the dead pool WAL-truncate to the last fully-surviving
    prefix (`kv_pool.lender_failure`) and the truncated tail goes back on
    ``remaining`` — the engine re-decodes it, so a lender crash costs
    latency, never sequences; (3) every standing descriptor grant the dead
    replica lends or borrows invalidates (`manager.revoke_nodes`); (4) the
    dead mask raises, and ``cfg.track_failures`` keeps the replica inert
    from the next step on.

    Host-side, between steps: it reads its report back to the host (a
    sync), as the reference's does. Needs ``cfg.track_failures``; raises
    ValueError under ``n_shards > 1`` (the reference's fault there, ROADMAP
    queue 3). The input state must not be reused."""
    if state.dead is None:
        raise ValueError(
            "fail_replica needs cfg.track_failures=True (state.dead is "
            "None: the step would keep scheduling onto the dead replica)")
    if cfg.n_shards > 1:
        raise ValueError(_SHARDED_FAILURE)
    failed = int(failed)
    r, st = cfg.n_replicas, total_slots(cfg)
    dev = state.queue.device
    pool = state.pool

    # (1) hosted sequences: requeue at home, abort the replica's own
    hosted = pool.seq_active[failed]
    homes = state.home_of[failed].long()
    own = homes == failed
    requeue = torch.zeros(r, dtype=torch.int32, device=dev).scatter_add_(
        0, homes.clamp(0, r - 1), (hosted & ~own).to(torch.int32))
    aborted = int((hosted & own).sum())
    done = torch.zeros((r, st), dtype=torch.bool, device=dev)
    done[failed] = hosted
    pool = kvp.release_sequences(pool, done)
    remaining, home_of = state.remaining.clone(), state.home_of.clone()
    remaining[failed] = 0
    home_of[failed] = -1
    queue = state.queue + requeue
    queue[failed] = 0

    # (2) offsite pages in the dead pool: WAL replay -> truncate -> the
    # lost tail re-decodes (remaining grows back by what was cut)
    len_before = pool.seq_len
    pool = kvp.lender_failure(pool, failed)
    lost = torch.where(pool.seq_active, len_before - pool.seq_len, 0)
    remaining = remaining + lost

    # (3) standing grants revoke, through the per-shard form of the table
    dead = state.dead.clone()
    dead[failed] = True
    table, revoked = mgr.revoke_nodes(
        desc.IdleResourceTable(*(x[None] for x in state.table)), dead[None])
    state = state._replace(
        pool=pool, table=desc.IdleResourceTable(*(x[0] for x in table)),
        home_of=home_of, remaining=remaining, queue=queue, dead=dead)
    return state, FailureReport(lost_tokens=int(lost.sum()),
                                requeued=int(requeue.sum()), aborted=aborted,
                                revoked=int(revoked.sum()))


@functools.lru_cache(maxsize=None)
def _manager(cfg: EngineConfig) -> mgr.ResourceManager:
    """The engine's management round: one PROCESSOR descriptor in slot 0,
    one DRAM descriptor (lendable pages) in slot 1, and with metering one
    LINK_BW descriptor (link budget) in slot 2; one busiest-first claim
    sweep per step."""
    pols = [
        mgr.ResourcePolicy(
            rtype=desc.PROCESSOR, slot0=0, slots=1, claim_rounds=1,
            watermark=WATERMARK, gate_watermark=0.98),
        mgr.ResourcePolicy(
            rtype=desc.DRAM, slot0=1, slots=1, claim_rounds=0,
            min_amount=DRAM_MIN_PAGES, amount_gated=True),
    ]
    n_slots = 2
    if cfg.link_pages_per_step > 0:
        pols.append(mgr.ResourcePolicy(
            rtype=desc.LINK_BW, slot0=2, slots=1, claim_rounds=1,
            watermark=WATERMARK))
        n_slots = 3
    return mgr.ResourceManager(mgr.ManagerConfig(
        n_slots=n_slots, policies=tuple(pols)))


def _route(cfg: EngineConfig, state: EngineState, arrivals: torch.Tensor):
    """§4.4 transparent redirection: split each replica's (queue +
    arrivals) between itself and its claimed lenders with the load-balance
    formula, every replica of every shard at once. Returns (kept
    int32[..., n], sent int32[..., n borrower, n lender])."""
    util = utilization(cfg, state)
    demand = state.queue + arrivals
    assist = _manager(cfg).assist_matrix(state.table, desc.PROCESSOR)
    return lb.split_commands(
        demand, util, util, (assist > 0).transpose(-1, -2),
        w_borrow_sq=cfg.normal_weight, w_shadow_sq=cfg.shadow_weight,
        sum_w_borrow=cfg.normal_weight * cfg.seq_slots,
        sum_w_lend=cfg.normal_weight * cfg.seq_slots)


def _admit(cfg: EngineConfig, state: EngineState, kept: torch.Tensor,
           sent: torch.Tensor, home_base=0, imported=None, import_src=None,
           import_home=None) -> EngineState:
    """Prefix-sum admission, every replica at once: the first ``kept[r]``
    free normal slots take local work, the first ``sum(sent[:, r])`` free
    shadow slots take redirected work. The j-th redirected request at
    lender r belongs to the borrower whose cumulative ``sent[:, r]`` count
    covers j — one batched `searchsorted` (right side) over the lenders.

    Works on [n, ...] or on a shard axis ([S, n, ...]). ``home_of`` holds
    GLOBAL replica ids: ``home_base`` is the global id of each shard's
    replica 0 ([S, 1, 1]; 0 with one shard). Cross-shard imports
    (``imported`` int[S, n] per host replica) take shadow slots AFTER the
    shard's own redirects; their home is the source shard's base
    ``import_home[src]``, src found through the per-source counts
    ``import_src`` ([S host, S source], the exchange matrix) — the
    aggregate exchange hides per-replica provenance (DESIGN.md §9)."""
    pool = state.pool
    st = total_slots(cfg)
    n = state.queue.shape[-1]
    dev = state.queue.device
    free = ~pool.seq_active                                   # [..., n, St]
    is_shadow = torch.arange(st, device=dev) >= cfg.seq_slots
    normal_free = free & ~is_shadow
    shadow_free = free & is_shadow
    nf, sf = normal_free.long(), shadow_free.long()
    nrank = torch.cumsum(nf, dim=-1) - nf
    srank = torch.cumsum(sf, dim=-1) - sf
    sent = sent.long()
    n_remote = sent.sum(dim=-2)                               # [..., n] redirected here
    admit_local = normal_free & (nrank < kept[..., None])
    admit_remote = shadow_free & (srank < n_remote[..., None])
    admit = admit_local | admit_remote

    cum = torch.cumsum(sent, dim=-2)                          # [..., B, R] per lender
    from_rep = torch.searchsorted(cum.transpose(-1, -2).contiguous(), srank,
                                  right=True).clamp(0, n - 1)  # [..., R, St]
    home = torch.where(is_shadow, home_base + from_rep,
                       home_base + torch.arange(n, device=dev)[:, None])
    leftover = (kept - admit_local.sum(dim=-1)
                + n_remote - admit_remote.sum(dim=-1))
    if imported is not None:
        # cross-shard arrivals rank behind the local redirects in the
        # shadow-slot order (local work keeps §4.4 priority)
        imported = imported.long()
        admit_import = (shadow_free & (srank >= n_remote[..., None])
                        & (srank < (n_remote + imported)[..., None]))
        admit = admit | admit_import
        ioff = torch.cumsum(imported, dim=-1) - imported      # exclusive
        j = srank - n_remote[..., None] + ioff[..., None]     # import rank
        ns = import_src.shape[-1]
        scum = torch.cumsum(import_src.long(), dim=-1)        # [S host, S src]
        src = torch.searchsorted(scum, j.reshape(j.shape[0], -1),
                                 right=True).clamp(0, ns - 1).reshape(j.shape)
        home = torch.where(admit_import, import_home[src], home)
        leftover = leftover + imported - admit_import.sum(dim=-1)
    return state._replace(
        pool=pool._replace(seq_active=pool.seq_active | admit),
        home_of=torch.where(admit, home, state.home_of).to(torch.int32),
        remaining=torch.where(admit, REQUEST_TOKENS, state.remaining),
        queue=leftover.to(torch.int32))


def _decode_all(cfg: EngineConfig, state: EngineState, dram_lenders,
                spill_budget, x: torch.Tensor):
    """One decode token for every active slot, batched over every shard:
    one `kv_pool.append_tokens` grows every sequence and one paged
    attention over the flattened (shard, replica, slot) batch does the
    compute. ``x`` [S, nl, St, d] holds the step's activations."""
    pool = state.pool
    st = total_slots(cfg)
    ns, r = state.queue.shape
    rows = ns * r * st
    q = (x @ state.wq).reshape(rows, cfg.n_heads, cfg.head_dim)
    k_t = (x @ state.wk).reshape(ns, r, st, cfg.kv_heads, cfg.head_dim)
    v_t = (x @ state.wv).reshape(ns, r, st, cfg.kv_heads, cfg.head_dim)

    active = pool.seq_active
    length_before = pool.seq_len
    pool, spill_pages = kvp.append_tokens(pool, k_t, v_t, active,
                                          dram_lenders,
                                          spill_budget=spill_budget)

    p = cfg.pages_per_replica
    k_flat, v_flat = pool.k[: ns * r * p], pool.v[: ns * r * p]  # no scratch page
    # a shard's stored page ids are local: its plane rows start at
    # s * nl * P. Clip a hole to the shard's page 0 THEN offset, as the
    # reference clips within the shard's own pool
    base = (torch.arange(ns, device=x.device, dtype=torch.int32)
            * (r * p))[:, None, None]
    table = pool.page_table.clamp(min=0) + base[..., None]
    scales = {}
    if kvp.quantized(pool):
        # int8 pool: codes + per-page scales go to the fused-dequant kernel
        scales = dict(k_scale=pool.k_scale.reshape(-1),
                      v_scale=pool.v_scale.reshape(-1))
    out = kops.paged_attention(
        q, k_flat, v_flat,
        table.reshape(rows, cfg.max_pages),
        pool.seq_len.reshape(rows),
        **scales,
    )
    out = torch.where(active.reshape(-1)[:, None, None], out, 0.0)
    attn_norm = (out.float() ** 2).sum()

    quant_err = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.kv_quant != "none":
        # write-side quantization error: read this step's token rows back
        # through the dequant path and compare with what decode produced
        wrote = pool.seq_len > length_before                  # [S, nl, St]
        lp = torch.div(pool.seq_len - 1, cfg.page, rounding_mode="floor")
        lp = lp.clamp(0, cfg.max_pages - 1)
        phys = torch.gather(pool.page_table, -1, lp[..., None].long())[..., 0]
        safe = (phys.clamp(0, r * p - 1) + base).reshape(-1).long()
        slot = ((pool.seq_len - 1) % cfg.page).clamp(0, cfg.page - 1)
        slot = slot.reshape(-1).long()
        ks = pool.k_scale.reshape(-1)[safe][:, None, None]
        vs = pool.v_scale.reshape(-1)[safe][:, None, None]
        kr = k_flat[safe, slot].float() * ks
        vr = v_flat[safe, slot].float() * vs
        m = (wrote & (phys >= 0)).reshape(-1)[:, None, None]
        kt = k_t.reshape(rows, cfg.kv_heads, cfg.head_dim)
        vt = v_t.reshape(rows, cfg.kv_heads, cfg.head_dim)
        quant_err = (torch.where(m, (kr - kt) ** 2, 0.0).sum()
                     + torch.where(m, (vr - vt) ** 2, 0.0).sum())

    remaining = torch.where(pool.seq_active, state.remaining - 1,
                            state.remaining)
    done = pool.seq_active & (remaining <= 0)
    pool = kvp.release_sequences(pool, done)
    # post-release offsite footprint — the one offsite scan of the step
    offsite_after = kvp.offsite_pages(pool)
    return (state._replace(pool=pool, remaining=torch.clamp(remaining, min=0)),
            pool.seq_active.sum(dim=-1, dtype=torch.int32), attn_norm,
            spill_pages, offsite_after, quant_err)


# The engine's metric registry: one declaration per signal carries its
# stats-dict reduction — "concat" per-replica arrays, "sum" to the global
# scalar, "first" already global, "none" ring-only (never in the stats).
ENGINE_METRICS = obs_m.MetricSet("engine")
for _nm in ("util", "want_pages", "link_budget_bytes"):
    ENGINE_METRICS.gauge(_nm, per="node", reduce="concat")
for _nm in ("link_redirect_bytes", "link_spill_bytes"):
    ENGINE_METRICS.counter(_nm, per="node", reduce="concat")
for _nm in ("active", "queued", "offsite_pages"):
    ENGINE_METRICS.gauge(_nm, per="node", reduce="sum")
ENGINE_METRICS.counter("redirected", per="node", reduce="sum")
for _nm in ("attn_norm", "log_commits", "quant_err_norm"):
    ENGINE_METRICS.gauge(_nm, per="scalar", reduce="first")
for _nm in ("cross_redirected", "cross_link_borrowed_bytes"):
    ENGINE_METRICS.counter(_nm, per="scalar", reduce="first")
ENGINE_METRICS.gauge("hbm_pressure", per="node", reduce="none")
for _nm in ("migrated_pages", "migration_bytes"):
    ENGINE_METRICS.counter(_nm, per="node", reduce="none")
ENGINE_METRICS.histogram("util_hist", bins=8, lo=0.0, hi=1.6)
del _nm

def _finish_stats(stats: dict) -> dict:
    out = {}
    for k, v in stats.items():
        red = ENGINE_METRICS.spec(k).reduce  # KeyError: unregistered stat
        if red == "concat":
            out[k] = v.reshape(-1)
        elif red == "sum":
            out[k] = v.sum(dtype=v.dtype)
        elif red == "first":
            out[k] = v.reshape(-1)[0] if v.dim() else v
        else:
            raise ValueError(
                f"stat {k!r} is ring-only (reduce='none') and must not "
                "appear in the step stats dict")
    return out


def _level_split_bytes(exports: torch.Tensor, n_exp_l: torch.Tensor,
                       cmd_x: tuple[float, ...]) -> torch.Tensor:
    """Price each replica's exported requests at the level that granted
    them. ``exports`` int[..., R] (fill_by_rank order), ``n_exp_l``
    int[..., L] grants per exchange level (nearest first), ``cmd_x`` the
    command bytes per export at each level. Both partition the same rank
    order [0, Σ exports), so the [R, L] overlap of their cumulative ranges
    attributes every export to exactly one level. The prices stay Python
    numbers (a tensor made from them would be a copy the step waits for);
    the byte counts are whole numbers, so any order of the sum is exact."""
    cr = torch.cumsum(exports, dim=-1)
    cr0 = cr - exports
    cl = torch.cumsum(n_exp_l, dim=-1)
    cl0 = cl - n_exp_l
    overlap = torch.clamp(
        torch.minimum(cr[..., :, None], cl[..., None, :])
        - torch.maximum(cr0[..., :, None], cl0[..., None, :]), min=0)
    overlap = overlap.to(torch.float32)
    out = overlap[..., 0] * cmd_x[0]
    for lv in range(1, len(cmd_x)):
        out = out + overlap[..., lv] * cmd_x[lv]
    return out


class _Exchange(NamedTuple):
    """What the exchange across shards hands back to the step."""

    kept: torch.Tensor              # [S, nl] local work after exports
    redirect_bytes: torch.Tensor    # [S, nl] with the exports' command bytes
    budget_bytes: torch.Tensor      # [S, nl] net of LINK_BW allowance lent
    extra_link: torch.Tensor        # [S, nl] LINK_BW bytes borrowed
    imports: torch.Tensor           # [S, nl] requests each replica hosts
    import_src: torch.Tensor        # [S host, S source] granted requests
    import_home: torch.Tensor       # [S] home id of each source shard
    cross_redirected: torch.Tensor  # requests exchanged (float32 scalar)
    cross_borrowed: torch.Tensor    # LINK_BW bytes borrowed (float32 scalar)
    # the grant matrices per level [L, host, source] (the rows of the
    # shards this process holds) and their unit prices, for the obs
    # plane's grant rows (LINK_BW: None unmetered)
    grants: torch.Tensor
    cmd_x: tuple
    link_grants: torch.Tensor | None
    link_prices: tuple | None


def _exchange(cfg: EngineConfig, state: EngineState, util, mem, free, kept,
              sent, budget_bytes, redirect_bytes, link_amt, page_b: float,
              ranks: "_Ranks | None" = None) -> _Exchange:
    """The exchange across shards (DESIGN.md §9, §11): only the post-local
    leftovers cross, as ONE (spare, want) pair per shard per rtype, settled
    nearest level first through `topology.hierarchical_exchange`, each
    level's grants priced at its tier. In one process every shard's
    summary is in hand; on a rank (``ranks``) they are gathered from every
    rank first, as the reference all-gathers them. Either way each process
    settles the whole exchange and keeps the rows of the shards it holds,
    so the exchange's totals need no further collective."""
    ns, n = state.queue.shape
    n_all = cfg.n_shards
    rows = slice(0, ns) if ranks is None else slice(ranks.sid, ranks.sid + ns)
    dev = state.queue.device
    metered = cfg.link_pages_per_step > 0
    shard_topo = shard_topology(cfg)
    levels = range(len(shard_topo.group_sizes))
    # PROCESSOR: requests beyond a shard's normal-slot capacity export to
    # shards with watermark-idle replicas holding free shadow slots (after
    # their own inbound redirects) and spare DRAM
    cmd_x = tuple(
        float(costs.tier_link_bytes(desc.PROCESSOR,
                                    level=shard_topo.level_tier(lv)))
        for lv in levels)
    free_slots = ~state.pool.seq_active
    free_normal = free_slots[..., : cfg.seq_slots].sum(dim=-1)
    free_shadow = free_slots[..., cfg.seq_slots:].sum(dim=-1)
    overflow = torch.clamp(kept - free_normal, min=0)
    if metered:
        # each export debits its level's command price from the same byte
        # account, before spill; the cap assumes the priciest tier
        afford = torch.floor((budget_bytes - redirect_bytes)
                             * mgr.recip32(max(cmd_x))).to(torch.int32)
        overflow = torch.minimum(overflow, torch.clamp(afford, min=0))
    inbound = sent.sum(dim=-2)
    host_ok = (util <= WATERMARK) & (free > DRAM_MIN_PAGES)
    host_cap = torch.where(host_ok, torch.clamp(free_shadow - inbound, min=0), 0)
    summary = _across(ranks, torch.stack(
        [host_cap.sum(dim=-1), overflow.sum(dim=-1)], dim=-1).to(torch.float32))
    grants, _ = topo.hierarchical_exchange(summary[:, 0], summary[:, 1], shard_topo)
    g_int = torch.floor(grants).to(torch.int32)        # [level, host, source]
    n_exp_l = g_int.sum(dim=1).T[rows]                 # [source, level]
    exports = mgr.fill_by_rank(overflow, n_exp_l.sum(dim=-1, keepdim=True))
    kept = kept - exports
    if metered:
        redirect_bytes = redirect_bytes + _level_split_bytes(
            exports, n_exp_l, cmd_x)
    import_src = g_int.sum(dim=0)[rows]                # [host, source]
    imports = mgr.fill_by_rank(host_cap, import_src.sum(dim=-1, keepdim=True))
    import_home = torch.arange(n_all, dtype=torch.int32, device=dev) * n
    extra_link = torch.zeros_like(budget_bytes)
    cross_borrowed = torch.zeros((), dtype=torch.float32, device=dev)
    lgrants = link_prices = None
    if metered:
        # LINK_BW: pressured shards borrow idle shards' leftover byte
        # allowance; each level's detour pays its extra-hop command bytes
        # as the exchange overhead
        link_ohs = tuple(
            float(costs.tier_link_bytes(
                desc.LINK_BW, 0.0, level=shard_topo.level_tier(lv))) / page_b
            for lv in levels)
        l_spare = torch.where(
            mem <= WATERMARK, torch.clamp(budget_bytes - redirect_bytes, min=0.0),
            0.0)
        l_want = torch.where(mem > WATERMARK, link_amt, 0.0)
        spare_tot = l_spare.sum(dim=-1)                # integer bytes: exact
        want_tot = l_want.sum(dim=-1)
        lsummary = _across(ranks, torch.stack([spare_tot, want_tot], dim=-1))
        lgrants, lrecv = topo.hierarchical_exchange(
            lsummary[:, 0], lsummary[:, 1], shard_topo, link_ohs)
        # per shard: its row over (level, borrower), its column over
        # levels, in the reference's order
        lent_x = mgr.seq_sum(lgrants.permute(1, 0, 2).reshape(n_all, -1))[rows]
        recv_all = mgr.seq_sum(lrecv.T)
        recv_x = recv_all[rows]
        lent_each = torch.where(
            spare_tot[:, None] > 0,
            l_spare * (lent_x / torch.clamp(spare_tot, min=1e-9))[:, None], 0.0)
        extra_link = torch.where(
            want_tot[:, None] > 0,
            l_want * (recv_x / torch.clamp(want_tot, min=1e-9))[:, None], 0.0)
        budget_bytes = budget_bytes - lent_each
        cross_borrowed = mgr.seq_sum(recv_all)
        lgrants = lgrants[:, rows]
        link_prices = tuple(oh * page_b for oh in link_ohs)
    return _Exchange(kept, redirect_bytes, budget_bytes, extra_link, imports,
                     import_src, import_home, g_int.sum().to(torch.float32),
                     cross_borrowed, g_int[:, rows], cmd_x, lgrants, link_prices)


def _grant_rows(cfg: EngineConfig, xch: _Exchange, t: torch.Tensor, first: int):
    """The obs plane's rows of the exchange's grants, lender-side: each
    shard logs the rows where it is the granting host (shard ids in
    lender and borrower), PROCESSOR levels then LINK_BW levels. The
    grants hold the rows of shards ``first``, ``first + 1``, ..."""
    ns = xch.grants.shape[1]
    shard_topo = shard_topology(cfg)
    lender_base = first + torch.arange(ns, dtype=torch.int32,
                                       device=xch.grants.device)[:, None, None]
    out = []
    for rtype, grants, prices in (
            (desc.PROCESSOR, xch.grants, xch.cmd_x),
            (desc.LINK_BW, xch.link_grants, xch.link_prices)):
        if grants is None:
            continue
        for lv in range(len(prices)):
            out.append(obs_s.grant_event_rows(
                grants[lv][:, None, :].to(torch.float32), rtype=rtype,
                level=shard_topo.level_tier(lv), t=t, price=prices[lv],
                lender_base=lender_base))
    return out


def _shard_step(cfg: EngineConfig, state: EngineState, arrivals: torch.Tensor,
                x: torch.Tensor, ranks: "_Ranks | None" = None):
    """One engine step over the shards this process holds — the
    reference's `_shard_step` under `jax.vmap`, with the shard axis
    leading every per-replica tensor ([S, nl, ...]): round -> route ->
    LINK_BW account -> exchange across shards -> admit -> decode -> stats.
    Without ``ranks`` it holds every shard and returns per-shard stats;
    on a rank of `make_sharded_step` it holds its own shard (S = 1), and
    its exchange and stats gather every rank's (the stats come back with
    every shard's rows, [n_shards, nl], and the global scalars)."""
    ns, n = state.queue.shape
    first = 0 if ranks is None else ranks.sid   # this process's first shard
    dev = state.queue.device
    manager = _manager(cfg)
    util = utilization(cfg, state)
    mem = hbm_pressure(cfg, state)
    free = kvp.free_pages(state.pool).to(torch.float32)
    zeros = torch.zeros((ns, n), dtype=torch.float32, device=dev)
    scalar0 = torch.zeros((), dtype=torch.float32, device=dev)
    metered = cfg.link_pages_per_step > 0
    page_b = float(kvp.page_nbytes(state.pool))
    dead = state.dead
    if cfg.track_failures:
        # failure plane: a dead replica takes no arrivals, looks saturated
        # to every trigger (never publishes, never redirects toward it),
        # gate-vetoes its own claims and offers no pages
        arrivals = torch.where(dead, 0, arrivals)
        util = torch.where(dead, 1.5, util)
        mem = torch.where(dead, 1.0, mem)
        free = torch.where(dead, 0.0, free)
    lendable, want_pages = free, zeros
    if cfg.trace_driven:
        # the kv_pool page-access stream: every page the decode batch will
        # attend over this step (active sequences' page tables, ids local
        # to the shard as the reference stores them); dead slots map to -1,
        # which the window takes as 0xFFFFFFFF, the estimator's padding
        tcfg = _telemetry(cfg)
        pt = state.pool.page_table                            # [S, nl, St, MP]
        live = (pt >= 0) & state.pool.seq_active[..., None]
        mrc_state = tele_win.update_window(
            state.mrc, torch.where(live, pt, -1).reshape(ns, n, -1), tcfg)
        want_pages = tele_want.want_entries(mrc_state, tcfg)
        # reserve the estimated growth beyond the pages already backing
        # local sequences out of the lendable amount
        footprint = live.sum(dim=(-2, -1)).to(torch.float32)
        reserve = torch.clamp(want_pages - footprint, min=0.0)
        lendable = torch.clamp(free - reserve, min=0.0)
        state = state._replace(mrc=mrc_state)
    inputs = {
        desc.PROCESSOR: mgr.RoundInputs(util=util, gate_util=mem),
        desc.DRAM: mgr.RoundInputs(amount=lendable),
    }
    if metered:
        # a replica under HBM pressure is about to spill: it borrows idle
        # peers' link budgets; relaxed replicas lend theirs
        link_util = mem
        link_pub = torch.full((ns, n), float(cfg.link_pages_per_step),
                              dtype=torch.float32, device=dev)
        if cfg.track_failures:
            # dead replicas publish a zero allowance and never claim (util
            # 0 keeps them under the watermark on both sides)
            link_util = torch.where(dead, 0.0, link_util)
            link_pub = torch.where(dead, 0.0, link_pub)
        inputs[desc.LINK_BW] = mgr.RoundInputs(util=link_util, amount=link_pub)
    prev_table = state.table  # obs: the grant events are the round's diff
    table = manager.round(state.table, inputs)
    state = state._replace(table=table)
    kept, sent = _route(cfg, state, arrivals)
    # DRAM descriptors are amount-gated capacity, never claimed: a replica
    # lends KV pages iff its descriptor is live with pages above threshold
    dmask = manager.slot_mask(desc.DRAM, table.n_slots, device=dev)
    dram_lenders = (table.valid & dmask
                    & (table.amount_a > DRAM_MIN_PAGES)).any(dim=-1)
    spill_budget = None
    link_amt = budget_bytes = redirect_bytes = extra_link = zeros
    if metered:
        # ONE LINK_BW byte account per borrower (§4.6): own allowance plus
        # what idle-link peers pledged through the round, minus what it
        # pledged away. Redirect commands debit it first; redirects beyond
        # the budget stay home and retry via the queue.
        link_m = manager.assist_matrix(table, desc.LINK_BW)
        link_amt = torch.full((ns, n), float(cfg.link_pages_per_step) * page_b,
                              dtype=torch.float32, device=dev)
        borrowed = (link_amt[..., None, :] @ link_m)[..., 0, :]
        lent = link_amt * link_m.sum(dim=-1)
        budget_bytes = link_amt - lent + borrowed
        cmd_b = float(costs.REDIRECT_CMD_BYTES)
        red_cap = torch.floor(budget_bytes * mgr.recip32(cmd_b)).to(torch.int32)
        cum = torch.cumsum(sent, dim=-1, dtype=torch.int32)
        capped = torch.clamp(torch.minimum(cum, red_cap[..., None])
                             - (cum - sent), min=0)
        kept = kept + (sent - capped).sum(dim=-1, dtype=torch.int32)
        sent = capped
        redirect_bytes = sent.sum(dim=-1).to(torch.float32) * cmd_b
    # the exchange across shards: post-local leftovers only
    xch = None
    if cfg.cross_shard and cfg.n_shards > 1:
        xch = _exchange(cfg, state, util, mem, free, kept, sent, budget_bytes,
                        redirect_bytes, link_amt, page_b, ranks)
        kept, redirect_bytes = xch.kept, xch.redirect_bytes
        budget_bytes, extra_link = xch.budget_bytes, xch.extra_link
    migrated = mig_bytes = zeros
    if cfg.migrate_pages_per_step > 0:
        # live migration: fold this step's pressure into the reclaim
        # predictor; lenders it flags stop taking new spill AND their held
        # offsite pages drain home (or to a calm second lender) under the
        # per-step allowance, debited from the LINK_BW account before the
        # spill floor
        rstate, risk = tele_reclaim.update(state.reclaim, mem, cfg.reclaim)
        if cfg.track_failures:
            risk = risk & ~dead  # a dead pool is already freed: no drain
        dram_lenders = dram_lenders & ~risk
        headroom = torch.full((ns, n), float(cfg.migrate_pages_per_step),
                              dtype=torch.float32, device=dev)
        if metered:
            headroom = torch.minimum(headroom, torch.clamp(
                budget_bytes - redirect_bytes + extra_link, min=0.0)
                * mgr.recip32(page_b))
        pool, migrated = kvp.drain_offsite(
            state.pool, risk, torch.floor(headroom).to(torch.int32), dram_lenders)
        mig_bytes = migrated.to(torch.float32) * page_b
        state = state._replace(pool=pool, reclaim=rstate)
    if metered:
        # spill pages get whatever bytes the command stream (and the drain)
        # left over, plus any cross-shard borrowed allowance (already net
        # of the hop tax)
        avail = budget_bytes - redirect_bytes + extra_link
        if cfg.migrate_pages_per_step > 0:
            avail = avail - mig_bytes
        spill_budget = torch.floor(avail * mgr.recip32(page_b)).to(torch.int32)
        budget_bytes = budget_bytes + extra_link

    home_base = ((first + torch.arange(ns, dtype=torch.int32, device=dev))
                 * n)[:, None, None]
    state = _admit(cfg, state, kept, sent, home_base=home_base,
                   **({} if xch is None else dict(
                       imported=xch.imports, import_src=xch.import_src,
                       import_home=xch.import_home)))
    (state, active, attn_norm, spill_pages, offsite_after,
     quant_err) = _decode_all(cfg, state, dram_lenders, spill_budget, x)
    stats = {
        "active": active,
        "redirected": sent.sum(dim=-1, dtype=torch.int32),
        "queued": state.queue,
        "util": utilization(cfg, state),
        "attn_norm": attn_norm,
        "offsite_pages": offsite_after,
        "log_commits": state.pool.logs.commits.sum(dtype=torch.int32),
        "want_pages": want_pages,
        # unified LINK_BW account per replica: with metering, spill +
        # redirect <= budget every step (budget includes cross-shard
        # borrowed bytes, net of the hop tax); unmetered, budget and
        # redirect bytes are zero and spill bytes report the offsite page
        # traffic
        "link_budget_bytes": budget_bytes,
        "link_redirect_bytes": redirect_bytes,
        "link_spill_bytes": spill_pages.to(torch.float32) * page_b,
        # requests exchanged and LINK bytes borrowed across shards this step
        "cross_redirected": scalar0 if xch is None else xch.cross_redirected,
        "cross_link_borrowed_bytes": scalar0 if xch is None else xch.cross_borrowed,
        # write-side int8 quantization error (sum of squared read-back
        # error over this step's token rows); zero for fp32 pages
        "quant_err_norm": quant_err,
    }
    every = None
    if ranks is not None:
        # one gather of every stat; the reference's psums are the sums of
        # the gathered scalars in shard order (the exchange's totals are
        # global already)
        every = ranks.gather_all(stats)
        for k in ("attn_norm", "log_commits", "quant_err_norm"):
            stats[k] = every[k] = mgr.seq_sum(every[k])
    if cfg.obs.enabled:
        with obs_x.scope("obs_record"):
            ring_vals = {k: v if v.dim() else v.expand(ns)
                         for k, v in stats.items()}
            ring_vals["hbm_pressure"] = hbm_pressure(cfg, state)
            ring_vals["migrated_pages"] = migrated.to(torch.float32)
            ring_vals["migration_bytes"] = mig_bytes
            ring_vals["util_hist"] = stats["util"]
            ms = ENGINE_METRICS.record(state.obs.metrics, ring_vals)
            base = (first + torch.arange(ns, dtype=torch.int32, device=dev)) * n
            rows, mask = obs_s.table_event_rows(prev_table, state.table,
                                                state.step_count, base=base)
            # ONE append a step: the table-diff rows and the exchange's
            # grant rows concatenated
            xrows = [] if xch is None else _grant_rows(cfg, xch, state.step_count,
                                                       first)
            log = obs_s.append(state.obs.events,
                               torch.cat([rows] + [r for r, _ in xrows], dim=-2),
                               torch.cat([mask] + [m for _, m in xrows], dim=-1))
            state = state._replace(obs=EngineObs(metrics=ms, events=log))
    return state, (stats if every is None else every)


# the pool's fields with a replica axis, and the state's (each a tensor, a
# NamedTuple of them, or None)
_POOL_FIELDS = ("k_scale", "v_scale", "used", "owner_seq", "page_table",
                "seq_len", "seq_active")
_STATE_FIELDS = ("home_of", "remaining", "queue", "mrc", "obs", "dead",
                 "reclaim")
# the fields a shard owns (each leaf leads with the replica or shard
# axis); step_count and the decode weights are replicated
SHARDED_FIELDS = ("pool", "table") + _STATE_FIELDS


def _to_shards(cfg: EngineConfig, state: EngineState,
               s: int | None = None) -> EngineState:
    """Canonical [R, ...] layout -> [S, R/S, ...] for every field a shard
    owns: pool metadata, WAL (one log per shard, its counters [S]),
    descriptor table, home_of, remaining, queue, the SHARDS state, the
    obs rings and log (their [S] leaves become [S, 1], the shard's local
    view), the dead mask and the predictor's carry. The K/V planes stay
    flat by global page id. ``s`` is the count of shards the state holds:
    ``cfg.n_shards``, or 1 for a rank's block (`split_state`)."""
    s = cfg.n_shards if s is None else s

    def split(x):
        return x.reshape(s, x.shape[0] // s, *x.shape[1:])

    pool, logs = state.pool, state.pool.logs
    logs = logs._replace(keys=split(logs.keys), vals=split(logs.vals),
                         count=split(logs.count),
                         flushes=logs.flushes.reshape(s),
                         commits=logs.commits.reshape(s))
    pool = pool._replace(logs=logs,
                         **{f: split(getattr(pool, f)) for f in _POOL_FIELDS})
    return state._replace(
        pool=pool, table=desc.IdleResourceTable(*map(split, state.table)),
        **{f: _tree_map(split, getattr(state, f)) for f in _STATE_FIELDS})


def _from_shards(cfg: EngineConfig, state: EngineState) -> EngineState:
    """[S, R/S, ...] -> the canonical layout (or a rank's block)."""
    def merge(x):
        return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])

    # one shard keeps the reference's scalar counters
    counter = (lambda c: c.reshape(())) if cfg.n_shards == 1 else (lambda c: c)
    pool, logs = state.pool, state.pool.logs
    logs = logs._replace(keys=merge(logs.keys), vals=merge(logs.vals),
                         count=merge(logs.count),
                         flushes=counter(logs.flushes),
                         commits=counter(logs.commits))
    pool = pool._replace(logs=logs,
                         **{f: merge(getattr(pool, f)) for f in _POOL_FIELDS})
    return state._replace(
        pool=pool, table=desc.IdleResourceTable(*map(merge, state.table)),
        **{f: _tree_map(merge, getattr(state, f)) for f in _STATE_FIELDS})


def _step_inputs(cfg: EngineConfig, dev, arrivals, x, generator):
    """`step`'s arrivals int32[R] and activations float32 [R, St, d] on
    ``dev`` (drawn N(0, 0.1^2) from ``generator`` when ``x`` is None)."""
    if isinstance(arrivals, torch.Tensor):
        arrivals = arrivals.to(device=dev, dtype=torch.int32)
    else:
        arrivals = torch.as_tensor(np.asarray(arrivals, np.int32), device=dev)
    if x is None:
        x = torch.randn((cfg.n_replicas, total_slots(cfg),
                         cfg.n_heads * cfg.head_dim),
                        generator=generator, device=dev) * 0.1
    else:
        x = x.to(device=dev, dtype=torch.float32)
    return arrivals, x


def step(cfg: EngineConfig, state: EngineState, arrivals, *,
         x: torch.Tensor | None = None,
         generator: torch.Generator | None = None):
    """One engine step: management round(s) -> route -> exchange -> admit
    -> decode -> stats, every shard at once. ``arrivals`` int[R] new
    requests per replica. ``x`` [R, St, d] float32 is the step's decode
    activations; when None they are drawn N(0, 0.1^2) from ``generator``
    (a generator on the state's device; the default generator when None).
    Returns (state', stats); the input state must not be reused (its K/V
    planes are updated in place)."""
    arrivals, x = _step_inputs(cfg, state.queue.device, arrivals, x, generator)
    ns, nl = cfg.n_shards, local_replicas(cfg)
    out, stats = _shard_step(cfg, _to_shards(cfg, state),
                             arrivals.reshape(ns, nl),
                             x.reshape(ns, nl, *x.shape[1:]))
    out = _from_shards(cfg, out)._replace(step_count=state.step_count + 1)
    return out, _finish_stats(stats)


def run_steps(cfg: EngineConfig, state: EngineState, arrivals_txr, k=None,
              *, xs=None, generator: torch.Generator | None = None):
    """Multi-step driver: ``k`` engine steps (default T) where step i
    consumes row ``i % T`` of the int[T, R] arrival schedule and, when
    given, ``xs[i]`` as its activations. Returns (state', stats) with every
    stat stacked along a leading [k] step axis — the same keys and
    per-step values as `step`."""
    t = len(arrivals_txr)
    n = t if k is None else int(k)
    log = []
    for i in range(n):
        state, stats = step(cfg, state, arrivals_txr[i % t],
                            x=None if xs is None else xs[i],
                            generator=generator)
        log.append(stats)
    return state, {key: torch.stack([s[key] for s in log])
                   for key in (log[0] if log else {})}


# ------------------------------------------------- the multi-rank step
SHARD_AXIS = "shards"  # the serving mesh's axis (`launch.mesh.make_serving_mesh`)


class _Ranks(NamedTuple):
    """A rank's place on the serving mesh: the shard it owns (its
    coordinate on the shard axis), the shard count and the axis's process
    group. Its one collective is an all-reduce, which gloo (staging CUDA
    tensors through the host) and NCCL both take: a gather is the SUM of
    a zeroed [S, ...] buffer where each rank fills its row, in float64,
    which holds every int32 and float32 exactly (a -0.0 comes back +0.0)."""

    sid: int
    n: int
    group: object

    def gather_all(self, tensors: dict) -> dict:
        """{name: [ns, ...]} held here -> {name: [S * ns, ...]} of every
        rank, in shard order; 0-dim tensors come back [S]. One all-reduce."""
        import torch.distributed as dist
        flat = [t.reshape(1, -1).to(torch.float64) for t in tensors.values()]
        row = torch.cat(flat, dim=1)
        buf = torch.zeros((self.n, row.shape[1]), dtype=torch.float64,
                          device=row.device)
        buf[self.sid] = row[0]
        dist.all_reduce(buf, group=self.group)
        out, at = {}, 0
        for (k, t), f in zip(tensors.items(), flat):
            part = buf[:, at:at + f.shape[1]].to(t.dtype)
            at += f.shape[1]
            out[k] = part.reshape(self.n * t.shape[0], *t.shape[1:]) if t.dim() \
                else part.reshape(self.n)
        return out


def _across(ranks: _Ranks | None, x: torch.Tensor) -> torch.Tensor:
    """[ns, ...] for the shards this process holds -> [S, ...] for every
    shard (the reference's all_gather)."""
    return x if ranks is None else ranks.gather_all({"x": x})["x"]


def state_partition_specs(cfg: EngineConfig) -> EngineState:
    """Per-leaf spec tree of an `EngineState` on the 1-D replica-shard
    mesh: every leaf of a shard-owned field (SHARDED_FIELDS: the pool with
    its K/V planes and [n_shards] WAL counters, the table, home_of,
    remaining, queue, the SHARDS state, the obs plane, the dead mask, the
    predictor's carry) shards its leading axis over SHARD_AXIS
    (``("shards",)``); step_count and the decode weights replicate
    (``()``); fields the config leaves out stay None. `split_state` and
    `join_states` are the split and the merge these specs describe;
    `launch.sharding.engine_state_shardings` gives their placements."""
    z = torch.zeros(())
    d, kvd = cfg.n_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    shapes = init(cfg, {n: z.expand(sh) for n, sh in
                        (("wq", (d, d)), ("wk", (d, kvd)), ("wv", (d, kvd)),
                         ("wo", (d, d)))}, device="meta")

    def specs(field):
        spec = (SHARD_AXIS,) if field in SHARDED_FIELDS else ()
        return _tree_map(lambda _: spec, getattr(shapes, field))

    return EngineState(**{f: specs(f) for f in EngineState._fields})


def split_state(cfg: EngineConfig, state: EngineState, shard: int) -> EngineState:
    """Shard ``shard``'s block of a canonical [R, ...] state, as the
    reference's device_put by `state_partition_specs` places it: each
    shard-owned leaf's block of its leading axis (R / S replicas, or one
    of the pool's [S] WAL counters and of the obs plane's [S] lanes), the
    K/V planes' pages of the shard's replicas with a scratch page of its
    own; replicated fields shared. The block is a copy. Needs
    ``n_shards >= 2``."""
    s = cfg.n_shards
    if s < 2 or not 0 <= shard < s:
        raise ValueError(f"split_state needs n_shards >= 2 and 0 <= shard < "
                         f"n_shards; got n_shards={s}, shard={shard}")
    rows = local_replicas(cfg) * cfg.pages_per_replica

    def block(x):
        return x.reshape(s, x.shape[0] // s, *x.shape[1:])[shard].clone()

    pool = state.pool
    planes = {f: torch.cat([getattr(pool, f)[shard * rows:(shard + 1) * rows],
                            getattr(pool, f)[-1:]]) for f in ("k", "v")}
    pool = pool._replace(logs=_tree_map(block, pool.logs), **planes,
                         **{f: block(getattr(pool, f)) for f in _POOL_FIELDS})
    return state._replace(
        pool=pool, table=_tree_map(block, state.table),
        **{f: _tree_map(block, getattr(state, f)) for f in _STATE_FIELDS})


def join_states(cfg: EngineConfig, blocks) -> EngineState:
    """The canonical state from every shard's block, in shard order (the
    inverse of `split_state`; the scratch page is shard 0's)."""
    if len(blocks) != cfg.n_shards:
        raise ValueError(f"join_states needs {cfg.n_shards} blocks, got "
                         f"{len(blocks)}")
    cat = lambda *xs: torch.cat(xs)
    first, pools = blocks[0], [b.pool for b in blocks]
    planes = {f: torch.cat([getattr(p, f)[:-1] for p in pools]
                           + [getattr(pools[0], f)[-1:]]) for f in ("k", "v")}
    pool = first.pool._replace(
        logs=_tree_map(cat, *(p.logs for p in pools)), **planes,
        **{f: cat(*(getattr(p, f) for p in pools)) for f in _POOL_FIELDS})
    return first._replace(
        pool=pool, table=_tree_map(cat, *(b.table for b in blocks)),
        **{f: _tree_map(cat, *(getattr(b, f) for b in blocks))
           for f in _STATE_FIELDS})


def make_sharded_step(cfg: EngineConfig, mesh=None):
    """The engine step of one rank of the serving mesh: each rank of its
    SHARD_AXIS dim owns one shard's ``n_replicas / n_shards`` replicas
    (its block of the state, `split_state`), runs the full local round on
    them, and joins the exchange across shards through collectives of
    the axis's process group (DESIGN.md §9): the reference's shard_map'ed
    step on `torch.distributed`.

    ``mesh`` defaults to `launch.mesh.make_serving_mesh(cfg.n_shards)`
    (CUDA; the caller initialises the process group). Returns
    ``step_fn(block, arrivals, *, x=None, generator=None) -> (block',
    stats)``: ``arrivals`` int[R] and ``x`` [R, St, d] are what `step`
    takes (each rank takes its replicas' rows; with ``x`` None every rank
    draws the whole [R, St, d] from ``generator`` as `step` does, so ranks
    seeded alike decode the activations one `step` would); ``stats`` are
    `step`'s, the same on every rank: per-replica stats over every shard,
    sums and the reference's psums over every shard. Integer stats and
    state equal `step`'s; floats summed across ranks differ in their last
    bits. The input block must not be reused."""
    if cfg.n_shards < 2:
        raise ValueError("make_sharded_step needs cfg.n_shards >= 2; "
                         "single-shard serving is just `step`")
    _validate(cfg)
    if mesh is None:
        from repro_torch.launch.mesh import make_serving_mesh
        mesh = make_serving_mesh(cfg.n_shards)
    names = tuple(mesh.mesh_dim_names or ())
    if names != (SHARD_AXIS,) or mesh.size() != cfg.n_shards:
        raise ValueError(f"make_sharded_step needs a 1-D mesh ({SHARD_AXIS!r},) "
                         f"of n_shards={cfg.n_shards} ranks; got {names} of "
                         f"{mesh.size()}")
    ranks = _Ranks(sid=mesh.get_local_rank(SHARD_AXIS), n=cfg.n_shards,
                   group=mesh.get_group(SHARD_AXIS))
    nl = local_replicas(cfg)
    mine = slice(ranks.sid * nl, (ranks.sid + 1) * nl)

    def sharded_step(state: EngineState, arrivals, *, x: torch.Tensor | None = None,
                     generator: torch.Generator | None = None):
        if state.queue.shape != (nl,):
            raise ValueError(f"a rank steps its block of {nl} replicas "
                             f"(`split_state`); got {tuple(state.queue.shape)}")
        arrivals, x = _step_inputs(cfg, state.queue.device, arrivals, x, generator)
        out, stats = _shard_step(cfg, _to_shards(cfg, state, 1),
                                 arrivals[mine].reshape(1, nl),
                                 x[mine].reshape(1, nl, *x.shape[1:]), ranks)
        out = _from_shards(cfg, out)._replace(step_count=state.step_count + 1)
        return out, _finish_stats(stats)

    return sharded_step


def obs_history(state: EngineState) -> dict:
    """Host-decode the metric rings of a canonical-layout state:
    {metric: [windows, lanes(, bins)]} oldest-first (empty when obs is
    disabled)."""
    if state.obs is None:
        return {}
    return ENGINE_METRICS.history(state.obs.metrics)


def obs_totals(state: EngineState) -> dict:
    if state.obs is None:
        return {}
    return ENGINE_METRICS.totals(state.obs.metrics)


def obs_events(state: EngineState):
    """Host-decode the grant-lifecycle log: (records, n_dropped). Level-0
    lender/borrower ids are global replica ids; level>=1 rows carry shard
    ids (the exchange's scope)."""
    if state.obs is None:
        return [], 0
    return obs_s.decode(state.obs.events)
