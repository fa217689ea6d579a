"""Cross-replica paged KV pool — the paper's disaggregated DRAM, serving KV.

Port of `repro.serving.kv_pool`. Every replica owns a physical page pool;
page ids are GLOBAL (phys = owner_replica * pages_per_replica + local), so
a sequence's page table can point into a peer replica's pool — XBOF DRAM
harvesting. Offsite allocations commit WAL entries into the borrower's
local log (`core.wal`), so a lender loss is recoverable by replay (§4.5).

Storage is fp (fp32/bf16) or, with ``quant="int8"``, int8 codes plus one
fp32 dequant scale per page and plane (the running max-abs of everything
written to the page / 127). A write that raises the max rescales the whole
page in one multiply-round pass.

Unlike the reference, `append_tokens` writes the K/V planes IN PLACE: the
input pool's ``k``/``v`` tensors are updated, so callers rebind the
returned pool and do not reuse the old one (the reference's step donates
its state for the same reason). The K/V planes are indexed by global page
id, flat ([R*P + 1, page, KV, Dh], where the reference keeps [R, P, page,
KV, Dh]), and their last page is scratch: rows that must not write
(inactive slots, denied allocations) write there instead, so the step
needs neither a filter (a host sync) nor a rebuilt pool, and no two live
writes ever meet. Readers take ``k[:R*P]``. The small metadata arrays are
rebuilt functionally the same way, through a temporary one-slot tail.

The hierarchical engine splits the replicas into shards of ``nl`` and
hands these functions a pool whose metadata carries a leading shard axis
([S, nl, ...]; the WAL one log per shard): the port's counterpart of the
reference's `jax.vmap`. Every id a shard stores is local to it, as in the
reference — page ids ``owner * P + idx`` with ``owner < nl``, sequence ids
``home * S_slots + slot``, lenders ranked within the shard — while the K/V
planes stay flat by global page id, so a plane row is the stored id plus
the shard's base ``s * nl * P``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import wal

NO_PAGE = -1

QMAX = 127.0       # int8 code range: scale = running max-abs / QMAX
_SCALE_EPS = 1e-12  # guards 0/0 on all-zero pages
# the reference's compiled step divides by the constant QMAX as a product
# with its float32 reciprocal (XLA's rewrite); so does the port, so the
# page scales match bit for bit
_INV_QMAX = float(np.float32(1.0) / np.float32(QMAX))


class PagedPool(NamedTuple):
    # metadata shapes are [R, ...], or [S, nl, ...] with a shard axis
    k: torch.Tensor           # [R*P + 1, page, KV, Dh] fp storage or int8
    v: torch.Tensor           #   codes by global page id; the last is scratch
    k_scale: torch.Tensor     # [R, P] fp32 per-page dequant scale (0 = empty;
    v_scale: torch.Tensor     #        inert all-zeros when not quantized)
    used: torch.Tensor        # [R, P] bool — physical page allocated
    owner_seq: torch.Tensor   # [R, P] int32 — global seq id using the page (-1)
    page_table: torch.Tensor  # [R, S_slots, max_pages] int32 global phys ids
    seq_len: torch.Tensor     # [R, S_slots] int32 tokens per sequence slot
    seq_active: torch.Tensor  # [R, S_slots] bool
    logs: wal.LogPages        # borrower-side redo logs for OFFSITE pages


def make_pool(n_replicas: int, pages_per_replica: int, page: int, kv: int,
              dh: int, seq_slots: int, max_pages: int,
              dtype=torch.bfloat16, quant: str = "none", *,
              device=None) -> PagedPool:
    if quant not in ("none", "int8"):
        raise ValueError(f"quant must be 'none' or 'int8', got {quant!r}")
    dev = resolve_device(device)
    r, p = n_replicas, pages_per_replica
    store = torch.int8 if quant == "int8" else dtype
    plane = (r * p + 1, page, kv, dh)   # + the scratch page
    return PagedPool(
        k=torch.zeros(plane, dtype=store, device=dev),
        v=torch.zeros(plane, dtype=store, device=dev),
        k_scale=torch.zeros((r, p), dtype=torch.float32, device=dev),
        v_scale=torch.zeros((r, p), dtype=torch.float32, device=dev),
        used=torch.zeros((r, p), dtype=torch.bool, device=dev),
        owner_seq=torch.full((r, p), -1, dtype=torch.int32, device=dev),
        page_table=torch.full((r, seq_slots, max_pages), NO_PAGE,
                              dtype=torch.int32, device=dev),
        seq_len=torch.zeros((r, seq_slots), dtype=torch.int32, device=dev),
        seq_active=torch.zeros((r, seq_slots), dtype=torch.bool, device=dev),
        logs=wal.make_log(r * p, device=dev),
    )


def quantized(pool: PagedPool) -> bool:
    """True when the pool stores int8 codes + live scale planes."""
    return pool.k.dtype == torch.int8


# the pool's fields with a replica axis (k and v are flat by global id)
_META = ("k_scale", "v_scale", "used", "owner_seq", "page_table", "seq_len",
         "seq_active")


def _with_shard_axis(pool: PagedPool) -> PagedPool:
    """The pool as one shard: a leading axis of 1 on the metadata and the
    WAL."""
    return pool._replace(logs=wal.LogPages(*(x[None] for x in pool.logs)),
                         **{f: getattr(pool, f)[None] for f in _META})


def _without_shard_axis(pool: PagedPool) -> PagedPool:
    return pool._replace(logs=wal.LogPages(*(x[0] for x in pool.logs)),
                         **{f: getattr(pool, f)[0] for f in _META})


def free_pages(pool: PagedPool) -> torch.Tensor:
    """int32[..., R] — unallocated pages per replica (descriptor amount)."""
    return (~pool.used).sum(dim=-1).to(torch.int32)


def page_nbytes(pool: PagedPool) -> int:
    """Bytes one KV page moves across the fabric when spilled to a lender:
    page_len x kv_heads x head_dim x (K and V) at the STORED dtype, plus
    the two fp32 page scales of a quantized pool. A Python int derived from
    shapes — the unit the engine's LINK_BW byte account debits."""
    page_sz, kv, dh = pool.k.shape[1:]
    payload = page_sz * kv * dh * 2 * pool.k.element_size()
    if quantized(pool):
        payload += 2 * 4
    return int(payload)


def _quantize_rows(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp32 values -> int8 codes at a per-row scale (scale 0 -> codes 0).
    `torch.round` rounds half to even, as the reference's `jnp.round`."""
    q = torch.round(x32 / torch.clamp(scale, min=_SCALE_EPS))
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def _requant_write(pages32: torch.Tensor, old_s: torch.Tensor,
                   slot: torch.Tensor, toks32: torch.Tensor):
    """Rescale-on-write for a batch of int8 pages (as fp32 code values):
    new scale = max(old running max-abs, the token row's max-abs)/QMAX;
    existing codes shift to it in one multiply-round pass (ratio 0 on a
    fresh page clears stale codes), then the token row lands at ``slot``.

    pages32 [N, page, KV, Dh]; old_s [N]; slot [N]; toks32 [N, KV, Dh].
    Returns (int8 pages [N, page, KV, Dh], new scales [N])."""
    n = pages32.shape[0]
    new_s = torch.maximum(old_s, toks32.abs().amax(dim=(-2, -1)) * _INV_QMAX)
    ratio = torch.where(new_s > 0, old_s / torch.clamp(new_s, min=_SCALE_EPS),
                        0.0)
    codes = torch.clamp(torch.round(pages32 * ratio[:, None, None, None]),
                        -QMAX, QMAX).to(torch.int8)
    codes[torch.arange(n, device=codes.device), slot] = _quantize_rows(
        toks32, new_s[:, None, None])
    return codes, new_s


def offsite_pages(pool: PagedPool) -> torch.Tensor:
    """int32[..., R] — pages each HOME replica maps in peer pools (the §4.5
    spill footprint). Owner and home are both local to a shard."""
    r, p = pool.used.shape[-2:]
    owner = torch.div(pool.page_table, p, rounding_mode="floor")
    mapped = pool.page_table >= 0
    home = torch.arange(r, dtype=pool.page_table.dtype,
                        device=pool.used.device)[:, None, None]
    return (mapped & (owner != home)).sum(dim=(-2, -1)).to(torch.int32)


def _scatter(flat: torch.Tensor, target: torch.Tensor, values, fill):
    """Write ``values`` (a tensor, or one Python scalar for every target)
    at ``target`` of ``flat`` through a temporary one-slot tail (masked
    rows target it) and drop the tail. A scalar goes through `index_fill_`:
    assigning it by indexing would copy it to the device first, a sync."""
    ext = torch.cat([flat, flat.new_full((1,), fill)])
    if isinstance(values, torch.Tensor):
        ext[target] = values
    else:
        ext.index_fill_(0, target, values)
    return ext[:-1]


def append_tokens(pool: PagedPool, k_toks: torch.Tensor, v_toks: torch.Tensor,
                  active: torch.Tensor, lender_mask: torch.Tensor,
                  spill_budget: torch.Tensor | None = None):
    """Append one token's K/V to every active (replica, slot) at once.
    Returns (pool', spilled) — ``spilled`` int32[R] is the offsite pages
    granted to each HOME replica by this call.

    ``k_toks``/``v_toks``: [R, S, KV, Dh]; ``active``: bool[R, S];
    ``lender_mask``: bool[R] DRAM lenders for offsite spill;
    ``spill_budget``: optional int32[R] LINK_BW cap on offsite grants per
    home replica (None leaves spill unmetered). With a shard axis every
    argument leads with it too ([S, nl, ...]) and each shard allocates
    from its own pools only.

    Allocation, with no per-slot loop:
      * page-boundary slots rank themselves by slot index and the j-th
        requester takes the j-th lowest free page of its HOME pool;
      * the rest spill to lender pages, lenders ordered most-spare-first
        (a stable sort) after each lender's own requests (§4.4: lending
        must not hurt the lender);
      * every offsite grant WAL-commits its page-table update (§4.5).
    A spill the budget denies leaves the sequence unallocated this step
    (no token written, seq_len unchanged): backpressure, not data loss.

    The K/V planes are written in place (see the module doc).
    """
    if pool.used.dim() == 2:
        out, spilled = _append(
            _with_shard_axis(pool), k_toks[None], v_toks[None], active[None],
            lender_mask[None], None if spill_budget is None else spill_budget[None])
        return _without_shard_axis(out), spilled[0]
    return _append(pool, k_toks, v_toks, active, lender_mask, spill_budget)


def _append(pool, k_toks, v_toks, active, lender_mask, spill_budget):
    """`append_tokens` on a pool with a shard axis: [ns, r, ...]."""
    ns, r, p = pool.used.shape
    s_slots = pool.seq_len.shape[-1]
    page_sz = pool.k.shape[1]
    mp = pool.page_table.shape[-1]
    dev = pool.used.device
    if pool.k.shape[0] != ns * r * p + 1 or pool.v.shape != pool.k.shape:
        raise ValueError(
            f"K/V planes must be [R*P + 1, page, KV, Dh] = [{ns * r * p + 1}, "
            f"...] (make_pool's, with the scratch page); got "
            f"{tuple(pool.k.shape)}, {tuple(pool.v.shape)}")
    length = pool.seq_len.long()                        # [ns, r, S]
    need = active & (length % page_sz == 0)
    need_i = need.long()

    # ---- local allocation: j-th requester <- j-th lowest free home page
    free_cnt = (~pool.used).sum(dim=-1)                 # [ns, r]
    rank = torch.cumsum(need_i, dim=-1) - need_i        # [ns, r, S] exclusive
    local_ok = need & (rank < free_cnt[..., None])
    free_order = torch.argsort(pool.used.to(torch.uint8), dim=-1, stable=True)
    local_idx = torch.gather(free_order, -1, rank.clamp(0, p - 1))

    # ---- overflow -> lender spare pages of the shard, most-spare first
    consumed = torch.minimum(need_i.sum(dim=-1), free_cnt)
    spare = torch.where(lender_mask, free_cnt - consumed, 0)
    lorder = torch.argsort(-spare, dim=-1, stable=True)
    spare_sorted = torch.gather(spare, -1, lorder)
    bounds = torch.cumsum(spare_sorted, dim=-1)         # inclusive
    offs = bounds - spare_sorted                        # exclusive
    total_spare = bounds[:, -1]                         # [ns]

    ov = need & ~local_ok
    if spill_budget is not None:
        ov_i = ov.long()
        ov_rank = torch.cumsum(ov_i, dim=-1) - ov_i
        ov = ov & (ov_rank < spill_budget.long()[..., None])
    ovf = ov.reshape(ns, -1).long()
    g = torch.cumsum(ovf, dim=-1) - ovf                 # [ns, r*S]
    lpos = torch.searchsorted(bounds, g, right=True).clamp(0, r - 1)
    lender = torch.gather(lorder, -1, lpos)             # [ns, r*S]
    within = torch.gather(consumed, -1, lender) + g - torch.gather(offs, -1, lpos)
    lender_idx = torch.gather(free_order.reshape(ns, r * p), -1,
                              lender * p + within.clamp(0, p - 1))
    lender = lender.reshape(ns, r, s_slots)
    lender_idx = lender_idx.reshape(ns, r, s_slots)
    ov_ok = ov & (g.reshape(ns, r, s_slots) < total_spare[:, None, None])

    homes = torch.arange(r, device=dev)[None, :, None].expand(ns, r, s_slots)
    slots = torch.arange(s_slots, device=dev)[None, None, :]
    shard = torch.arange(ns, device=dev)[:, None, None]
    owner = torch.where(local_ok, homes, torch.where(ov_ok, lender, -1))
    idx = torch.where(local_ok, local_idx, lender_idx)
    ok = owner >= 0
    phys = torch.where(ok, owner * p + idx, NO_PAGE)    # shard-local ids

    okf = ok.reshape(-1)
    target = torch.where(okf, (shard * (r * p) + owner * p + idx).reshape(-1),
                         ns * r * p)
    gid = (homes * s_slots + slots).reshape(-1)
    used = _scatter(pool.used.reshape(-1), target, True, False).reshape(ns, r, p)
    owner_seq = _scatter(pool.owner_seq.reshape(-1), target,
                         gid.to(torch.int32), -1).reshape(ns, r, p)

    lpage = (length // page_sz).clamp(0, mp - 1)        # [ns, r, S]
    pt_target = torch.where(
        okf, (((shard * r + homes) * s_slots + slots) * mp + lpage).reshape(-1),
        ns * r * s_slots * mp)
    table = _scatter(pool.page_table.reshape(-1), pt_target,
                     phys.reshape(-1).to(torch.int32), NO_PAGE)
    table = table.reshape(ns, r, s_slots, mp)

    # ---- WAL commits for the offsite grants (§4.5), into each shard's log
    offsite = ok & (owner != homes)
    logs = wal.commit_batch(
        pool.logs,
        (homes * p + idx % p).reshape(ns, -1),
        (slots * mp + lpage).reshape(ns, -1),
        phys.reshape(ns, -1),
        mask=offsite.reshape(ns, -1),
    )

    # ---- token write into (page, slot) of every active sequence; the
    # plane row is the shard's base plus the stored id
    tphys = torch.gather(table, -1, lpage[..., None])[..., 0].long()
    valid_t = active & (tphys >= 0)
    t_page = torch.where(
        valid_t,
        shard * (r * p)
        + torch.div(tphys, p, rounding_mode="floor").clamp(0, r - 1) * p
        + (tphys % p).clamp(0, p - 1), ns * r * p).reshape(-1)
    t_slot = (length % page_sz).reshape(-1)
    kd = pool.k.shape[2:]
    kx, vx = pool.k, pool.v
    k_rows = k_toks.reshape(-1, *kd)
    v_rows = v_toks.reshape(-1, *kd)
    k_scale, v_scale = pool.k_scale, pool.v_scale
    if quantized(pool):
        # rescale-on-write: distinct active slots hold distinct pages
        # (owner_seq ownership), so no two live rows share a page
        ks_flat = torch.cat([k_scale.reshape(-1), k_scale.new_zeros(1)])
        vs_flat = torch.cat([v_scale.reshape(-1), v_scale.new_zeros(1)])
        kc, ks_new = _requant_write(kx[t_page].float(), ks_flat[t_page],
                                    t_slot, k_rows.float())
        vc, vs_new = _requant_write(vx[t_page].float(), vs_flat[t_page],
                                    t_slot, v_rows.float())
        kx[t_page] = kc
        vx[t_page] = vc
        ks_flat[t_page] = ks_new
        vs_flat[t_page] = vs_new
        k_scale = ks_flat[:-1].reshape(k_scale.shape)
        v_scale = vs_flat[:-1].reshape(v_scale.shape)
    else:
        kx[t_page, t_slot] = k_rows.to(kx.dtype)
        vx[t_page, t_slot] = v_rows.to(vx.dtype)
    pool = pool._replace(
        used=used, owner_seq=owner_seq, page_table=table, logs=logs,
        k_scale=k_scale, v_scale=v_scale,
        seq_len=pool.seq_len + valid_t.to(torch.int32))
    return pool, offsite.sum(dim=-1).to(torch.int32)


def release_sequences(pool: PagedPool, done: torch.Tensor) -> PagedPool:
    """Free every page (local and offsite) of the finished sequences in
    the bool[..., R, S] mask ``done``; freed pages drop their scales. With
    a shard axis, owner_seq holds shard-local sequence ids."""
    r = pool.used.shape[-2]
    s_slots = pool.seq_len.shape[-1]
    lead = pool.used.shape[:-2]
    owner = pool.owner_seq.long().clamp(0, r * s_slots - 1)
    done_of = done.reshape(*lead, -1).gather(
        -1, owner.reshape(*lead, -1)).reshape(owner.shape)
    page_done = (pool.owner_seq >= 0) & done_of
    return pool._replace(
        used=pool.used & ~page_done,
        owner_seq=torch.where(page_done, -1, pool.owner_seq),
        k_scale=torch.where(page_done, 0.0, pool.k_scale),
        v_scale=torch.where(page_done, 0.0, pool.v_scale),
        page_table=torch.where(done[..., None], NO_PAGE, pool.page_table),
        seq_len=torch.where(done, 0, pool.seq_len),
        seq_active=pool.seq_active & ~done,
    )


def gather_kv(pool: PagedPool, home: int, seq_slot: int):
    """Flat (k, v, valid) views of one sequence across ALL owner pools:
    k/v [max_pages*page, KV, Dh] (fp32 when the pool is quantized),
    valid bool[max_pages*page]."""
    r, p = pool.used.shape
    page_sz = pool.k.shape[1]
    table = pool.page_table[home, seq_slot]            # [mp]
    safe = table.long().clamp(0, r * p - 1)
    kg, vg = pool.k[safe], pool.v[safe]
    if quantized(pool):
        kg = kg.float() * pool.k_scale.reshape(-1)[safe][:, None, None, None]
        vg = vg.float() * pool.v_scale.reshape(-1)[safe][:, None, None, None]
    mp = table.shape[0]
    idx = torch.arange(mp * page_sz, device=table.device)
    valid = ((table.repeat_interleave(page_sz) >= 0)
             & (idx < pool.seq_len[home, seq_slot]))
    return (kg.reshape(mp * page_sz, *kg.shape[2:]),
            vg.reshape(mp * page_sz, *vg.shape[2:]), valid)
