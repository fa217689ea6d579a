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


def pages_per_replica(pool: PagedPool) -> int:
    """Physical pages each replica holds (the ``used`` table's width)."""
    return pool.used.shape[-1]


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


def _where_pool(cond: torch.Tensor, a: PagedPool, b: PagedPool) -> PagedPool:
    """``a`` where ``cond`` (a bool scalar) holds, else ``b``, field by
    field over the metadata and the WAL (the K/V planes are ``a``'s): the
    masked-write form of the reference's `lax.cond`."""
    return a._replace(
        logs=wal.LogPages(*(torch.where(cond, x, y) for x, y in zip(a.logs, b.logs))),
        **{f: torch.where(cond, getattr(a, f), getattr(b, f)) for f in _META})


def alloc_page(pool: PagedPool, home, seq_slot, lender_mask: torch.Tensor):
    """Allocate one physical page for (home replica, seq slot) of a pool
    without a shard axis — the reference's scalar API (its tests' oracle).

    Prefers the home pool; when that is full, takes the lowest free page of
    the best lender (most free pages among ``lender_mask`` bool[R], first
    on ties) and WAL-logs the offsite mapping (key = seq_slot * max_pages +
    logical page, val = phys id) into the HOME-local log (§4.5). Every
    write is masked, so nothing is read back to the host. Returns (pool',
    phys) — phys int64[] = -1 when everything is full."""
    r, p = pool.used.shape
    s_slots = pool.seq_len.shape[1]
    mp = pool.page_table.shape[2]
    dev = pool.used.device
    home = torch.as_tensor(home, device=dev).long()
    seq_slot = torch.as_tensor(seq_slot, device=dev).long()
    free = (~pool.used).to(torch.int32)
    has_local = free[home].any()
    local_idx = free[home].argmax()                  # first free home page

    free_cnt = free.sum(dim=1)
    cand = torch.where(lender_mask.to(torch.bool)
                       & (torch.arange(r, device=dev) != home), free_cnt, -1)
    lender = cand.argmax()
    lender_ok = cand[lender] > 0
    lender_idx = free[lender].argmax()

    owner = torch.where(has_local, home, torch.where(lender_ok, lender, -1))
    idx = torch.where(has_local, local_idx, lender_idx)
    ok = owner >= 0
    phys = torch.where(ok, owner * p + idx, NO_PAGE)
    safe_owner = owner.clamp(0, r - 1)

    used = pool.used.clone()
    used[safe_owner, idx] = used[safe_owner, idx] | ok
    owner_seq = pool.owner_seq.clone()
    owner_seq[safe_owner, idx] = torch.where(
        ok, home * s_slots + seq_slot, owner_seq[safe_owner, idx].long()).to(torch.int32)
    lpage = pool.seq_len[home, seq_slot].long() // pool.k.shape[1]
    lp = lpage.clamp(0, mp - 1)
    table = pool.page_table.clone()
    table[home, seq_slot, lp] = torch.where(
        ok, phys, table[home, seq_slot, lp].long()).to(torch.int32)
    # WAL only for OFFSITE pages (owner != home), into home's log region
    logs = wal.commit(pool.logs, home * p + idx % p, seq_slot * mp + lpage,
                      phys, enable=ok & (owner != home))
    return pool._replace(used=used, owner_seq=owner_seq, page_table=table,
                         logs=logs), phys


def append_token(pool: PagedPool, home, seq_slot, k_tok: torch.Tensor,
                 v_tok: torch.Tensor, lender_mask: torch.Tensor) -> PagedPool:
    """Append one token's K/V ([KV, Dh]) to one sequence of a pool without
    a shard axis, allocating on a page boundary (`alloc_page`) — the
    reference's scalar API. A sequence whose page could not be allocated
    writes the scratch page and keeps its length. The K/V planes are
    written in place (see the module doc)."""
    r, p = pool.used.shape
    page_sz = pool.k.shape[1]
    mp = pool.page_table.shape[2]
    dev = pool.used.device
    home = torch.as_tensor(home, device=dev).long()
    seq_slot = torch.as_tensor(seq_slot, device=dev).long()
    length = pool.seq_len[home, seq_slot].long()
    allocated, _ = alloc_page(pool, home, seq_slot, lender_mask)
    pool = _where_pool(length % page_sz == 0, allocated, pool)
    lpage = (length // page_sz).clamp(0, mp - 1)
    phys = pool.page_table[home, seq_slot, lpage].long()
    valid = phys >= 0
    owner = torch.div(phys, p, rounding_mode="floor").clamp(0, r - 1)
    page = torch.where(valid, owner * p + (phys % p).clamp(0, p - 1), r * p)[None]
    slot = (length % page_sz)[None]
    if quantized(pool):
        ks = torch.cat([pool.k_scale.reshape(-1), pool.k_scale.new_zeros(1)])
        vs = torch.cat([pool.v_scale.reshape(-1), pool.v_scale.new_zeros(1)])
        kc, ks_new = _requant_write(pool.k[page].float(), ks[page], slot,
                                    k_tok.float()[None])
        vc, vs_new = _requant_write(pool.v[page].float(), vs[page], slot,
                                    v_tok.float()[None])
        pool.k[page] = kc
        pool.v[page] = vc
        ks[page] = ks_new
        vs[page] = vs_new
        pool = pool._replace(k_scale=ks[:-1].reshape(r, p),
                             v_scale=vs[:-1].reshape(r, p))
    else:
        pool.k[page, slot] = k_tok.to(pool.k.dtype)[None]
        pool.v[page, slot] = v_tok.to(pool.v.dtype)[None]
    seq_len = pool.seq_len.clone()
    seq_len[home, seq_slot] = seq_len[home, seq_slot] + valid.to(torch.int32)
    return pool._replace(seq_len=seq_len)


def release_sequence(pool: PagedPool, home, seq_slot) -> PagedPool:
    """Free every page (local and offsite) of one finished sequence of a
    pool without a shard axis; freed pages drop their scales."""
    dev = pool.used.device
    home = torch.as_tensor(home, device=dev).long()
    seq_slot = torch.as_tensor(seq_slot, device=dev).long()
    mine = pool.owner_seq == home * pool.seq_len.shape[1] + seq_slot
    table, seq_len = pool.page_table.clone(), pool.seq_len.clone()
    active = pool.seq_active.clone()
    table[home, seq_slot] = NO_PAGE
    seq_len[home, seq_slot] = 0
    active[home, seq_slot] = False
    return pool._replace(
        used=pool.used & ~mine,
        owner_seq=torch.where(mine, -1, pool.owner_seq),
        k_scale=torch.where(mine, 0.0, pool.k_scale),
        v_scale=torch.where(mine, 0.0, pool.v_scale),
        page_table=table, seq_len=seq_len, seq_active=active)


def drain_offsite(pool: PagedPool, src_mask: torch.Tensor, budget: torch.Tensor,
                  second_mask: torch.Tensor | None = None):
    """Live-migrate offsite KV pages OFF the replicas in ``src_mask`` — the
    §4.5 evacuation a borrower runs when a lender signals (or the
    predictor anticipates) reclaim, so the pages are gone before the
    revoke or the crash lands.

    Each held page moves HOME when the home pool has a free page, else to
    one second lender (the most-free replica of ``second_mask`` that is not
    itself draining, first on ties). The move is crash-consistent in WAL
    order: the page-table repoint commits to the borrower-local redo log
    BEFORE the source page frees, so a lender loss mid-drain replays to
    the old or the new location — never to a freed page.

    ``src_mask`` bool[R] replicas to evacuate; ``budget`` int[R] pages each
    HOME replica may pull this step (the drain rides the same link as
    spill, so the engine debits `page_nbytes` per moved page from the
    LINK_BW account); ``second_mask`` optional bool[R] alternate lenders
    (None: pages that do not fit home stay and retry next step). With a
    shard axis every argument leads with it ([S, nl, ...]) and each shard
    drains within its own pools.

    Returns (pool', moved int32[R]) — pages migrated per HOME replica. The
    K/V planes are written in place: every page of the pool is gathered
    and written to its destination, or to the scratch page when it stays
    (a static shape: nothing is read back to the host)."""
    if pool.used.dim() == 2:
        out, moved = _drain(_with_shard_axis(pool), src_mask[None], budget[None],
                            None if second_mask is None else second_mask[None])
        return _without_shard_axis(out), moved[0]
    return _drain(pool, src_mask, budget, second_mask)


def _exclusive_rank(onehot: torch.Tensor) -> torch.Tensor:
    """Per column of ``onehot`` bool[..., R, N] (one True at most, in row
    home), how many earlier columns hold a True in the same row: each
    page's arrival rank among its home's pages. Returns int64[..., N]."""
    oh = onehot.long()
    return (torch.cumsum(oh, dim=-1) - oh).sum(dim=-2)


def _drain(pool: PagedPool, src_mask, budget, second_mask):
    """`drain_offsite` on a pool with a shard axis: [ns, r, ...]."""
    ns, r, p = pool.used.shape
    s_slots = pool.seq_len.shape[-1]
    mp = pool.page_table.shape[-1]
    rp = r * p
    dev = pool.used.device
    src_mask = src_mask.to(torch.bool)
    f = torch.arange(rp, device=dev)
    row = f // p
    reps = torch.arange(r, device=dev)[:, None]
    gid = pool.owner_seq.reshape(ns, rp).long()         # shard-local seq ids
    safe_gid = gid.clamp(0, r * s_slots - 1)
    home = safe_gid // s_slots                          # [ns, rp]
    held = (pool.used.reshape(ns, rp) & src_mask[:, row] & (gid >= 0)
            & (home != row))

    # per-home arrival rank among held pages, then budget admission
    rank = _exclusive_rank((home[:, None, :] == reps) & held[:, None, :])
    adm = held & (rank < torch.gather(budget.long(), -1, home))

    # pass A: the j-th admitted page of a home takes its j-th lowest free
    # page (the allocator's free-first order)
    onehot_a = (home[:, None, :] == reps) & adm[:, None, :]
    rank_a = _exclusive_rank(onehot_a)
    free_cnt = (~pool.used).sum(dim=-1)                 # [ns, r]
    free_order = torch.argsort(pool.used.to(torch.uint8), dim=-1,
                               stable=True).reshape(ns, rp)
    home_ok = adm & (rank_a < torch.gather(free_cnt, -1, home))
    idx_a = torch.gather(free_order, -1, home * p + rank_a.clamp(0, p - 1))

    # pass B: overflow to ONE second lender (most free after pass A)
    cons_a = torch.minimum(onehot_a.sum(dim=-1), free_cnt)  # pass-A pages per dest
    if second_mask is None:
        moved = home_ok
        dest = torch.where(home_ok, home, -1)
        idx = idx_a
    else:
        cand = torch.where(second_mask.to(torch.bool) & ~src_mask,
                           free_cnt - cons_a, -1)
        s2 = cand.argmax(dim=-1, keepdim=True)          # [ns, 1], first max
        rem = adm & ~home_ok
        rem_i = rem.long()
        rank_b = torch.cumsum(rem_i, dim=-1) - rem_i
        b_ok = rem & (rank_b < torch.gather(cand, -1, s2).clamp(min=0))
        idx_b = torch.gather(
            free_order, -1,
            s2 * p + (torch.gather(cons_a, -1, s2) + rank_b).clamp(0, p - 1))
        moved = home_ok | b_ok
        dest = torch.where(home_ok, home, torch.where(b_ok, s2, -1))
        idx = torch.where(home_ok, idx_a, idx_b)
    new_phys = torch.where(moved, dest * p + idx, NO_PAGE)

    # locate each moved page in its sequence's table (old phys == f)
    pt_rows = pool.page_table.reshape(ns, r * s_slots, mp)
    match = torch.gather(pt_rows, 1, safe_gid[..., None].expand(ns, rp, mp)) \
        == f[:, None]                                   # [ns, rp, mp]
    lpage = match.to(torch.int32).argmax(dim=-1)        # first match
    moved = moved & match.any(dim=-1)

    # WAL commit FIRST (the repoint supersedes the stale lender entry on
    # replay), then repoint the table, then free the source
    logs = wal.commit_batch(pool.logs, home * p + idx % p,
                            (safe_gid % s_slots) * mp + lpage, new_phys,
                            mask=moved)
    shard = torch.arange(ns, device=dev)[:, None]
    pt_target = torch.where(moved, (shard * (r * s_slots) + safe_gid) * mp + lpage,
                            ns * r * s_slots * mp).reshape(-1)
    table = _scatter(pool.page_table.reshape(-1), pt_target,
                     new_phys.reshape(-1).to(torch.int32), NO_PAGE)

    # copy page contents (and scales) dest <- source; a page that stays is
    # written to the scratch page (plane) or the temporary tail (metadata)
    base = shard * rp
    target = torch.where(moved, base + dest.clamp(0, r - 1) * p + idx,
                         ns * rp).reshape(-1)
    source = (base + f).reshape(-1)
    pool.k[target] = pool.k[source]
    pool.v[target] = pool.v[source]
    src_t = torch.where(moved, base + f, ns * rp).reshape(-1)

    def move(x, fill):
        ext = torch.cat([x.reshape(-1), x.new_full((1,), fill)])
        out = ext.clone()
        out[target] = ext[source]
        out.index_fill_(0, src_t, fill)
        return out[:-1].reshape(x.shape)

    used = torch.cat([pool.used.reshape(-1), pool.used.new_zeros(1)])
    used.index_fill_(0, target, True)
    used.index_fill_(0, src_t, False)
    oseq = torch.cat([pool.owner_seq.reshape(-1), pool.owner_seq.new_full((1,), -1)])
    oseq[target] = gid.reshape(-1).to(torch.int32)
    oseq.index_fill_(0, src_t, -1)
    pool = pool._replace(
        k_scale=move(pool.k_scale, 0.0), v_scale=move(pool.v_scale, 0.0),
        used=used[:-1].reshape(pool.used.shape),
        owner_seq=oseq[:-1].reshape(pool.owner_seq.shape),
        page_table=table.reshape(pool.page_table.shape), logs=logs)
    per_home = torch.zeros((ns, r), dtype=torch.int32, device=dev).scatter_add_(
        -1, home, moved.to(torch.int32))
    return pool, per_home


def lender_failure(pool: PagedPool, failed):
    """Lender replica ``failed`` dies (a pool without a shard axis): every
    sequence with pages there replays its WAL to learn which logical pages
    were lost, drops them, and truncates to the last fully-surviving
    prefix (the engine re-decodes the tail); the failed pool frees
    entirely, scales included. Paper §4.5 recovery."""
    r, p = pool.used.shape
    page_sz = pool.k.shape[1]
    failed = torch.as_tensor(failed, device=pool.used.device).long()
    owner_of = torch.div(pool.page_table, p, rounding_mode="floor")
    lost = (owner_of == failed) & (pool.page_table >= 0)        # [R, S, mp]
    first_lost = lost.to(torch.int32).argmax(dim=-1)            # first lost page
    new_len = torch.where(lost.any(dim=-1),
                          torch.minimum(pool.seq_len, first_lost * page_sz),
                          pool.seq_len)
    dead = torch.arange(r, device=pool.used.device)[:, None] == failed
    return pool._replace(
        page_table=torch.where(lost, NO_PAGE, pool.page_table),
        seq_len=new_len.to(torch.int32), used=pool.used & ~dead,
        owner_seq=torch.where(dead, -1, pool.owner_seq),
        k_scale=torch.where(dead, 0.0, pool.k_scale),
        v_scale=torch.where(dead, 0.0, pool.v_scale))
