"""Mixture-of-Experts FFN (DeepSeek-v2/v3 style: shared + routed experts).

Port of `repro.models.moe`. The router's top-k goes through
`kernels.ops.topk_router` (the CUDA router kernel for CUDA tensors, the
plain version for CPU tensors); the expert and shared products are plain
large products (`torch.einsum` / `matmul`), as the reference leaves them
to XLA. Two dispatch paths, chosen by the token count as in the
reference:

- above `SMALL_BATCH_TOKENS` (prefill), the sorted-capacity dispatch per
  sequence: each sequence's (token, expert) pairs sorted stably by expert
  into [E, capacity, D] blocks; pairs past an expert's capacity drop;
- at or below it (decode), dense one-hot dispatch and combine products
  over every expert with a capacity of at least 4 slots.

One-hots compare against ``torch.arange`` and nothing reads back to the
host, so a decode step does not synchronize.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.launch.placement import is_dtensor
from .common import mean, settle
from .config import ArchConfig

# below this many tokens the dispatch uses dense one-hot products (the
# decode path); above it the sorted-capacity path (prefill)
SMALL_BATCH_TOKENS = 2048


def route(cfg: ArchConfig, p: dict, x: torch.Tensor):
    """x [T, D] -> (weights [T, k] in x's dtype, idx [T, k] int32, router
    logits [T, E] fp32). Softmax scores, or (DeepSeek-v3) sigmoid scores
    whose selection adds the aux-free bias."""
    e = cfg.moe
    logits = settle(x.float() @ p["router"].float(), x)
    if e.aux_free_bias:
        w, idx = kops.topk_router(torch.sigmoid(logits), e.top_k,
                                  bias=p["router_bias"])
    else:
        w, idx = kops.topk_router(torch.softmax(logits, dim=-1), e.top_k)
    return w.to(x.dtype), idx, logits


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of idx [...] over n classes; an index outside [0, n)
    gives a zero row, as `jax.nn.one_hot` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def aux_loss(logits: torch.Tensor, idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss (used when aux_free_bias is off)."""
    me = mean(torch.softmax(logits, dim=-1), 0)
    ce = mean(_one_hot(idx, n_experts).sum(1), 0)
    return n_experts * torch.sum(me * ce)


def _gated(g: torch.Tensor, u: torch.Tensor, act: str) -> torch.Tensor:
    # jax.nn.gelu is the tanh approximation by default
    return (F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")) * u


def _expert_ffn(xg: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """xg [..., E, C, D] grouped tokens; expert weights [E, D, F] / [E, F, D]."""
    g = torch.einsum("...ecd,edf->...ecf", xg, p["wi_gate"])
    u = torch.einsum("...ecd,edf->...ecf", xg, p["wi_up"])
    return torch.einsum("...ecf,efd->...ecd", _gated(g, u, act), p["wo"])


def moe_ffn(cfg: ArchConfig, p: dict, x: torch.Tensor):
    """x [B, S, D] -> ([B, S, D], aux loss, a 0-d fp32 tensor: 0 with the
    aux-free bias)."""
    e = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    w, idx, logits = route(cfg, p, xf)
    if is_dtensor(x):
        y = _moe_placed(cfg, p, x, w, idx)
    elif t <= SMALL_BATCH_TOKENS:
        y = _moe_small_batch(cfg, p, xf, w, idx)
    else:
        y = _moe_sorted(cfg, p, x, w, idx)
    if e.n_shared:  # always-on shared experts
        sp = p["shared"]
        y = y + settle(_gated(xf @ sp["wi_gate"], xf @ sp["wi_up"], cfg.act) @ sp["wo"], y)
    laux = (torch.zeros((), dtype=torch.float32, device=x.device)
            if e.aux_free_bias else aux_loss(logits, idx, e.n_routed))
    return y.reshape(b, s, d), laux


def _moe_sorted(cfg: ArchConfig, p: dict, x: torch.Tensor, w, idx, experts=None):
    """Sorted-capacity dispatch, per sequence: x [B, S, D], w and idx [B *
    S, k] -> y [B * S, D]. Each sequence's S * k (token, expert) pairs are
    sorted stably by expert; a pair's rank among its expert's is its slot,
    and pairs at a rank >= capacity drop. A dropped pair adds zeros into
    slot capacity - 1 (the reference's clipped scatter; x + 0 = x, so the
    dispatch's adds are exact in any order). The combine gathers each
    token's k weighted expert outputs and adds them in a fixed order, so
    one seed gives one result. With ``experts`` = (lo, n), ``p`` holds
    experts lo .. lo + n - 1 only, and only the pairs routed to them are
    dispatched and combined (the mesh trainer's expert shards)."""
    e = cfg.moe
    b, s, d = x.shape
    k, n_e = e.top_k, e.n_routed
    lo, n_l = experts or (0, n_e)
    cap = max(int(s * k / n_e * e.capacity_factor), 4)
    dev = x.device
    flat_e = idx.reshape(b, s * k).long()
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)                       # [B, S*k]
    st = torch.arange(s, device=dev).repeat_interleave(k)[order]
    sw = torch.gather(w.reshape(b, s * k), 1, order)
    pos = torch.arange(s * k, device=dev) - torch.searchsorted(se, se, side="left")
    keep = pos < cap                                          # overflow drops
    if experts is not None:
        keep = keep & (se >= lo) & (se < lo + n_l)
        se = (se - lo).clamp(0, n_l - 1)
    slot = pos.clamp(0, cap - 1)
    row = torch.arange(b, device=dev)[:, None]
    # dispatch: [B, E, cap, D] flattened to rows
    dst = ((row * n_l + se) * cap + slot).reshape(-1)
    src = torch.where(keep[..., None], x[row, st], 0).reshape(-1, d)
    xg = torch.zeros((b * n_l * cap, d), dtype=x.dtype, device=dev)
    xg.index_add_(0, dst, src)
    yg = _expert_ffn(xg.reshape(b, n_l, cap, d), p["experts"], cfg.act)
    # combine: a gather, no atomics. A token's k contributions are added
    # in the order of their places in the sorted pairs, the order in
    # which the reference's scatter applies them
    contrib = (yg.reshape(-1, d)[dst] * (sw * keep).reshape(-1, 1)).reshape(b, s * k, d)
    at = torch.argsort(order, dim=1).reshape(b, s, k).sort(dim=-1).values
    picks = torch.gather(contrib, 1, at.reshape(b, s * k, 1).expand(-1, -1, d))
    picks = picks.reshape(b * s, k, d)
    y = picks[:, 0]
    for j in range(1, k):
        y = y + picks[:, j]
    return y


def _moe_small_batch(cfg: ArchConfig, p: dict, xf: torch.Tensor, w, idx, experts=None,
                     prior=None, t_all=None):
    """Decode-path MoE: dense one-hot dispatch and combine products. A
    (token, expert) pair's slot is its rank among the expert's earlier
    pairs (a cumulative sum, no sort); every expert's FFN runs on its
    ``capacity`` slots. On one block of a batch split across ranks,
    ``prior`` [E] counts each expert's pairs in the blocks before it and
    ``t_all`` is the whole batch's token count (the capacity's); with
    ``experts`` = (lo, n), ``p`` holds experts lo .. lo + n - 1 only."""
    e = cfg.moe
    t, d = xf.shape
    k, n_e = e.top_k, e.n_routed
    lo, n_l = experts or (0, n_e)
    capacity = max(int((t_all or t) * k / n_e * e.capacity_factor), 4)
    oh_e = _one_hot(idx.reshape(t * k), n_e)                   # [Tk, E]
    rank = torch.cumsum(oh_e, dim=0) - oh_e                   # prior same-expert
    if prior is not None:
        rank = rank + prior.float()
    slot = torch.sum(rank * oh_e, dim=1).to(torch.int32)      # [Tk]
    keep = slot < capacity
    oh_c = _one_hot(slot, capacity)                           # [Tk, C]
    oh_e = oh_e[:, lo:lo + n_l]
    disp_k = ((oh_e[:, :, None] * oh_c[:, None, :]) * keep[:, None, None]
              ).reshape(t, k, n_l, capacity)
    xg = torch.einsum("tec,td->ecd", disp_k.sum(1).to(xf.dtype), xf)
    yg = _expert_ffn(xg, p["experts"], cfg.act)               # [E, C, D]
    # combine weights: per (t, e, c) the routing weight of the matching pick
    comb = torch.einsum("tkec,tk->tec", disp_k, w.float())
    return torch.einsum("tec,ecd->td", comb.to(xf.dtype), yg)


def _moe_placed(cfg: ArchConfig, p: dict, x, w, idx):
    """The routed experts on DTensors: x [B, S, D], w and idx [B * S, k]
    -> y [B * S, D] placed as the tokens (batch kept, replicated
    elsewhere). Each rank runs `_expert_ffn` on its own experts (the
    experts' leading dim keeps its shards: over "model" in training, over
    the data axes in serving; the expert-FFN dim keeps its shards too;
    an FSDP-sharded model dim is gathered) for the tokens routed to them,
    the tokens gathered over the mesh dims that shard the experts. The
    ranks' outputs are partial sums over those dims, reduced by one
    collective into the tokens' placement: no all-to-all, no gather of
    expert weights. The dispatch keeps one process's semantics: per
    sequence above `SMALL_BATCH_TOKENS` tokens in all, and below it each
    expert's slots counted across the token blocks of every rank (their
    per-expert counts gathered) with the whole batch's capacity."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.launch.placement import shard_span
    e = cfg.moe
    mesh = x.device_mesh
    ex = p["experts"]
    nd = mesh.ndim
    shards = lambda t, dim: {i for i, q in enumerate(t.placements)
                             if isinstance(q, Shard) and q.dim == dim}
    edims = shards(ex["wi_gate"], 0)
    fdims = shards(ex["wi_gate"], 2) & shards(ex["wo"], 1)
    busy = edims | fdims
    tok = {i for i in shards(x, 0) if i not in busy}
    tw = tuple(Shard(0) if i in edims else Shard(2) if i in fdims else Replicate()
               for i in range(nd))
    to = tuple(Shard(0) if i in edims else Shard(1) if i in fdims else Replicate()
               for i in range(nd))
    tx = tuple(Shard(0) if i in tok else Replicate() for i in range(nd))
    gx = tuple(Partial() if i in busy else q for i, q in enumerate(tx))
    gww = tuple(Partial() if i in tok else q for i, q in enumerate(tw))
    gwo = tuple(Partial() if i in tok else q for i, q in enumerate(to))
    yp = tuple(Partial() if i in busy else q for i, q in enumerate(tx))
    lo, n_l = shard_span(e.n_routed, mesh, tw, 0)
    b, s, d = x.shape
    t_all = b * s
    tok_dims = sorted(tok)

    def prior_counts(idx_l):
        """Each expert's pairs in the token blocks before this rank's."""
        import torch.distributed._functional_collectives as fc
        counts = _one_hot(idx_l.reshape(-1), e.n_routed).sum(0)      # [E]
        blocks = counts[None]
        for i in reversed(tok_dims):    # row-major over the token dims
            blocks = fc.all_gather_single(blocks, gather_dim=0, group=(mesh, i))
        coord = mesh.get_coordinate()
        mine = 0
        for i in tok_dims:
            mine = mine * mesh.size(i) + coord[i]
        return blocks.reshape(-1, e.n_routed)[:mine].sum(0)

    def body(xl, wl, il, wg, wu, wo):
        pl = {"experts": {"wi_gate": wg, "wi_up": wu, "wo": wo}}
        if t_all > SMALL_BATCH_TOKENS:
            return _moe_sorted(cfg, pl, xl, wl, il, experts=(lo, n_l))
        prior = prior_counts(il) if tok_dims else None
        return _moe_small_batch(cfg, pl, xl.reshape(-1, d), wl, il, experts=(lo, n_l),
                                prior=prior, t_all=t_all)

    y = local_map(body, out_placements=(yp,), in_placements=(tx, tx, tx, tw, tw, to),
                  in_grad_placements=(gx, gx, tx, gww, gww, gwo), device_mesh=mesh,
                  redistribute_inputs=True)(x, w, idx, ex["wi_gate"], ex["wi_up"], ex["wo"])
    return y.redistribute(mesh, tx)
