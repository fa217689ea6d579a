"""Attention blocks: grouped-query attention with RoPE or M-RoPE,
qk-norm, an optional sliding window and cross-attention, and DeepSeek's
Multi-head Latent Attention (MLA).

Port of `repro.models.attention`. `gqa_train` is the full-sequence
attention used by `transformer.forward` and `decode.prefill`: causal
self-attention, or cross-attention (``kv_source``: keys and values from
an encoder's output, no RoPE, no mask). Its inner product goes through
`repro_torch.kernels.ops.attention`, which launches the CUDA flash kernel
for CUDA tensors and runs the plain version for CPU tensors. `gqa_decode`
steps one token against a `KVCache` (a ring at a sliding window, else a
linear cache); the model's own decode step is `decode._decode_gqa`, which
writes into the stacked cache, as the reference's is (its `gqa_decode`
has no caller there either).

MLA (`mla_train`, `mla_decode`) attends in the compressed latent space
against a cache of the latent ``c_kv`` and the shared RoPE key. Its
attention is plain PyTorch on every device, as the reference's is plain
jnp (it never reaches a kernel): dense scores below `ref.CHUNKED_THRESHOLD`
keys, an online softmax over chunks of `ref.CHUNK` keys at or above it
when the key count is a multiple of the chunk. `mla_decode` attends over
the whole latent cache; under a serve mesh with a "model" axis
(`launch.runtime.set_serve_mesh`) it runs `mla_decode_seq_sharded`, where
each model rank holds a contiguous span of the cache's positions and the
ranks combine their softmax statistics with all-reduces. The reference's
`_axprod` (the size of the mesh's batch axes, which picks the batch's
block) is `launch.mesh.axis_size`, which `launch.sharding.cache_specs`
reads: each rank is handed its block.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import CHUNK, CHUNKED_THRESHOLD, NEG_INF
from .common import apply_mrope, apply_rope, reshape_heads, rmsnorm, settle
from .config import ArchConfig


class KVCache(NamedTuple):
    k: torch.Tensor        # [B, S_max, n_kv, Dh]
    v: torch.Tensor        # [B, S_max, n_kv, Dh]
    length: torch.Tensor   # [] int32 — tokens already cached


def _positions(s: int, device=None) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :]


def _rope_q_k(cfg: ArchConfig, q, k, positions):
    """RoPE, or with ``cfg.mrope_sections`` M-RoPE with one position for
    all three streams (the reference's model path has text positions
    only, where M-RoPE gives RoPE's values)."""
    if cfg.mrope_sections:
        pos3 = positions[..., None].expand(*positions.shape, 3)
        q = apply_mrope(q, pos3, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, pos3, cfg.mrope_sections, cfg.rope_theta)
        return q, k
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k


def gqa_train(cfg: ArchConfig, p: dict, x: torch.Tensor, *, window: int = 0,
              use_rope: bool = True, kv_source: torch.Tensor | None = None,
              causal: bool = True, return_kv: bool = False):
    """x [B, S, D] -> y [B, S, D] (and the layer's k, v [B, T, KV, Dh],
    after RoPE where it applies, with ``return_kv``). Self-attention by
    default: RoPE when ``use_rope``, a causal mask when ``causal``, and the
    ``window``. With ``kv_source`` [B, T, D] (an encoder's output) it is
    cross-attention: K and V come from it, and neither RoPE nor a mask
    applies."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if kv_source is None else kv_source
    t = src.shape[1]
    q = reshape_heads(x @ p["wq"], b, s, h, dh)
    k = reshape_heads(src @ p["wk"], b, t, kv, dh)
    v = reshape_heads(src @ p["wv"], b, t, kv, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if use_rope and kv_source is None:
        q, k = _rope_q_k(cfg, q, k, _positions(s, device=x.device))
    out = kops.attention(q, k, v, causal=causal and kv_source is None, window=window)
    y = reshape_heads(out, b, s, h * dh) @ p["wo"]
    if return_kv:
        return y, (k, v)
    return y


def gqa_decode(cfg: ArchConfig, p: dict, x: torch.Tensor, cache: KVCache, *,
               window: int = 0, use_rope: bool = True):
    """One token x [B, 1, D] against ``cache``: writes its K/V into the
    cache's tensors in place and attends over the valid slots. With a
    ``window`` smaller than the cache, the cache is a ring: the write goes
    to slot ``length % window`` and slots below min(length + 1, window)
    are valid; otherwise the write goes to slot ``length`` (clamped to the
    last slot, as the reference's dynamic_update_slice clamps) and slots
    up to it are valid. Returns (y [B, 1, D], KVCache of the same tensors,
    length + 1). Reads nothing back to the host."""
    b = x.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    length = cache.length
    q = reshape_heads(x @ p["wq"], b, 1, h, dh)
    k_new = reshape_heads(x @ p["wk"], b, 1, kv, dh)
    v_new = reshape_heads(x @ p["wv"], b, 1, kv, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k_new = rmsnorm(k_new, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q, k_new = _rope_q_k(cfg, q, k_new, length.expand(b, 1))
    s_max = cache.k.shape[1]
    slots = torch.arange(s_max, device=x.device)
    if window and window < s_max:
        slot = torch.remainder(length, window)
        valid = slots < torch.clamp(length + 1, max=window)
    else:
        slot = torch.clamp(length, max=s_max - 1)
        valid = slots < length + 1
    slot = slot.reshape(1).long()
    cache.k.index_copy_(1, slot, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, slot, v_new.to(cache.v.dtype))
    out = kops.decode_attention(q, cache.k, cache.v, valid)
    y = out.reshape(b, 1, h * dh) @ p["wo"]
    return y, KVCache(cache.k, cache.v, length + 1)


# --------------------------------------------------------------- MLA
class MLACache(NamedTuple):
    c_kv: torch.Tensor     # [B, S_max, kv_lora]    compressed latent
    k_rope: torch.Tensor   # [B, S_max, rope_dim]   decoupled rope key
    length: torch.Tensor   # [] int32 — tokens already cached


def _mla_qkv(cfg: ArchConfig, p: dict, x: torch.Tensor, positions):
    """x [B, S, D] -> (q_nope [B, S, H, nope], q_rope [B, S, H, rope] after
    RoPE, c_kv [B, S, kv_lora], k_rope [B, S, rope] after RoPE)."""
    m = cfg.mla
    b, s, _ = x.shape
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    # on DTensors the down-projections stay in x's placement (`settle`:
    # DTensor would split their replicated rows over "model" by the
    # sequence, which its backward cannot take)
    if m.q_lora_rank:
        q = reshape_heads(settle(x @ p["wq_a"], x) @ p["wq_b"], b, s, cfg.n_heads, qd)
    else:
        q = reshape_heads(x @ p["wq"], b, s, cfg.n_heads, qd)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = settle(x @ p["wkv_a"], x)
    k_rope = apply_rope(settle(x @ p["wk_rope"], x)[..., None, :], positions,
                        cfg.rope_theta)[..., 0, :]   # one shared head
    return q_nope, q_rope, c_kv, k_rope


def _mla_scale(cfg: ArchConfig, dtype: torch.dtype) -> float:
    """1 / sqrt(nope + rope) as the reference's weakly typed scalar meets
    the scores: computed in fp32, then rounded to the scores' dtype."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    m = cfg.mla
    with unset_fake_temporarily():   # a constant: real even in the dry run
        s32 = 1.0 / torch.sqrt(torch.tensor(float(m.qk_nope_head_dim + m.qk_rope_head_dim)))
        return float(s32.to(dtype))


def _mla_scores(q_c, q_rope, c_kv, k_rope, scale):
    """(q_c . c_kv + q_rope . k_rope) * scale: [B, H, S, T] in q's dtype."""
    sc = torch.einsum("bshl,btl->bhst", q_c, c_kv)
    sc += torch.einsum("bshr,btr->bhst", q_rope, k_rope)
    return sc.mul_(scale)


def _mla_attend(cfg: ArchConfig, p: dict, q_nope, q_rope, c_kv, k_rope,
                valid=None, causal: bool = False):
    """Latent-space attention (the 'absorbed' MLA form): q_nope goes into
    the compressed space through W_uk, scores are q_c . c_kv + q_rope .
    k_rope, the context is a mix of c_kv, and W_uv brings it up per head;
    no per-head K or V is ever made. ``valid`` [T] masks cache slots;
    ``causal`` places query i at key position i + T - S."""
    from repro_torch.launch.placement import is_dtensor
    m = cfg.mla
    if is_dtensor(q_nope):
        out = _mla_context_placed(cfg, p["wkv_b"], q_nope, q_rope, c_kv, k_rope, valid,
                                  causal)
    else:
        out = _mla_context(cfg, p["wkv_b"], q_nope, q_rope, c_kv, k_rope, valid, causal)
    b, s, h = out.shape[:3]
    return reshape_heads(out, b, s, h * m.v_head_dim) @ p["wo"]


def _mla_context_placed(cfg, wkv_b, q_nope, q_rope, c_kv, k_rope, valid, causal):
    """`_mla_context` on DTensors, each rank on its shards: batch kept,
    the query heads kept on the dims that shard them (and ``wkv_b``'s
    columns, whole heads, on the same dims), everything else replicated;
    the latent cache's gradient is a partial sum over the head dims."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.launch.placement import keep_dims, partial_on, sharding_dims
    tq = keep_dims(q_nope.placements, (0, 2), q_nope, 2)
    hdims = sharding_dims(tq, 2)
    tc = tuple(Replicate() if i in hdims else p for i, p in enumerate(tq))
    gc = partial_on(tc, hdims)
    tw = tuple(Shard(1) if i in hdims else Replicate() for i in range(len(tq)))
    gw = partial_on(tw, [i for i, p in enumerate(tq) if isinstance(p, Shard)
                             and p.dim == 0])

    def body(wl, qn, qr, cl, kl):
        return _mla_context(cfg, wl, qn, qr, cl, kl, valid, causal)

    return local_map(body, out_placements=(tq,), in_placements=(tw, tq, tq, tc, tc),
                     in_grad_placements=(gw, tq, tq, gc, gc),
                     device_mesh=q_nope.device_mesh,
                     redistribute_inputs=True)(wkv_b, q_nope, q_rope, c_kv, k_rope)


def _mla_context(cfg: ArchConfig, wkv_b, q_nope, q_rope, c_kv, k_rope, valid=None,
                 causal: bool = False):
    """The per-head context [B, S, H, v] of `_mla_attend` before the output
    projection, for the H heads in q_nope (and ``wkv_b``'s columns)."""
    m = cfg.mla
    h = q_nope.shape[2]
    wkv_b = wkv_b.reshape(m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim)
    w_uk = wkv_b[..., :m.qk_nope_head_dim]        # [kv_lora, h, nope]
    w_uv = wkv_b[..., m.qk_nope_head_dim:]        # [kv_lora, h, v]
    q_c = torch.einsum("bshn,lhn->bshl", q_nope, w_uk)
    scale = _mla_scale(cfg, q_c.dtype)
    b, s = q_c.shape[:2]
    t = c_kv.shape[1]
    dev = q_c.device
    if t >= CHUNKED_THRESHOLD and t % CHUNK == 0:
        # online softmax over chunks of keys: O(S * CHUNK) live scores
        qpos = torch.arange(s, device=dev) + (t - s)
        m_run = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=dev)
        l_run = torch.zeros((b, h, s), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, s, m.kv_lora_rank), dtype=torch.float32, device=dev)
        for start in range(0, t, CHUNK):
            cb = c_kv[:, start:start + CHUNK]
            sc = _mla_scores(q_c, q_rope, cb, k_rope[:, start:start + CHUNK],
                             scale).float()
            mask = torch.ones((s, CHUNK), dtype=torch.bool, device=dev)
            if causal:
                kpos = start + torch.arange(CHUNK, device=dev)
                mask &= kpos[None, :] <= qpos[:, None]
            if valid is not None:
                mask &= valid[start:start + CHUNK][None, :]
            sc.masked_fill_(~mask, NEG_INF)
            m_cur = torch.maximum(m_run, sc.amax(-1))
            alpha = torch.exp(m_run - m_cur)
            pp = torch.exp(sc - m_cur[..., None])
            l_run = l_run * alpha + pp.sum(-1)
            ctx = torch.einsum("bhst,btl->bhsl", pp.to(cb.dtype), cb)
            acc = acc * alpha[..., None] + ctx.float()
            m_run = m_cur
        ctx = (acc / l_run.clamp(min=1e-30)[..., None]).to(q_c.dtype)
        ctx = ctx.transpose(1, 2)                  # [b, s, h, l]
    else:
        scores = _mla_scores(q_c, q_rope, c_kv, k_rope, scale)
        if causal:
            mask = torch.ones((s, t), dtype=torch.bool, device=dev).tril(t - s)
            scores.masked_fill_(~mask, NEG_INF)
        if valid is not None:
            scores.masked_fill_(~valid[None, None, None, :], NEG_INF)
        w = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
        del scores
        ctx = torch.einsum("bhst,btl->bshl", w, c_kv)     # latent context
    return torch.einsum("bshl,lhv->bshv", ctx, w_uv)      # up-project per head


def mla_train(cfg: ArchConfig, p: dict, x: torch.Tensor, return_latent: bool = False):
    """Causal MLA over x [B, S, D] -> y [B, S, D] (and the latent cache
    entries (c_kv [B, S, kv_lora], k_rope [B, S, rope]) with
    ``return_latent``)."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, _positions(x.shape[1], x.device))
    y = _mla_attend(cfg, p, q_nope, q_rope, c_kv, k_rope, causal=True)
    if return_latent:
        return y, (c_kv, k_rope)
    return y


def mla_decode(cfg: ArchConfig, p: dict, x: torch.Tensor, cache: MLACache):
    """One token x [B, 1, D] against a latent cache: writes its c_kv and
    k_rope at slot ``length`` of the cache's tensors in place (clamped to
    the last slot, as the reference's dynamic_update_slice clamps) and
    attends over the slots up to it. Returns (y [B, 1, D], MLACache of the
    same tensors, length + 1). Reads nothing back to the host. Under a
    serve mesh with a "model" axis it is `mla_decode_seq_sharded`."""
    from repro_torch.launch import runtime
    from repro_torch.launch.mesh import mesh_axes
    mesh = runtime.get_serve_mesh()
    if mesh is not None and "model" in mesh_axes(mesh):
        from repro_torch.launch.placement import is_dtensor
        if is_dtensor(x):
            return _mla_decode_placed(cfg, p, x, cache, mesh)
        return mla_decode_seq_sharded(cfg, p, x, cache, mesh)
    b = x.shape[0]
    length = cache.length
    q_nope, q_rope, c_new, kr_new = _mla_qkv(cfg, p, x, length.expand(b, 1))
    t = cache.c_kv.shape[1]
    slot = torch.clamp(length, max=t - 1).reshape(1).long()
    cache.c_kv.index_copy_(1, slot, c_new.to(cache.c_kv.dtype))
    cache.k_rope.index_copy_(1, slot, kr_new.to(cache.k_rope.dtype))
    valid = torch.arange(t, device=x.device) < length + 1
    y = _mla_attend(cfg, p, q_nope, q_rope, cache.c_kv, cache.k_rope, valid=valid)
    return y, MLACache(cache.c_kv, cache.k_rope, length + 1)


def _mla_decode_placed(cfg: ArchConfig, p: dict, x, cache: MLACache, mesh):
    """`mla_decode_seq_sharded` on DTensors: each rank runs it on its
    block of the batch, its span of the latent cache (the cache's own
    shards) and the layer's weights gathered whole (the serve layout
    shards their heads over "model"; the sequence-sharded decode holds
    every head). Writes the token into the caches' local spans in place."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.launch.placement import keep_dims
    tx = keep_dims(x.placements, (0,))
    rep = tuple(Replicate() for _ in range(mesh.ndim))
    keys = sorted(p)

    def body(xl, cl, kl, ln, *pl):
        y, _ = mla_decode_seq_sharded(cfg, dict(zip(keys, pl)), xl, MLACache(cl, kl, ln),
                                      mesh)
        return y

    y = local_map(body, out_placements=(tx,),
                  in_placements=(tx, tuple(cache.c_kv.placements),
                                 tuple(cache.k_rope.placements), rep) + (rep,) * len(keys),
                  device_mesh=mesh, redistribute_inputs=True)(
        x, cache.c_kv, cache.k_rope, cache.length, *(p[k] for k in keys))
    return y, MLACache(cache.c_kv, cache.k_rope, cache.length + 1)


def mla_decode_seq_sharded(cfg: ArchConfig, p: dict, x: torch.Tensor,
                           cache: MLACache, mesh):
    """Sequence-sharded MLA decode on one rank of ``mesh`` (a DeviceMesh
    with a "model" axis). The rank holds its contiguous span of the latent
    cache's positions (`launch.sharding.cache_specs`: rank i of the model
    axis owns positions [i * S_loc, (i + 1) * S_loc) of ``cache.c_kv`` and
    ``k_rope`` [B, S_loc, ...]) and its block of the batch in ``x`` [B, 1,
    D]; ``cache.length`` is the global length. It writes the new token
    only where its position falls in its span, attends over its span, and
    combines with the others by the flash combine over the model axis's
    process group: an all-reduce MAX of the row maxima m, then all-reduce
    SUMs of l * corr and ctx * corr, corr = exp(m - max m). The combine
    runs in float32 whatever the cache's dtype (the reference sums the
    context in the cache's dtype), so gloo and NCCL both take it. Returns
    (y [B, 1, D], MLACache of the same span tensors, length + 1)."""
    import torch.distributed as dist

    m = cfg.mla
    h = cfg.n_heads
    b = x.shape[0]
    length = cache.length
    q_nope, q_rope, c_new, kr_new = _mla_qkv(cfg, p, x, length.expand(b, 1))
    wkv_b = p["wkv_b"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim)
    w_uk = wkv_b[..., :m.qk_nope_head_dim]
    w_uv = wkv_b[..., m.qk_nope_head_dim:]
    q_c = torch.einsum("bshn,lhn->bshl", q_nope, w_uk)     # [B, 1, H, R]
    scale = _mla_scale(cfg, q_c.dtype)

    group = mesh.get_group("model")
    c_kv, k_rope = cache.c_kv, cache.k_rope
    s_loc = c_kv.shape[1]
    start = mesh.get_local_rank("model") * s_loc
    rel = length - start
    in_range = (rel >= 0) & (rel < s_loc)
    slot = torch.clamp(rel, 0, s_loc - 1).reshape(1).long()
    for buf, new in ((c_kv, c_new), (k_rope, kr_new)):
        buf.index_copy_(1, slot, torch.where(in_range, new.to(buf.dtype),
                                             buf.index_select(1, slot)))

    valid = start + torch.arange(s_loc, device=x.device) <= length
    sc = _mla_scores(q_c, q_rope, c_kv, k_rope, scale).float()   # [B, H, 1, S_loc]
    sc.masked_fill_(~valid, NEG_INF)
    m_l = sc.amax(-1)                                             # [B, H, 1]
    pp = torch.exp(sc - m_l[..., None])
    ctx_l = torch.einsum("bhst,btl->bhsl", pp.to(c_kv.dtype), c_kv)
    m_g = m_l.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m_l - m_g)
    l_g = pp.sum(-1) * corr
    ctx = ctx_l.float() * corr[..., None]
    dist.all_reduce(l_g, group=group)
    dist.all_reduce(ctx, group=group)
    ctx = (ctx / l_g.clamp(min=1e-30)[..., None]).to(c_kv.dtype)
    ctx = ctx.transpose(1, 2)                                     # [B, 1, H, R]
    out = torch.einsum("bshl,lhv->bshv", ctx, w_uv)
    y = out.reshape(b, 1, h * m.v_head_dim) @ p["wo"]
    return y, MLACache(c_kv, k_rope, length + 1)
