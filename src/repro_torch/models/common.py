"""Shared layers: norms, rotary embeddings (with qwen2-vl's M-RoPE),
MLPs, embedding, init.

Port of `repro.models.common`. Norms and
rotary embeddings compute in fp32 and cast back to the input's dtype, as
the reference does; the products ``x @ w`` stay `torch.matmul`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ----------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale).to(dt)


def norm(x: torch.Tensor, p: dict, kind: str, eps: float) -> torch.Tensor:
    if kind == "layernorm":
        dt = x.dtype
        x = x.float()
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
        y = (x - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"] + p["bias"]).to(dt)
    return rmsnorm(x, p["scale"], eps)


# ------------------------------------------------------------------ rope
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S]."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)          # [Dh/2]
    angles = positions[..., None].float() * freqs           # [..., S, Dh/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: tuple[int, ...], theta: float) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: three position streams (t, h, w) rotate
    disjoint sections of the frequency slots. x: [..., S, H, Dh];
    positions: [..., S, 3] (text: t == h == w). Slot j takes the stream
    of the section it falls in (slots past the sections take stream 0)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)          # [Dh/2]
    sec = torch.zeros(dh // 2, dtype=torch.long, device=x.device)
    start = 0
    for i, n in enumerate(sections):
        sec[start:start + n] = i
        start += n
    angles = positions.float()[..., sec] * freqs            # [..., S, Dh/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- placement
def settle(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``y`` in ``like``'s placements when both are DTensors (the residual
    stream keeps the batch's placement: batch on the data axes, the rest
    replicated), else ``y``. A block's output reaches the stream in
    whatever placements DTensor's products chose (a partial sum over
    "model" after a row-parallel product); this reduces it there, so the
    next block starts from the same layout."""
    from repro_torch.launch.placement import is_dtensor
    if is_dtensor(y) and is_dtensor(like):
        return _Settle.apply(y, tuple(like.placements))
    return y


class _Settle(torch.autograd.Function):
    """`settle`: the forward redistributes to ``placements``, and so does
    the backward with the gradient, which DTensor would otherwise hand on
    as a partial sum (its own backward of a partial-to-replicated
    redistribution), leaving the products behind it to gather their
    weights rather than reduce the gradient once."""

    @staticmethod
    def forward(ctx, y, placements):
        ctx.placements = placements
        if tuple(y.placements) == placements:
            return y.view_as(y)
        return y.redistribute(y.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


class _SumOver(torch.autograd.Function):
    """A local tensor's sum over ``dim`` (None: all), all-reduced over the
    process groups ``groups``; the gradient is the incoming one expanded
    back (each rank's elements counted once)."""

    @staticmethod
    def forward(ctx, x, dim, groups):
        import torch.distributed as dist
        ctx.shape, ctx.dim = x.shape, dim
        out = x.sum() if dim is None else x.sum(dim)
        for g in groups:
            dist.all_reduce(out, group=g)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.dim is not None:
            g = g.unsqueeze(ctx.dim)
        return g.expand(ctx.shape).contiguous(), None, None


def mean(t: torch.Tensor, dim=None) -> torch.Tensor:
    """``torch.mean(t, dim)``. On a DTensor each rank sums its own shard and
    one all-reduce over the mesh dims that shard the summed dims adds the
    sums, the rest of the placements kept: its gradient stays in t's
    placements (DTensor's own reduction would expand a replicated
    gradient to the whole tensor on every rank)."""
    from repro_torch.launch.placement import is_dtensor
    if not is_dtensor(t):
        return torch.mean(t) if dim is None else torch.mean(t, dim)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = t.device_mesh
    dims = tuple(range(t.ndim)) if dim is None else (dim % t.ndim,)
    out, groups = [], []
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim in dims:
            out.append(Replicate())
            groups.append(mesh.get_group(i))
        elif isinstance(p, Shard):
            out.append(Shard(p.dim - sum(d < p.dim for d in dims)))
        else:
            out.append(p)
    n = t.numel() if dim is None else t.shape[dim]
    d = None if dim is None else dims[0]
    return local_map(lambda x: _SumOver.apply(x, d, groups),
                     out_placements=(tuple(out),), in_placements=(tuple(t.placements),),
                     device_mesh=mesh)(t) / n


def _heads_reshape(y, shape):
    """``y.reshape(shape)`` of a DTensor whose last one or two dims are
    [heads, head dim] on one side and their product on the other. Where
    the merged dim is sharded over more ranks than the heads divide among
    (8 KV heads on a 16-wide "model" axis), it is gathered first,
    explicitly, since the split could not keep it sharded; the local
    shard is made contiguous (DTensor reshapes it with ``view``, and its
    own ``contiguous()`` reads the global strides only)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    heads = shape[-2] if len(shape) > y.ndim else y.shape[-2]
    last = y.ndim - 1 if len(shape) > y.ndim else y.ndim - 2
    dims = [i for i, p in enumerate(y.placements) if isinstance(p, Shard) and p.dim == last]
    n = 1
    for i in dims:
        n *= y.device_mesh.size(i)
    if dims and heads % n:
        y = y.redistribute(y.device_mesh, [Replicate() if i in dims else p
                                           for i, p in enumerate(y.placements)])
    loc = y.to_local()
    if not loc.is_contiguous():
        y = DTensor.from_local(loc.contiguous(), y.device_mesh, y.placements,
                               shape=y.shape, stride=y.stride())
    return y.reshape(shape)


class _HeadsReshape(torch.autograd.Function):
    """`_heads_reshape` forward, and backward on the gradient, which then
    takes the forward input's placements (a partial sum over the heads'
    ranks is reduce-scattered back onto the shards it came from)."""

    @staticmethod
    def forward(ctx, y, shape):
        from torch.distributed.tensor import Partial, Replicate
        # a partial sum's gradient is the same on every rank
        ctx.shape = tuple(y.shape)
        ctx.placements = tuple(Replicate() if isinstance(p, Partial) else p
                               for p in y.placements)
        return _heads_reshape(y, shape)

    @staticmethod
    def backward(ctx, g):
        g = _heads_reshape(g, ctx.shape)
        if tuple(g.placements) != ctx.placements:   # as the forward's input
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def reshape_heads(y: torch.Tensor, *shape: int) -> torch.Tensor:
    """``y.reshape(*shape)`` splitting y's last dim into [heads, head dim]
    or merging them back; on a DTensor through `_HeadsReshape` (the merged
    dim gathered first where the heads cannot keep its shards)."""
    from repro_torch.launch.placement import is_dtensor
    if is_dtensor(y):
        return _HeadsReshape.apply(y, shape)
    return y.reshape(*shape)


# ------------------------------------------------------------------- mlp
def mlp(x: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    if act in ("swiglu", "geglu"):
        g = x @ p["wi_gate"]
        u = x @ p["wi_up"]
        # jax.nn.gelu is the tanh approximation by default
        h = (F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")) * u
    else:  # plain gelu MLP (whisper)
        h = F.gelu(x @ p["wi_up"], approximate="tanh")
    return h @ p["wo"]


# ------------------------------------------------------------- embedding
class _Embedding(torch.autograd.Function):
    """``table[tokens]`` whose gradient sums each row's cotangents in a
    fixed order: a product of the tokens' one-hot [N, V] and the cotangent
    [N, D] (fp32 sums inside the matmul), where indexing's backward would
    use ``index_put_(accumulate=True)``, whose CUDA atomics add in no fixed
    order (a restarted run must repeat bit for bit)."""

    @staticmethod
    def forward(ctx, tokens, table):
        ctx.save_for_backward(tokens)
        ctx.vocab = table.shape[0]
        return table[tokens]

    @staticmethod
    def backward(ctx, dy):
        (tokens,) = ctx.saved_tensors
        flat = tokens.reshape(-1, 1).long()
        one_hot = torch.zeros((flat.shape[0], ctx.vocab), dtype=dy.dtype, device=dy.device)
        one_hot.scatter_(1, flat, 1.0)
        return None, one_hot.T @ dy.reshape(flat.shape[0], -1)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    from repro_torch.launch.placement import is_dtensor
    if is_dtensor(table):
        return _embed_placed(tokens, table)
    return _Embedding.apply(tokens, table)


def _embed_placed(tokens, table):
    """`embed` of DTensor tokens [B, S] in a DTensor table [V, D], vocab-
    parallel: the table keeps its vocab shards and gathers its FSDP-sharded
    dim; tokens keep their batch shards and are gathered over the dims
    that shard the vocab; each rank looks up the tokens in its rows (zeros
    elsewhere) and the partial sums over the vocab dims are reduced by one
    all-reduce. The table's gradient is a partial sum over the dims that
    shard the tokens."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.launch.placement import shard_span
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim)
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    tt = tuple(Shard(0) if v else Replicate() for v in vocab)
    tk = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 and not v else Replicate()
               for p, v in zip(tokens.placements, vocab))
    gt = tuple(Partial() if isinstance(k, Shard) else t for t, k in zip(tt, tk))
    out = tuple(Partial() if v else k for v, k in zip(vocab, tk))
    v0, rows = shard_span(table.shape[0], mesh, tt, 0)

    def body(tok, tab):
        tok = tok.long()
        mine = (tok >= v0) & (tok < v0 + rows)
        y = _Embedding.apply(torch.where(mine, tok - v0, 0), tab)
        return y * mine[..., None].to(y.dtype)

    y = local_map(body, out_placements=(out,), in_placements=(tk, tt),
                  in_grad_placements=(tk, gt), device_mesh=mesh,
                  redistribute_inputs=True)(tokens, table)
    return y.redistribute(mesh, tk)


def unembed(x: torch.Tensor, table_or_head: torch.Tensor, tied: bool) -> torch.Tensor:
    w = table_or_head.T if tied else table_or_head
    return x @ w.to(x.dtype)


# ---------------------------------------------------------------- init
# the standard normal's probability mass below -2 and below 2
_CDF_LO, _CDF_HI = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))


def dense_init(shape, in_axis: int = -2, dtype=torch.bfloat16, *,
               generator: torch.Generator, device=None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """A normal truncated to [-2, 2] times ``fan_in ** -0.5``, drawn in
    fp32 and cast to ``dtype``, like `repro.models.common.dense_init`
    (whose `jax.random` stream torch cannot reproduce). Given ``out``, it
    fills that tensor in place (``shape`` is then the shape the fan-in is
    read from) and draws only ``out``'s elements."""
    fan_in = shape[in_axis]
    target = out.shape if out is not None else shape
    t = torch.empty(target, dtype=torch.float32, device=device)
    # inverse CDF of a uniform draw between the two tails (as jax does)
    t.uniform_(2 * _CDF_LO - 1, 2 * _CDF_HI - 1, generator=generator)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(fan_in ** -0.5)
    if out is not None:
        out.copy_(t)
        return out
    return t.to(dtype)
