"""Kernel entries for DTensor and fake tensors.

`kernels.ops` sends the four kernels of the training and prefill paths
(prefill attention, the RG-LRU and WKV scans, the MoE router) here when
their input is not a plain tensor:

- a DTensor (the mesh trainer's activations) runs the same `ops` entry on
  its local shards through `torch.distributed.tensor.experimental.
  local_map` (`attention_placed`, `rglru_placed`, `rwkv6_wkv_placed`,
  `topk_router_placed`). Batch stays on the mesh dims that shard it and
  heads (channels for the RG-LRU) on the dims that shard them; the
  sequence dim, the head dim and the router's expert dim are
  redistributed to replicated first, explicitly, so the collective shows
  (the dry run counts it). Nothing else is gathered: where q's heads are
  sharded and k's or v's cannot be (8 KV heads on a 16-wide axis), each
  rank slices the KV heads its query heads read, and their gradient
  comes back as a partial sum over that dim. Inside, the usual rule
  holds: a CUDA shard launches the hand-written kernel, a CPU shard runs
  the plain version.
- a fake tensor (the dry run's `FakeTensorMode`, on any device) takes the
  kernel's fake entry: a `torch.library` custom op (``xbof::*``) whose
  `register_fake` gives the outputs' shapes and dtypes and reports the
  workspace the kernel allocates (`note_transient`, from the same
  function the launcher sizes it by), with a backward op of its own and a
  FLOP formula for `torch.utils.flop_counter` (flash 4 D a (query, key)
  pair and head forward, 10 D backward; RG-LRU 7 an element forward, 20
  backward; WKV 5 K V + 3 K + 2 V a (b, t, h) forward, 10 K V backward;
  the router its bias add and 2 a pick forward, 2 a pick backward).

Neither is a fallback: a fake tensor has no data to compute on, and a
real CUDA tensor still launches its kernel or raises. The custom ops are
the fake entries only: on a real tensor they raise, since `ops` runs real
tensors through the kernels' autograd Functions. The placement arithmetic
is `launch.placement`'s.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import Tensor

from repro_torch.launch.placement import (keep_dims, local_block, partial_on,
                                          replicated, sharding_dims)
from . import flash_attention as _fa
from . import ref
from . import rglru_scan as _rg
from . import rwkv6_scan as _wkv

# SMs of an H100 SXM: the flash backward's split (and so its workspace)
# depends on them; a fake tensor has no card to ask
H100_SMS = 132

# callables taking a workspace's bytes: the dry run's memory tracker
TRANSIENT_HOOKS: list = []


def note_transient(nbytes: int) -> None:
    """A kernel's workspace: allocated at its launch, freed at its end."""
    for hook in TRANSIENT_HOOKS:
        hook(int(nbytes))


def is_fake(t) -> bool:
    """A tensor without data: the dry run's fake tensors, or meta."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor) or t.device.type == "meta"


def _empty(like: Tensor) -> Tensor:
    return like.new_empty((0,), dtype=torch.float32)


def _real(name: str):
    raise RuntimeError(f"xbof::{name} is the dry run's fake entry; a real tensor goes "
                       "through kernels.ops")


# ======================================================== fake entries
@torch.library.custom_op("xbof::flash_attention", mutates_args=())
def flash_attention_op(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int,
                       scale: float, with_stats: bool) -> tuple[Tensor, Tensor]:
    """(o, the softmax statistics fp32 [2, B, H, S], or [0] without
    ``with_stats``)."""
    _real("flash_attention")


@flash_attention_op.register_fake
def _(q, k, v, causal, window, scale, with_stats):
    b, s, h, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((2, b, h, s) if with_stats else (0,), dtype=torch.float32))


@torch.library.custom_op("xbof::flash_attention_bwd", mutates_args=())
def flash_attention_bwd_op(q: Tensor, k: Tensor, v: Tensor, o: Tensor, stats: Tensor,
                           dout: Tensor, causal: bool, window: int,
                           scale: float) -> tuple[Tensor, Tensor, Tensor]:
    _real("flash_attention_bwd")


@flash_attention_bwd_op.register_fake
def _(q, k, v, o, stats, dout, causal, window, scale):
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    n_split = _fa.bwd_split(q.dtype, b, t, kv, H100_SMS)
    note_transient(4 * _fa.bwd_workspace_floats(b, s, t, h, kv, d, n_split))
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, window, scale, _ = inputs
    ctx.save_for_backward(q, k, v, output[0], output[1])
    ctx.mask = (causal, window, scale)


def _flash_backward(ctx, dout, _dstats):
    q, k, v, o, stats = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd_op(q, k, v, o, stats, dout.contiguous(), *ctx.mask)
    return dq, dk, dv, None, None, None, None


flash_attention_op.register_autograd(_flash_backward, setup_context=_flash_setup)


@torch.library.custom_op("xbof::rglru", mutates_args=())
def rglru_op(x: Tensor, a: Tensor, h0: Optional[Tensor]) -> Tensor:
    _real("rglru")


@rglru_op.register_fake
def _(x, a, h0):
    return torch.empty_like(x)


@torch.library.custom_op("xbof::rglru_bwd", mutates_args=())
def rglru_bwd_op(x: Tensor, a: Tensor, h0: Optional[Tensor],
                 dout: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    _real("rglru_bwd")


@rglru_bwd_op.register_fake
def _(x, a, h0, dout):
    note_transient(4 * _rg.bwd_workspace_floats(*x.shape))
    return (torch.empty_like(x), torch.empty_like(a),
            _empty(x) if h0 is None else torch.empty_like(h0))


def _rglru_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _rglru_backward(ctx, dout):
    x, a, h0 = ctx.saved_tensors
    dx, da, dh0 = rglru_bwd_op(x, a, h0, dout.contiguous())
    return dx, da, None if h0 is None else dh0


rglru_op.register_autograd(_rglru_backward, setup_context=_rglru_setup)


@torch.library.custom_op("xbof::rwkv6_wkv", mutates_args=())
def rwkv6_wkv_op(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                 s0: Optional[Tensor]) -> tuple[Tensor, Tensor]:
    _real("rwkv6_wkv")


@rwkv6_wkv_op.register_fake
def _(r, k, v, w, u, s0):
    b, t, h, dk = r.shape
    return (r.new_empty((b, t, h, v.shape[-1])),
            r.new_empty((b, h, dk, v.shape[-1])))


@torch.library.custom_op("xbof::rwkv6_wkv_bwd", mutates_args=())
def rwkv6_wkv_bwd_op(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
                     s0: Optional[Tensor], dout: Tensor, ds_final: Optional[Tensor]
                     ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    _real("rwkv6_wkv_bwd")


@rwkv6_wkv_bwd_op.register_fake
def _(r, k, v, w, u, s0, dout, ds_final):
    note_transient(4 * _wkv.bwd_workspace_floats(*r.shape))
    return (*(torch.empty_like(x) for x in (r, k, v, w, u)),
            _empty(r) if s0 is None else torch.empty_like(s0))


def _wkv_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)
    ctx.set_materialize_grads(False)


def _wkv_backward(ctx, dout, ds_final):
    r, k, v, w, u, s0 = ctx.saved_tensors
    dout = torch.zeros_like(v) if dout is None else dout.contiguous()
    *grads, ds0 = rwkv6_wkv_bwd_op(r, k, v, w, u, s0, dout, ds_final)
    return (*grads, None if s0 is None else ds0)


rwkv6_wkv_op.register_autograd(_wkv_backward, setup_context=_wkv_setup)


@torch.library.custom_op("xbof::topk_router", mutates_args=())
def topk_router_op(scores: Tensor, k: int, bias: Optional[Tensor]) -> tuple[Tensor, Tensor]:
    _real("topk_router")


@topk_router_op.register_fake
def _(scores, k, bias):
    t = scores.shape[0]
    return (scores.new_empty((t, k), dtype=torch.float32),
            scores.new_empty((t, k), dtype=torch.int32))


@torch.library.custom_op("xbof::topk_router_bwd", mutates_args=())
def topk_router_bwd_op(scores: Tensor, idx: Tensor, dw: Tensor) -> Tensor:
    _real("topk_router_bwd")


@topk_router_bwd_op.register_fake
def _(scores, idx, dw):
    return torch.empty_like(scores)


def _router_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0], output[1])


def _router_backward(ctx, dw, _didx):
    scores, idx = ctx.saved_tensors
    return topk_router_bwd_op(scores, idx, dw.contiguous()), None, None


topk_router_op.register_autograd(_router_backward, setup_context=_router_setup)


# ========================================================== FLOP formulas
@functools.lru_cache(maxsize=None)
def flash_pairs(s: int, t: int, causal: bool, window: int) -> tuple[int, int]:
    """(unmasked (query, key) pairs, rows with no valid key) of one head:
    query row i sits at key position i + T - S."""
    if not causal:
        return s * t, 0
    lo = max(0, t - s)                  # key position of the first row with a key

    def upto(n):                        # sum over j = 1..n of min(j, window)
        if not window or n <= window:
            return n * (n + 1) // 2
        return window * (window + 1) // 2 + (n - window) * window

    return upto(t) - upto(lo), max(0, s - t)


def _flash_fwd_flops(q, k, causal, window):
    b, s, h, d = q
    pairs, no_key = flash_pairs(s, k[1], causal, window)
    return 4 * d * b * h * pairs + no_key * b * h * k[1] * d


def _flash_bwd_flops(q, k, causal, window):
    b, s, h, d = q
    pairs, no_key = flash_pairs(s, k[1], causal, window)
    return 10 * d * b * h * pairs + 2 * no_key * b * h * k[1] * d


def _register_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.xbof.flash_attention)
    def _(q, k, v, causal, window, scale, with_stats, out_shape=None, **kw):
        return _flash_fwd_flops(q, k, causal, window)

    @register_flop_formula(torch.ops.xbof.flash_attention_bwd)
    def _(q, k, v, o, stats, dout, causal, window, scale, out_shape=None, **kw):
        return _flash_bwd_flops(q, k, causal, window)

    @register_flop_formula(torch.ops.xbof.rglru)
    def _(x, a, h0, out_shape=None, **kw):
        return 7 * x[0] * x[1] * x[2]

    @register_flop_formula(torch.ops.xbof.rglru_bwd)
    def _(x, a, h0, dout, out_shape=None, **kw):
        return 20 * x[0] * x[1] * x[2]

    @register_flop_formula(torch.ops.xbof.rwkv6_wkv)
    def _(r, k, v, w, u, s0, out_shape=None, **kw):
        b, t, h, dk = r
        dv = v[-1]
        return (5 * dk * dv + 3 * dk + 2 * dv) * b * t * h

    @register_flop_formula(torch.ops.xbof.rwkv6_wkv_bwd)
    def _(r, k, v, w, u, s0, dout, ds_final, out_shape=None, **kw):
        b, t, h, dk = r
        return 10 * dk * v[-1] * b * t * h

    @register_flop_formula(torch.ops.xbof.topk_router)
    def _(scores, k, bias, out_shape=None, **kw):
        t, e = scores
        return (t * e if bias is not None else 0) + 2 * t * k

    @register_flop_formula(torch.ops.xbof.topk_router_bwd)
    def _(scores, idx, dw, out_shape=None, **kw):
        return 2 * idx[0] * idx[1]


_register_flops()


def attention_fake(q, k, v, causal, window, scale):
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return flash_attention_op(q, k, v, causal, window, scale, grad)[0]


# ============================================================== DTensor
def _group_placements(q, kv_heads, head_dim_index):
    """(q's target placements, the KV tensors' and their gradients', and
    the KV heads this rank reads as (lo, hi), or None when its KV shards
    already are the right ones). Query heads stay sharded where the KV
    heads shard alike or each rank's query heads read whole KV heads;
    otherwise q's heads are gathered too."""
    from torch.distributed.tensor import Replicate
    mesh = q.device_mesh
    tq = keep_dims(q.placements, (0, head_dim_index), q, head_dim_index)
    h = q.shape[head_dim_index]
    hdims = sharding_dims(tq, head_dim_index)
    n = 1
    for i in hdims:
        n *= mesh.size(i)
    if not hdims or kv_heads % n == 0:
        return tq, tq, tq, None
    group = h // kv_heads
    (lq, off) = local_block(q.shape, mesh, tq)
    h0, hl = off[head_dim_index], lq[head_dim_index]
    lo, hi = h0 // group, (h0 + hl - 1) // group + 1
    if hl % (hi - lo) or (hl >= group and (h0 % group or hl % group)) or \
            (hl < group and group % hl):
        tq = tuple(Replicate() if i in hdims else p for i, p in enumerate(tq))
        return tq, tq, tq, None
    tk = tuple(Replicate() if i in hdims else p for i, p in enumerate(tq))
    return tq, tk, partial_on(tk, hdims), (lo, hi)


def attention_placed(q, k, v, causal, window, scale):
    """`ops.attention` on DTensors: q [B, S, H, D], k and v [B, T, KV, D]
    on one mesh; returns o [B, S, H, D] placed as q (sequence and head dim
    replicated)."""
    from torch.distributed.tensor.experimental import local_map
    from . import ops
    tq, tk, gk, heads = _group_placements(q, k.shape[2], 2)

    def body(ql, kl, vl):
        if heads is not None:
            kl = kl[:, :, heads[0]:heads[1]].contiguous()
            vl = vl[:, :, heads[0]:heads[1]].contiguous()
        return ops.attention(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                             causal=causal, window=window, scale=scale)

    return local_map(body, out_placements=(tq,), in_placements=(tq, tk, tk),
                     in_grad_placements=(tq, gk, gk), device_mesh=q.device_mesh,
                     redistribute_inputs=True)(q, k, v)


def decode_attention_placed(q, k, v, valid):
    """`ops.decode_attention` (the plain version: no kernel backs it) on
    DTensors q [B, 1, H, D] and a cache k, v [B, S, KV, D]: each rank on
    its batch block and query heads, the KV heads placed or sliced as in
    `attention_placed`; ``valid`` [S] replicated."""
    from torch.distributed.tensor.experimental import local_map
    tq, tk, _, heads = _group_placements(q, k.shape[2], 2)

    rep = replicated(len(tq))

    def body(ql, kl, vl, ok):
        if heads is not None:
            kl, vl = kl[:, :, heads[0]:heads[1]], vl[:, :, heads[0]:heads[1]]
        return ref.decode_attention(ql, kl, vl, ok)

    return local_map(body, out_placements=(tq,), in_placements=(tq, tk, tk, rep),
                     device_mesh=q.device_mesh, redistribute_inputs=True)(q, k, v, valid)


def rglru_placed(x, a, h0):
    """`ops.rglru` on DTensors x, a [B, T, W]: batch and channels kept,
    the time dim replicated; h0 [B, W] placed to match."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    from . import ops
    tx = keep_dims(x.placements, (0, 2), x, 2)
    th = tuple(Shard(1) if getattr(p, "dim", None) == 2 else p for p in tx)

    def body(xl, al, hl):
        return ops.rglru(xl.contiguous(), al.contiguous(), h0=hl)[0]

    ins = (tx, tx, None if h0 is None else th)
    out = local_map(body, out_placements=(tx,), in_placements=ins,
                    device_mesh=x.device_mesh, redistribute_inputs=True)(x, a, h0)
    return out, out[:, -1]


def rwkv6_wkv_placed(r, k, v, w, u, s0, return_state):
    """`ops.rwkv6_wkv` on DTensors r, k, w [B, T, H, K], v [B, T, H, V], u
    [H, K]: batch and heads kept, the time and channel dims replicated;
    each rank slices u's rows of its heads (u's gradient a partial sum
    over the dims sharding the heads or the batch); s0 [B, H, K, V]
    placed to match."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    from . import ops
    mesh = r.device_mesh
    tr = keep_dims(r.placements, (0, 2), r, 2)
    hdims = sharding_dims(tr, 2)
    lr, off = local_block(r.shape, mesh, tr)
    h0, hl = off[2], lr[2]
    tu = replicated(len(tr))
    gu = partial_on(tu, hdims + sharding_dims(tr, 0))
    ts = tuple(Shard(1) if getattr(p, "dim", None) == 2 else p for p in tr)

    def body(rl, kl, vl, wl, ul, sl):
        out, s_fin = ops.rwkv6_wkv(rl.contiguous(), kl.contiguous(), vl.contiguous(),
                                   wl.contiguous(), ul[h0:h0 + hl].contiguous(),
                                   s0=sl, return_state=True)
        return out, s_fin

    out, s_fin = local_map(
        body, out_placements=(tr, ts), in_placements=(tr, tr, tr, tr, tu,
                                                      None if s0 is None else ts),
        in_grad_placements=(tr, tr, tr, tr, gu, None if s0 is None else ts),
        device_mesh=mesh, redistribute_inputs=True)(r, k, v, w, u, s0)
    return (out, s_fin) if return_state else out


def topk_router_placed(scores, k, bias):
    """`ops.topk_router` on DTensor scores [T, E]: tokens kept, the
    expert dim replicated; the bias [E] replicated."""
    from torch.distributed.tensor.experimental import local_map
    from . import ops
    ts = keep_dims(scores.placements, (0,))
    tb = replicated(len(ts))

    def body(sl, bl):
        return ops.topk_router(sl.contiguous(), k, bias=bl)

    return local_map(body, out_placements=(ts, ts),
                     in_placements=(ts, None if bias is None else tb),
                     device_mesh=scores.device_mesh,
                     redistribute_inputs=True)(scores, bias)
