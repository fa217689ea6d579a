"""Kernel entry points: the dispatcher.

A CUDA tensor launches the hand-written kernel (it raises on what the
kernel does not take — no fallback); a CPU tensor takes the plain PyTorch
version in `ref`. There is no shape gate and no environment switch. The
four kernels of the training and prefill paths (`attention`, `rglru`,
`rwkv6_wkv`, `topk_router`) also take a DTensor, which runs this same
entry on its local shards, and a fake tensor, which takes the kernel's
fake entry (`entries`).
"""
from __future__ import annotations

import torch

from repro_torch.launch.placement import is_dtensor
from . import entries as _en
from . import flash_attention as _fa
from . import ftl_lookup as _ftl
from . import moe_router as _mr
from . import paged_attention as _pa
from . import ref
from . import rglru_scan as _rg
from . import rwkv6_scan as _wkv
from . import shards_window as _sw


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0,
              scale: float | None = None) -> torch.Tensor:
    """Prefill attention: q [B, S, H, D] over k, v [B, T, KV, D]. A CUDA
    tensor goes through `FlashAttention`: the forward kernel, and under a
    gradient the backward kernel (when nothing needs one, as in serving,
    the forward kernel is all it launches)."""
    if is_dtensor(q):
        return _en.attention_placed(q, k, v, causal, window, scale)
    if _en.is_fake(q):
        return _en.attention_fake(q, k, v, causal, window, scale)
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window, scale=scale)
    return _fa.FlashAttention.apply(q, k, v, causal, window, scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """One-token attention against a KV cache. No TPU kernel backs it (the
    reference runs its jnp oracle on every backend), so it is the plain
    version on every device (on a DTensor, on each rank's shards)."""
    if is_dtensor(q):
        return _en.decode_attention_placed(q, k, v, valid)
    return ref.decode_attention(q, k, v, valid)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, k_scale: torch.Tensor | None = None,
                    v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Paged decode attention. Pass ``k_scale``/``v_scale`` ([P] fp32)
    when the pools hold int8 codes; omit them for fp pools."""
    if q.device.type == "cpu":
        if k_scale is not None:
            return ref.paged_attention_quant(q, k_pool, v_pool, k_scale,
                                             v_scale, page_table, lengths)
        return ref.paged_attention(q, k_pool, v_pool, page_table, lengths)
    return _pa.paged_attention(q, k_pool, v_pool, page_table, lengths,
                               k_scale=k_scale, v_scale=v_scale)


def rglru(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None = None):
    """RG-LRU recurrence over x, a [B, T, W] from h0 [B, W] (zeros when
    None) -> (out [B, T, W], h_T). A CUDA tensor goes through `RGLRU`: the
    forward kernel, and under a gradient the backward kernel."""
    if is_dtensor(x):
        return _en.rglru_placed(x, a, h0)
    if _en.is_fake(x):
        out = _en.rglru_op(x, a, h0)
        return out, out[:, -1]
    if x.device.type == "cpu":
        return ref.rglru(x, a, h0=h0)
    out = _rg.RGLRU.apply(x, a, h0)
    return out, out[:, -1]


# the decode step: no TPU kernel backs it (the reference runs its jnp
# oracle on every backend), so it is the plain version on every device
rglru_step = ref.rglru_step


def rwkv6_wkv(r, k, v, w, u, s0=None, return_state: bool = False):
    """RWKV6 WKV over r, k, w [B, T, H, K], v [B, T, H, V] with bonus u
    [H, K], from s0 [B, H, K, V] (zeros when None); with ``return_state``
    also the final state. A CUDA tensor goes through `RWKV6WKV`: the
    forward kernel, and under a gradient the backward kernel."""
    if is_dtensor(r):
        return _en.rwkv6_wkv_placed(r, k, v, w, u, s0, return_state)
    if _en.is_fake(r):
        out, s_fin = _en.rwkv6_wkv_op(r, k, v, w, u, s0)
        return (out, s_fin) if return_state else out
    if r.device.type == "cpu":
        return ref.rwkv6_wkv(r, k, v, w, u, s0=s0, return_state=return_state)
    out, s_fin = _wkv.RWKV6WKV.apply(r, k, v, w, u, s0)
    return (out, s_fin) if return_state else out


# the decode step, like `rglru_step`: the plain version on every device
rwkv6_wkv_step = ref.rwkv6_wkv_step


def topk_router(scores: torch.Tensor, k: int, bias: torch.Tensor | None = None):
    """Top-k experts of scores [T, E] fp32 by ``scores + bias`` -> (weights
    [T, k] fp32 renormalizing the unbiased picked scores, indices [T, k]
    int32). No shape gate: the reference's ``E >= 128`` is a TPU lane
    constraint. A CUDA tensor goes through `TopKRouter`: the forward
    kernel, and under a gradient the backward kernel (for the scores)."""
    if is_dtensor(scores):
        return _en.topk_router_placed(scores, k, bias)
    if _en.is_fake(scores):
        return _en.topk_router_op(scores, k, bias)
    if scores.device.type == "cpu":
        return ref.topk_router(scores, k, bias=bias)
    return _mr.TopKRouter.apply(scores, k, bias)


def ftl_lookup(lpns: torch.Tensor, directory: torch.Tensor,
               mapping_cache: torch.Tensor, entries_per_segment: int):
    """LPN -> PPN translation through the cached mapping table -> (ppn [N]
    int32, hit [N] bool); a miss gives -1."""
    if lpns.device.type == "cpu":
        return ref.ftl_lookup(lpns, directory, mapping_cache, entries_per_segment)
    return _ftl.ftl_lookup(lpns, directory, mapping_cache, entries_per_segment)


def shards_window(addrs: torch.Tensor, last_seen: torch.Tensor,
                  clock: torch.Tensor, hist: torch.Tensor, cold: torch.Tensor,
                  total: torch.Tensor, refs: torch.Tensor, mask: torch.Tensor,
                  sample_mod: int, sample_thresh: int, bucket_width: int):
    """Fixed-size SHARDS over one window of references for every node:
    state addrs int64 [N, K], last_seen int32 [N, K], clock int32 [N],
    hist float32 [N, B], cold and total float32 [N]; refs int64 [N, A]
    and mask bool [N, A] -> the six updated tensors."""
    args = (addrs, last_seen, clock, hist, cold, total, refs, mask,
            sample_mod, sample_thresh, bucket_width)
    if addrs.device.type == "cpu":
        return ref.shards_window(*args)
    return _sw.shards_window(*args)
