"""Kernel entry points: the dispatcher.

A CUDA tensor launches the hand-written kernel (it raises on what the
kernel does not take — no fallback); a CPU tensor takes the plain PyTorch
version in `ref`. There is no shape gate and no environment switch.
"""
from __future__ import annotations

import torch

from . import flash_attention as _fa
from . import paged_attention as _pa
from . import ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0,
              scale: float | None = None) -> torch.Tensor:
    """Prefill attention: q [B, S, H, D] over k, v [B, T, KV, D]."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window, scale=scale)
    return _fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """One-token attention against a KV cache. No TPU kernel backs it (the
    reference runs its jnp oracle on every backend), so it is the plain
    version on every device."""
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
