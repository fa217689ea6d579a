"""Attention blocks: grouped-query attention with RoPE, qk-norm and an
optional sliding window.

Port of the GQA part of `repro.models.attention`: `gqa_train` is the
full-sequence causal attention used by `transformer.forward` and
`decode.prefill`; the single-token decode lives in `decode._decode_gqa`.
The inner product goes through `repro_torch.kernels.ops.attention`, which
launches the CUDA flash kernel for CUDA tensors and runs the plain version
for CPU tensors. MLA, M-RoPE and cross-attention come with later slices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from .common import apply_rope, rmsnorm
from .config import ArchConfig


def _positions(s: int, device=None) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None, :]


def _rope_q_k(cfg: ArchConfig, q, k, positions):
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k


def gqa_train(cfg: ArchConfig, p: dict, x: torch.Tensor, *, window: int = 0,
              return_kv: bool = False):
    """Causal self-attention with RoPE: x [B, S, D] -> y [B, S, D] (and
    the layer's post-RoPE k, v [B, S, KV, Dh] with ``return_kv``)."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, dh)
    k = (x @ p["wk"]).reshape(b, s, kv, dh)
    v = (x @ p["wv"]).reshape(b, s, kv, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q, k = _rope_q_k(cfg, q, k, _positions(s, device=x.device))
    out = kops.attention(q, k, v, causal=True, window=window)
    y = out.reshape(b, s, h * dh) @ p["wo"]
    if return_kv:
        return y, (k, v)
    return y
