"""Serving path for the dense family: cache construction, prefill, and
single-token decode.

Port of the uniform-attention branch of `repro.models.decode`. The cache
is a dict with the reference's keys and shapes: ``k`` and ``v``
[L, B, S, KV, Dh] and ``length``, a 0-d int32 tensor. Sliding-window caches
are ring buffers sized to the window. Unlike the reference's pure
functions, `prefill` writes each layer's keys into the cache as it goes
and `decode_step` writes the new token's K/V into the cache tensors in
place (it returns a new dict holding the same tensors), so no second copy
of the cache is ever held. `decode_step` reads nothing back to the host:
`length` stays on the device.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import ops as kops
from . import attention as attn
from .common import embed, mlp, norm, rmsnorm, unembed
from .config import ArchConfig, require_in_slice
from .transformer import Params, layer_params


def _nf(cfg):
    return lambda y, pp: norm(y, pp, cfg.norm, cfg.norm_eps)


# ============================================================ cache init
def _kv_len(cfg: ArchConfig, max_len: int, window: int) -> int:
    return min(max_len, window) if window else max_len


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Any:
    require_in_slice(cfg)
    dt = dtype or cfg.param_dtype
    s = _kv_len(cfg, max_len, cfg.sliding_window)
    shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
    return {"length": torch.zeros((), dtype=torch.int32, device=device),
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


# ========================================================== decode blocks
def _ring_update(buf: torch.Tensor, new: torch.Tensor, length: torch.Tensor):
    """buf [B, S, ...] <- new [B, 1, ...] at slot length % S, in place."""
    slot = torch.remainder(length, buf.shape[1]).reshape(1).long()
    return buf.index_copy_(1, slot, new.to(buf.dtype))


def _decode_gqa(cfg, lp, x, k_buf, v_buf, length):
    """One token's attention; writes its K/V into the layer's cache
    buffers [B, S, KV, Dh] in place. The window is the buffer's size."""
    b = x.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ lp["wq"]).reshape(b, 1, h, dh)
    k_new = (x @ lp["wk"]).reshape(b, 1, kv, dh)
    v_new = (x @ lp["wv"]).reshape(b, 1, kv, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, lp["q_norm"], cfg.norm_eps)
        k_new = rmsnorm(k_new, lp["k_norm"], cfg.norm_eps)
    pos = length.expand(b, 1)
    q, k_new = attn._rope_q_k(cfg, q, k_new, pos)
    _ring_update(k_buf, k_new, length)
    _ring_update(v_buf, v_new, length)
    s = k_buf.shape[1]
    valid = torch.arange(s, device=x.device) < torch.clamp(length + 1, max=s)
    out = kops.decode_attention(q, k_buf, v_buf, valid)
    return out.reshape(b, 1, h * dh) @ lp["wo"]


def _decode_attn_layer(cfg, lp, x, kb, vb, length):
    nf = _nf(cfg)
    x = x + _decode_gqa(cfg, lp["attn"], nf(x, lp["ln1"]), kb, vb, length)
    return x + mlp(nf(x, lp["ln2"]), lp["mlp"], cfg.act)


def decode_step(cfg: ArchConfig, params: Params, cache: Any, token: torch.Tensor):
    """token: [B] int -> (logits [B, V], cache'). Writes the token's K/V
    into ``cache["k"]`` / ``cache["v"]`` in place."""
    require_in_slice(cfg)
    x = embed(token, params["embed"])[:, None, :]   # [B, 1, D]
    length = cache["length"]
    for i in range(cfg.n_layers):
        x = _decode_attn_layer(cfg, layer_params(params["layers"], i), x,
                               cache["k"][i], cache["v"][i], length)
    cache = dict(cache, length=length + 1)
    x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    logits = unembed(x[:, 0], params.get("lm_head", params["embed"]),
                     tied="lm_head" not in params)
    return logits, cache


# =============================================================== prefill
def _write_kv(buf: torch.Tensor, kv_seq: torch.Tensor, window: int):
    """Place the (last-window) keys of a prompt at ring-consistent slots:
    buf [B, S_cache, KV, Dh] <- kv_seq [B, s, KV, Dh], in place."""
    s, dst = kv_seq.shape[1], buf.shape[1]
    if window and s > dst:
        kv_seq = kv_seq[:, -dst:]
        idx = torch.remainder(torch.arange(s - dst, s, device=buf.device), dst)
    else:
        idx = torch.arange(min(s, dst), device=buf.device)
        kv_seq = kv_seq[:, :dst]
    return buf.index_copy_(1, idx, kv_seq.to(buf.dtype))


def prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            max_len: int | None = None):
    """Full-sequence prefill: tokens [B, S] -> (last-token logits [B, V],
    filled cache of ``max_len`` slots (S when None), or of the window)."""
    require_in_slice(cfg)
    x = embed(tokens, params["embed"])
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_len or s, device=x.device)
    nf = _nf(cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        y, (k, v) = attn.gqa_train(cfg, lp["attn"], nf(x, lp["ln1"]),
                                   window=cfg.sliding_window, return_kv=True)
        x = x + y
        x = x + mlp(nf(x, lp["ln2"]), lp["mlp"], cfg.act)
        _write_kv(cache["k"][i], k, cfg.sliding_window)
        _write_kv(cache["v"][i], v, cfg.sliding_window)
    cache["length"] = torch.full((), s, dtype=torch.int32, device=x.device)
    x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    logits = unembed(x[:, -1], params.get("lm_head", params["embed"]),
                     tied="lm_head" not in params)
    return logits, cache
