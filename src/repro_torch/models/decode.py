"""Serving path: cache construction, prefill, and single-token decode.

Port of `repro.models.decode` for every family: the dense family and
qwen2-vl, DeepSeek's MoE/MLA family, rwkv6, the RG-LRU hybrid and
whisper's encoder-decoder. The cache is a dict with the reference's keys
and shapes:

- dense (and qwen2-vl): ``k`` and ``v`` [L, B, S, KV, Dh];
- MLA: the compressed latent ``c_kv`` [L, B, S, kv_lora] and the shared
  RoPE key ``k_rope`` [L, B, S, rope];
- rwkv6: ``wkv`` [L, B, H, Dh, Dh] (the WKV state, in the params' dtype,
  so each decode step rounds it as the reference does), ``shift_t`` and
  ``shift_c`` [L, B, D];
- hybrid: ``attn_k`` and ``attn_v`` [n_attn, B, S, KV, Dh], ``rec_h``
  [n_rec, B, W] and ``rec_conv`` [n_rec, B, conv_width - 1, W];
- enc-dec: the decoder's self-attention ``self_k`` and ``self_v`` [L, B,
  S, KV, Dh] (no RoPE) and its cross-attention's ``cross_k`` and
  ``cross_v`` [L, B, enc_seq, KV, Dh], the encoder output's keys and
  values, written by the prefill and only read by decode;

and ``length``, a 0-d int32 tensor. Sliding-window and local-attention
caches are ring buffers sized to the window. Unlike the reference's pure
functions, `prefill` writes each layer's state into the cache as it goes
and `decode_step` writes the new token's K/V and recurrent state into the
cache tensors in place (it returns a new dict holding the same tensors),
so no second copy of the cache is ever held. `decode_step` reads nothing
back to the host: `length` stays on the device. A MoE layer's FFN takes
the sorted-capacity dispatch in a prefill of more than
`moe.SMALL_BATCH_TOKENS` tokens and the one-hot dispatch in decode.
A frontend model (qwen2-vl) prefills from ``input_embeds`` and decodes
tokens; an encoder-decoder (whisper) prefills the encoder from
``enc_embeds`` and a decoder prompt of tokens, and each decode step adds
the learned position ``dec_pos`` of its slot.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import ops as kops
from repro_torch.launch.placement import is_dtensor
from . import attention as attn
from . import rglru as rglru_mod
from . import rwkv6 as rwkv_mod
from .common import mlp, norm, reshape_heads, rmsnorm, settle, unembed
from .config import ArchConfig, require_in_slice
from .transformer import (Params, _rec_block, deepseek_layers, dec_positions,
                          embed_tokens, encode, ffn, kind_layers, layer_params)


def _nf(cfg):
    return lambda y, pp: norm(y, pp, cfg.norm, cfg.norm_eps)


# ============================================================ cache init
def _kv_len(cfg: ArchConfig, max_len: int, window: int) -> int:
    return min(max_len, window) if window else max_len


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Any:
    require_in_slice(cfg)
    dt = dtype or cfg.param_dtype
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=device)
    cache: dict = {"length": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.is_encdec:
        for key in ("self_k", "self_v"):
            cache[key] = zeros(cfg.n_layers, batch, max_len, kv, dh)
        for key in ("cross_k", "cross_v"):
            cache[key] = zeros(cfg.n_layers, batch, cfg.enc_seq, kv, dh)
        return cache
    if cfg.mla is not None:
        m = cfg.mla
        cache["c_kv"] = zeros(cfg.n_layers, batch, max_len, m.kv_lora_rank)
        cache["k_rope"] = zeros(cfg.n_layers, batch, max_len, m.qk_rope_head_dim)
        return cache
    if cfg.recurrent == "rwkv6":
        cache["wkv"] = zeros(cfg.n_layers, batch, cfg.n_heads, dh, dh)
        cache["shift_t"] = zeros(cfg.n_layers, batch, cfg.d_model)
        cache["shift_c"] = zeros(cfg.n_layers, batch, cfg.d_model)
        return cache
    if cfg.pattern_period > 1:  # hybrid
        n_attn = cfg.layer_kinds().count("attn")
        n_rec = cfg.n_layers - n_attn
        w = cfg.lru_width or cfg.d_model
        s = _kv_len(cfg, max_len, cfg.local_window)
        cache["attn_k"] = zeros(n_attn, batch, s, kv, dh)
        cache["attn_v"] = zeros(n_attn, batch, s, kv, dh)
        cache["rec_h"] = zeros(n_rec, batch, w)
        cache["rec_conv"] = zeros(n_rec, batch, cfg.conv_width - 1, w)
        return cache
    s = _kv_len(cfg, max_len, cfg.sliding_window)
    cache["k"] = zeros(cfg.n_layers, batch, s, kv, dh)
    cache["v"] = zeros(cfg.n_layers, batch, s, kv, dh)
    return cache


def _assign(buf, src):
    """buf <- src in place; on DTensors src is placed as buf first and each
    rank writes its own shard."""
    if is_dtensor(buf):
        if is_dtensor(src):
            src = src.redistribute(buf.device_mesh, buf.placements)
        buf.to_local().copy_(src.to_local() if is_dtensor(src) else src)
        return buf
    return buf.copy_(src)


def _index_copy(buf, dim, idx, src):
    """``buf.index_copy_(dim, idx, src)``; on DTensors (``dim`` not a
    sharded dim of buf) src is placed as buf first and each rank writes
    its own shard."""
    if is_dtensor(buf):
        src = src.redistribute(buf.device_mesh, buf.placements)
        buf.to_local().index_copy_(dim, idx.to_local() if is_dtensor(idx) else idx,
                                   src.to_local())
        return buf
    return buf.index_copy_(dim, idx, src)


# ========================================================== decode blocks
def _ring_update(buf: torch.Tensor, new: torch.Tensor, length: torch.Tensor):
    """buf [B, S, ...] <- new [B, 1, ...] at slot length % S, in place."""
    slot = torch.remainder(length, buf.shape[1]).reshape(1).long()
    return buf.index_copy_(1, slot, new.to(buf.dtype))


def _decode_gqa(cfg, lp, x, k_buf, v_buf, length, use_rope=True):
    """One token's attention; writes its K/V into the layer's cache
    buffers [B, S, KV, Dh] in place. The window is the buffer's size."""
    b = x.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = reshape_heads(x @ lp["wq"], b, 1, h, dh)
    k_new = reshape_heads(x @ lp["wk"], b, 1, kv, dh)
    v_new = reshape_heads(x @ lp["wv"], b, 1, kv, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, lp["q_norm"], cfg.norm_eps)
        k_new = rmsnorm(k_new, lp["k_norm"], cfg.norm_eps)
    if use_rope:
        q, k_new = attn._rope_q_k(cfg, q, k_new, length.expand(b, 1))
    _ring_update(k_buf, k_new, length)
    _ring_update(v_buf, v_new, length)
    s = k_buf.shape[1]
    valid = torch.arange(s, device=x.device) < torch.clamp(length + 1, max=s)
    out = kops.decode_attention(q, k_buf, v_buf, valid)
    return reshape_heads(out, b, 1, h * dh) @ lp["wo"]


def _decode_attn_layer(cfg, lp, x, kb, vb, length, cross=None, use_rope=True):
    """One attention layer and its MLP for one token; with ``cross`` (the
    layer's cross_k, cross_v [B, T, KV, Dh]), cross-attention over every
    one of those keys between the two."""
    nf = _nf(cfg)
    x = settle(x + _decode_gqa(cfg, lp["attn"], nf(x, lp["ln1"]), kb, vb, length, use_rope), x)
    if cross is not None:
        ck, cv = cross
        b = x.shape[0]
        h, dh = cfg.n_heads, cfg.head_dim
        q = reshape_heads(nf(x, lp["lnx"]) @ lp["xattn"]["wq"], b, 1, h, dh)
        valid = torch.ones(ck.shape[1], dtype=torch.bool, device=x.device)
        out = kops.decode_attention(q, ck, cv, valid)
        x = settle(x + reshape_heads(out, b, 1, h * dh) @ lp["xattn"]["wo"], x)
    return settle(x + mlp(nf(x, lp["ln2"]), lp["mlp"], cfg.act), x)


def _decode_encdec(cfg, params, cache, x, length):
    x = x + dec_positions(params, length, 1).to(x.dtype)
    for i in range(cfg.n_layers):
        x = _decode_attn_layer(cfg, layer_params(params["dec_layers"], i), x,
                               cache["self_k"][i], cache["self_v"][i], length,
                               cross=(cache["cross_k"][i], cache["cross_v"][i]),
                               use_rope=False)
    return x


def _decode_hybrid(cfg, params, cache, x, length):
    for kind, i in kind_layers(cfg):
        if kind == "attn":
            x = _decode_attn_layer(cfg, layer_params(params["attn_layers"], i), x,
                                   cache["attn_k"][i], cache["attn_v"][i], length)
        else:
            state = rglru_mod.RGLRUState(cache["rec_h"][i], cache["rec_conv"][i])
            x, st = _rec_block(cfg, layer_params(params["rec_layers"], i), x, state)
            cache["rec_h"][i].copy_(st.h)
            cache["rec_conv"][i].copy_(st.conv)
    return x


def _decode_rwkv(cfg, params, cache, x):
    for i in range(cfg.n_layers):
        state = rwkv_mod.RWKVState(cache["wkv"][i], cache["shift_t"][i],
                                   cache["shift_c"][i])
        x, new = _rec_block(cfg, layer_params(params["layers"], i), x, state)
        cache["wkv"][i].copy_(new.wkv)
        cache["shift_t"][i].copy_(new.shift_t)
        cache["shift_c"][i].copy_(new.shift_c)
    return x


def _decode_mla(cfg, params, cache, x, length):
    nf = _nf(cfg)
    for i, lp in enumerate(deepseek_layers(cfg, params)):
        y, _ = attn.mla_decode(cfg, lp["attn"], nf(x, lp["ln1"]),
                               attn.MLACache(cache["c_kv"][i], cache["k_rope"][i], length))
        x = settle(x + y, x)
        y, _ = ffn(cfg, lp, nf(x, lp["ln2"]))
        x = settle(x + y, x)
    return x


def decode_step(cfg: ArchConfig, params: Params, cache: Any, token: torch.Tensor):
    """token: [B] int -> (logits [B, V], cache'). Writes the token's K/V
    and the layers' recurrent state into the cache's tensors in place."""
    require_in_slice(cfg)
    x = embed_tokens(cfg, params, token)[:, None, :]   # [B, 1, D]
    length = cache["length"]
    if cfg.is_encdec:
        x = _decode_encdec(cfg, params, cache, x, length)
    elif cfg.mla is not None:
        x = _decode_mla(cfg, params, cache, x, length)
    elif cfg.recurrent == "rwkv6":
        x = _decode_rwkv(cfg, params, cache, x)
    elif cfg.pattern_period > 1:
        x = _decode_hybrid(cfg, params, cache, x, length)
    else:
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
    return _index_copy(buf, 1, idx, kv_seq.to(buf.dtype))


def _prefill_attn_layer(cfg, lp, x, k_buf, v_buf, window):
    nf = _nf(cfg)
    y, (k, v) = attn.gqa_train(cfg, lp["attn"], nf(x, lp["ln1"]),
                               window=window, return_kv=True)
    x = settle(x + y, x)
    x = settle(x + mlp(nf(x, lp["ln2"]), lp["mlp"], cfg.act), x)
    _write_kv(k_buf, k, window)
    _write_kv(v_buf, v, window)
    return x


def _prefill_encdec(cfg, params, cache, x, enc_embeds):
    """The encoder, then per decoder layer: causal self-attention without
    RoPE (its K/V to ``self_k``/``self_v``), cross-attention over the
    encoder's output (its K/V to ``cross_k``/``cross_v``), the MLP."""
    nf = _nf(cfg)
    e = encode(cfg, params, enc_embeds)
    x = x + dec_positions(params, 0, x.shape[1]).to(x.dtype)
    for i in range(cfg.n_layers):
        lp = layer_params(params["dec_layers"], i)
        y, (k, v) = attn.gqa_train(cfg, lp["attn"], nf(x, lp["ln1"]), use_rope=False,
                                   return_kv=True)
        x = settle(x + y, x)
        _write_kv(cache["self_k"][i], k, 0)
        _write_kv(cache["self_v"][i], v, 0)
        y, (ck, cv) = attn.gqa_train(cfg, lp["xattn"], nf(x, lp["lnx"]), kv_source=e,
                                     return_kv=True)
        x = settle(x + y, x)
        _assign(cache["cross_k"][i], ck)
        _assign(cache["cross_v"][i], cv)
        x = settle(x + mlp(nf(x, lp["ln2"]), lp["mlp"], cfg.act), x)
    return x


def _prefill_mla(cfg, params, cache, x):
    nf = _nf(cfg)
    s = x.shape[1]
    for i, lp in enumerate(deepseek_layers(cfg, params)):
        y, (c_kv, k_rope) = attn.mla_train(cfg, lp["attn"], nf(x, lp["ln1"]),
                                           return_latent=True)
        x = settle(x + y, x)
        y, _ = ffn(cfg, lp, nf(x, lp["ln2"]))
        x = settle(x + y, x)
        if s == cache["c_kv"].shape[2]:
            _assign(cache["c_kv"][i], c_kv)
            _assign(cache["k_rope"][i], k_rope)
        else:
            cache["c_kv"][i, :, :s].copy_(c_kv)
            cache["k_rope"][i, :, :s].copy_(k_rope)
    return x


def _prefill_hybrid(cfg, params, cache, x):
    for kind, i in kind_layers(cfg):
        if kind == "attn":
            x = _prefill_attn_layer(cfg, layer_params(params["attn_layers"], i), x,
                                    cache["attn_k"][i], cache["attn_v"][i],
                                    cfg.local_window)
        else:
            x, st = _rec_block(cfg, layer_params(params["rec_layers"], i), x)
            _assign(cache["rec_h"][i], st.h)
            _assign(cache["rec_conv"][i], st.conv)
    return x


def _prefill_rwkv(cfg, params, cache, x):
    # the WKV scan kernel gives the final state (the reference's
    # `_rwkv_time_mix_prefill` calls its oracle for it)
    for i in range(cfg.n_layers):
        x, st = _rec_block(cfg, layer_params(params["layers"], i), x)
        _assign(cache["wkv"][i], st.wkv)
        _assign(cache["shift_t"][i], st.shift_t)
        _assign(cache["shift_c"][i], st.shift_c)
    return x


def prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor | None = None,
            input_embeds: torch.Tensor | None = None,
            enc_embeds: torch.Tensor | None = None, max_len: int | None = None):
    """Full-sequence prefill: tokens [B, S] (or, when None, a frontend
    stub's ``input_embeds`` [B, S, D]; an encoder-decoder also takes the
    encoder's ``enc_embeds`` [B, enc_seq, D]) -> (last-token logits [B,
    V], filled cache of ``max_len`` slots (S when None), or of the
    window).

    The hybrid needs S >= conv_width - 1: the conv tail it leaves for
    decode is the last conv_width - 1 rows of the prompt's conv input. The
    reference stores a shorter tail for a shorter prompt, which its decode
    then misreads; the port refuses such a prompt with ``ValueError``."""
    require_in_slice(cfg)
    x = embed_tokens(cfg, params, tokens, input_embeds)
    b, s = x.shape[:2]
    if cfg.recurrent == "rglru" and cfg.pattern_period > 1 and s < cfg.conv_width - 1:
        raise ValueError(
            f"{cfg.name}: a prompt of {s} tokens is shorter than the temporal "
            f"conv's tail of conv_width - 1 = {cfg.conv_width - 1}")
    if is_dtensor(x):   # the dry run's prefill: the cache placed by cache_specs
        from repro_torch.launch import sharding as SH
        meta = init_cache(cfg, b, max_len or s, device="meta")
        cache = SH.zeros_placed(meta, SH.cache_specs(cfg, meta, x.device_mesh),
                                x.device_mesh)
    else:
        cache = init_cache(cfg, b, max_len or s, device=x.device)
    if cfg.is_encdec:
        x = _prefill_encdec(cfg, params, cache, x, enc_embeds)
    elif cfg.mla is not None:
        x = _prefill_mla(cfg, params, cache, x)
    elif cfg.recurrent == "rwkv6":
        x = _prefill_rwkv(cfg, params, cache, x)
    elif cfg.pattern_period > 1:
        x = _prefill_hybrid(cfg, params, cache, x)
    else:
        for i in range(cfg.n_layers):
            x = _prefill_attn_layer(cfg, layer_params(params["layers"], i), x,
                                    cache["k"][i], cache["v"][i],
                                    cfg.sliding_window)
    cache["length"] = torch.full((), s, dtype=torch.int32, device=x.device)
    x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    logits = unembed(x[:, -1], params.get("lm_head", params["embed"]),
                     tied="lm_head" not in params)
    return logits, cache
