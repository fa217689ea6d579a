"""Attention blocks: grouped-query attention with RoPE, qk-norm and an
optional sliding window, and DeepSeek's Multi-head Latent Attention (MLA).

Port of `repro.models.attention`. `gqa_train` is the full-sequence causal
attention used by `transformer.forward` and `decode.prefill`; its
single-token decode lives in `decode._decode_gqa`. Its inner product goes
through `repro_torch.kernels.ops.attention`, which launches the CUDA flash
kernel for CUDA tensors and runs the plain version for CPU tensors.

MLA (`mla_train`, `mla_decode`) attends in the compressed latent space
against a cache of the latent ``c_kv`` and the shared RoPE key. Its
attention is plain PyTorch on every device, as the reference's is plain
jnp (it never reaches a kernel): dense scores below `ref.CHUNKED_THRESHOLD`
keys, an online softmax over chunks of `ref.CHUNK` keys at or above it
when the key count is a multiple of the chunk. `mla_decode` is the
reference's single-device path; its sequence-sharded form
(`mla_decode_seq_sharded`) waits for the launch slice. M-RoPE and
cross-attention come with later slices.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import CHUNK, CHUNKED_THRESHOLD, NEG_INF
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
    if m.q_lora_rank:
        q = ((x @ p["wq_a"]) @ p["wq_b"]).reshape(b, s, cfg.n_heads, qd)
    else:
        q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, qd)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = x @ p["wkv_a"]
    k_rope = apply_rope((x @ p["wk_rope"])[..., None, :], positions,
                        cfg.rope_theta)[..., 0, :]   # one shared head
    return q_nope, q_rope, c_kv, k_rope


def _mla_scale(cfg: ArchConfig, dtype: torch.dtype) -> float:
    """1 / sqrt(nope + rope) as the reference's weakly typed scalar meets
    the scores: computed in fp32, then rounded to the scores' dtype."""
    m = cfg.mla
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
    m = cfg.mla
    h = cfg.n_heads
    wkv_b = p["wkv_b"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim)
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
    out = torch.einsum("bshl,lhv->bshv", ctx, w_uv)       # up-project per head
    return out.reshape(b, s, h * m.v_head_dim) @ p["wo"]


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
    same tensors, length + 1). Reads nothing back to the host."""
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
