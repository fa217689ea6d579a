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
    return _Embedding.apply(tokens, table)


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
