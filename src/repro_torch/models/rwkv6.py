"""RWKV6 "Finch" block: token-shift, data-dependent decay WKV, channel mix.

Port of `repro.models.rwkv6`. A full sequence goes through
`kernels.ops.rwkv6_wkv` (the CUDA scan kernel for CUDA tensors, the plain
version for CPU tensors), which also returns the final state that a
prefill leaves in the cache; decode keeps a [B, H, K, V] matrix state plus
the 1-token shift states and takes the single-step form, the plain version
on every device as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from .common import reshape_heads, settle
from .config import ArchConfig


class RWKVState(NamedTuple):
    wkv: torch.Tensor      # [B, H, K, V] per-layer recurrence state
    shift_t: torch.Tensor  # [B, D] last token (time-mix shift)
    shift_c: torch.Tensor  # [B, D] last token (channel-mix shift)


def _token_shift(x: torch.Tensor, last: torch.Tensor | None) -> torch.Tensor:
    """x: [B, T, D]; returns the x_{t-1} stream (zero/state-filled at t=0)."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(x, x_prev, mu, lora_a, lora_b):
    """RWKV6 data-dependent interpolation between x_t and x_{t-1}. On
    DTensors the low-rank products stay in x's placement (`settle`):
    DTensor would split their replicated rows over "model" by the
    sequence, which its backward cannot take."""
    base = x + (x_prev - x) * mu
    dd = settle(settle(torch.tanh(base @ lora_a), x) @ lora_b, x)
    return x + (x_prev - x) * (mu + dd)


def time_mix(cfg: ArchConfig, p: dict, x: torch.Tensor,
             state: RWKVState | None):
    """x: [B, T, D] -> ([B, T, D], the new WKV state [B, H, K, V]). With
    ``state`` (decode, T = 1) the WKV takes one step from it; without, it
    scans the sequence from zeros and the kernel gives the final state in
    x's dtype, as the reference's prefill computes it."""
    b, t, _ = x.shape
    h, dk = cfg.n_heads, cfg.head_dim
    xp = _token_shift(x, state.shift_t if state is not None else None)

    r_in = _ddlerp(x, xp, p["mu_r"], p["lora_a"], p["lora_b_r"])
    k_in = _ddlerp(x, xp, p["mu_k"], p["lora_a"], p["lora_b_k"])
    v_in = _ddlerp(x, xp, p["mu_v"], p["lora_a"], p["lora_b_v"])
    g_in = _ddlerp(x, xp, p["mu_g"], p["lora_a"], p["lora_b_g"])
    w_in = _ddlerp(x, xp, p["mu_w"], p["lora_a"], p["lora_b_w"])

    r = reshape_heads(r_in @ p["wr"], b, t, h, dk)
    k = reshape_heads(k_in @ p["wk"], b, t, h, dk)
    v = reshape_heads(v_in @ p["wv"], b, t, h, dk)
    g = F.silu(g_in @ p["wg"])
    # data-dependent decay (0, 1): w = exp(-exp(decay))
    decay = reshape_heads(p["w_base"] + settle(settle(torch.tanh(w_in @ p["w_lora_a"]), x)
                                             @ p["w_lora_b"], x), b, t, h, dk)
    w = torch.exp(-torch.exp(decay.float())).to(x.dtype)
    u = p["u"].reshape(h, dk)

    if state is None:
        out, S = kops.rwkv6_wkv(r, k, v, w, u, return_state=True)
    else:
        S, o = kops.rwkv6_wkv_step(state.wkv, r[:, 0], k[:, 0], v[:, 0], w[:, 0], u)
        out = o[:, None]

    out = reshape_heads(out, b, t, h * dk)
    out = _group_norm(out, p["ln_x_scale"], p["ln_x_bias"], h)
    return (out * g) @ p["wo"], S


def _group_norm(x, scale, bias, groups: int, eps: float = 64e-5):
    b, t, d = x.shape
    xg = reshape_heads(x, b, t, groups, d // groups).float()
    mu = xg.mean(-1, keepdim=True)
    var = xg.var(-1, keepdim=True, unbiased=False)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return (reshape_heads(xg, b, t, d) * scale + bias).to(x.dtype)


def channel_mix(cfg: ArchConfig, p: dict, x: torch.Tensor, state: RWKVState | None):
    xp = _token_shift(x, state.shift_c if state is not None else None)
    k_in = x + (xp - x) * p["mu_k"]
    r_in = x + (xp - x) * p["mu_r"]
    k = torch.square(torch.relu(k_in @ p["wk"]))
    return torch.sigmoid(r_in @ p["wr"]) * (k @ p["wv"])


def rwkv_block(cfg: ArchConfig, p: dict, x: torch.Tensor,
               state: RWKVState | None, norm_fn):
    """x: [B, T, D] -> ([B, T, D], new state): from ``state`` (decode) or
    from zeros (prefill, forward). The new state is the WKV state and the
    last token of each mix's input, what the cache keeps."""
    xn = norm_fn(x, p["ln1"])
    h, S = time_mix(cfg, p["time"], xn, state)
    x = settle(x + h, x)
    cn = norm_fn(x, p["ln2"])
    x = settle(x + channel_mix(cfg, p["chan"], cn, state), x)
    return x, RWKVState(S, xn[:, -1], cn[:, -1])
