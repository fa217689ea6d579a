"""Model assembly for the dense family: parameter init, carrying the
reference's weights across, and the full-sequence forward.

Port of the uniform-attention branch of `repro.models.transformer`.
Params are a dict of tensors with the reference tree's keys and layouts:
the layer parameters are STACKED along a leading layer axis
(``params["layers"]["attn"]["wq"]`` is [L, D, H * Dh]) and the forward
walks the stack in a Python loop where the reference scans it. Other
families raise ``NotImplementedError("later slice")``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from . import attention as attn
from .common import dense_init, embed, mlp, norm, unembed
from .config import ArchConfig, require_in_slice

Params = Any


# ======================================================== parameter init
class _Init:
    """Draws a dense model's parameters one tensor (or one layer slice) at
    a time, each in fp32 and then cast, so the peak stays near the size of
    the weights in their own dtype."""

    def __init__(self, cfg: ArchConfig, device: torch.device,
                 generator: torch.Generator):
        self.cfg, self.device, self.gen = cfg, device, generator
        self.layers = cfg.n_layers

    def dense(self, shape, in_axis=-2, stacked=False):
        dt = self.cfg.param_dtype
        if not stacked:
            return dense_init(shape, in_axis, dt, generator=self.gen,
                              device=self.device)
        out = torch.empty((self.layers, *shape), dtype=dt, device=self.device)
        for i in range(self.layers):
            dense_init(shape, in_axis, dt, generator=self.gen,
                       device=self.device, out=out[i])
        return out

    def ones(self, shape, stacked=False):
        lead = (self.layers,) if stacked else ()
        return torch.ones((*lead, *shape), dtype=self.cfg.param_dtype,
                          device=self.device)

    def zeros(self, shape, stacked=False):
        lead = (self.layers,) if stacked else ()
        return torch.zeros((*lead, *shape), dtype=self.cfg.param_dtype,
                           device=self.device)


def _norm_p(init: _Init, stacked=False):
    cfg = init.cfg
    p = {"scale": init.ones((cfg.d_model,), stacked)}
    if cfg.norm == "layernorm":
        p["bias"] = init.zeros((cfg.d_model,), stacked)
    return p


def _attn_p(init: _Init, stacked=False):
    cfg = init.cfg
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": init.dense((d, h * dh), stacked=stacked),
        "wk": init.dense((d, kv * dh), stacked=stacked),
        "wv": init.dense((d, kv * dh), stacked=stacked),
        "wo": init.dense((h * dh, d), stacked=stacked),
    }
    if cfg.qk_norm:
        p["q_norm"] = init.ones((dh,), stacked)
        p["k_norm"] = init.ones((dh,), stacked)
    return p


def _mlp_p(init: _Init, stacked=False):
    cfg = init.cfg
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi_up": init.dense((d, f), stacked=stacked),
         "wo": init.dense((f, d), stacked=stacked)}
    if cfg.act in ("swiglu", "geglu"):
        p["wi_gate"] = init.dense((d, f), stacked=stacked)
    return p


def _attn_layer_p(init: _Init, stacked=False):
    return {"attn": _attn_p(init, stacked), "ln1": _norm_p(init, stacked),
            "ln2": _norm_p(init, stacked), "mlp": _mlp_p(init, stacked)}


def init_params(cfg: ArchConfig, *, device=None,
                generator: torch.Generator | None = None) -> Params:
    """Random parameters of a dense model on ``device`` (CUDA when None):
    the reference's tree, drawn like `common.dense_init` from
    ``generator`` (a ``torch.Generator`` on that device; seed 0 when
    None)."""
    require_in_slice(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    init = _Init(cfg, dev, generator)
    p: dict = {
        "embed": init.dense((cfg.vocab, cfg.d_model), in_axis=-1),
        "final_norm": _norm_p(init),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init.dense((cfg.d_model, cfg.vocab))
    p["layers"] = _attn_layer_p(init, stacked=True)
    return p


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as jax exports it
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(cfg: ArchConfig, tree: Params, device=None) -> Params:
    """The reference's params as numpy arrays (``jax.tree.map(np.asarray,
    params)``) -> the port's params on ``device``, same keys, layouts and
    dtypes."""
    require_in_slice(cfg)
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(node, dev)

    return conv(tree)


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# ========================================================== forward
def _attn_block(cfg: ArchConfig, lp: dict, x, *, window: int):
    nf = lambda y, pp: norm(y, pp, cfg.norm, cfg.norm_eps)
    x = x + attn.gqa_train(cfg, lp["attn"], nf(x, lp["ln1"]), window=window)
    return x + mlp(nf(x, lp["ln2"]), lp["mlp"], cfg.act)


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor):
    """Full-sequence forward: tokens [B, S] -> (logits [B, S, V], aux
    loss). The dense family has no auxiliary loss, so aux is 0."""
    require_in_slice(cfg)
    x = embed(tokens, params["embed"])
    for i in range(cfg.n_layers):
        x = _attn_block(cfg, layer_params(params["layers"], i), x,
                        window=cfg.sliding_window)
    x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    logits = unembed(x, params.get("lm_head", params["embed"]),
                     tied="lm_head" not in params)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)
