"""Model assembly: parameter init, carrying the reference's weights
across, and the full-sequence forward.

Port of `repro.models.transformer` for every family of the reference:
the dense family and qwen2-vl (one stack ``layers``; M-RoPE for
qwen2-vl), the DeepSeek MoE/MLA family (MLA attention in every layer, a
stack of dense-FFN prefix layers ``dense_layers`` and a stack of MoE
layers ``moe_layers``, and for DeepSeek-v3 the multi-token-prediction
block ``mtp``, which serving never reads), rwkv6 (one stack of RWKV6
blocks), the RG-LRU hybrid (a stack of local-attention layers and a stack
of recurrent layers, dispatched by the period pattern) and whisper's
encoder-decoder (``enc_layers``, ``dec_layers`` with cross-attention
``xattn`` and its norm ``lnx``, ``enc_final_norm`` and the learned
decoder positions ``dec_pos``). Params are a dict of tensors with the
reference tree's keys, layouts and dtypes (the MoE router and its bias
are fp32): the layer parameters are STACKED along a leading layer axis
(``params["layers"]["attn"]["wq"]`` is [L, D, H * Dh], a MoE layer's
``experts`` [L, E, D, F]) and the forward walks the stacks in a Python
loop where the reference scans them. A modality frontend is a stub: the
caller hands in its embeddings (``input_embeds`` in place of tokens;
``enc_embeds``, the encoder's input).

The reference's encoder is causal and rotates its queries and keys
(`_scan_attn_stack` with its defaults), and so is the port's; only the
cross-attention is unmasked.

Training: `lm_loss` (token cross-entropy, DeepSeek-v3's MTP term, the MoE
aux loss) over `forward`, whose layers (the encoder's and the decoder's
too) are checkpointed (recomputed in the backward pass, as the
reference's `jax.checkpoint`) when ``cfg.remat`` and grad mode is on;
`abstract_params` gives the tree's shapes and dtypes from the meta
device.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from . import attention as attn
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import rwkv6 as rwkv_mod
from .common import dense_init, embed, mean, mlp, norm, settle, unembed
from .config import ArchConfig, require_in_slice

Params = Any


# ======================================================== parameter init
class _Init:
    """Draws a model's parameters one tensor (or one layer slice) at a
    time, each in fp32 and then cast, so the peak stays near the size of
    the weights in their own dtype. ``n`` > 0 stacks a tensor along a
    leading axis of ``n`` layers, each drawn on its own."""

    def __init__(self, cfg: ArchConfig, device: torch.device,
                 generator: torch.Generator):
        self.cfg, self.device, self.gen = cfg, device, generator

    def dense(self, shape, in_axis=-2, n=0, dtype=None):
        dt = dtype or self.cfg.param_dtype
        if self.device.type == "meta":   # shapes and dtypes only
            return torch.empty((n, *shape) if n else shape, dtype=dt, device=self.device)
        if not n:
            return dense_init(shape, in_axis, dt, generator=self.gen,
                              device=self.device)
        out = torch.empty((n, *shape), dtype=dt, device=self.device)
        for i in range(n):
            dense_init(shape, in_axis, dt, generator=self.gen,
                       device=self.device, out=out[i])
        return out

    def experts(self, shape, n):
        """A stack of ``n`` layers of expert weights [n, E, D_in, D_out]
        (``shape`` = [E, D_in, D_out], fan-in D_in), each (layer, expert)
        slice drawn on its own: the fp32 temporary is one expert's matrix
        (a whole layer's DeepSeek-v3 wi_gate would need 15 GB)."""
        dt = self.cfg.param_dtype
        out = torch.empty((n, *shape), dtype=dt, device=self.device)
        if self.device.type == "meta":
            return out
        for i in range(n):
            for e in range(shape[0]):
                dense_init(shape, 1, dt, generator=self.gen,
                           device=self.device, out=out[i, e])
        return out

    def full(self, shape, value, n=0, dtype=None):
        lead = (n,) if n else ()
        return torch.full((*lead, *shape), value,
                          dtype=dtype or self.cfg.param_dtype, device=self.device)

    def ones(self, shape, n=0):
        return self.full(shape, 1.0, n)

    def zeros(self, shape, n=0, dtype=None):
        return self.full(shape, 0.0, n, dtype)


def _norm_p(init: _Init, n=0):
    cfg = init.cfg
    p = {"scale": init.ones((cfg.d_model,), n)}
    if cfg.norm == "layernorm":
        p["bias"] = init.zeros((cfg.d_model,), n)
    return p


def _mla_p(init: _Init, n=0):
    cfg = init.cfg
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    p = {
        "wkv_a": init.dense((d, m.kv_lora_rank), n=n),
        "wk_rope": init.dense((d, m.qk_rope_head_dim), n=n),
        "wkv_b": init.dense((m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim)),
                            in_axis=0, n=n),
        "wo": init.dense((h * m.v_head_dim, d), n=n),
    }
    qdim = h * (m.qk_nope_head_dim + m.qk_rope_head_dim)
    if m.q_lora_rank:
        p["wq_a"] = init.dense((d, m.q_lora_rank), n=n)
        p["wq_b"] = init.dense((m.q_lora_rank, qdim), in_axis=0, n=n)
    else:
        p["wq"] = init.dense((d, qdim), n=n)
    return p


def _attn_p(init: _Init, n=0, cross: bool = False):
    cfg = init.cfg
    if cfg.mla is not None and not cross:
        return _mla_p(init, n)
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": init.dense((d, h * dh), n=n),
        "wk": init.dense((d, kv * dh), n=n),
        "wv": init.dense((d, kv * dh), n=n),
        "wo": init.dense((h * dh, d), n=n),
    }
    if cfg.qk_norm:
        p["q_norm"] = init.ones((dh,), n)
        p["k_norm"] = init.ones((dh,), n)
    return p


def _mlp_p(init: _Init, n=0):
    cfg = init.cfg
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi_up": init.dense((d, f), n=n),
         "wo": init.dense((f, d), n=n)}
    if cfg.act in ("swiglu", "geglu"):
        p["wi_gate"] = init.dense((d, f), n=n)
    return p


def _moe_p(init: _Init, n):
    cfg = init.cfg
    e, d = cfg.moe, cfg.d_model
    p = {
        "router": init.dense((d, e.n_routed), n=n, dtype=torch.float32),
        "experts": {
            "wi_gate": init.experts((e.n_routed, d, e.d_ff_expert), n),
            "wi_up": init.experts((e.n_routed, d, e.d_ff_expert), n),
            "wo": init.experts((e.n_routed, e.d_ff_expert, d), n),
        },
    }
    if e.aux_free_bias:
        p["router_bias"] = init.zeros((e.n_routed,), n, dtype=torch.float32)
    if e.n_shared:
        fs = e.d_ff_expert * e.n_shared
        p["shared"] = {"wi_gate": init.dense((d, fs), n=n),
                       "wi_up": init.dense((d, fs), n=n),
                       "wo": init.dense((fs, d), n=n)}
    return p


def _rwkv_p(init: _Init, n=0):
    cfg = init.cfg
    d = cfg.d_model
    hk = cfg.n_heads * cfg.head_dim
    lora = max(d // 16, 32)
    time = {f"mu_{c}": init.zeros((d,), n) for c in "rkvgw"}
    time["lora_a"] = init.dense((d, lora), n=n)
    for c in "rkvgw":
        time[f"lora_b_{c}"] = init.dense((lora, d), in_axis=0, n=n)
    for c in "rkvg":
        time[f"w{c}"] = init.dense((d, hk), n=n)
    time.update(
        wo=init.dense((hk, d), n=n),
        w_base=init.zeros((d,), n),
        w_lora_a=init.dense((d, lora), n=n),
        w_lora_b=init.dense((lora, d), in_axis=0, n=n),
        u=init.zeros((hk,), n),
        ln_x_scale=init.ones((hk,), n),
        ln_x_bias=init.zeros((hk,), n),
    )
    chan = {"mu_k": init.zeros((d,), n), "mu_r": init.zeros((d,), n),
            "wk": init.dense((d, cfg.d_ff), n=n),
            "wv": init.dense((cfg.d_ff, d), n=n),
            "wr": init.dense((d, d), n=n)}
    return {"time": time, "chan": chan, "ln1": _norm_p(init, n),
            "ln2": _norm_p(init, n)}


def _rglru_p(init: _Init, n=0):
    cfg = init.cfg
    d = cfg.d_model
    w = cfg.lru_width or d
    return {
        "w_in": init.dense((d, w), n=n),
        "w_in_gate": init.dense((d, w), n=n),
        "conv_w": init.dense((cfg.conv_width, w), in_axis=0, n=n),
        "w_rg": init.dense((w, w), n=n),
        "b_rg": init.zeros((w,), n),
        "w_ig": init.dense((w, w), n=n),
        "b_ig": init.zeros((w,), n),
        "lambda_p": init.full((w,), 0.5, n),
        "w_out": init.dense((w, d), n=n),
    }


def _attn_layer_p(init: _Init, n=0, moe_layer: bool = False, cross: bool = False):
    p = {"attn": _attn_p(init, n), "ln1": _norm_p(init, n), "ln2": _norm_p(init, n)}
    if cross:
        p["xattn"] = _attn_p(init, n, cross=True)
        p["lnx"] = _norm_p(init, n)
    if moe_layer:
        p["moe"] = _moe_p(init, n)
    else:
        p["mlp"] = _mlp_p(init, n)
    return p


def _rec_layer_p(init: _Init, n=0):
    if init.cfg.recurrent == "rwkv6":
        return _rwkv_p(init, n)
    return {"rec": _rglru_p(init, n), "ln1": _norm_p(init, n),
            "ln2": _norm_p(init, n), "mlp": _mlp_p(init, n)}


def init_params(cfg: ArchConfig, *, device=None,
                generator: torch.Generator | None = None) -> Params:
    """Random parameters on ``device`` (CUDA when None): the reference's
    tree, drawn like `common.dense_init` from ``generator`` (a
    ``torch.Generator`` on that device; seed 0 when None). rwkv6 has one
    stack ``layers``; the hybrid two, ``attn_layers`` and ``rec_layers``;
    DeepSeek ``dense_layers`` (its first ``first_k_dense``), ``moe_layers``
    and, with ``mtp_depth``, ``mtp``; an encoder-decoder ``enc_layers``,
    ``dec_layers`` (with cross-attention), ``enc_final_norm`` and
    ``dec_pos`` [dec_pos_len, D]. Expert stacks are drawn one (layer,
    expert) matrix at a time."""
    require_in_slice(cfg)
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    init = _Init(cfg, dev, generator)
    p: dict = {
        "embed": init.dense((cfg.vocab, cfg.d_model), in_axis=-1),
        "final_norm": _norm_p(init),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init.dense((cfg.d_model, cfg.vocab))
    if cfg.is_encdec:
        p["enc_layers"] = _attn_layer_p(init, cfg.n_enc_layers)
        p["dec_layers"] = _attn_layer_p(init, cfg.n_layers, cross=True)
        p["enc_final_norm"] = _norm_p(init)
        p["dec_pos"] = init.dense((cfg.dec_pos_len, cfg.d_model), in_axis=-1)
    elif cfg.mla is not None:  # DeepSeek
        fk = cfg.moe.first_k_dense
        if fk:
            p["dense_layers"] = _attn_layer_p(init, fk)
        p["moe_layers"] = _attn_layer_p(init, cfg.n_layers - fk, moe_layer=True)
    elif cfg.recurrent == "rwkv6":
        p["layers"] = _rec_layer_p(init, cfg.n_layers)
    elif cfg.pattern_period > 1:  # hybrid
        n_attn = cfg.layer_kinds().count("attn")
        p["attn_layers"] = _attn_layer_p(init, n_attn)
        p["rec_layers"] = _rec_layer_p(init, cfg.n_layers - n_attn)
    else:
        p["layers"] = _attn_layer_p(init, cfg.n_layers)
    if cfg.mtp_depth:
        p["mtp"] = {"layer": _attn_layer_p(init),
                    "proj": init.dense((2 * cfg.d_model, cfg.d_model)),
                    "norm": _norm_p(init)}
    return p


def abstract_params(cfg: ArchConfig) -> Params:
    """The parameter tree's shapes and dtypes, as tensors on the meta
    device: nothing is allocated or drawn (the reference's
    ``jax.eval_shape`` of `init_params`)."""
    return init_params(cfg, device="meta")


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


def leaves(tree: Params):
    """Every tensor of a parameter tree."""
    for v in tree.values():
        yield from leaves(v) if isinstance(v, dict) else (v,)


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# ========================================================== forward
def embed_tokens(cfg: ArchConfig, params: Params, tokens: torch.Tensor | None,
                 input_embeds: torch.Tensor | None = None):
    """The model's input: the token embeddings, or when ``tokens`` is None
    a frontend stub's ``input_embeds`` [B, S, D] cast to the parameters'
    dtype; RG-LRU models scale either by sqrt(d_model), rounded to the
    activations' dtype first (the reference's ``jnp.asarray(d ** 0.5,
    x.dtype)``)."""
    if tokens is not None:
        x = embed(tokens, params["embed"])
    else:
        x = input_embeds.to(cfg.param_dtype)
    if cfg.recurrent != "rglru":
        return x
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    with unset_fake_temporarily():   # a constant: real even in the dry run
        scale = float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
    return x * scale


def kind_layers(cfg: ArchConfig):
    """(kind, index within that kind's stack) of each layer in order, for
    a hybrid's two stacks (recurrentgemma: rec 0, rec 1, attn 0, ...)."""
    index = {"attn": 0, "rec": 0}
    for kind in cfg.layer_kinds():
        yield kind, index[kind]
        index[kind] += 1


def deepseek_layers(cfg: ArchConfig, params: Params):
    """Each layer's parameters, in order, of a model with a dense-FFN
    prefix stack and a MoE stack (DeepSeek)."""
    fk = cfg.moe.first_k_dense
    for i in range(fk):
        yield layer_params(params["dense_layers"], i)
    for i in range(cfg.n_layers - fk):
        yield layer_params(params["moe_layers"], i)


def ffn(cfg: ArchConfig, lp: dict, x):
    """A layer's FFN on its normed input: the MoE layer's (y, aux loss), or
    the MLP's (y, None)."""
    if "moe" in lp:
        return moe_mod.moe_ffn(cfg, lp["moe"], x)
    return mlp(x, lp["mlp"], cfg.act), None


def _attn_block(cfg: ArchConfig, lp: dict, x, *, window: int, use_rope: bool = True,
                enc_out=None):
    """One attention layer (GQA, or MLA), with ``enc_out`` [B, T, D] its
    cross-attention over that encoder output, and its FFN: (x, aux loss
    or None)."""
    nf = lambda y, pp: norm(y, pp, cfg.norm, cfg.norm_eps)
    if cfg.mla is not None:
        x = settle(x + attn.mla_train(cfg, lp["attn"], nf(x, lp["ln1"])), x)
    else:
        x = settle(x + attn.gqa_train(cfg, lp["attn"], nf(x, lp["ln1"]), window=window,
                                      use_rope=use_rope), x)
    if enc_out is not None:
        x = settle(x + attn.gqa_train(cfg, lp["xattn"], nf(x, lp["lnx"]), use_rope=False,
                                      kv_source=enc_out), x)
    h, laux = ffn(cfg, lp, nf(x, lp["ln2"]))
    return settle(x + h, x), laux


def _rec_block(cfg: ArchConfig, lp: dict, x, state=None):
    """One recurrent layer (an RWKV6 block, or an RG-LRU block + MLP):
    steps from ``state`` (decode) or scans from zeros (prefill, forward).
    Returns (x, the layer's new state)."""
    nf = lambda y, pp: norm(y, pp, cfg.norm, cfg.norm_eps)
    if cfg.recurrent == "rwkv6":
        return rwkv_mod.rwkv_block(cfg, lp, x, state, nf)
    h, st = rglru_mod.rglru_block(cfg, lp["rec"], nf(x, lp["ln1"]), state)
    x = settle(x + h, x)
    x = settle(x + mlp(nf(x, lp["ln2"]), lp["mlp"], cfg.act), x)
    return x, st


def _layer(cfg: ArchConfig, block, *args, **kw):
    """One layer's body; recomputed in the backward pass (non-reentrant
    checkpoint: only its input is kept) when ``cfg.remat`` and grad mode is
    on, as the reference checkpoints its scanned bodies."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(block, cfg, *args, use_reentrant=False, **kw)
    return block(cfg, *args, **kw)


def _hybrid_forward(cfg: ArchConfig, params: Params, x):
    """Period-pattern dispatch (recurrentgemma: rec, rec, attn): layer i of
    each kind takes the next slice of that kind's stack."""
    for kind, i in kind_layers(cfg):
        if kind == "attn":
            x, _ = _layer(cfg, _attn_block, layer_params(params["attn_layers"], i), x,
                          window=cfg.local_window)
        else:
            x, _ = _layer(cfg, _rec_block, layer_params(params["rec_layers"], i), x)
    return x


def encode(cfg: ArchConfig, params: Params, enc_embeds: torch.Tensor):
    """The encoder of an encoder-decoder: ``enc_embeds`` [B, T, D] (the
    frontend stub's output) cast to the parameters' dtype, through the
    ``enc_layers`` stack (causal self-attention with RoPE, as the
    reference's), then ``enc_final_norm``."""
    e = enc_embeds.to(cfg.param_dtype)
    for i in range(cfg.n_enc_layers):
        e, _ = _layer(cfg, _attn_block, layer_params(params["enc_layers"], i), e,
                      window=0)
    return norm(e, params["enc_final_norm"], cfg.norm, cfg.norm_eps)


def dec_positions(params: Params, start, s: int):
    """Rows ``start`` .. ``start`` + s - 1 of the learned decoder positions
    ``dec_pos``, [1, s, D]; a 0-d tensor ``start`` (decode, s = 1) reads
    its row on the device, clamped to the table as the reference's
    dynamic_slice clamps."""
    table = params["dec_pos"]
    if torch.is_tensor(start):
        row = torch.clamp(start, 0, table.shape[0] - s).reshape(1).long()
        return table.index_select(0, row)[None]
    return table[start:start + s][None]


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor | None = None,
            input_embeds: torch.Tensor | None = None,
            enc_embeds: torch.Tensor | None = None, return_hidden: bool = False):
    """Full-sequence forward: tokens [B, S] (or, when None, a frontend
    stub's ``input_embeds`` [B, S, D]; an encoder-decoder also takes the
    encoder's ``enc_embeds`` [B, T, D]) -> (logits [B, S, V], aux loss[,
    the final-normed hidden state [B, S, D] with ``return_hidden``]). The
    aux loss is the MoE layers' load-balance loss summed (0 with
    DeepSeek-v3's aux-free bias, and in every other family). An
    encoder-decoder adds ``dec_pos`` to the decoder's input and runs its
    decoder without RoPE, each layer attending over the encoder's
    output."""
    require_in_slice(cfg)
    x = embed_tokens(cfg, params, tokens, input_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.is_encdec:
        e = encode(cfg, params, enc_embeds)
        x = x + dec_positions(params, 0, x.shape[1]).to(x.dtype)
        for i in range(cfg.n_layers):
            x, _ = _layer(cfg, _attn_block, layer_params(params["dec_layers"], i), x,
                          window=0, use_rope=False, enc_out=e)
    elif cfg.mla is not None:  # DeepSeek
        for lp in deepseek_layers(cfg, params):
            x, laux = _layer(cfg, _attn_block, lp, x, window=0)
            if laux is not None:
                aux = aux + laux
    elif cfg.recurrent == "rwkv6":
        for i in range(cfg.n_layers):
            x, _ = _layer(cfg, _rec_block, layer_params(params["layers"], i), x)
    elif cfg.pattern_period > 1:
        x = _hybrid_forward(cfg, params, x)
    else:
        for i in range(cfg.n_layers):
            x, _ = _layer(cfg, _attn_block, layer_params(params["layers"], i), x,
                          window=cfg.sliding_window)
    x = norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    logits = unembed(x, params.get("lm_head", params["embed"]),
                     tied="lm_head" not in params)
    if return_hidden:
        return logits, aux, x
    return logits, aux


# ============================================================= loss
def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy: fp32 log-softmax, the target's entry. On
    DTensors it is vocab-parallel (`_xent_placed`)."""
    from repro_torch.launch.placement import is_dtensor
    if is_dtensor(logits):
        return _xent_placed(logits, targets)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long())[..., 0]


class _VocabXent(torch.autograd.Function):
    """Cross-entropy over a vocab split across the ranks of ``groups``:
    logits [..., V_local] (vocab rows v0 ..), the max and the sum of
    exponentials all-reduced over the groups, the target's logit summed
    from its owner. The same formula as `_xent` in fp32; its gradient is
    (softmax - one-hot) on each rank's own columns."""

    @staticmethod
    def forward(ctx, logits, targets, v0, groups):
        import torch.distributed as dist
        lf = logits.float()
        m = lf.amax(-1)
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        e = torch.exp(lf - m[..., None])
        s = e.sum(-1)
        tl = (targets.long() - v0)
        mine = (tl >= 0) & (tl < lf.shape[-1])
        pick = torch.gather(lf, -1, tl.clamp(0, lf.shape[-1] - 1)[..., None])[..., 0]
        pick = torch.where(mine, pick, torch.zeros_like(pick))
        for g in groups:
            dist.all_reduce(s, group=g)
            dist.all_reduce(pick, group=g)
        ctx.save_for_backward(e, s, tl, mine)
        ctx.dtype = logits.dtype
        return m + torch.log(s) - pick

    @staticmethod
    def backward(ctx, g):
        e, s, tl, mine = ctx.saved_tensors
        grad = e / s[..., None]
        hot = torch.zeros_like(grad)
        hot.scatter_(-1, tl.clamp(0, grad.shape[-1] - 1)[..., None], mine[..., None].float())
        return ((grad - hot) * g[..., None]).to(ctx.dtype), None, None, None


def _xent_placed(logits, targets):
    """`_xent` on DTensors logits [B, S, V] and targets [B, S]: tokens keep
    their batch shards, the vocab its shards (`_VocabXent`), nothing of
    the logits gathered. Returns [B, S] placed as the targets."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.launch.placement import shard_span
    mesh = logits.device_mesh
    vdims = [i for i, p in enumerate(logits.placements)
             if isinstance(p, Shard) and p.dim == logits.ndim - 1]
    tt = tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0 and i not in vdims
               else Replicate() for i, p in enumerate(targets.placements))
    tl = tuple(Shard(logits.ndim - 1) if i in vdims else p for i, p in enumerate(tt))
    v0, _ = shard_span(logits.shape[-1], mesh, tl, logits.ndim - 1)
    groups = [mesh.get_group(i) for i in vdims]
    return local_map(lambda lg, tg: _VocabXent.apply(lg, tg, v0, groups),
                     out_placements=(tt,), in_placements=(tl, tt),
                     device_mesh=mesh, redistribute_inputs=True)(logits, targets)


def lm_loss(cfg: ArchConfig, params: Params, tokens: torch.Tensor | None,
            targets: torch.Tensor, input_embeds=None, enc_embeds=None,
            mtp_weight: float = 0.3):
    """Mean next-token cross-entropy over targets [B, S] -> (loss + coef *
    aux, (loss, aux)); with DeepSeek-v3's ``mtp`` block, plus ``mtp_weight``
    times the cross-entropy of its prediction of token t + 2 from [h_t ;
    emb(t + 1)] (targets rolled by one, sharing embedding and head); coef is
    the MoE's ``router_aux_coef`` (0 without MoE). ``tokens`` may be None
    with the frontend stubs' ``input_embeds`` in its place; an
    encoder-decoder takes ``enc_embeds`` (`forward`)."""
    logits, aux, h = forward(cfg, params, tokens, input_embeds=input_embeds,
                             enc_embeds=enc_embeds, return_hidden=True)
    loss = mean(_xent(logits, targets))
    if cfg.mtp_depth and "mtp" in params:
        mp = params["mtp"]
        emb_next = embed(targets, params["embed"])     # t+1 embeddings
        hn = norm(h, mp["norm"], cfg.norm, cfg.norm_eps)
        x_in = settle(torch.cat([hn, emb_next], dim=-1) @ mp["proj"], hn)
        x_mtp, _ = _attn_block(cfg, mp["layer"], x_in, window=0)
        logits_mtp = unembed(norm(x_mtp, params["final_norm"], cfg.norm, cfg.norm_eps),
                             params.get("lm_head", params["embed"]),
                             tied="lm_head" not in params)
        targets_mtp = torch.roll(targets, -1, dims=-1)
        loss = loss + mtp_weight * mean(_xent(logits_mtp, targets_mtp))
    if cfg.moe is None:      # no aux term (loss + 0 * 0 is loss)
        return loss, (loss, aux)
    return loss + cfg.moe.router_aux_coef * aux, (loss, aux)
