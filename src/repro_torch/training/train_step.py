"""Training step: microbatched gradient accumulation + AdamW.

Port of `repro.training.train_step`. The batch splits into ``n_micro``
microbatches along its first axis; each one's loss (`models.transformer.
lm_loss`) is differentiated with ``torch.autograd.grad`` and its gradients
are added, in order, into fp32 sums, so activation memory is one
microbatch deep (and each layer is recomputed in the backward pass under
``cfg.remat``). The sums are scaled by 1 / n_micro and handed to
`optimizer.update`. Nothing reads back to the host inside a step.

The parameter leaves are plain tensors: a step differentiates detached
views of them (``requires_grad_``), so the caller's tensors are left as
they were. XLA's arithmetic: the reference's compiled ``g / n_micro``
is ``g * f32(1 / n_micro)`` (`core.manager.recip32`).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.manager import recip32
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from . import optimizer as opt
from . import tree as tr


class TrainState(NamedTuple):
    params: Any
    opt: opt.AdamWState


def init_state(cfg: ArchConfig, params) -> TrainState:
    """The state that starts from ``params`` (`transformer.init_params`,
    or the reference's weights through `params_from_numpy`): zero moments,
    step 0."""
    return TrainState(params, opt.init(params))


def abstract_state(cfg: ArchConfig) -> TrainState:
    """The state's shapes and dtypes on the meta device, nothing allocated
    (the reference's ``jax.eval_shape`` of `init_state`)."""
    return init_state(cfg, T.abstract_params(cfg))


def train_state_from_numpy(cfg: ArchConfig, tree, device=None) -> TrainState:
    """The reference's TrainState as numpy arrays (``jax.tree.map(
    np.asarray, state)``: params, then the optimizer's step, m and v) ->
    the port's TrainState on ``device`` (CUDA when None), same trees and
    dtypes."""
    params, (step, m, v) = tree
    dev = resolve_device(device)
    conv = lambda t: T.params_from_numpy(cfg, t, dev)
    step = torch.from_numpy(np.array(step, dtype=np.int32)).to(dev)
    return TrainState(conv(params), opt.AdamWState(step, conv(m), conv(v)))


def train_step(cfg: ArchConfig, state: TrainState, batch: dict, n_micro: int = 1,
               lr: float = 3e-4) -> tuple[TrainState, dict]:
    """batch: {"tokens": [B, S], "targets": [B, S]} (int32, on the state's
    device), B a multiple of ``n_micro`` -> (the new TrainState, {"loss":
    the objective's mean over microbatches, "grad_norm": the global norm
    of the averaged gradients before clipping}, both 0-d fp32 tensors)."""
    b = batch["targets"].shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    p_flat, treedef = tr.flatten(state.params)
    leaves = [p.detach().requires_grad_() for p in p_flat]
    params = tr.unflatten(treedef, leaves)
    mb = b // n_micro
    g_sum = None
    loss_sum = torch.zeros((), dtype=torch.float32, device=p_flat[0].device)
    for i in range(n_micro):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items() if v is not None}
        loss, _ = T.lm_loss(cfg, params, micro.get("tokens"), micro["targets"],
                            input_embeds=micro.get("input_embeds"),
                            enc_embeds=micro.get("enc_embeds"))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        if g_sum is None:
            g_sum = [g.float() for g in grads]
        else:
            for acc, g in zip(g_sum, grads):
                acc.add_(g)
        loss_sum = loss_sum + loss.detach()
        del loss, grads
    inv = recip32(n_micro)
    for g in g_sum:
        g.mul_(inv)
    new_params, opt_state, gnorm = opt.update(state.params, tr.unflatten(treedef, g_sum),
                                              state.opt, lr=lr)
    return TrainState(new_params, opt_state), {"loss": loss_sum * inv, "grad_norm": gnorm}
