"""Training step: microbatched gradient accumulation + AdamW.

Port of `repro.training.train_step`. The batch splits into ``n_micro``
microbatches along its first axis; each one's loss (`models.transformer.
lm_loss`) is differentiated with ``torch.autograd.grad`` and its gradients
are added, in order, into fp32 sums, so activation memory is one
microbatch deep (and each layer is recomputed in the backward pass under
``cfg.remat``). The sums are scaled by 1 / n_micro and handed to
`optimizer.update`. Nothing reads back to the host inside a step.

The parameter leaves are plain tensors, or DTensors on one mesh (the
mesh trainer: a state placed by `launch.sharding.state_specs` and
`place`, a batch by `batch_specs`), as the reference's step runs under
GSPMD. A step differentiates detached views of them
(``requires_grad_``), so the caller's tensors are left as they were. On
DTensors the step runs under DTensor's `implicit_replication` (the
models' positions, masks and constants are replicated); a batch
sharded along its rows is first regrouped by one all-to-all
(`_regroup`), so that each rank's i-th slice of its local rows is its
block of one process's microbatch i (slicing a batch-sharded dim would
gather the batch): the microbatches are the reference's, which a MoE
layer's aux loss and capacity, taken per microbatch, need; each
microbatch's gradients
are summed in the placements they come in (partial sums stay local) and
reduced to the parameters' placements once, after the last microbatch:
the gradient synchronization (an all-reduce over the data axes, a
reduce-scatter for an FSDP-sharded leaf). XLA's arithmetic: the
reference's compiled ``g / n_micro`` is ``g * f32(1 / n_micro)``
(`core.manager.recip32`).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.manager import recip32
from repro_torch.launch.placement import is_dtensor, sharding_dims
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
    p_flat, treedef = tr.flatten(state.params)
    if is_dtensor(p_flat[0]):
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            return _step(cfg, state, batch, n_micro, lr, p_flat, treedef)
    return _step(cfg, state, batch, n_micro, lr, p_flat, treedef)


def _regroup(x, n_micro: int):
    """A batch leaf whose rows are sharded over mesh dims, its rows moved
    by one all-to-all over those dims so that each rank's i-th slice of
    its local rows is its block of one process's microbatch i. The rows
    move in chunks of c = a rank's rows / n_micro: with the rows in
    n_blocks blocks, chunk u sits on block u // n_micro and goes to block
    u % n_blocks, as its slot u // n_blocks. Other leaves, one block or
    one microbatch: ``x`` itself."""
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import DTensor
    if n_micro == 1 or not _row_sharded(x):
        return x
    mesh = x.device_mesh
    dims = sharding_dims(x.placements, 0)
    n_blocks, me = 1, 0
    for i in dims:     # the block index: row-major over the mesh dims
        n_blocks, me = n_blocks * mesh.size(i), me * mesh.size(i) + mesh.get_coordinate()[i]
    if n_blocks == 1:
        return x
    names = tuple(mesh.mesh_dim_names[i] for i in dims)
    if len(names) == 1:
        group = mesh[names[0]].get_group()
    else:
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        with unset_fake_temporarily():   # the mesh's own index arithmetic
            group = mesh[names]._flatten().get_group()
    loc = x.to_local()
    c = loc.shape[0] // n_micro
    dest = lambda blk, j: (blk * n_micro + j) % n_blocks
    order = sorted(range(n_micro), key=lambda j: dest(me, j))
    send = torch.cat([loc[j * c:(j + 1) * c] for j in order])
    sends = [c * sum(dest(me, j) == r for j in range(n_micro)) for r in range(n_blocks)]
    recvs = [c * sum(dest(r, j) == me for j in range(n_micro)) for r in range(n_blocks)]
    got = fc.wait_tensor(fc.all_to_all_single(send, recvs, sends, group))
    return DTensor.from_local(got, mesh, x.placements, shape=x.shape, stride=x.stride())


def _row_sharded(x) -> bool:
    return is_dtensor(x) and bool(sharding_dims(x.placements, 0))


def _micro(x, i: int, n_micro: int):
    """Microbatch ``i`` of ``n_micro`` of one batch leaf: its rows, or on
    a DTensor sharded along them (after `_regroup`), the i-th slice of
    each rank's local rows."""
    if _row_sharded(x):
        from torch.distributed.tensor import DTensor
        loc = x.to_local()
        mb = loc.shape[0] // n_micro
        return DTensor.from_local(loc[i * mb:(i + 1) * mb], x.device_mesh, x.placements)
    mb = x.shape[0] // n_micro
    return x[i * mb:(i + 1) * mb]


def _rows(x) -> int:
    if _row_sharded(x):
        return x.to_local().shape[0]
    return x.shape[0]


def _step(cfg, state, batch, n_micro, lr, p_flat, treedef):
    b = _rows(batch["targets"])
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    batch = {k: _regroup(v, n_micro) for k, v in batch.items() if v is not None}
    leaves = [p.detach().requires_grad_() for p in p_flat]
    params = tr.unflatten(treedef, leaves)
    g_sum = None
    loss_sum = torch.zeros((), dtype=torch.float32, device=p_flat[0].device)
    for i in range(n_micro):
        micro = {k: _micro(v, i, n_micro) for k, v in batch.items()}
        loss, _ = T.lm_loss(cfg, params, micro.get("tokens"), micro["targets"],
                            input_embeds=micro.get("input_embeds"),
                            enc_embeds=micro.get("enc_embeds"))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        if g_sum is None:
            g_sum = [g.float() for g in grads]
        else:
            for j, g in enumerate(grads):
                g_sum[j] = _accumulate(g_sum[j], g, p_flat[j])
        loss_sum = loss_sum + loss.detach()
        del loss, grads
    inv = recip32(n_micro)
    for j, (g, p) in enumerate(zip(g_sum, p_flat)):
        if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        g_sum[j] = g.mul_(inv)
    new_params, opt_state, gnorm = opt.update(state.params, tr.unflatten(treedef, g_sum),
                                              state.opt, lr=lr)
    metrics = {"loss": loss_sum * inv, "grad_norm": gnorm}
    if is_dtensor(gnorm):
        metrics = {k: v.full_tensor() if is_dtensor(v) else v for k, v in metrics.items()}
    return TrainState(new_params, opt_state), metrics


def _accumulate(acc, g, p):
    """acc + g in place; DTensors whose placements differ are both reduced
    to the parameter's ``p`` first."""
    if is_dtensor(g) and tuple(g.placements) != tuple(acc.placements):
        mesh, pl = p.device_mesh, tuple(p.placements)
        if tuple(acc.placements) != pl:
            acc = acc.redistribute(mesh, pl)
        g = g.redistribute(mesh, pl)
    return acc.add_(g)
