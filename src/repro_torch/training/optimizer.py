"""AdamW with global-norm clipping.

Port of `repro.training.optimizer`: fp32 moments shaped like the
parameters, a linear warm-up of the learning rate, the bias corrections,
decoupled weight decay. The parameter update is computed in fp32 and cast
back to each parameter's dtype. Functional, as the reference: `update`
returns new tensors and leaves its arguments as they were.

XLA's arithmetic: the reference's compiled step computes ``step /
warmup`` as ``step * f32(1 / warmup)``; the port multiplies by the same
float32 reciprocal (`core.manager.recip32`). ``clip_norm / (gnorm +
1e-9)`` stays a true division (a tensor over a tensor: torch turns a
Python number over a tensor into a reciprocal times that number).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.manager import recip32
from . import tree as tr


class AdamWState(NamedTuple):
    step: torch.Tensor   # [] int32
    m: Any               # fp32, the parameters' tree
    v: Any               # fp32, the parameters' tree


def init(params) -> AdamWState:
    """Zero moments in fp32 on each parameter's device, step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tr.leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tr.tree_map(zeros, params), v=tr.tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves, in the reference's leaf order, of each
    leaf's fp32 sum of squares. On DTensor leaves each leaf's sum becomes
    a partial sum over the whole mesh, the partial sums add on each rank,
    and one all-reduce gives the total (another order than the
    reference's)."""
    leaves = tr.leaves(tree)
    from repro_torch.launch.placement import is_dtensor
    if leaves and is_dtensor(leaves[0]):
        return torch.sqrt(_placed_sum(
            [torch.sum(torch.square(x.to_local().float())) for x in leaves], leaves))
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def _placed_sum(local_sums, leaves):
    """The sum over a mesh of each DTensor leaf's local ``local_sums``,
    each leaf counted once: a rank adds a leaf's local sum only where its
    coordinate is 0 on every mesh dim that replicates the leaf, so the
    partial sums over the whole mesh add up to the total, which one
    all-reduce gives every rank (a replicated 0-d DTensor)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = leaves[0].device_mesh
    coord = mesh.get_coordinate()
    total = torch.zeros((), dtype=torch.float32, device=local_sums[0].device)
    for part, x in zip(local_sums, leaves):
        if all(c == 0 or type(p).__name__ == "Shard" for c, p in zip(coord, x.placements)):
            total = total + part
    return DTensor.from_local(total, mesh, [Partial()] * mesh.ndim).redistribute(
        mesh, [Replicate()] * mesh.ndim)


def update(params, grads, state: AdamWState, lr: float = 3e-4, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
           clip_norm: float = 1.0, warmup: int = 100):
    """One AdamW step -> (new params, new AdamWState, the gradients' global
    norm before clipping). Reads nothing back to the host."""
    gnorm = global_norm(grads)
    scale = torch.clamp(torch.full_like(gnorm, clip_norm) / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    stepf = step.float()
    lr_t = lr * torch.clamp(stepf * recip32(warmup), max=1.0)
    b1c = 1 - torch.pow(b1, stepf)   # fp32 powers, as the reference's
    b2c = 1 - torch.pow(b2, stepf)

    def upd(p, g, m, v):
        # the reference's operations in its order, each rounded to fp32;
        # the in-place ones write only temporaries made here, so a leaf
        # holds a few fp32 temporaries at a time
        g = g.float() * scale
        m = (b1 * m).add_((1 - b1) * g)
        v = (b2 * v).add_(((1 - b2) * g).mul_(g))
        del g
        denom = (v / b2c).sqrt_().add_(eps)
        delta = (m / b1c).div_(denom)
        del denom
        pf = p.float()
        delta.add_(weight_decay * pf)
        return torch.sub(pf, delta.mul_(lr_t)).to(p.dtype), m, v

    p_flat, treedef = tr.flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        p_flat, tr.leaves(grads), tr.leaves(state.m), tr.leaves(state.v))]
    new = [tr.unflatten(treedef, [o[i] for o in out]) for i in range(3)]
    return new[0], AdamWState(step, new[1], new[2]), gnorm
