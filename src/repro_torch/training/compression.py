"""Gradient compression with error feedback (off by default).

Port of `repro.training.compression`: each leaf is quantized to int8 in
blocks of 256 values with one fp32 scale a block (max |x| / 127, at least
1e-12), round half to even; the quantization residual is kept in an
error-feedback state and added to the next step's gradient. Nothing on
the training path calls it yet: it is the wire format of a cross-replica
reduce.

The reference runs it eagerly (its tests call it outside any jit), so
``/ 127.0`` and ``blocks / scale`` are true divisions there, and here:
the divisor 127 is a tensor on the leaf's device, since CUDA divides by a
Python number as a multiplication by its reciprocal.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from . import tree as tr

BLOCK = 256


class EFState(NamedTuple):
    residual: Any   # fp32, the gradients' tree


def init(grads_like: Any) -> EFState:
    return EFState(tr.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like))


def _pad_len(n: int) -> int:
    return (BLOCK - n % BLOCK) % BLOCK


def compress_leaf(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32/bf16 leaf -> (int8 codes [n_blocks, 256], fp32 scales [n_blocks])."""
    flat = g.float().reshape(-1)
    blocks = F.pad(flat, (0, _pad_len(flat.shape[0]))).reshape(-1, BLOCK)
    qmax = torch.full((), 127.0, dtype=torch.float32, device=blocks.device)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / qmax
    scale = torch.clamp(scale, min=1e-12)
    codes = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return codes, scale[:, 0]


def decompress_leaf(codes: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    blocks = codes.float() * scale[:, None]
    n = 1
    for d in shape:
        n *= d
    return blocks.reshape(-1)[:n].reshape(shape)


def compress(grads: Any, ef: EFState) -> tuple[Any, EFState]:
    """Apply error feedback, quantize, and record the new residual: (the
    tree of (codes, scales) pairs, the new EFState)."""
    g_flat, treedef = tr.flatten(grads)
    pairs, resid = [], []
    for g, r in zip(g_flat, tr.leaves(ef.residual)):
        target = g.float() + r
        codes, scale = compress_leaf(target)
        pairs.append((codes, scale))
        resid.append(target - decompress_leaf(codes, scale, g.shape))
    return tr.unflatten(treedef, pairs), EFState(tr.unflatten(treedef, resid))


def decompress(comp: Any, grads_like: Any) -> Any:
    """The fp32 gradients of a tree of (codes, scales) pairs."""
    g_flat, treedef = tr.flatten(grads_like)
    c_flat = tr.leaves(comp)   # each pair flattens to its codes, then its scales
    return tr.unflatten(treedef, [decompress_leaf(codes, scale, g.shape) for codes, scale, g
                                  in zip(c_flat[0::2], c_flat[1::2], g_flat)])
