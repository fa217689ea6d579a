"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Port of `repro.models.rglru`. Block = input/gate projections + short
temporal conv + RG-LRU recurrence:
    a_t = sigmoid(Λ)^(c * sigmoid(r_t))        (recurrence gate)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)
A full sequence goes through `kernels.ops.rglru` (the CUDA scan kernel
for CUDA tensors, the plain version for CPU tensors); decode takes the
single-step form, the plain version on every device as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from .config import ArchConfig

_C = 8.0  # Griffin's recurrence sharpness constant


class RGLRUState(NamedTuple):
    h: torch.Tensor       # [B, W] recurrent state
    conv: torch.Tensor    # [B, conv_width-1, W] temporal-conv tail


def _conv1d(x: torch.Tensor, w: torch.Tensor, tail: torch.Tensor | None):
    """Causal depthwise temporal conv; x: [B, T, W], w: [cw, W]. Returns
    (out [B, T, W], the last cw - 1 rows of the padded input)."""
    cw = w.shape[0]
    pad = (torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device) if tail is None else tail)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(cw))
    new_tail = xp[:, -(cw - 1):] if cw > 1 else None
    return out, new_tail


def rglru_block(cfg: ArchConfig, p: dict, x: torch.Tensor,
                state: RGLRUState | None):
    """x: [B, T, D] -> ([B, T, D], new state). With ``state`` (decode, T =
    1) the recurrence takes one step from it; without, it scans the whole
    sequence from zeros. The new state (h_T and the conv tail) is what a
    prefill or a decode step leaves in the cache."""
    gx = x @ p["w_in_gate"]           # [B, T, W] multiplicative branch
    rx = x @ p["w_in"]                # [B, T, W] recurrent branch
    rx, new_tail = _conv1d(rx, p["conv_w"], state.conv if state is not None else None)

    r_gate = torch.sigmoid(rx @ p["w_rg"] + p["b_rg"])   # [B, T, W]
    i_gate = torch.sigmoid(rx @ p["w_ig"] + p["b_ig"])
    log_a = -_C * r_gate * F.softplus(p["lambda_p"])    # log sigmoid(Λ)^(c·r)
    # rounded to x's dtype before the scan, as the reference does: in bf16
    # an a close to 1 becomes 1 and shuts its input off
    a = torch.exp(log_a.float()).to(x.dtype)
    gated_x = i_gate * rx

    if state is None:
        h, h_last = kops.rglru(gated_x, a)
    else:
        h_last = kops.rglru_step(state.h, gated_x[:, 0], a[:, 0])
        h = h_last[:, None, :]

    # jax.nn.gelu is the tanh approximation by default
    out = (h * F.gelu(gx, approximate="tanh")) @ p["w_out"]
    return out, RGLRUState(h_last, new_tail)
