"""Holistic load balance (paper §4.4).

Port of `repro.core.loadbalance`. The host driver redirects commands from
a borrower queue to a lender shadow queue with

    N_borrow / N_lend = (U_lend / U_borrow)
                      * (sum_W_lend / W_shadowSQ)
                      * (W_borrowSQ / sum_W_borrow)

so  p_redirect = N_lend / (N_lend + N_borrow) = 1 / (1 + ratio).

Every function broadcasts over leading axes and computes in float32, as
the reference does (its scalar weights are float32 arrays there too).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device

_EPS = 1e-6


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


def borrow_lend_ratio(u_borrow, u_lend, w_borrow_sq=1.0, w_shadow_sq=1.0,
                      sum_w_borrow=1.0, sum_w_lend=1.0) -> torch.Tensor:
    """N_borrow / N_lend per the paper's formula (clipped for stability)."""
    u_borrow = torch.clamp(u_borrow.to(torch.float32), min=_EPS)
    u_lend = torch.clamp(u_lend.to(torch.float32), min=_EPS)
    like = u_borrow
    ratio = (
        (u_lend / u_borrow)
        * (_f32(sum_w_lend, like) / torch.clamp(_f32(w_shadow_sq, like), min=_EPS))
        * (_f32(w_borrow_sq, like) / torch.clamp(_f32(sum_w_borrow, like), min=_EPS))
    )
    return torch.clamp(ratio, _EPS, 1e6)


def redirect_probability(u_borrow, u_lend, w_borrow_sq=1.0, w_shadow_sq=1.0,
                         sum_w_borrow=1.0, sum_w_lend=1.0) -> torch.Tensor:
    """P(redirect a borrower command to the lender shadow queue).
    Paper example: N_borrow/N_lend == 3  ->  p == 0.25."""
    ratio = borrow_lend_ratio(u_borrow, u_lend, w_borrow_sq, w_shadow_sq,
                              sum_w_borrow, sum_w_lend)
    return 1.0 / (1.0 + ratio)


def split_commands(n_commands: torch.Tensor, u_borrow: torch.Tensor,
                   u_lends: torch.Tensor, lender_mask: torch.Tensor,
                   **weights):
    """Split each borrower's command count across itself and its lenders.

    Batched over borrowers: ``n_commands`` int[..., B], ``u_borrow``
    float[..., B], ``u_lends`` float[..., N] (every node's utilization),
    ``lender_mask`` bool[..., B, N] (which nodes lend to each borrower);
    leading axes are independent pools (the hierarchical engine's shards).
    Returns (n_kept int32[..., B], n_sent int32[..., B, N]). Shares are
    proportional to each lender's redirect probability, capped at 0.95 in
    total so the borrower is never starved; the count is conserved exactly
    (floors go to the lenders, the remainder stays local). The reference's
    one-borrower call is the B=1 row.
    """
    p = redirect_probability(u_borrow[..., :, None], u_lends[..., None, :],
                             **weights)
    p = torch.where(lender_mask, p, 0.0)
    p_sum = p.sum(dim=-1)
    total_p = torch.clamp(p_sum, max=0.95)
    scale = torch.where(p_sum > 0, total_p / torch.clamp(p_sum, min=_EPS), 0.0)
    n_sent = torch.floor(n_commands[..., None] * p * scale[..., None]).to(torch.int32)
    n_kept = (n_commands - n_sent.sum(dim=-1)).to(torch.int32)
    return n_kept, n_sent


def wrr_weights(n_queues: int, shadow_weight: float = 1.0,
                normal_weight: float = 4.0, *, device=None) -> torch.Tensor:
    """NVMe weighted-round-robin defaults: shadow SQs get low weight so
    lending minimally perturbs the lender's own I/O (paper §4.4)."""
    w = torch.full((n_queues,), normal_weight, dtype=torch.float32,
                   device=resolve_device(device))
    w[-1] = shadow_weight
    return w
