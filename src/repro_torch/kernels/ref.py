"""Plain PyTorch versions of the port's kernels — the semantics contract.

Port of the paged-attention part of `repro.kernels.ref`. The CPU path runs
these; on the GPU `chip_smoke.py` and the CUDA tests hold each kernel
against them on the same inputs. The remaining oracles (flash attention,
MoE router, RG-LRU, RWKV6, FTL lookup) come with the slices whose kernels
need them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _gather(page_table: torch.Tensor, lengths: torch.Tensor, n_pages: int,
            page: int):
    """Clipped page ids [B, mp] and the token validity mask [B, mp*page]:
    a slot is valid when it lies below the sequence length and its page
    is mapped. Holes (-1) clip to page 0 and mask out."""
    mp = page_table.shape[1]
    safe = page_table.long().clamp(0, n_pages - 1)
    pos = torch.arange(mp * page, device=page_table.device)[None, :]
    valid = (pos < lengths[:, None]) & (
        page_table >= 0).repeat_interleave(page, dim=1)
    return safe, valid


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention over a paged KV cache.

    q [B, H, Dh] (one decode token per sequence); k_pool/v_pool [P, page,
    KV, Dh]; page_table [B, max_pages] int32 physical page ids (-1 = hole);
    lengths [B] int32. Grouped-query attention (group = H / KV), scale
    Dh^-0.5, masked scores at the finite NEG_INF — so a row with no valid
    slot averages V over every gathered row, as the reference does.
    Returns [B, H, Dh] in q's dtype.
    """
    b, h, dh = q.shape
    p, page, kv, _ = k_pool.shape
    mp = page_table.shape[1]
    group = h // kv
    safe, valid = _gather(page_table, lengths, p, page)
    kg = k_pool[safe].reshape(b, mp * page, kv, dh)
    vg = v_pool[safe].reshape(b, mp * page, kv, dh)
    qg = q.reshape(b, kv, group, dh)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, kg) * dh ** -0.5
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", w, vg)
    return out.reshape(b, h, dh)


def dequantize_pages(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 page codes [P, page, KV, Dh] + per-page fp32 scales [P] ->
    fp32 values (the read-side inverse of kv_pool's quantize-on-write)."""
    return codes.float() * scale[:, None, None, None]


def paged_attention_quant(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, page_table: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """`paged_attention` over an int8 pool ([P, page, KV, Dh] codes with
    per-page fp32 scales [P]). The scales fold into the scores (K) and the
    softmax weights (V); the math is fp32 end to end. Returns q's dtype."""
    b, h, dh = q.shape
    p, page, kv, _ = k_pool.shape
    mp = page_table.shape[1]
    group = h // kv
    safe, valid = _gather(page_table, lengths, p, page)
    kg = k_pool[safe].reshape(b, mp * page, kv, dh)
    vg = v_pool[safe].reshape(b, mp * page, kv, dh)
    ks = k_scale[safe].repeat_interleave(page, dim=1)    # [B, mp*page]
    vs = v_scale[safe].repeat_interleave(page, dim=1)
    qg = q.reshape(b, kv, group, dh).float()
    scores = torch.einsum("bkgd,btkd->bkgt", qg, kg.float())
    scores = scores * (ks[:, None, None, :] * dh ** -0.5)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", w * vs[:, None, None, :],
                       vg.float())
    return out.reshape(b, h, dh).to(q.dtype)
