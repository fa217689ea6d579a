"""Paged decode attention on Hopper — wrapper of `csrc/paged_attention.cu`.

Replaces the TPU Pallas kernel `repro.kernels.paged_attention` in both of
its forms: fp32/bf16 pools, and int8 pools with per-page fp32 scales
(dequantized inside the kernel, fp32 math). See the source's note for
its design and what sets its time. Plain version:
`kernels.ref.paged_attention` / `paged_attention_quant`.

`paged_attention` launches the kernel on PyTorch's current stream for
CUDA tensors only and raises on anything it does not take; the dispatcher
`kernels.ops.paged_attention` sends CPU tensors to the plain version.
``paged_attention.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import refuse_grad

_KIND = {torch.float32: 0, torch.bfloat16: 1}
_INT8 = 2
_ERR_SHAPE = -1  # the C entry's code for a shape beyond the kernel's limits


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    fn = lib.xbof_paged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(q, k_pool, v_pool, page_table, lengths, k_scale, v_scale):
    quant = k_scale is not None or v_scale is not None
    tensors = [q, k_pool, v_pool, page_table, lengths]
    if quant:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 pools need both k_scale and v_scale")
        tensors += [k_scale, v_scale]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(
            f"paged_attention launches a CUDA kernel; got a tensor on {dev} "
            "(kernels.ops.paged_attention runs the plain version for CPU tensors)")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}; got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("paged_attention needs contiguous inputs")
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"need q [B, H, D] and pools [P, page, KV, D] of one shape; got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    b, h, d = q.shape
    p, page, kv, dk = k_pool.shape
    if dk != d or kv < 1 or h % kv != 0:
        raise ValueError(f"head_dim {d} vs {dk}, heads {h} vs kv heads {kv}")
    if (page_table.dtype != torch.int32 or page_table.dim() != 2
            or page_table.shape[0] != b):
        raise ValueError("page_table must be int32 [B, max_pages]")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise ValueError("lengths must be int32 [B]")
    if quant:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise ValueError("k_scale/v_scale come with int8 pools")
        if q.dtype != torch.float32:
            raise ValueError("the int8 form takes float32 q")
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or tuple(s.shape) != (p,):
                raise ValueError("scales must be float32 [P]")
        kind = _INT8
    else:
        if q.dtype not in _KIND or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
            raise ValueError(
                f"fp pools take float32 or bfloat16 q and pools of the same "
                f"dtype; got q {q.dtype}, pools {k_pool.dtype}/{v_pool.dtype}")
        kind = _KIND[q.dtype]
    if p < 1 or page_table.shape[1] < 1:
        raise ValueError("need at least one pool page and one table column")
    return kind


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    lengths: torch.Tensor, k_scale: torch.Tensor | None = None,
                    v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel. q [B, H, D] (fp32 or bf16; fp32 for int8
    pools); k_pool/v_pool [P, page, KV, D] of q's dtype, or int8 codes
    with k_scale/v_scale fp32 [P]; page_table int32 [B, max_pages] (-1 =
    hole); lengths int32 [B]. Returns [B, H, D] in q's dtype."""
    kind = _check(q, k_pool, v_pool, page_table, lengths, k_scale, v_scale)
    refuse_grad("paged_attention", q, k_pool, v_pool, k_scale, v_scale)
    b, h, d = q.shape
    p, page, kv, _ = k_pool.shape
    out = torch.empty_like(q)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().xbof_paged_attention(
        kind, q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, h, kv, d, p, page, page_table.shape[1], d ** -0.5, stream)
    if err == _ERR_SHAPE:
        raise ValueError(
            f"shape beyond the kernel's limits (csrc/paged_attention.cu): "
            f"group * head_dim = {(h // kv) * d}, page = {page}")
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {err}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
