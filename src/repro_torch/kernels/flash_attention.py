"""Prefill flash attention on Hopper — wrapper of `csrc/flash_attention.cu`.

Replaces the TPU Pallas kernel `repro.kernels.flash_attention`: tiled
online-softmax grouped-query attention, causal or not, with an optional
sliding window, queries offset by T - S. At the model zoo's prefill shapes
it is bound by tensor-core flops. bf16 runs FlashAttention-3's forward
pass: a producer warpgroup streams Q, K and V into shared memory with TMA,
two consumer warpgroups run both products on `wgmma`; TMA needs q, k and v
to start on 16 bytes. fp32 runs on the CUDA cores. See the source's note
for the design. Plain version: `kernels.ref.attention`.

`flash_attention` launches the kernel on PyTorch's current stream for CUDA
tensors only and raises on anything it does not take; the dispatcher
`kernels.ops.attention` sends CPU tensors to the plain version.
``flash_attention.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import check_mask_args

_KIND = {torch.float32: 0, torch.bfloat16: 1}
_ERR_SHAPE = -1  # the C entry's code for a shape beyond the kernel's limits


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.xbof_flash_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, causal, window):
    check_mask_args(causal, window)
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention launches a CUDA kernel; got a tensor on {q.device} "
            "(kernels.ops.attention runs the plain version for CPU tensors)")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}; got one on {t.device}")
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("flash_attention needs contiguous inputs")
    if q.dtype not in _KIND or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention takes float32 or bfloat16 q, k and v of one "
            f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"need q [B, S, H, D] and k, v [B, T, KV, D] of one shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    kb, _, kv, dk = k.shape
    if kb != b or dk != d or kv < 1 or h % kv != 0:
        raise ValueError(f"batch {b} vs {kb}, head_dim {d} vs {dk}, heads {h} "
                         f"vs kv heads {kv}")
    if window < 0:
        raise ValueError(f"window must be >= 0; got {window}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(
                    f"bf16 {name} must start on 16 bytes (TMA); got address "
                    f"{t.data_ptr():#x} (a view with a storage offset?)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel. q [B, S, H, D], k and v [B, T, KV, D], all
    float32 or all bfloat16; H a multiple of KV. ``scale`` defaults to
    D ** -0.5. Returns [B, S, H, D] in q's dtype."""
    _check(q, k, v, causal, window)
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    scale = d ** -0.5 if scale is None else scale
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().xbof_flash_attention(
        _KIND[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, t, h, kv, d, int(causal), window, scale, stream)
    if err == _ERR_SHAPE:
        raise ValueError(
            f"shape beyond the kernel's limits (csrc/flash_attention.cu): "
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, window {window}")
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
