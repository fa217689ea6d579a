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
``flash_attention.launches`` counts launches, and
``flash_attention.launches_by_shape`` the same launches by (q's shape,
k's shape, causal, window).

Its gradient: `FlashAttention`, a ``torch.autograd.Function`` whose
forward launches the kernel above unchanged (and saves q, k, v and its
output) and whose backward launches `flash_attention_bwd`, the wrapper of
`csrc/flash_attention_bwd.cu` (no TPU kernel behind it: the reference's
gradient is XLA's autodiff of its jnp oracle). Plain version:
`kernels.ref.attention_bwd`. ``flash_attention_bwd.launches`` counts its
calls, each two CUDA kernels (statistics and dq, then dk and dv), and
``flash_attention_bwd.launches_by_shape`` the same calls by shape.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import check_mask_args, refuse_grad

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


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    fn = lib.xbof_flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
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


def _count(wrapper, q, k, causal, window) -> None:
    """One more launch of ``wrapper``, in all and at its shape."""
    wrapper.launches += 1
    key = (tuple(q.shape), tuple(k.shape), bool(causal), int(window))
    wrapper.launches_by_shape[key] = wrapper.launches_by_shape.get(key, 0) + 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel. q [B, S, H, D], k and v [B, T, KV, D], all
    float32 or all bfloat16; H a multiple of KV. ``scale`` defaults to
    D ** -0.5. Returns [B, S, H, D] in q's dtype. Raises under grad mode
    when an input needs a gradient: `FlashAttention` carries one."""
    _check(q, k, v, causal, window)
    refuse_grad("flash_attention (use FlashAttention)", q, k, v)
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
    _count(flash_attention, q, k, causal, window)
    return out


flash_attention.launches = 0
flash_attention.launches_by_shape = {}


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, dout: torch.Tensor, causal: bool = True,
                        window: int = 0, scale: float | None = None):
    """Launch the backward kernel: the gradients (dq, dk, dv) of
    `flash_attention`'s output ``o`` = attention(q, k, v) under the
    cotangent ``dout``, in q's dtype, summed in fp32. q, o and dout [B, S,
    H, D], k and v [B, T, KV, D], all contiguous, all float32 or all
    bfloat16; D a multiple of 8 up to 256. Deterministic: a repeated call
    gives the same bits."""
    _check(q, k, v, causal, window)
    refuse_grad("flash_attention_bwd (no double backward)", q, k, v, o, dout)
    for name, t in (("o", o), ("dout", dout)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name} must match q ({tuple(q.shape)}, {q.dtype}, "
                             f"{q.device}); got {tuple(t.shape)}, {t.dtype}, {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd needs a contiguous {name}")
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b == 0 or s == 0:
        return dq, dk.zero_(), dv.zero_()
    stats = torch.empty((3, b, h, s), dtype=torch.float32, device=q.device)
    scale = d ** -0.5 if scale is None else scale
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_lib().xbof_flash_attention_bwd(
        _KIND[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        stats.data_ptr(), b, s, t, h, kv, d, int(causal), window, scale, stream)
    if err == _ERR_SHAPE:
        raise ValueError(
            f"shape beyond the backward kernel's limits (csrc/flash_attention_bwd.cu): "
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, window {window}")
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {err}")
    _count(flash_attention_bwd, q, k, causal, window)
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_shape = {}


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: the forward kernel, then the backward
    kernel on ``dout.contiguous()`` (the forward's rule against copies is
    about q, k and v; an incoming cotangent may be a view)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o = flash_attention(q, k, v, causal=causal, window=window, scale=scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.mask = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, o, dout.contiguous(), causal=causal,
                                         window=window, scale=scale)
        return dq, dk, dv, None, None, None
