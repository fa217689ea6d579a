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

Given a ``stats`` tensor, fp32 [2, B, H, S], the kernel also stores each
row's softmax statistics there: m, the max of its masked scaled scores,
and l, the sum of exp(score - m), in natural units (a row with no valid
key: m = NEG_INF, l = T). Plain version: `kernels.ref.attention_stats`.

Its gradient: `FlashAttention`, a ``torch.autograd.Function`` whose
forward launches the kernel above, with a statistics tensor when an
input needs a gradient (serving passes none), and saves q, k, v, its
output and the statistics; its backward launches `flash_attention_bwd`,
the wrapper of `csrc/flash_attention_bwd.cu` (no TPU kernel behind it:
the reference's gradient is XLA's autodiff of its jnp oracle), which
takes those statistics instead of recomputing them. bf16 runs on the
tensor cores (wgmma and TMA: a pass for delta and log-sum-exp, then one
kernel for dq and one for dk and dv, two at head dim 256, and, where few
KV heads leave SMs idle, each dk / dv walk cut into `bwd_split` runs
whose fp32 sums one more kernel adds in order; no atomics, so a call
repeats bit for bit), with the softmax weights P and dS rounded to bf16
before the three products (`bwd_operands`); fp32 runs on the CUDA cores
(dq, then dk and dv) with P and dS in fp32. Plain version:
`kernels.ref.attention_bwd`. ``flash_attention_bwd.launches`` counts its
calls and ``flash_attention_bwd.launches_by_shape`` the same calls by
shape; `bwd_kernels_per_call` says how many CUDA kernels a call is.
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
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    fn = lib.xbof_flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
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


def _check_stats(stats, q) -> None:
    b, s, h, _ = q.shape
    if (not torch.is_tensor(stats) or stats.device != q.device
            or stats.dtype != torch.float32 or tuple(stats.shape) != (2, b, h, s)):
        raise ValueError(
            f"stats must be float32 [2, B, H, S] = [2, {b}, {h}, {s}] on {q.device}; got "
            + (f"{stats.dtype} {tuple(stats.shape)} on {stats.device}"
               if torch.is_tensor(stats) else type(stats).__name__))
    if not stats.is_contiguous():
        raise ValueError("stats must be contiguous")


def bwd_operands(dtype: torch.dtype) -> str:
    """The precision in which the backward kernels feed P and dS to their
    three products: "bf16" on the tensor cores (bf16 inputs: both rounded
    to bf16 in registers, as the forward rounds P), "fp32" on the CUDA
    cores (fp32 inputs). `chip_smoke.bwd_given_o` takes it."""
    return "bf16" if dtype == torch.bfloat16 else "fp32"


# dk / dv blocks wanted per SM before a bf16 walk is cut (`bwd_split`)
_SPLIT_BLOCKS_PER_SM = 2
_MAX_SPLIT = 16


def bwd_split(dtype: torch.dtype, b: int, t: int, kv: int, sms: int) -> int:
    """The runs each bf16 dk / dv walk (a block per 128 keys, KV head and
    batch) is cut into: enough blocks for _SPLIT_BLOCKS_PER_SM on each of
    ``sms`` SMs, at most _MAX_SPLIT; 1 (no cut) for fp32. h2o-danube's
    training attention (8 KV heads, T = 8192) takes 1, qwen2-vl-2b's (2,
    4096) 5 and recurrentgemma-9b's (1, 4096) 9 on an H100's 132 SMs."""
    if dtype != torch.bfloat16:
        return 1
    blocks = -(-t // 128) * kv * b
    return max(1, min(_MAX_SPLIT, -(-_SPLIT_BLOCKS_PER_SM * sms // blocks)))


def bwd_kernels_per_call(dtype: torch.dtype, head_dim: int, n_split: int) -> int:
    """CUDA kernels one `flash_attention_bwd` call launches. bf16: the delta
    pass, dq, dk and dv (two walks above head dim 128) and, for n_split >
    1, the sum of the runs; fp32: dq, then dk and dv."""
    if dtype != torch.bfloat16:
        return 2
    return 2 + (2 if head_dim > 128 else 1) + (n_split > 1)


def bwd_workspace_floats(b: int, s: int, t: int, h: int, kv: int, d: int,
                         n_split: int) -> int:
    """fp32 floats of `flash_attention_bwd`'s scratch: delta and the base-2
    log-sum-exp of each row, S rounded up to 128 (the fp32 kernels use B *
    H * S of it), then the split runs' fp32 sums of dk and dv when each
    walk is cut into ``n_split`` > 1 runs (`bwd_split`). The dry run's
    fake entry counts the same bytes."""
    return (2 * b * h * (-(-s // 128) * 128)
            + (2 * n_split * b * t * kv * d if n_split > 1 else 0))


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _count(wrapper, q, k, causal, window) -> None:
    """One more launch of ``wrapper``, in all and at its shape."""
    wrapper.launches += 1
    key = (tuple(q.shape), tuple(k.shape), bool(causal), int(window))
    wrapper.launches_by_shape[key] = wrapper.launches_by_shape.get(key, 0) + 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None,
                    stats: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel. q [B, S, H, D], k and v [B, T, KV, D], all
    float32 or all bfloat16; H a multiple of KV. ``scale`` defaults to
    D ** -0.5. Returns [B, S, H, D] in q's dtype; with ``stats`` (float32
    [2, B, H, S], contiguous) the kernel also writes each row's m and l
    there. Raises under grad mode when an input needs a gradient:
    `FlashAttention` carries one."""
    _check(q, k, v, causal, window)
    refuse_grad("flash_attention (use FlashAttention)", q, k, v)
    if stats is not None:
        _check_stats(stats, q)
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    scale = d ** -0.5 if scale is None else scale
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().xbof_flash_attention(
        _KIND[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if stats is None else stats.data_ptr(),
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
                        o: torch.Tensor, stats: torch.Tensor, dout: torch.Tensor,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None):
    """Launch the backward kernels: the gradients (dq, dk, dv) of
    `flash_attention`'s output ``o`` = attention(q, k, v) under the
    cotangent ``dout``, in q's dtype, summed in fp32, given the forward's
    softmax statistics ``stats`` (float32 [2, B, H, S], as
    `flash_attention(..., stats=)` writes them). q, o and dout [B, S, H,
    D], k and v [B, T, KV, D], all contiguous, all float32 or all
    bfloat16; D a multiple of 8 up to 256; bf16 dout, like q, k and v,
    starting on 16 bytes. Deterministic: a repeated call gives the same
    bits."""
    _check(q, k, v, causal, window)
    refuse_grad("flash_attention_bwd (no double backward)", q, k, v, o, dout)
    _check_stats(stats, q)
    for name, t in (("o", o), ("dout", dout)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name} must match q ({tuple(q.shape)}, {q.dtype}, "
                             f"{q.device}); got {tuple(t.shape)}, {t.dtype}, {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd needs a contiguous {name}")
    if q.dtype == torch.bfloat16 and dout.data_ptr() % 16:
        raise ValueError(f"bf16 dout must start on 16 bytes (TMA); got address "
                         f"{dout.data_ptr():#x}")
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b == 0 or s == 0:
        return dq, dk.zero_(), dv.zero_()
    n_split = bwd_split(q.dtype, b, t, kv, _sms(q.device))
    work = torch.empty(bwd_workspace_floats(b, s, t, h, kv, d, n_split),
                       dtype=torch.float32, device=q.device)
    scale = d ** -0.5 if scale is None else scale
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd_lib().xbof_flash_attention_bwd(
        _KIND[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        stats.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        work.data_ptr(), b, s, t, h, kv, d, int(causal), window, n_split, scale, stream)
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
    """Attention with a gradient: the forward kernel, storing the softmax
    statistics when q, k or v needs a gradient (nothing else changes for
    a forward that needs none, as in serving), then the backward kernels
    on those statistics and ``dout.contiguous()`` (the forward's rule
    against copies is about q, k and v; an incoming cotangent may be a
    view)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        stats = None
        if any(ctx.needs_input_grad[:3]):
            b, s, h, _ = q.shape
            stats = torch.empty((2, b, h, s), dtype=torch.float32, device=q.device)
        o = flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                            stats=stats)
        ctx.save_for_backward(q, k, v, o, stats)
        ctx.mask = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, stats = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, o, stats, dout.contiguous(),
                                         causal=causal, window=window, scale=scale)
        return dq, dk, dv, None, None, None
