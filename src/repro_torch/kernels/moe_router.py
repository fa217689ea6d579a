"""MoE top-k router on Hopper — wrapper of `csrc/moe_router.cu`.

Replaces the TPU Pallas kernel `repro.kernels.moe_router.topk_router`:
per token row the k experts with the largest ``scores + bias``, ties to
the lowest index, weighted by their UNBIASED scores over max(sum, 1e-9).
One warp per row; latency, not bytes, sets its time (see the source's
note). Plain version: `kernels.ref.topk_router`.

`topk_router` launches the kernel on PyTorch's current stream for CUDA
tensors only and raises on anything it does not take; the dispatcher
`kernels.ops.topk_router` sends CPU tensors to the plain version. It reads
nothing back to the host. ``topk_router.launches`` counts launches.

Its gradient: `TopKRouter`, a ``torch.autograd.Function`` whose forward
launches the kernel above unchanged (and saves the scores and the
kernel's indices) and whose backward launches `topk_router_bwd`, the
wrapper of `csrc/moe_router_bwd.cu` (no TPU kernel behind it: the
reference's gradient is XLA's autodiff of its jnp oracle): the weights'
gradient scattered into the picked experts' scores. The indices have no
gradient and the bias, which only selects, gets none, as on the plain
path. Plain version: `kernels.ref.topk_router_bwd`.
``topk_router_bwd.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import refuse_grad

_ERR_SHAPE = -1  # the C entry's code for a shape beyond the kernel's limits


def _lib() -> ctypes.CDLL:
    lib = _build.load("moe_router")
    fn = lib.xbof_topk_router
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("moe_router_bwd")
    fn = lib.xbof_topk_router_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(scores, bias):
    if scores.device.type != "cuda":
        raise ValueError(
            f"topk_router launches a CUDA kernel; got a tensor on {scores.device} "
            "(kernels.ops.topk_router runs the plain version for CPU tensors)")
    if scores.dtype != torch.float32 or scores.dim() != 2:
        raise ValueError(f"need scores [T, E] float32; got {tuple(scores.shape)} "
                         f"{scores.dtype}")
    if bias is not None:
        if bias.device != scores.device:
            raise ValueError(f"bias must be on {scores.device}; got {bias.device}")
        if bias.dtype != torch.float32 or tuple(bias.shape) != (scores.shape[1],):
            raise ValueError(f"need bias [E] = [{scores.shape[1]}] float32; got "
                             f"{tuple(bias.shape)} {bias.dtype}")
    if not (scores.is_contiguous() and (bias is None or bias.is_contiguous())):
        raise ValueError("topk_router needs contiguous scores and bias")


def topk_router(scores: torch.Tensor, k: int, bias: torch.Tensor | None = None):
    """Launch the CUDA kernel. scores [T, E] float32, bias [E] float32 or
    None. Returns (weights [T, k] float32, indices [T, k] int32). Raises
    under grad mode when an input needs a gradient: `TopKRouter` carries
    one."""
    _check(scores, bias)
    refuse_grad("topk_router (use TopKRouter)", scores, bias)
    t, e = scores.shape
    w = torch.empty((t, k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((t, k), dtype=torch.int32, device=scores.device)
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    err = _lib().xbof_topk_router(scores.data_ptr(),
                                  None if bias is None else bias.data_ptr(),
                                  w.data_ptr(), idx.data_ptr(), t, e, k, stream)
    if err == _ERR_SHAPE:
        raise ValueError(f"shape beyond the kernel's limits (csrc/moe_router.cu): "
                         f"scores {tuple(scores.shape)}, k {k}")
    if err != 0:
        raise RuntimeError(f"topk_router kernel launch failed: CUDA error {err}")
    topk_router.launches += 1
    return w, idx


topk_router.launches = 0


def topk_router_bwd(scores: torch.Tensor, idx: torch.Tensor, dw: torch.Tensor):
    """Launch the backward kernel: d scores [T, E] fp32 of `topk_router`'s
    weights under the cotangent ``dw`` [T, k] fp32 (contiguous), for the
    indices ``idx`` [T, k] int32 its forward returned. Deterministic."""
    _check(scores, None)
    refuse_grad("topk_router_bwd (no double backward)", scores, dw)
    t, e = scores.shape
    for name, x, dtype in (("idx", idx, torch.int32), ("dw", dw, torch.float32)):
        if x.device != scores.device or x.dtype != dtype or x.dim() != 2 \
                or x.shape[0] != t or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [T = {t}, k] {dtype} on "
                             f"{scores.device}; got {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}")
    k = idx.shape[1]
    if dw.shape[1] != k:
        raise ValueError(f"dw must be [T, k] = {(t, k)}; got {tuple(dw.shape)}")
    dscores = torch.empty_like(scores)
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    err = _bwd_lib().xbof_topk_router_bwd(scores.data_ptr(), idx.data_ptr(), dw.data_ptr(),
                                          dscores.data_ptr(), t, e, k, stream)
    if err == _ERR_SHAPE:
        raise ValueError(f"shape beyond the backward kernel's limits "
                         f"(csrc/moe_router_bwd.cu): scores {tuple(scores.shape)}, k {k}")
    if err != 0:
        raise RuntimeError(f"topk_router_bwd kernel launch failed: CUDA error {err}")
    topk_router_bwd.launches += 1
    return dscores


topk_router_bwd.launches = 0


class TopKRouter(torch.autograd.Function):
    """The router with a gradient for the scores: the forward kernel, then
    the backward kernel on ``dw.contiguous()``. The indices are marked
    non-differentiable; ``k`` and the bias get no gradient."""

    @staticmethod
    def forward(ctx, scores, k, bias):
        w, idx = topk_router(scores, k, bias=bias)
        ctx.save_for_backward(scores, idx)
        ctx.mark_non_differentiable(idx)
        return w, idx

    @staticmethod
    def backward(ctx, dw, _didx):
        scores, idx = ctx.saved_tensors
        return topk_router_bwd(scores, idx, dw.contiguous()), None, None
