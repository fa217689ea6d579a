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
    None. Returns (weights [T, k] float32, indices [T, k] int32)."""
    _check(scores, bias)
    refuse_grad("topk_router", scores, bias)
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
