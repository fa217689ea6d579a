"""FTL address translation on Hopper — wrapper of `csrc/ftl_lookup.cu`.

Replaces the TPU Pallas kernel `repro.kernels.ftl_lookup.ftl_lookup`:
batched LPN -> PPN translation through a segment directory and the cached
mapping pages, a miss (slot -1) giving (-1, False). One thread per LPN
does two gathers; the result is exact int32 (the TPU kernel's one-hot
matmuls round PPNs of 2^24 and above through fp32). Plain version:
`kernels.ref.ftl_lookup`.

`ftl_lookup` launches the kernel on PyTorch's current stream for CUDA
tensors only and raises on anything it does not take; the dispatcher
`kernels.ops.ftl_lookup` sends CPU tensors to the plain version. It reads
nothing back to the host. ``ftl_lookup.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import refuse_grad

_ERR_SHAPE = -1  # the C entry's code for a shape beyond the kernel's limits


def _lib() -> ctypes.CDLL:
    lib = _build.load("ftl_lookup")
    fn = lib.xbof_ftl_lookup
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(lpns, directory, mapping_cache, entries_per_segment):
    if lpns.device.type != "cuda":
        raise ValueError(
            f"ftl_lookup launches a CUDA kernel; got a tensor on {lpns.device} "
            "(kernels.ops.ftl_lookup runs the plain version for CPU tensors)")
    for name, t, dim in (("lpns", lpns, 1), ("directory", directory, 1),
                         ("mapping_cache", mapping_cache, 2)):
        if t.device != lpns.device:
            raise ValueError(f"{name} must be on {lpns.device}; got {t.device}")
        if t.dtype != torch.int32 or t.dim() != dim or not t.is_contiguous():
            raise ValueError(f"need {name} contiguous int32 of {dim} "
                             f"dimension(s); got {tuple(t.shape)} {t.dtype}")
    if entries_per_segment != mapping_cache.shape[1]:
        raise ValueError(f"entries_per_segment {entries_per_segment} != the "
                         f"mapping cache's row length {mapping_cache.shape[1]}")


def ftl_lookup(lpns: torch.Tensor, directory: torch.Tensor,
               mapping_cache: torch.Tensor, entries_per_segment: int):
    """Launch the CUDA kernel. lpns [N], directory [n_seg] and
    mapping_cache [n_slots, entries_per_segment], all int32. Returns (ppn
    [N] int32, hit [N] bool)."""
    _check(lpns, directory, mapping_cache, entries_per_segment)
    refuse_grad("ftl_lookup", lpns, directory, mapping_cache)
    n = lpns.shape[0]
    ppn = torch.empty((n,), dtype=torch.int32, device=lpns.device)
    hit = torch.empty((n,), dtype=torch.bool, device=lpns.device)
    stream = torch.cuda.current_stream(lpns.device).cuda_stream
    err = _lib().xbof_ftl_lookup(lpns.data_ptr(), directory.data_ptr(),
                                 mapping_cache.data_ptr(), ppn.data_ptr(),
                                 hit.data_ptr(), n, directory.shape[0],
                                 mapping_cache.shape[0], entries_per_segment,
                                 stream)
    if err == _ERR_SHAPE:
        raise ValueError(f"shape beyond the kernel's limits (csrc/ftl_lookup.cu): "
                         f"lpns {tuple(lpns.shape)}, directory "
                         f"{tuple(directory.shape)}, mapping_cache "
                         f"{tuple(mapping_cache.shape)}")
    if err != 0:
        raise RuntimeError(f"ftl_lookup kernel launch failed: CUDA error {err}")
    ftl_lookup.launches += 1
    return ppn, hit


ftl_lookup.launches = 0
