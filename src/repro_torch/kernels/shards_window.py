"""SHARDS window scan on Hopper — wrapper of `csrc/shards_window.cu`.

Stands for the reference's `lax.scan` of `repro.core.shards_mrc.update`
over one window, vmapped over nodes by `repro.telemetry.windows.
update_window` (no TPU kernel backs it: XLA compiles the scan into one
device loop). One warp per node walks the window in order; every node of
every shard goes in one launch. The integer and the float results equal
the plain version's (`kernels.ref.shards_window`) bit for bit: the order
of the float32 adds is the reference's.

`shards_window` launches the kernel on PyTorch's current stream for CUDA
tensors only and raises on anything it does not take; the dispatcher
`kernels.ops.shards_window` sends CPU tensors to the plain version. It
reads nothing back to the host. ``shards_window.launches`` counts
launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import refuse_grad, shards_constants

_ERR_SHAPE = -1  # the C entry's code for a shape beyond the kernel's limits
# the largest table (K, with B = 16 buckets) that fits an H100's 227 KB of
# opt-in shared memory per block: (2K + 16) * 4 <= 227 * 1024
MAX_K_H100 = (227 * 1024 // 4 - 16) // 2


def _lib() -> ctypes.CDLL:
    lib = _build.load("shards_window")
    fn = lib.xbof_shards_window
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int64]
                       + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(addrs, last_seen, clock, hist, cold, total, refs, mask):
    if addrs.device.type != "cuda":
        raise ValueError(
            f"shards_window launches a CUDA kernel; got a tensor on {addrs.device} "
            "(kernels.ops.shards_window runs the plain version for CPU tensors)")
    n = addrs.shape[0] if addrs.dim() == 2 else -1
    want = (("addrs", addrs, torch.int64, 2), ("last_seen", last_seen, torch.int32, 2),
            ("clock", clock, torch.int32, 1), ("hist", hist, torch.float32, 2),
            ("cold", cold, torch.float32, 1), ("total", total, torch.float32, 1),
            ("refs", refs, torch.int64, 2), ("mask", mask, torch.bool, 2))
    for name, t, dtype, dim in want:
        if t.device != addrs.device:
            raise ValueError(f"{name} must be on {addrs.device}; got {t.device}")
        if (t.dtype != dtype or t.dim() != dim or not t.is_contiguous()
                or t.shape[0] != n):
            raise ValueError(f"need {name} contiguous {dtype} of {dim} "
                             f"dimension(s) with {n} nodes; got "
                             f"{tuple(t.shape)} {t.dtype}")
    if last_seen.shape != addrs.shape or mask.shape != refs.shape:
        raise ValueError(f"addrs {tuple(addrs.shape)} / last_seen "
                         f"{tuple(last_seen.shape)} or refs {tuple(refs.shape)} / "
                         f"mask {tuple(mask.shape)} differ in shape")


def shards_window(addrs: torch.Tensor, last_seen: torch.Tensor,
                  clock: torch.Tensor, hist: torch.Tensor, cold: torch.Tensor,
                  total: torch.Tensor, refs: torch.Tensor, mask: torch.Tensor,
                  sample_mod: int, sample_thresh: int, bucket_width: int):
    """Launch the CUDA kernel. State: addrs int64 [N, K], last_seen int32
    [N, K], clock int32 [N], hist float32 [N, B], cold and total float32
    [N]; window: refs int64 [N, A], mask bool [N, A]. Returns the six
    updated tensors (new buffers; the inputs are not written)."""
    _check(addrs, last_seen, clock, hist, cold, total, refs, mask)
    refuse_grad("shards_window", hist, cold, total)
    scale, inv_rate = shards_constants(sample_mod, sample_thresh, bucket_width)
    out = [torch.empty_like(t) for t in (addrs, last_seen, clock, hist, cold, total)]
    n, k = addrs.shape
    stream = torch.cuda.current_stream(addrs.device).cuda_stream
    err = _lib().xbof_shards_window(
        *(t.data_ptr() for t in (addrs, last_seen, clock, hist, cold, total,
                                 refs, mask)),
        *(t.data_ptr() for t in out), n, k, hist.shape[1], refs.shape[1],
        sample_mod, sample_thresh, scale, inv_rate, stream)
    if err == _ERR_SHAPE:
        raise ValueError(f"shape beyond the kernel's limits (csrc/shards_window.cu): "
                         f"table {tuple(addrs.shape)}, hist {tuple(hist.shape)}, "
                         f"refs {tuple(refs.shape)}, sample_mod {sample_mod}; the "
                         f"table and histogram take (2K + B) * 4 bytes of shared "
                         f"memory, at most the card's opt-in limit per block "
                         f"(227 KB on an H100: K <= {MAX_K_H100} with B = 16)")
    if err != 0:
        raise RuntimeError(f"shards_window kernel launch failed: CUDA error {err}")
    if n:
        shards_window.launches += 1
    return tuple(out)


shards_window.launches = 0
