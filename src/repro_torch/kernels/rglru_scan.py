"""RG-LRU linear recurrence on Hopper — wrapper of `csrc/rglru_scan.cu`.

Replaces the TPU Pallas kernel `repro.kernels.rglru_scan.rglru`:
h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * x_t over [B, T, W], the
state carried in fp32, from an optional h0 (which the TPU kernel does not
take). It is bound by bytes. Its blocks split the work per element, not
the order of the walk: producer warps stream chunks of x and a into
shared memory and compute each step's a and gain times x, consumer threads
(one per channel) walk the recurrence; see the source's note. It does the
plain version's IEEE operations in its order, so it gives the plain
version (`kernels.ref.rglru`) bit for bit, in fp32 and bf16. It takes any
contiguous x and a, views at any storage offset included (narrower copies
where rows are off 16 bytes).

`rglru` launches the kernel on PyTorch's current stream for CUDA tensors
only and raises on anything it does not take; the dispatcher
`kernels.ops.rglru` sends CPU tensors to the plain version.
``rglru.launches`` counts launches.

Its gradient: `RGLRU`, a ``torch.autograd.Function`` whose forward
launches the kernel above unchanged (and saves x, a and h0) and whose
backward launches `rglru_bwd`, the wrapper of `csrc/rglru_scan_bwd.cu`
(no TPU kernel behind it: the reference's gradient is XLA's autodiff of
its jnp oracle). A call launches two kernels: the state and cotangent
chains walked alone, snapshotted every 8 rows, then every (batch, group,
channel) in parallel from those snapshots; it gives the plain gradient
(`kernels.ref.rglru_bwd`) value for value. ``rglru_bwd.launches`` counts
its calls.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import refuse_grad

_KIND = {torch.float32: 0, torch.bfloat16: 1}
_ERR_SHAPE = -1  # the C entry's code for a shape beyond the kernel's limits


def _lib() -> ctypes.CDLL:
    lib = _build.load("rglru_scan")
    fn = lib.xbof_rglru
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("rglru_scan_bwd")
    fn = lib.xbof_rglru_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.xbof_rglru_bwd_workspace.argtypes = [ctypes.c_int] * 3
        lib.xbof_rglru_bwd_workspace.restype = ctypes.c_int64
    return lib


# rows between two of the backward's fp32 state snapshots (csrc/rglru_scan_bwd.cu: kG)
_BWD_GROUP = 8


def bwd_workspace_floats(b: int, t: int, w: int) -> int:
    """fp32 floats of `rglru_bwd`'s workspace for x [B, T, W]: the h and
    cotangent snapshots at the start of every group of _BWD_GROUP rows
    (the C entry's ``xbof_rglru_bwd_workspace``, which the launcher checks
    it against). The dry run's fake entry counts the same bytes."""
    return 2 * b * (-(-t // _BWD_GROUP)) * w


def _check(x, a, h0):
    if x.device.type != "cuda":
        raise ValueError(
            f"rglru launches a CUDA kernel; got a tensor on {x.device} "
            "(kernels.ops.rglru runs the plain version for CPU tensors)")
    for t in (a, h0):
        if t is not None and t.device != x.device:
            raise ValueError(f"all inputs must be on {x.device}; got one on {t.device}")
    if not (x.is_contiguous() and a.is_contiguous()):
        raise ValueError("rglru needs contiguous x and a")
    if x.dtype not in _KIND or a.dtype != x.dtype:
        raise ValueError(f"rglru takes float32 or bfloat16 x and a of one dtype; "
                         f"got {x.dtype}, {a.dtype}")
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"need x and a [B, T, W] of one shape; got "
                         f"{tuple(x.shape)}, {tuple(a.shape)}")
    if h0 is not None and tuple(h0.shape) != (x.shape[0], x.shape[2]):
        raise ValueError(f"h0 must be [B, W] = {(x.shape[0], x.shape[2])}; "
                         f"got {tuple(h0.shape)}")


def rglru(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None = None):
    """Launch the CUDA kernel. x, a [B, T, W], both float32 or both
    bfloat16; h0 [B, W] of any float dtype or None (zeros). Returns (out
    [B, T, W] in x's dtype, h_T = out[:, -1]). Raises under grad mode when
    an input needs a gradient: `RGLRU` carries one."""
    _check(x, a, h0)
    refuse_grad("rglru (use RGLRU)", x, a, h0)
    b, t, w = x.shape
    out = torch.empty_like(x)
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().xbof_rglru(_KIND[x.dtype], x.data_ptr(), a.data_ptr(),
                            None if h0 is None else h0.data_ptr(),
                            out.data_ptr(), b, t, w, stream)
    if err == _ERR_SHAPE:
        raise ValueError(f"shape beyond the kernel's limits (csrc/rglru_scan.cu): "
                         f"x {tuple(x.shape)}")
    if err != 0:
        raise RuntimeError(f"rglru kernel launch failed: CUDA error {err}")
    rglru.launches += 1
    return out, out[:, -1]


rglru.launches = 0


def rglru_bwd(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None,
              dout: torch.Tensor):
    """Launch the backward kernel: the gradients (dx, da, dh0) of
    `rglru`'s out under the cotangent ``dout`` (contiguous, in x's dtype
    and shape), dx and da in x's dtype, dh0 in h0's (None without h0).
    Deterministic: no reduction, nothing atomic."""
    _check(x, a, h0)
    refuse_grad("rglru_bwd (no double backward)", x, a, h0, dout)
    if dout.device != x.device or dout.dtype != x.dtype or dout.shape != x.shape:
        raise ValueError(f"dout must match x ({tuple(x.shape)}, {x.dtype}, {x.device}); "
                         f"got {tuple(dout.shape)}, {dout.dtype}, {dout.device}")
    if not dout.is_contiguous():
        raise ValueError("rglru_bwd needs a contiguous dout")
    b, t, w = x.shape
    lib = _bwd_lib()
    dx, da = torch.empty_like(x), torch.empty_like(a)
    h0f = None if h0 is None else h0.to(torch.float32).contiguous()
    dh0 = None if h0 is None else torch.empty((b, w), dtype=torch.float32, device=x.device)
    n_ws = bwd_workspace_floats(b, t, w)
    if n_ws != lib.xbof_rglru_bwd_workspace(b, t, w):
        raise RuntimeError(f"bwd_workspace_floats({b}, {t}, {w}) = {n_ws} disagrees with "
                           "csrc/rglru_scan_bwd.cu's xbof_rglru_bwd_workspace")
    ws = torch.empty(max(n_ws, 1), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.xbof_rglru_bwd(_KIND[x.dtype], x.data_ptr(), a.data_ptr(),
                             None if h0f is None else h0f.data_ptr(), dout.data_ptr(),
                             dx.data_ptr(), da.data_ptr(),
                             None if dh0 is None else dh0.data_ptr(), ws.data_ptr(),
                             b, t, w, stream)
    if err == _ERR_SHAPE:
        raise ValueError(f"shape beyond the backward kernel's limits "
                         f"(csrc/rglru_scan_bwd.cu): x {tuple(x.shape)}")
    if err != 0:
        raise RuntimeError(f"rglru_bwd kernel launch failed: CUDA error {err}")
    rglru_bwd.launches += 1
    return dx, da, None if dh0 is None else dh0.to(h0.dtype)


rglru_bwd.launches = 0


class RGLRU(torch.autograd.Function):
    """The RG-LRU scan with a gradient: the forward kernel, then the
    backward kernel on ``dout.contiguous()``. It returns out only: the
    caller takes h_T = out[:, -1] (a Function that also returned a view of
    its own output would confuse autograd), so a cotangent of h_T reaches
    the backward inside dout."""

    @staticmethod
    def forward(ctx, x, a, h0):
        out, _ = rglru(x, a, h0)
        ctx.save_for_backward(x, a, h0)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, a, h0 = ctx.saved_tensors
        return rglru_bwd(x, a, h0, dout.contiguous())
