"""RWKV6 WKV recurrence on Hopper — wrapper of `csrc/rwkv6_scan.cu`.

Replaces the TPU Pallas kernel `repro.kernels.rwkv6_scan.rwkv6_wkv` and
computes the whole of the reference oracle's signature: an optional
initial state ``s0`` and, with ``return_state``, the final state, so the
prefill runs it too. Per (batch, head) a [K, V] fp32 state S:
out_t = r_t . (S + diag(u) k_t v_t^T), then S <- diag(w_t) S + k_t v_t^T.
Plain version: `kernels.ref.rwkv6_wkv`.

bf16 runs a chunked kernel on the tensor cores: chunks of 16 steps, each
three matrix products (`mma.sync`) with an fp32 state, the decay taken
as running products of w. Its domain is 0 <= w <= 1, the model's range
(w = exp(-exp(x)), where w = 0 and w = 1 occur in bf16): there every
decay factor lies in [0, 1], w = 0 is exact and nothing overflows.
fp32 runs a serial kernel that walks T one step at a time on the CUDA
cores, as does a bf16 view whose r, k, v or w does not start on 16
bytes. See the source's note for both designs and what bounds them.

`rwkv6_wkv` launches the kernel on PyTorch's current stream for CUDA
tensors only and raises on anything it does not take; the dispatcher
`kernels.ops.rwkv6_wkv` sends CPU tensors to the plain version.
``rwkv6_wkv.launches`` counts launches.

Its gradient: `RWKV6WKV`, a ``torch.autograd.Function`` whose forward
launches the kernel above unchanged (and saves its inputs) and whose
backward launches `rwkv6_wkv_bwd`, the wrapper of `csrc/rwkv6_scan_bwd.cu`
(no TPU kernel behind it: the reference's gradient is XLA's autodiff of
its jnp oracle), in fp32 on the CUDA cores for both dtypes: one kernel
walks the two state chains (S forward, dS back) and keeps each at the
edges of every group of 64 rows (32 at K = 128); a second takes every
(batch, head, group) in parallel, recomputes the group's states from
those snapshots and writes dr, dk, dv and dw; a third sums du's
partials in a fixed order. Nothing atomic: a repeated call gives the
same bits. Plain version: `kernels.ref.rwkv6_wkv_bwd`.
``rwkv6_wkv_bwd.launches`` counts its calls, each three CUDA kernels.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import refuse_grad

_KIND = {torch.float32: 0, torch.bfloat16: 1}
_ERR_SHAPE = -1  # the C entry's code for a shape beyond the kernel's limits


def _lib() -> ctypes.CDLL:
    lib = _build.load("rwkv6_scan")
    fn = lib.xbof_rwkv6_wkv
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("rwkv6_scan_bwd")
    fn = lib.xbof_rwkv6_wkv_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.xbof_rwkv6_wkv_bwd_workspace.argtypes = [ctypes.c_int] * 4
        lib.xbof_rwkv6_wkv_bwd_workspace.restype = ctypes.c_int64
    return lib


def bwd_workspace_floats(b: int, t: int, h: int, k: int) -> int:
    """fp32 floats of `rwkv6_wkv_bwd`'s workspace for r [B, T, H, K]: the S
    and dS snapshots at the edges of every group of rows, and du's
    partials (the C entry's ``xbof_rwkv6_wkv_bwd_workspace``, which the
    launcher checks it against); -1 for a K the kernel does not take.
    84.5 MB at [1, 4096, 40, 64]. The dry run's fake entry counts the same
    bytes."""
    if k not in (16, 32, 64, 128):
        return -1
    rows = 32 if k == 128 else 64     # csrc/rwkv6_scan_bwd.cu: group_rows<K>
    groups = -(-t // rows)
    return 2 * b * h * groups * k * k + b * h * groups * k


def _check(r, k, v, w, u, s0):
    if r.device.type != "cuda":
        raise ValueError(
            f"rwkv6_wkv launches a CUDA kernel; got a tensor on {r.device} "
            "(kernels.ops.rwkv6_wkv runs the plain version for CPU tensors)")
    for t in (k, v, w, u, s0):
        if t is not None and t.device != r.device:
            raise ValueError(f"all inputs must be on {r.device}; got one on {t.device}")
    if not all(t.is_contiguous() for t in (r, k, v, w)):
        raise ValueError("rwkv6_wkv needs contiguous r, k, v and w")
    if r.dtype not in _KIND or any(t.dtype != r.dtype for t in (k, v, w)):
        raise ValueError(f"rwkv6_wkv takes float32 or bfloat16 r, k, v and w of "
                         f"one dtype; got {r.dtype}, {k.dtype}, {v.dtype}, {w.dtype}")
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"need r, k, w [B, T, H, K] and v [B, T, H, V]; got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(w.shape)}")
    b, _, h, dk = r.shape
    if tuple(u.shape) != (h, dk):
        raise ValueError(f"u must be [H, K] = {(h, dk)}; got {tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != (b, h, dk, v.shape[-1]):
        raise ValueError(f"s0 must be [B, H, K, V] = {(b, h, dk, v.shape[-1])}; "
                         f"got {tuple(s0.shape)}")


def rwkv6_wkv(r, k, v, w, u, s0=None, return_state: bool = False):
    """Launch the CUDA kernel. r, k, w [B, T, H, K] and v [B, T, H, V], all
    float32 or all bfloat16, with K = V in {16, 32, 64, 128}; u [H, K] and
    s0 [B, H, K, V] (or None: zeros) of any float dtype. Returns out [B, T,
    H, V] in r's dtype and, with ``return_state``, the final state [B, H,
    K, V] in r's dtype. Raises under grad mode when an input needs a
    gradient: `RWKV6WKV` carries one."""
    _check(r, k, v, w, u, s0)
    refuse_grad("rwkv6_wkv (use RWKV6WKV)", r, k, v, w, u, s0)
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    u = u.to(torch.float32).contiguous()
    if s0 is not None:
        s0 = s0.to(torch.float32).contiguous()
    out = torch.empty((b, t, h, dv), dtype=r.dtype, device=r.device)
    s_out = (torch.empty((b, h, dk, dv), dtype=r.dtype, device=r.device)
             if return_state else None)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = _lib().xbof_rwkv6_wkv(
        _KIND[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), None if s0 is None else s0.data_ptr(), out.data_ptr(),
        None if s_out is None else s_out.data_ptr(), b, t, h, dk, dv, stream)
    if err == _ERR_SHAPE:
        raise ValueError(f"shape beyond the kernel's limits (csrc/rwkv6_scan.cu: "
                         f"K = V in 16, 32, 64, 128): r {tuple(r.shape)}, "
                         f"v {tuple(v.shape)}")
    if err != 0:
        raise RuntimeError(f"rwkv6_wkv kernel launch failed: CUDA error {err}")
    rwkv6_wkv.launches += 1
    return (out, s_out) if return_state else out


rwkv6_wkv.launches = 0


def rwkv6_wkv_bwd(r, k, v, w, u, s0, dout, ds_final=None):
    """Launch the backward kernel: the gradients (dr, dk, dv, dw, du, ds0)
    of `rwkv6_wkv`(..., return_state=True) under the cotangents ``dout``
    of out (contiguous, r's dtype, v's shape) and ``ds_final`` of the final
    state ([B, H, K, V] of any float dtype, or None: zeros); dr, dk, dv and
    dw in r's dtype, du in u's, ds0 in s0's (None without s0).
    Deterministic: fixed-order sums, nothing atomic."""
    _check(r, k, v, w, u, s0)
    refuse_grad("rwkv6_wkv_bwd (no double backward)", r, k, v, w, u, s0, dout, ds_final)
    if dout.device != r.device or dout.dtype != r.dtype or dout.shape != v.shape:
        raise ValueError(f"dout must match v ({tuple(v.shape)}, {r.dtype}, {r.device}); "
                         f"got {tuple(dout.shape)}, {dout.dtype}, {dout.device}")
    if not dout.is_contiguous():
        raise ValueError("rwkv6_wkv_bwd needs a contiguous dout")
    b, t, h, dk = r.shape
    dv_ = v.shape[-1]
    if ds_final is not None and (ds_final.device != r.device
                                 or tuple(ds_final.shape) != (b, h, dk, dv_)):
        raise ValueError(f"ds_final must be [B, H, K, V] = {(b, h, dk, dv_)} on "
                         f"{r.device}; got {tuple(ds_final.shape)} on {ds_final.device}")
    lib = _bwd_lib()
    n_ws = bwd_workspace_floats(b, t, h, dk)
    if n_ws != lib.xbof_rwkv6_wkv_bwd_workspace(b, t, h, dk):
        raise RuntimeError(f"bwd_workspace_floats({b}, {t}, {h}, {dk}) = {n_ws} disagrees "
                           "with csrc/rwkv6_scan_bwd.cu's xbof_rwkv6_wkv_bwd_workspace")
    if n_ws < 0 or dk != dv_:
        raise ValueError(f"shape beyond the backward kernel's limits "
                         f"(csrc/rwkv6_scan_bwd.cu: K = V in 16, 32, 64, 128): "
                         f"r {tuple(r.shape)}, v {tuple(v.shape)}")
    f32 = lambda x: None if x is None else x.to(torch.float32).contiguous()
    uf, s0f, dsf = f32(u), f32(s0), f32(ds_final)
    dr, dk_, dv, dw = (torch.empty_like(x) for x in (r, k, v, w))
    du = torch.empty((h, dk), dtype=torch.float32, device=r.device)
    ds0 = None if s0 is None else torch.empty((b, h, dk, dv_), dtype=torch.float32,
                                              device=r.device)
    ws = torch.empty(n_ws, dtype=torch.float32, device=r.device)
    ptr = lambda x: None if x is None else x.data_ptr()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = lib.xbof_rwkv6_wkv_bwd(
        _KIND[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        uf.data_ptr(), ptr(s0f), dout.data_ptr(), ptr(dsf), dr.data_ptr(),
        dk_.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(), ptr(ds0),
        ws.data_ptr(), b, t, h, dk, dv_, stream)
    if err == _ERR_SHAPE:
        raise ValueError(f"shape beyond the backward kernel's limits "
                         f"(csrc/rwkv6_scan_bwd.cu): r {tuple(r.shape)}, "
                         f"v {tuple(v.shape)}")
    if err != 0:
        raise RuntimeError(f"rwkv6_wkv_bwd kernel launch failed: CUDA error {err}")
    rwkv6_wkv_bwd.launches += 1
    return (dr, dk_, dv, dw, du.to(u.dtype),
            None if ds0 is None else ds0.to(s0.dtype))


rwkv6_wkv_bwd.launches = 0


class RWKV6WKV(torch.autograd.Function):
    """The WKV scan with a gradient, as `rwkv6_wkv`(..., return_state=True):
    (out, the final state). The forward kernel, then the backward kernel on
    ``dout.contiguous()`` and the final state's cotangent, which is None
    (zeros) when the caller discards the state, as training does."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        out, s_fin = rwkv6_wkv(r, k, v, w, u, s0=s0, return_state=True)
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.set_materialize_grads(False)
        return out, s_fin

    @staticmethod
    def backward(ctx, dout, ds_final):
        r, k, v, w, u, s0 = ctx.saved_tensors
        dout = torch.zeros_like(v) if dout is None else dout.contiguous()
        return rwkv6_wkv_bwd(r, k, v, w, u, s0, dout, ds_final)
