"""repro_torch — the PyTorch/CUDA port of `repro` (XBOF), beside it.

The port mirrors `repro`'s module layout (``repro_torch.core.manager`` is
the port of ``repro.core.manager``) and imports neither JAX nor anything of
`repro`. State is NamedTuples of tensors threaded through plain functions;
every entry point takes an explicit ``device`` and runs on CUDA when it is
None. The paged-attention decode runs a hand-written CUDA kernel for
Hopper (`kernels/csrc/paged_attention.cu`) on CUDA tensors and its plain
PyTorch version (`kernels/ref.py`) on CPU tensors.

This slice covers the single-shard serving-engine step (fp32 and int8 KV
pages); configurations outside it raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device a port entry point runs on: CUDA unless the caller names
    another one. Raises when CUDA is wanted and none is present — the port
    never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device unless told otherwise, and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path")
    return dev


__all__ = ["resolve_device"]
