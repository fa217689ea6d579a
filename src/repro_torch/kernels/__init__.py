"""repro_torch.kernels — hand-written CUDA kernels for Hopper and their
plain PyTorch versions.

Layout: csrc/<name>.cu holds a kernel with a plain C interface,
<name>.py its ctypes wrapper (checks, launch, launch count), ref.py the
plain versions, ops.py the dispatcher (CUDA tensor -> kernel, CPU tensor
-> plain version), _build.py the nvcc build at first use.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
