"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into a shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds). Libraries land in `build/` beside this file, named by a
hash of the source, the shared headers (`csrc/*.cuh`) and the flags, so
an edited source rebuilds and an unchanged one is reused. `build()`
starts one nvcc per source, all at once; `load()` builds on first use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("paged_attention", "flash_attention", "flash_attention_bwd",
           "rglru_scan", "rglru_scan_bwd", "rwkv6_scan", "rwkv6_scan_bwd", "moe_router",
           "moe_router_bwd", "ftl_lookup", "shards_window")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# nvcc's report per built source (registers, shared memory, spills)
LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels build from source at first use")


def library_path(name: str) -> Path:
    # the shared headers (`csrc/*.cuh`) count as part of every source
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every listed source that has no library yet, one nvcc
    process each, all started together. Raises with nvcc's stderr if any
    compile fails."""
    running = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (so, tmp, proc) in running.items():
        out, err = proc.communicate()
        LOG[name] = out + err
        if proc.returncode != 0:
            errors.append(f"{name}.cu: nvcc exited {proc.returncode}\n{err}")
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return {name: library_path(name) for name in names}


def use(name: str, lib: ctypes.CDLL) -> None:
    """Make the wrapper of ``csrc/<name>.cu`` launch ``lib`` from now on: a
    build of another source with the same C entry, as the benches time
    side by side (`chip_smoke.bench_builds`)."""
    _LIBS[name] = lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build((name,))[name]))
    return _LIBS[name]
