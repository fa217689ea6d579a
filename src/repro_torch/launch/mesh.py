"""Device meshes over `torch.distributed` (port of `repro.launch.mesh`).

Every mesh is built by a function, never when the module is imported, so
importing it touches no process group and no device. Each returns a
`torch.distributed.device_mesh.DeviceMesh` with the reference's axis
names. The device type is CUDA unless the caller names ``"cpu"``; the
process group's backend is whatever the caller initialised (with none
initialised, `init_device_mesh` initialises PyTorch's default for the
device type from the environment). Nothing here moves to the CPU or to
another backend on its own.

The spec rules (`launch.sharding`) read a mesh's axes and sizes through
`mesh_axes` and `axis_size`, which take a DeviceMesh or a shape-only mesh
(an object with ``shape`` as a {name: size} dict and ``axis_names``).
"""
from __future__ import annotations

def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 ("data", "model"), or 2x16x16 ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str = "cuda"):
    """Any shape whose product is the world size, with these axis names.
    Raises when CUDA is asked for and there is none."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import resolve_device
    resolve_device(device_type)
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_serving_mesh(n_shards: int, *, device_type: str = "cuda"):
    """1-D mesh over the serving engine's replica-shard axis: n_shards
    ranks, each owning n_replicas / n_shards replicas' pool, descriptor
    table and telemetry state (`serving.engine.make_sharded_step`). The
    axis name is `serving.engine.SHARD_AXIS`."""
    return make_mesh((n_shards,), ("shards",), device_type=device_type)


def mesh_axes(mesh) -> tuple[str, ...]:
    """The mesh's axis names, in order."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_size(mesh, axes) -> int:
    """The product of the mesh's sizes over ``axes`` (a name or a tuple)."""
    shape = mesh.shape
    if not isinstance(shape, dict):
        shape = dict(zip(mesh_axes(mesh), shape))
    n = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        n *= shape[a]
    return n


def data_axes(mesh) -> tuple[str, ...]:
    """The batch-sharding axes for this mesh (everything but 'model')."""
    return tuple(a for a in mesh_axes(mesh) if a != "model")
