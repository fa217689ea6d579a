"""Where a DTensor's dims sit on its mesh.

The placement arithmetic that the kernels' DTensor entries
(`kernels.entries`), the models' placed paths and `launch.sharding`
share. Everything here reads placements and mesh coordinates only: it
makes no tensor and issues no collective, so it runs under
`FakeTensorMode` too.
"""
from __future__ import annotations


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def replicated(n: int) -> tuple:
    """``n`` mesh dims' placements, every one replicated."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in range(n))


def sharding_dims(placements, dim: int) -> list[int]:
    """The mesh dims whose placement shards tensor dim ``dim``."""
    return [i for i, p in enumerate(placements) if getattr(p, "dim", None) == dim]


def partial_on(placements, mesh_dims) -> tuple:
    """``placements`` with a partial sum on each of ``mesh_dims``."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if i in mesh_dims else p for i, p in enumerate(placements))


def keep_dims(placements, dims, t=None, split=None) -> tuple:
    """Each mesh dim's placement kept where it shards one of ``dims``,
    else replicated (a partial sum is reduced, a shard gathered). With a
    DTensor ``t`` and a dim ``split`` (heads, channels) that no mesh dim
    shards yet, the mesh dims that would replicate shard it instead where
    they divide it: a partial sum is then reduce-scattered, a replicated
    tensor sliced, and the ranks split the work."""
    from torch.distributed.tensor import Replicate, Shard
    out = [p if isinstance(p, Shard) and p.dim in dims else Replicate()
           for p in placements]
    if t is not None and not sharding_dims(out, split):
        n = t.shape[split]
        for i, p in enumerate(out):
            size = t.device_mesh.size(i)
            if not isinstance(p, Shard) and size > 1 and n % size == 0:
                out[i] = Shard(split)
                n //= size
    return tuple(out)


def shard_span(n: int, mesh, placements, dim: int) -> tuple[int, int]:
    """(offset, length) of this rank's block of a dim of ``n`` elements
    under ``placements`` (each mesh dim that shards it splits the block
    before it as `torch.chunk` does), from the mesh coordinate alone."""
    coord = mesh.get_coordinate()
    lo, length = 0, n
    for i, p in enumerate(placements):
        if getattr(p, "dim", None) == dim and type(p).__name__ == "Shard":
            size = mesh.size(i)
            chunk = -(-length // size)
            start = min(coord[i] * chunk, length)
            lo, length = lo + start, min(chunk, length - start)
    return lo, length


def local_block(shape, mesh, placements) -> tuple[list[int], list[int]]:
    """(this rank's local shape, its offset in the whole) of a DTensor of
    ``shape`` under ``placements``."""
    spans = [shard_span(n, mesh, placements, d) for d, n in enumerate(shape)]
    return [s[1] for s in spans], [s[0] for s in spans]
