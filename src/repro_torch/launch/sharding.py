"""Sharding rules: path pattern -> spec for every parameter, batch and
cache leaf, and the serving engine's state (port of
`repro.launch.sharding`).

A spec is what the reference's `PartitionSpec` holds: a tuple with, for
each dim, a mesh axis name, a tuple of names, or None (a one-name tuple
is the name, as `PartitionSpec` normalises it), so the two compare
directly. `shardings_of` turns a spec into the DTensor placements of each
mesh dim.

Baseline layout:
  batch           -> all data axes ("pod", "data")
  TP (d_ff, heads-merged, vocab, experts, kv-lora) -> "model"
  FSDP (optional) -> params' non-TP matrix dim over the data axes
Dims shard only when divisible by the mesh-axis product, otherwise the
leaf replicates on that dim. The rules read the mesh only through
`launch.mesh.axis_size` and `data_axes`, so a shape-only mesh will do.

`state_specs` gives a training state's specs (params and both moments
by `param_specs`, the step replicated) and `place` puts a tree on a
DeviceMesh as DTensors by them: the mesh trainer (`training.train_step`
on DTensor leaves) and the dry run (`launch.dryrun`) place weights so.
The serving engine keeps its weights replicated on every rank: its state
is what `engine_state_shardings` splits.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.config import ArchConfig
from .mesh import axis_size, data_axes, mesh_axes

MODEL = "model"


def _norm(ax):
    """A spec entry as `PartitionSpec` keeps it: a one-name tuple is the
    name, an empty one None."""
    if isinstance(ax, tuple):
        return None if not ax else ax[0] if len(ax) == 1 else ax
    return ax


def _spec(*entries) -> tuple:
    return tuple(_norm(e) for e in entries)


def _ok(mesh, dim: int, axes) -> bool:
    return axes is not None and dim % axis_size(mesh, axes) == 0


def _spec_for(path: str, shape: tuple[int, ...], mesh, fsdp_axes,
              serve: bool = False) -> tuple:
    """Mesh axes (or None) for each dim of one parameter leaf."""
    name = path.split("/")[-1]
    nd = len(shape)

    def build(*wanted):
        # wanted aligns to the TRAILING dims; leading (stack) dims -> None
        lead = (None,) * (nd - len(wanted))
        out = [ax if _ok(mesh, dim, ax) else None
               for dim, ax in zip(shape[nd - len(wanted):], wanted)]
        return _spec(*lead, *out)

    # --- embeddings / head
    if name == "embed":
        return build(MODEL, fsdp_axes)
    if name == "lm_head":
        return build(fsdp_axes, MODEL)
    if name == "dec_pos":
        return build(None, None)
    # --- MoE
    if "experts" in path:
        if serve:
            # serving shards the experts over the data axes and the
            # expert-FFN dim over model: weights stay resident, tokens move
            da = data_axes(mesh)
            if name in ("wi_gate", "wi_up"):
                return build(da, None, MODEL)         # [E, D, Fe]
            if name == "wo":
                return build(da, MODEL, None)         # [E, Fe, D]
        if name in ("wi_gate", "wi_up"):
            return build(MODEL, fsdp_axes, None)      # [E, D, Fe]
        if name == "wo":
            return build(MODEL, None, fsdp_axes)      # [E, Fe, D]
    if name == "router":
        return build(fsdp_axes, None)
    if name == "router_bias":
        return build(None)
    # --- MLA
    if name in ("wq_a", "wkv_a", "wk_rope"):
        return build(fsdp_axes, None)
    if name in ("wq_b", "wkv_b"):
        return build(None, MODEL)
    # --- attention / mlp / rwkv / rglru projections
    if name in ("wq", "wk", "wv", "wr", "wg", "wi_gate", "wi_up",
                "w_in", "w_in_gate"):
        return build(fsdp_axes, MODEL)
    if name in ("wo", "w_out"):
        return build(MODEL, fsdp_axes)
    if name in ("lora_a", "w_lora_a"):
        return build(fsdp_axes, None)
    if name.startswith("lora_b") or name == "w_lora_b":
        return build(None, fsdp_axes)
    if name in ("w_rg", "w_ig"):
        return build(MODEL, None)
    if name == "conv_w":
        return build(None, MODEL)
    if name in ("b_rg", "b_ig", "lambda_p"):
        return build(MODEL)
    if name == "proj":  # MTP concat projection
        return build(fsdp_axes, None)
    # --- norms, mus, scalar vectors
    return (None,) * nd


def _map_with_path(fn, tree, path=()):
    """``fn(path string, leaf)`` over the leaves of nested dicts, lists
    and tuples; the path joins dict keys and sequence indices with "/"
    and leaves a NamedTuple's field names out, as the reference's
    `_path_str` does."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def param_specs(cfg: ArchConfig, params_shape: Any, mesh, fsdp: bool,
                serve: bool = False):
    """Spec tree matching the (abstract) params tree. ``serve=True``
    selects the inference layout: no FSDP, experts over the data axes."""
    fsdp_axes = data_axes(mesh) if (fsdp and not serve) else None
    return _map_with_path(
        lambda path, x: _spec_for(path, tuple(x.shape), mesh, fsdp_axes, serve=serve),
        params_shape)


def _placements(spec: tuple, mesh) -> tuple:
    """A spec's placement on each mesh dim; a dim of size 1 replicates
    (the same layout, which DTensor handles more simply)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh_axes(mesh):
        dims = [i for i, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims and axis_size(mesh, name) > 1 else Replicate())
    return tuple(out)


def shardings_of(specs, mesh):
    """The DTensor placements (one `Shard(dim)` or `Replicate()` per mesh
    dim) of every spec in a tree of specs."""
    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if hasattr(t, "_fields"):
            return type(t)(*(walk(v) for v in t))
        if isinstance(t, list):
            return [walk(v) for v in t]
        return _placements(t, mesh)
    return walk(specs)


def state_specs(cfg: ArchConfig, state_shape: Any, mesh, fsdp: bool):
    """Specs of a `training.train_step.TrainState`: params and both
    moments by `param_specs`, the step replicated (the reference's
    dry-run ``in_shardings``)."""
    pspecs = param_specs(cfg, state_shape.params, mesh, fsdp)
    opt = state_shape.opt
    return type(state_shape)(pspecs, type(opt)((), pspecs, pspecs))


def _place_leaf(x, spec, mesh):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, _placements(spec, mesh), src_data_rank=None)


def _place_walk(t, specs, mesh):
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _place_walk(t[k], specs[k], mesh) for k in t}
    if hasattr(t, "_fields"):
        return type(t)(*(_place_walk(a, b, mesh) for a, b in zip(t, specs)))
    if isinstance(t, (list, tuple)):
        return type(t)(_place_walk(a, b, mesh) for a, b in zip(t, specs))
    return _place_leaf(t, specs, mesh)


def place(tree, specs, mesh):
    """Each tensor of ``tree`` as a DTensor on ``mesh`` with its spec's
    placements (`shardings_of`): every rank passes the same whole tensor
    and keeps its shard, with no collective (`distribute_tensor` with no
    source rank). The tree keeps its structure,
    so its leaves keep the reference's order (`training.tree`)."""
    return _place_walk(tree, specs, mesh)


def zeros_placed(tree, specs, mesh):
    """Zeros of a tree of (meta) tensors' shapes and dtypes as DTensors on
    ``mesh`` with their specs' placements, each rank allocating its shard
    only (the prefill's cache)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.placement import shard_span

    def leaf(x, spec):
        pl = _placements(spec, mesh)
        shape = [shard_span(n, mesh, pl, d)[1] for d, n in enumerate(x.shape)]
        loc = torch.zeros(shape, dtype=x.dtype, device=mesh.device_type)
        stride, n = [], 1
        for d in reversed(x.shape):
            stride.insert(0, n)
            n *= d
        return DTensor.from_local(loc, mesh, pl, shape=x.shape, stride=tuple(stride))

    def walk(t, sp):
        if isinstance(t, dict):
            return {k: walk(t[k], sp[k]) for k in t}
        return leaf(t, sp)
    return walk(tree, specs)


def engine_state_shardings(cfg, mesh):
    """Placements of a serving `EngineState` on the 1-D replica-shard mesh
    (`mesh.make_serving_mesh`): shard-owned fields split their leading
    replica axis over the shard axis, the rest replicates. ``cfg`` is a
    `serving.engine.EngineConfig`; `engine.split_state` and `join_states`
    do the split and the merge."""
    from repro_torch.serving import engine as _engine
    return shardings_of(_engine.state_partition_specs(cfg), mesh)


def batch_spec(mesh) -> tuple:
    return _spec(data_axes(mesh))


def batch_specs(cfg: ArchConfig, batch_shape: Any, mesh):
    """Specs for a data batch dict: dim 0 (batch) over the data axes when
    divisible, else replicated."""
    da = data_axes(mesh)

    def leaf(_, x):
        nd = len(x.shape)
        if nd >= 1 and _ok(mesh, x.shape[0], da):
            return _spec(da, *(None,) * (nd - 1))
        return (None,) * nd

    return _map_with_path(leaf, batch_shape)


def cache_specs(cfg: ArchConfig, cache_shape: Any, mesh):
    """Decode-cache sharding: batch dim over the data axes; head or
    feature dims over model where divisible; the latent cache (c_kv,
    k_rope: [L, B, S, R]) over model along its SEQUENCE dim, each model
    rank owning a contiguous span of positions
    (`attention.mla_decode_seq_sharded`)."""
    da = data_axes(mesh)

    def leaf(path, x):
        name = path.split("/")[-1]
        if name == "length":
            return ()
        nd = len(x.shape)
        dims: list = [None] * nd
        if nd >= 2 and _ok(mesh, x.shape[1], da):
            dims[1] = da
        if name in ("k", "v", "attn_k", "attn_v", "self_k", "self_v",
                    "cross_k", "cross_v") and nd == 5:
            if _ok(mesh, x.shape[3], MODEL):
                dims[3] = MODEL
        elif name in ("c_kv", "k_rope") and nd == 4:
            if _ok(mesh, x.shape[2], MODEL):
                dims[2] = MODEL
        elif name == "wkv" and nd == 5:
            if _ok(mesh, x.shape[2], MODEL):
                dims[2] = MODEL
        elif name in ("rec_h", "shift_t", "shift_c") and nd == 3:
            if _ok(mesh, x.shape[2], MODEL):
                dims[2] = MODEL
        elif name == "rec_conv" and nd == 4:
            if _ok(mesh, x.shape[3], MODEL):
                dims[3] = MODEL
        return _spec(*dims)

    return _map_with_path(leaf, cache_shape)


def wants_fsdp(cfg: ArchConfig) -> bool:
    """FSDP for archs whose params + moments exceed a replica's memory."""
    return cfg.n_params() * 10 > 8e9 * 16  # >16 chips' worth at 10 B/param
