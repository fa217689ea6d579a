"""Multi-pod dry run: every (arch x shape x mesh) cell as a fake-rank pass
(port of `repro.launch.dryrun`).

In one process, a ``fake`` process group of 256 (one pod, 16 x 16
("data", "model")) or 512 ranks (two pods, 2 x 16 x 16) stands for the
mesh of `launch.mesh.make_production_mesh`; under `FakeTensorMode` the
state, batch and cache are placed as DTensors by `launch.sharding`
(`state_specs`, `param_specs`, `batch_specs`, `cache_specs`), and the
step runs through the same port functions the card runs
(`training.train_step.train_step`, `models.decode.prefill`,
`models.decode.decode_step`, the latter under `launch.runtime.
set_serve_mesh`). Nothing is allocated and nothing is launched: the
kernels take their fake entries (`kernels.entries`). Every number is of
rank 0, on its local shards, and is a model, not a measurement:

- memory, the H100 memory model: ``argument_bytes``, the local bytes of
  the placed inputs; ``output_bytes``, of the step's outputs;
  ``temp_bytes``, the peak of live storages above the arguments (every
  local tensor an op makes, alive until its last reference goes, and each
  kernel's workspace while it runs); ``peak_bytes`` = arguments + temp,
  and ``fits`` = peak <= `H100_HBM_BYTES`. The port keeps the old state
  beside the new until the step returns, and the count is as the port
  runs (no donation of the arguments).
- ``flops``: `torch.utils.flop_counter`'s formulas on the local shards
  (products, and the kernels' formulas registered by `kernels.entries`);
  ``replication`` = flops x n_devices / the unsharded step's flops (the
  same step on plain fake tensors): 1 where the ranks split the work,
  more where they repeat it.
- ``bytes_accessed``: the bytes of each op's tensor operands and results
  on the rank's shards (views and collectives not counted), the kernels'
  included: their operands and results are their bound bytes.
- ``collectives``: every functional collective DTensor issues
  (``torch.ops._c10d_functional.*``) and every c10d call of the port's
  own (``dist.all_reduce`` in the MLA combine), by the reference's five
  kinds: each op's output bytes and its group's size g with the
  reference's ring factors (all-gather out (g-1)/g, reduce-scatter out
  (g-1), all-reduce 2 out (g-1)/g, all-to-all out (g-1)/g, permute out).

A cell that raises is recorded ``status: "error"`` with the error, the
last op it reached and the trace's end. Usage:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      --shape train_4k --mesh single --out results/dryrun_torch.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

``--device-type`` names the fake tensors' device: ``cuda`` by default
where this torch sees a card, else ``cpu``; the records are the same.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.kernels import entries
from repro_torch.launch import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import axis_size, data_axes, make_mesh, make_production_mesh
from repro_torch.launch.placement import is_dtensor
from repro_torch.training import tree as tr

# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3, 700.00 W (read on the card; chip_smoke.py's dryrun_memory phase
# reads it again and fails if it differs)
H100_HBM_BYTES = 85017493504

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)
_KIND = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_FACTOR = {
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: g - 1,
    "all-reduce": lambda g: 2 * (g - 1) / g,
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}
_SKIP_BYTES = {"detach", "alias", "lift_fresh", "_to_copy"}


def _tensors(tree, out=None) -> list:
    """The tensors in a tree of lists, tuples and dicts (an op's
    arguments or results)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _group_size(args, kwargs) -> int:
    """The size of a collective's group: its group_size argument, or the
    group its name resolves to."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (KeyError, RuntimeError, ValueError):
                continue
        if hasattr(a, "size") and callable(a.size) and not isinstance(a, torch.Tensor):
            return a.size()
    ints = [a for a in args[1:] if isinstance(a, int)]
    return ints[0] if ints else 1


class Tracker(TorchDispatchMode):
    """Per-rank accounting of a fake step, op by op on the local tensors
    (a DTensor op returns NotImplemented here, so DTensor runs it and its
    local ops and collectives come back through): live storages and their
    peak, flops, bytes accessed, collectives, and (``last_seen``) the last
    op seen."""

    last_seen = None

    def __init__(self, count_memory: bool = True):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.count_memory = count_memory
        self.live: dict[int, int] = {}
        self.refs: dict[int, weakref.ref] = {}
        self.cur = self.peak = self.pending = 0
        self.flops = 0
        self.bytes = 0
        self.coll = {k: {"bytes": 0.0, "raw": 0, "count": 0} for k in _COLLECTIVES}
        self.shadow_ops = 0

    def track(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":   # shapes only (the cache's template)
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.cur += n
        self.refs[key] = weakref.ref(st, lambda _, k=key: self._free(k))

    def _free(self, key) -> None:
        self.cur -= self.live.pop(key, 0)
        self.refs.pop(key, None)

    def transient(self, nbytes: int) -> None:
        self.pending += nbytes

    def __enter__(self):
        # DTensor's sharding propagation runs each new op once on fake
        # tensors of the GLOBAL shapes to learn its output's shape; that is
        # no work of the rank's, so the tracker looks away meanwhile
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        entries.TRANSIENT_HOOKS.append(self.transient)
        self._meta_fn = ShardingPropagator._propagate_tensor_meta_non_cached
        self.away = 0

        def meta_fn(prop, *a, **kw):
            self.away += 1
            try:
                return self._meta_fn(prop, *a, **kw)
            finally:
                self.away -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = meta_fn
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        ShardingPropagator._propagate_tensor_meta_non_cached = self._meta_fn
        entries.TRANSIENT_HOOKS.remove(self.transient)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        ins = _tensors((args, kwargs))
        if self.away or not all(t.untyped_storage()._cdata in self.live for t in ins):
            # DTensor deriving an output's global shape: a run on tensors
            # that no op of the rank's made
            self.shadow_ops += 1
            return func(*args, **kwargs)
        Tracker.last_seen = str(func)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        name = func.__name__.split(".")[0]
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d") and name in _KIND:
            kind = _KIND[name]
            g = max(_group_size(args, kwargs), 2)
            nbytes = sum(t.numel() * t.element_size() for t in outs)
            self.coll[kind]["bytes"] += nbytes * _FACTOR[kind](g)
            self.coll[kind]["raw"] += nbytes
            self.coll[kind]["count"] += 1
        elif ns not in ("_c10d_functional", "c10d") and not func.is_view \
                and name not in _SKIP_BYTES:
            packet = func._overloadpacket
            if packet in self.flop_registry:
                self.flops += int(self.flop_registry[packet](*args, **kwargs, out_val=out))
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            self.track(t)
        if self.count_memory:
            self.peak = max(self.peak, self.cur + self.pending)
        self.pending = 0
        return out

    def collectives(self) -> dict:
        return {
            "bytes_by_kind": {k: round(v["bytes"]) for k, v in self.coll.items()},
            "raw_out_bytes": {k: v["raw"] for k, v in self.coll.items()},
            "counts": {k: v["count"] for k, v in self.coll.items()},
            "total_bytes": round(sum(v["bytes"] for v in self.coll.values())),
        }


def _locals(tree) -> list:
    return [x.to_local() if is_dtensor(x) else x for x in _tensors(tree)]


def _unique_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


@contextlib.contextmanager
def fake_world(n: int):
    """A ``fake`` process group of ``n`` ranks in this process (this
    process is rank 0), destroyed on exit. Raises if this torch has no
    ``fake`` backend."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the dry run makes its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_like(tree, device):
    """Fake tensors of a tree of meta tensors' shapes and dtypes (called
    under `FakeTensorMode`)."""
    return tr.tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype, device=device), tree)


def _step_fn(cfg, shape, mesh, n_micro, fsdp):
    """(inputs' meta trees, their specs, the step) of a cell. The serving
    steps run under `implicit_replication` (the models' positions, masks
    and constants are replicated), as `train_step` does on its own."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    from repro_torch.training import train_step as TS
    if shape.kind == "train":
        state = TS.abstract_state(cfg)
        batch = SP.batch_specs_for(cfg, shape)
        specs = None if mesh is None else (
            SH.state_specs(cfg, state, mesh, fsdp), SH.batch_specs(cfg, batch, mesh))

        def step(state, batch):
            return TS.train_step(cfg, state, batch, n_micro=n_micro)
        return (state, batch), specs, step
    params = T.abstract_params(cfg)
    serve = shape.kind == "decode"
    pspecs = None if mesh is None else SH.param_specs(cfg, params, mesh, fsdp,
                                                       serve=serve)
    if shape.kind == "prefill":
        batch = SP.batch_specs_for(cfg, shape)
        specs = None if mesh is None else (pspecs, SH.batch_specs(cfg, batch, mesh))

        def step(params, batch):
            with implicit_replication():
                return D.prefill(cfg, params, batch.get("tokens"),
                                 input_embeds=batch.get("input_embeds"),
                                 enc_embeds=batch.get("enc_embeds"), max_len=shape.seq)
        return (params, batch), specs, step
    cache, token = SP.decode_inputs_for(cfg, shape)
    specs = None
    if mesh is not None:
        da = data_axes(mesh)
        tspec = (da if shape.global_batch % axis_size(mesh, da) == 0 else None,)
        specs = (pspecs, SH.cache_specs(cfg, cache, mesh), tspec)

    def step(params, cache, token):
        with implicit_replication():
            return D.decode_step(cfg, params, cache, token)
    return (params, cache, token), specs, step


def _rank0_bytes(x, spec, mesh) -> int:
    """Rank 0's bytes of a tensor placed by ``spec`` on ``mesh`` (a
    DeviceMesh or a shape-only one): each dim split over its mesh dims,
    rank 0 holding the first chunk."""
    pl = SH._placements(spec, mesh)
    axes = SH.mesh_axes(mesh)
    n = x.numel()
    shape = list(x.shape)
    for name, p in zip(axes, pl):
        if getattr(p, "dim", None) is not None:
            size = axis_size(mesh, name)
            chunk = -(-shape[p.dim] // size)
            n = n // shape[p.dim] * chunk if shape[p.dim] else 0
            shape[p.dim] = chunk
    return n * x.element_size()


def argument_bytes(cfg, shape_name: str, mesh, fsdp: bool) -> int:
    """Rank 0's bytes of a cell's placed inputs, by shape arithmetic alone
    (`launch.specs` meta tensors and the `launch.sharding` specs;
    ``mesh`` may be shape-only): what `run_cell` records as
    ``argument_bytes``."""
    shape = SP.SHAPES[shape_name]
    metas, specs, _ = _step_fn(cfg, shape, mesh, 1, fsdp)
    total = 0
    for tree, spec in zip(metas, specs):
        leaves, _ = tr.flatten(tree)
        for x, sp in zip(leaves, _spec_leaves(spec)):
            total += _rank0_bytes(x, sp, mesh)
    return total


def _spec_leaves(spec) -> list:
    """A spec tree's specs (tuples) in `training.tree`'s leaf order."""
    if isinstance(spec, dict):
        return [s for k in sorted(spec) for s in _spec_leaves(spec[k])]
    if hasattr(spec, "_fields"):
        return [s for v in spec for s in _spec_leaves(v)]
    return [spec]


def _run(cfg, shape, mesh, n_micro, fsdp, device, count_memory):
    """One fake step: (tracker, argument bytes, output bytes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import runtime
    metas, specs, step = _step_fn(cfg, shape, mesh, n_micro, fsdp)
    with FakeTensorMode(allow_non_fake_inputs=True):
        inputs = [_fake_like(m, device) for m in metas]
        if mesh is not None:
            inputs = [SH.place(x, s, mesh) for x, s in zip(inputs, specs)]
        args = _locals(inputs)
        tracker = Tracker(count_memory)
        for t in args:
            tracker.track(t)
        arg_bytes = tracker.cur
        tracker.peak = tracker.cur
        serve = mesh is not None and shape.kind == "decode"
        if serve:
            runtime.set_serve_mesh(mesh)
        try:
            with tracker:
                out = step(*inputs)
        finally:
            if serve:
                runtime.set_serve_mesh(None)
        out_bytes = _unique_bytes(_locals(out))
        del out, inputs, args
    return tracker, arg_bytes, out_bytes


def default_device_type() -> str:
    """The fake tensors' device: the card's where this torch sees CUDA,
    else the CPU's (DTensor cannot split fake CUDA tensors in a torch built
    without CUDA)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def run_step(cfg, shape: SP.Shape, *, multi_pod: bool = False, mesh_shape=None,
             fsdp: bool = False, n_micro: int | None = None, device_type: str | None = None,
             replication: bool = True) -> dict:
    """One step of ``cfg`` at ``shape`` (a `launch.specs.Shape`: one of
    SHAPES, or any batch and length) on a fake mesh: the production mesh,
    or with ``mesh_shape`` a ("data", "model") mesh of that shape. Makes
    its own fake process group. Returns the record's numbers; with
    ``replication`` False the unsharded step is not run (and
    `replication` is None). ``device_type`` is the fake tensors' device
    (`default_device_type` when None)."""
    device_type = device_type or default_device_type()
    n_dev = (mesh_shape[0] * mesh_shape[1] if mesh_shape
             else 512 if multi_pod else 256)
    device = torch.device(device_type)
    t0 = time.time()
    with fake_world(n_dev):
        mesh = (make_mesh(tuple(mesh_shape), ("data", "model"), device_type=device_type)
                if mesh_shape else
                make_production_mesh(multi_pod=multi_pod, device_type=device_type))
        n_data = axis_size(mesh, data_axes(mesh))
        if shape.kind != "train":
            n_micro = 0
        elif n_micro is None:
            n_micro = SP.default_n_micro(cfg, shape, n_data)
        tracker, arg_bytes, out_bytes = _run(cfg, shape, mesh, n_micro, fsdp, device, True)
    t_sharded = time.time() - t0
    t0 = time.time()
    whole = _run(cfg, shape, None, n_micro, fsdp, device, False)[0] if replication else None
    t_whole = time.time() - t0
    mem_rec = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
               "temp_bytes": tracker.peak - arg_bytes, "peak_bytes": tracker.peak,
               "fits": tracker.peak <= H100_HBM_BYTES, "hbm_bytes": H100_HBM_BYTES}
    return {
        "n_devices": n_dev, "fsdp": bool(fsdp), "n_micro": n_micro,
        "device_type": device_type,
        "trace_s": round(t_sharded, 1), "trace_unsharded_s": round(t_whole, 1),
        "memory": mem_rec,
        "flops": float(tracker.flops),
        "flops_unsharded": float(whole.flops) if whole else None,
        "replication": (tracker.flops * n_dev / whole.flops
                        if whole and whole.flops else None),
        "bytes_accessed": float(tracker.bytes),
        "collectives": tracker.collectives(),
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, fsdp=None, cfg_override=None,
             n_micro_override=None, quiet=False, device_type: str | None = None,
             mesh_shape: tuple | None = None, replication: bool = True) -> dict:
    """One cell's record (the reference's keys; `peak_bytes`, `fits` and
    `replication` added): `run_step` on the production mesh, or with
    ``mesh_shape`` a ("data", "model") mesh of that shape."""
    cfg = cfg_override if cfg_override is not None else configs.get(arch)
    shape = SP.SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    ok, why = SP.cell_supported(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    fsdp = SH.wants_fsdp(cfg) if fsdp is None else fsdp
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "ok",
           **run_step(cfg, shape, multi_pod=multi_pod, mesh_shape=mesh_shape, fsdp=fsdp,
                      n_micro=n_micro_override, device_type=device_type,
                      replication=replication)}
    if not quiet:
        print(json.dumps({k: rec[k] for k in ("arch", "shape", "mesh", "status", "trace_s")}))
        print("  memory:", rec["memory"])
        print("  flops=%.3e replication=%.4f bytes=%.3e" % (
            rec["flops"], rec["replication"] or 0, rec["bytes_accessed"]))
        print("  collectives:", rec["collectives"]["counts"],
              "total_bytes=%.3e" % rec["collectives"]["total_bytes"])
    return rec


def error_record(arch, shape, mesh_name, err: BaseException, last_op) -> dict:
    return {"arch": arch, "shape": shape, "mesh": mesh_name, "status": "error",
            "error": f"{type(err).__name__}: {err}"[:2000], "op": last_op,
            "trace": traceback.format_exc()[-2000:]}


def run_probes(out_path: Path, archs, shapes, device_type=None):
    """Trace the shallow scanned/unrolled probe variants the roofline
    extrapolation reads (`launch.specs.probe_variants`)."""
    ledger = {}
    if out_path.exists():
        ledger = json.loads(out_path.read_text())
    for arch in archs:
        cfg = configs.get(arch)
        for shape in shapes:
            okc, _ = SP.cell_supported(cfg, shape)
            if not okc:
                continue
            kind = SP.SHAPES[shape].kind
            for i, (variant, coeffs) in enumerate(SP.probe_variants(cfg, kind)):
                key = f"{arch}|{shape}|probe{i}"
                if ledger.get(key, {}).get("status") == "ok":
                    continue
                try:
                    rec = run_cell(arch, shape, False, cfg_override=variant,
                                   n_micro_override=1, quiet=True,
                                   device_type=device_type)
                    rec["coeffs"] = coeffs
                    print(f"probe ok {key} flops={rec['flops']:.3e}")
                except Exception as e:
                    rec = {"status": "error", "error": f"{type(e).__name__}: {e}",
                           "op": Tracker.last_seen, "coeffs": coeffs}
                    print(f"probe FAILED {key}: {e}", file=sys.stderr)
                ledger[key] = rec
                out_path.write_text(json.dumps(ledger, indent=1))
    return ledger


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--fsdp", default=None, choices=[None, "on", "off"])
    ap.add_argument("--probes", action="store_true",
                    help="run roofline probe variants instead of full cells")
    ap.add_argument("--device-type", choices=["cuda", "cpu"], default=None,
                    help="the fake tensors' device (default: cuda where this torch "
                         "sees a card, else cpu)")
    args = ap.parse_args(argv)

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)

    archs = configs.ARCH_NAMES if (args.all or not args.arch) else [args.arch]
    shapes = list(SP.SHAPES) if (args.all or not args.shape) else [args.shape]
    if args.probes:
        run_probes(out_path, archs, shapes, device_type=args.device_type)
        return 0
    ledger: dict[str, dict] = {}
    if out_path.exists():
        ledger = json.loads(out_path.read_text())
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    fsdp = None if args.fsdp is None else (args.fsdp == "on")

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = f"{arch}|{shape}|{'multi' if mp else 'single'}"
                if ledger.get(key, {}).get("status") in ("ok", "skipped"):
                    continue
                try:
                    rec = run_cell(arch, shape, mp, fsdp=fsdp,
                                   device_type=args.device_type)
                except Exception as e:
                    failures += 1
                    rec = error_record(arch, shape, "multi" if mp else "single", e,
                                       Tracker.last_seen)
                    print(f"FAILED {key}: {type(e).__name__}: {e}"[:500], file=sys.stderr)
                ledger[key] = rec
                out_path.write_text(json.dumps(ledger, indent=1))
    print(f"dry-run complete: {sum(1 for r in ledger.values() if r['status']=='ok')} ok, "
          f"{sum(1 for r in ledger.values() if r['status']=='skipped')} skipped, "
          f"{sum(1 for r in ledger.values() if r['status']=='error')} errors")
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
