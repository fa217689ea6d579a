"""The port's launch rules (`repro_torch.launch.mesh`, `sharding`) against
the reference's (`repro.launch.mesh`, `sharding`), on the shape-only
meshes of tests/test_launch.py: `param_specs` (serve off and on, FSDP off
and on), `cache_specs` on each architecture's `init_cache` and
`batch_specs` on its training batch, for all ten configs; the engine's
`state_partition_specs` field by field; `wants_fsdp`; the mesh helpers;
the DTensor placements of a spec; and the meshes themselves on a
one-rank gloo group. Specs compare as the tuples a `PartitionSpec`
holds."""
import functools

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.launch import mesh as JM
from repro.launch import sharding as SH
from repro.launch import specs as SP
from repro.models import decode as JD
from repro.models import transformer as JT
from repro.obs import metrics as jobs_m
from repro.serving import engine as E
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as TM
from repro_torch.launch import runtime as TR
from repro_torch.launch import sharding as TSH
from repro_torch.models import decode as TD
from repro_torch.models import transformer as TT
from repro_torch.serving import engine as TE
from test_launch import MESH, MESH_MP
from test_torch_engine import port_cfg

jax.config.update("jax_platform_name", "cpu")

MESHES = {"16x16": MESH, "2x16x16": MESH_MP}


def _ref_flat(specs):
    """{path: spec tuple} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {SH._path_str(path): tuple(spec) for path, spec in flat}


def _port_flat(specs, path=""):
    """{path: spec tuple} of a port spec tree (dicts and lists of tuples)."""
    if isinstance(specs, dict):
        items = specs.items()
    elif isinstance(specs, list):
        items = enumerate(specs)
    else:
        return {path: specs}
    out = {}
    for k, v in items:
        out.update(_port_flat(v, f"{path}/{k}" if path else str(k)))
    return out


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The reference's and the port's abstract params of ``arch``."""
    return (JT.abstract_params(jconfigs.get(arch)),
            TT.abstract_params(tconfigs.get(arch)))


def _meta(shapes):
    """Port meta tensors of a reference tree of shapes."""
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), shapes)


@pytest.mark.parametrize("serve", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_param_specs_are_the_references(arch, mesh, fsdp, serve):
    m = MESHES[mesh]
    jparams, tparams = _params(arch)
    want = _ref_flat(SH.param_specs(jconfigs.get(arch), jparams, m, fsdp=fsdp,
                                    serve=serve))
    got = _port_flat(TSH.param_specs(tconfigs.get(arch), tparams, m, fsdp=fsdp,
                                     serve=serve))
    assert got == want


@pytest.mark.parametrize("batch", [32, 6])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_cache_and_batch_specs_are_the_references(arch, mesh, batch):
    """Every architecture's decode cache (batch 32 divides both meshes'
    data axes, 6 neither) and training batch."""
    m, jcfg, tcfg = MESHES[mesh], jconfigs.get(arch), tconfigs.get(arch)
    jcache = jax.eval_shape(lambda: JD.init_cache(jcfg, batch, 256))
    tcache = TD.init_cache(tcfg, batch, 256, device="meta")
    assert _port_flat(TSH.cache_specs(tcfg, tcache, m)) == \
        _ref_flat(SH.cache_specs(jcfg, jcache, m))
    jbatch = SP.batch_specs_for(jcfg, SP.SHAPES["train_4k"])
    assert _port_flat(TSH.batch_specs(tcfg, _meta(jbatch), m)) == \
        _ref_flat(SH.batch_specs(jcfg, jbatch, m))
    assert TSH.batch_spec(m) == tuple(SH.batch_spec(m))


@pytest.mark.parametrize("arch", jconfigs.ARCH_NAMES)
def test_wants_fsdp_is_the_references(arch):
    assert TSH.wants_fsdp(tconfigs.get(arch)) == SH.wants_fsdp(jconfigs.get(arch))


ENGINE_CFGS = {
    "flat": dict(n_replicas=8, n_shards=2),
    "planes": dict(n_replicas=16, n_shards=4, shards_per_enclosure=2,
                   link_pages_per_step=2, kv_quant="int8", trace_driven=True,
                   obs=jobs_m.ObsConfig(enabled=True, ring_depth=8, event_capacity=64)),
    "failure": dict(n_replicas=8, n_shards=2, track_failures=True,
                    migrate_pages_per_step=2),
}


@pytest.mark.parametrize("name", list(ENGINE_CFGS))
def test_state_partition_specs_are_the_references(name):
    cfg = E.EngineConfig(**ENGINE_CFGS[name])
    want = E.state_partition_specs(cfg)
    got = TE.state_partition_specs(port_cfg(cfg))
    assert got._fields == want._fields
    for field in want._fields:
        tspecs = []
        TE._tree_map(tspecs.append, getattr(got, field))
        if getattr(got, field) is None:
            # a plane the config leaves out; the port carries no estimator
            # without trace_driven
            assert getattr(want, field) is None or (
                field == "mrc" and not cfg.trace_driven), field
            continue
        jspecs = {tuple(s) for s in jax.tree.leaves(
            getattr(want, field), is_leaf=lambda x: isinstance(x, P))}
        assert set(tspecs) == jspecs, field
    # the placements each leaf gets on the serving mesh's shape
    mesh = type(MESH)({"shards": cfg.n_shards})
    placed = TSH.shardings_of(got, mesh)
    assert placed.queue == (torch.distributed.tensor.Shard(0),)
    assert placed.step_count == (torch.distributed.tensor.Replicate(),)


def test_mesh_helpers_shape_math():
    assert TM.data_axes(MESH) == JM.data_axes(MESH) == ("data",)
    assert TM.data_axes(MESH_MP) == JM.data_axes(MESH_MP) == ("pod", "data")
    assert TM.axis_size(MESH_MP, ("pod", "data")) == SH._axis_size(MESH_MP, ("pod", "data")) == 32
    assert TM.axis_size(MESH, "model") == 16


def test_shardings_of_places_each_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    spec = (None, ("pod", "data"), "model")
    assert TSH.shardings_of({"w": spec}, MESH_MP) == {"w": (Shard(1), Shard(1), Shard(2))}
    assert TSH.shardings_of([(None, "model"), ()], MESH) == [
        (Replicate(), Shard(1)), (Replicate(), Replicate())]


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_meshes_on_a_gloo_group(one_rank):
    mesh = TM.make_serving_mesh(1, device_type="cpu")
    assert mesh.mesh_dim_names == (TE.SHARD_AXIS,) and mesh.device_type == "cpu"
    mesh = TM.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    assert TM.data_axes(mesh) == ("data",) and TM.axis_size(mesh, ("data", "model")) == 1
    assert TSH.cache_specs(tconfigs.smoke("deepseek-v2-236b"), {
        "c_kv": torch.empty((2, 4, 8, 16), device="meta")}, mesh) == {
        "c_kv": (None, "data", "model", None)}
    if not torch.cuda.is_available():
        # CUDA is the default, and the port never drops to the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            TM.make_serving_mesh(1)
    assert TR.get_serve_mesh() is None
    TR.set_serve_mesh(mesh)
    try:
        assert TR.get_serve_mesh() is mesh
    finally:
        TR.set_serve_mesh(None)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_shapes(monkeypatch, multi_pod):
    """The reference's production shapes (256 or 512 ranks: the call to
    `init_device_mesh` is captured, not made)."""
    import torch.distributed.device_mesh as dm
    monkeypatch.setattr(dm, "init_device_mesh",
                        lambda dev, shape, mesh_dim_names: (dev, shape, mesh_dim_names))
    dev, shape, names = TM.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    assert (shape, names) == (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                              else ((16, 16), ("data", "model")))
    assert dev == "cpu"
