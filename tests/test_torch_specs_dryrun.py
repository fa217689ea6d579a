"""The port's cell specs and dry run (`repro_torch.launch.specs`,
`repro_torch.launch.dryrun`) against the reference's (`repro.launch.specs`,
`repro.launch.sharding`), and the kernels' fake entries
(`repro_torch.kernels.entries`).

- `specs` equals the reference on every arch x shape: `cell_supported` and
  its reasons, the batch's and cache's leaves (shapes and dtypes),
  `probe_variants`' configs and coefficients, `true_coeffs` and
  `default_n_micro` at 1, 16 and 32 data ranks.
- For every arch x shape x mesh (16 x 16, 2 x 16 x 16), the dry run's
  per-rank argument bytes (`dryrun.argument_bytes`, shape arithmetic on
  tests/test_launch.py's shape-only meshes) equal, exactly, the local
  shard bytes of the reference's `param_specs`, `batch_specs` and
  `cache_specs` for the same inputs. Nothing is compiled.
- `run_cell` at probe depth (`probe_variants(cfg, kind)[0]`, one
  microbatch) on the 16 x 16 fake mesh, for train_4k of one arch per
  family and two decode cells: status ok, the recorded argument bytes
  those of the shape arithmetic, replication >= 1 (and 1 on a data-only
  (2, 1) mesh whose dims divide the cell's batch), all-gathers and
  reduce-scatters in an FSDP cell.
- Each fake entry gives its plain version's output shapes and dtypes,
  reports its kernel's workspace (the same function the launcher sizes it
  by: 84 541 440 bytes for the WKV backward at [1, 4096, 40, 64]) and counts its
  FLOP formula; on a real tensor it raises (real tensors go through
  `kernels.ops`).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.launch import sharding as JSH
from repro.launch import specs as JSP
from repro.models import transformer as JT
from repro.training import train_step as JTS
from repro_torch import configs as tconfigs
from repro_torch.kernels import entries as EN
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as RG
from repro_torch.kernels import rwkv6_scan as WKV
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as TSP
from test_launch import MESH, MESH_MP

jax.config.update("jax_platform_name", "cpu")

ARCHS = jconfigs.ARCH_NAMES
SHAPES = list(JSP.SHAPES)
MESHES = {"single": MESH, "multi": MESH_MP}
# run_cell at probe depth: one arch per family, and two serving cells
CELLS = [("granite-8b", "train_4k"), ("recurrentgemma-9b", "train_4k"),
         ("rwkv6-3b", "train_4k"), ("deepseek-v2-236b", "train_4k"),
         ("whisper-tiny", "train_4k"), ("deepseek-v2-236b", "decode_32k"),
         ("rwkv6-3b", "long_500k")]
REPLICATION_TOL = 1e-6


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, shape):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    assert TSP.SHAPES[shape] == tuple(JSP.SHAPES[shape])
    assert TSP.cell_supported(tcfg, shape) == JSP.cell_supported(jcfg, shape)
    sh_j, sh_t = JSP.SHAPES[shape], TSP.SHAPES[shape]
    kind = sh_j.kind
    if kind != "decode":
        jb, tb = JSP.batch_specs_for(jcfg, sh_j), TSP.batch_specs_for(tcfg, sh_t)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert tuple(tb[k].shape) == jb[k].shape
            assert str(tb[k].dtype).replace("torch.", "") == str(jb[k].dtype)
            assert tb[k].device.type == "meta"
    else:
        jc, jtok = JSP.decode_inputs_for(jcfg, sh_j)
        tc, ttok = TSP.decode_inputs_for(tcfg, sh_t)
        assert sorted(jc) == sorted(tc)
        for k in jc:
            assert tuple(tc[k].shape) == jc[k].shape, k
            assert str(tc[k].dtype).replace("torch.", "") == str(jc[k].dtype), k
            assert tc[k].device.type == "meta"
        assert tuple(ttok.shape) == jtok.shape and ttok.dtype == torch.int32
    jp, tp = JSP.probe_variants(jcfg, kind), TSP.probe_variants(tcfg, kind)
    assert len(jp) == len(tp)
    for (jv, jco), (tv, tco) in zip(jp, tp):
        assert dataclasses.asdict(tv) == dataclasses.asdict(jv)
        assert tco == jco
    assert TSP.true_coeffs(tcfg, kind) == JSP.true_coeffs(jcfg, kind)
    for n_data in (1, 16, 32):
        assert TSP.default_n_micro(tcfg, sh_t, n_data) == \
            JSP.default_n_micro(jcfg, sh_j, n_data)


def _ref_local_bytes(tree, specs, mesh) -> int:
    """Local shard bytes of a reference tree of ShapeDtypeStructs placed by
    a tree of PartitionSpecs on a shape-only mesh."""
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for x, spec in zip(leaves, spec_leaves):
        n = int(np.prod(x.shape)) if x.shape else 1
        for dim, axes in zip(x.shape, tuple(spec)):
            if axes is None:
                continue
            size = 1
            for a in (axes if isinstance(axes, tuple) else (axes,)):
                size *= mesh.shape[a]
            assert dim % size == 0
            n = n // dim * (dim // size)
        total += n * np.dtype(x.dtype).itemsize
    return total


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch):
    cfg = jconfigs.get(arch)
    return JT.abstract_params(cfg), JTS.abstract_state(cfg)


def _ref_argument_bytes(arch, shape, mesh) -> int:
    cfg = jconfigs.get(arch)
    sh = JSP.SHAPES[shape]
    fsdp = JSH.wants_fsdp(cfg)
    params, state = _ref_abstract(arch)
    if sh.kind == "train":
        pspecs = JSH.param_specs(cfg, state.params, mesh, fsdp)
        batch = JSP.batch_specs_for(cfg, sh)
        return (_ref_local_bytes(state.params, pspecs, mesh)
                + _ref_local_bytes(state.opt.step, P(), mesh)
                + _ref_local_bytes(state.opt.m, pspecs, mesh)
                + _ref_local_bytes(state.opt.v, pspecs, mesh)
                + _ref_local_bytes(batch, JSH.batch_specs(cfg, batch, mesh), mesh))
    serve = sh.kind == "decode"
    pspecs = JSH.param_specs(cfg, params, mesh, fsdp, serve=serve)
    total = _ref_local_bytes(params, pspecs, mesh)
    if sh.kind == "prefill":
        batch = JSP.batch_specs_for(cfg, sh)
        return total + _ref_local_bytes(batch, JSH.batch_specs(cfg, batch, mesh), mesh)
    cache, token = JSP.decode_inputs_for(cfg, sh)
    da = tuple(a for a in mesh.axis_names if a != "model")
    n_data = int(np.prod([mesh.shape[a] for a in da]))
    tspec = P(da if sh.global_batch % n_data == 0 else None)
    return (total + _ref_local_bytes(cache, JSH.cache_specs(cfg, cache, mesh), mesh)
            + _ref_local_bytes(token, tspec, mesh))


# every supported cell (long_500k needs sub-quadratic attention: the
# others are skipped cells, which `test_run_cell_skips_unsupported...`
# covers)
SUPPORTED = [(a, s) for a in ARCHS for s in SHAPES
             if JSP.cell_supported(jconfigs.get(a), s)[0]]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", SUPPORTED)
def test_argument_bytes_match_reference_specs(arch, shape, mesh):
    m = MESHES[mesh]
    cfg = tconfigs.get(arch)
    got = DR.argument_bytes(cfg, shape, m, fsdp=DR.SH.wants_fsdp(cfg))
    assert got == _ref_argument_bytes(arch, shape, m)


@functools.lru_cache(maxsize=None)
def _probe_record(arch, shape, mesh_shape=None):
    """The probe cell's record on the 16 x 16 mesh, or on ``mesh_shape``;
    there the unsharded step is the 16 x 16 record's (the same config,
    shape and microbatches), not traced again."""
    cfg = tconfigs.get(arch)
    variant, _ = TSP.probe_variants(cfg, TSP.SHAPES[shape].kind)[0]
    if mesh_shape is None:
        return variant, DR.run_cell(arch, shape, False, cfg_override=variant,
                                    n_micro_override=1, quiet=True)
    whole = _probe_record(arch, shape)[1]["flops_unsharded"]
    rec = DR.run_cell(arch, shape, False, cfg_override=variant, n_micro_override=1,
                      quiet=True, mesh_shape=mesh_shape, replication=False)
    return variant, dict(rec, replication=rec["flops"] * rec["n_devices"] / whole)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_run_cell_at_probe_depth(arch, shape):
    variant, rec = _probe_record(arch, shape)
    assert rec["status"] == "ok"
    assert rec["n_devices"] == 256
    mem = rec["memory"]
    assert mem["argument_bytes"] == DR.argument_bytes(variant, shape, _FakeProd(),
                                                      rec["fsdp"])
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["temp_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["fits"] == (mem["peak_bytes"] <= DR.H100_HBM_BYTES)
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["replication"] >= 1 - REPLICATION_TOL
    coll = rec["collectives"]
    assert coll["total_bytes"] > 0
    if rec["fsdp"] and TSP.SHAPES[shape].kind == "train":
        assert coll["counts"]["all-gather"] > 0 and coll["counts"]["reduce-scatter"] > 0


def test_run_cell_fsdp_gathers_weights_and_scatters_gradients():
    """An FSDP cell (granite-8b's probe with FSDP on; no probe variant of
    the seven is large enough for `wants_fsdp`): the weights' all-gathers
    and the gradients' reduce-scatters are recorded, and rank 0 holds less
    than without FSDP."""
    cfg = tconfigs.get("granite-8b")
    variant, plain = _probe_record("granite-8b", "train_4k")
    rec = DR.run_cell("granite-8b", "train_4k", False, fsdp=True, cfg_override=variant,
                      n_micro_override=1, quiet=True, replication=False)
    assert rec["status"] == "ok" and rec["fsdp"] and not plain["fsdp"]
    counts = rec["collectives"]["counts"]
    assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0
    assert rec["memory"]["argument_bytes"] < plain["memory"]["argument_bytes"]
    assert rec["memory"]["argument_bytes"] == DR.argument_bytes(variant, "train_4k",
                                                                _FakeProd(), True)
    assert cfg.name == variant.name


class _FakeProd:
    """The 16 x 16 production mesh, shape only."""
    shape = {"data": 16, "model": 16}
    axis_names = ("data", "model")


@pytest.mark.parametrize("arch,shape", [c for c in CELLS
                                        if TSP.SHAPES[c[1]].global_batch % 2 == 0])
def test_run_cell_data_parallel_replication_is_one(arch, shape):
    """On a data-only mesh whose dims divide the batch, every rank does its
    share of the work and no more (long_500k's batch of 1 does not
    divide)."""
    _, rec = _probe_record(arch, shape, (2, 1))
    assert rec["status"] == "ok" and rec["n_devices"] == 2
    assert abs(rec["replication"] - 1) <= REPLICATION_TOL


def test_run_cell_skips_unsupported_and_records_errors():
    rec = DR.run_cell("granite-8b", "long_500k", False, quiet=True)
    assert rec["status"] == "skipped"
    assert rec["reason"] == JSP.cell_supported(jconfigs.get("granite-8b"), "long_500k")[1]
    try:
        raise ValueError("boom")
    except ValueError as e:
        rec = DR.error_record("granite-8b", "train_4k", "single", e, "aten.mm.default")
    assert rec["status"] == "error" and rec["op"] == "aten.mm.default"
    assert "ValueError: boom" in rec["error"]


def _collect_transient():
    seen = []
    EN.TRANSIENT_HOOKS.append(seen.append)
    return seen


def _fake(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype)


def _same(fake_out, real_out):
    fo = fake_out if isinstance(fake_out, (tuple, list)) else (fake_out,)
    ro = real_out if isinstance(real_out, (tuple, list)) else (real_out,)
    assert len(fo) == len(ro)
    for f, r in zip(fo, ro):
        if r is None:
            assert f.numel() == 0
            continue
        assert tuple(f.shape) == tuple(r.shape) and f.dtype == r.dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_entries_match_plain_shapes_workspace_and_flops(dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g).to(dtype)
    b, s, t, h, kv, d = 2, 24, 24, 4, 2, 16
    q, k, v = rnd(b, s, h, d), rnd(b, t, kv, d), rnd(b, t, kv, d)
    o = ref.attention(q, k, v, causal=True, window=5)
    stats = ref.attention_stats(q, k, True, 5)
    want_bwd = ref.attention_bwd(q, k, v, o, stats, o, causal=True, window=5)
    x, a = rnd(b, t, 32), torch.rand(b, t, 32, generator=g).to(dtype)
    want_rg, want_rg_bwd = ref.rglru(x, a)[0], ref.rglru_bwd(x, a, None, x)
    r_, k_, v_, w_ = (rnd(b, t, h, d) for _ in range(4))
    w_ = torch.sigmoid(w_.float()).to(dtype)
    u = torch.randn(h, d, generator=g)
    want_wkv = ref.rwkv6_wkv(r_, k_, v_, w_, u, return_state=True)
    want_wkv_bwd = ref.rwkv6_wkv_bwd(r_, k_, v_, w_, u, None, want_wkv[0])
    sc = torch.softmax(torch.randn(40, 8, generator=g), -1)
    want_r = ref.topk_router(sc, 2)
    want_r_bwd = ref.topk_router_bwd(sc, want_r[1], want_r[0])
    seen = _collect_transient()
    try:
        with FakeTensorMode():
            fq, fk, fv = _fake(q.shape, dtype), _fake(k.shape, dtype), _fake(v.shape, dtype)
            got = EN.flash_attention_op(fq, fk, fv, True, 5, d ** -0.5, True)
            _same(got, (o, stats))
            with FlopCounterMode(display=False) as fc:
                _same(EN.flash_attention_bwd_op(fq, fk, fv, got[0], got[1], got[0], True, 5,
                                                d ** -0.5), want_bwd)
            pairs, _ = EN.flash_pairs(s, t, True, 5)
            assert fc.get_total_flops() == 10 * d * b * h * pairs
            n_split = EN._fa.bwd_split(dtype, b, t, kv, EN.H100_SMS)
            assert seen[-1] == 4 * EN._fa.bwd_workspace_floats(b, s, t, h, kv, d, n_split)
            fx, fa = _fake(x.shape, dtype), _fake(a.shape, dtype)
            _same(EN.rglru_op(fx, fa, None), want_rg)
            _same(EN.rglru_bwd_op(fx, fa, None, fx), want_rg_bwd)
            assert seen[-1] == 4 * RG.bwd_workspace_floats(b, t, 32)
            fr = [_fake(r_.shape, dtype) for _ in range(4)]
            fu = _fake(u.shape)
            with FlopCounterMode(display=False) as fc:
                _same(EN.rwkv6_wkv_op(*fr, fu, None), want_wkv)
            assert fc.get_total_flops() == (5 * d * d + 5 * d) * b * t * h
            _same(EN.rwkv6_wkv_bwd_op(*fr, fu, None, fr[0], None)[:5], want_wkv_bwd[:5])
            assert seen[-1] == 4 * WKV.bwd_workspace_floats(b, t, h, d)
            fs = _fake(sc.shape)
            _same(EN.topk_router_op(fs, 2, None), want_r)
            _same(EN.topk_router_bwd_op(fs, _fake((40, 2), torch.int32), _fake((40, 2))),
                  want_r_bwd)
            # the WKV backward's workspace at rwkv6-3b's training shape
            EN.rwkv6_wkv_bwd_op(*(_fake((1, 4096, 40, 64), dtype) for _ in range(4)),
                                _fake((40, 64)), None, _fake((1, 4096, 40, 64), dtype), None)
            assert seen[-1] == 84_541_440
    finally:
        EN.TRANSIENT_HOOKS.remove(seen.append)


def _real_args(name):
    x = torch.zeros(1, 4, 2, 8)
    return {
        "flash_attention": (x, x, x, True, 0, 1.0, False),
        "flash_attention_bwd": (x, x, x, x, x, x, True, 0, 1.0),
        "rglru": (x[0], x[0], None),
        "rglru_bwd": (x[0], x[0], None, x[0]),
        "rwkv6_wkv": (x, x, x, x, x[0, 0], None),
        "rwkv6_wkv_bwd": (x, x, x, x, x[0, 0], None, x, None),
        "topk_router": (x[0, 0], 2, None),
        "topk_router_bwd": (x[0, 0], x[0, 0, :, :2].int(), x[0, 0, :, :2]),
    }[name]


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd", "rglru",
                                  "rglru_bwd", "rwkv6_wkv", "rwkv6_wkv_bwd", "topk_router",
                                  "topk_router_bwd"])
def test_fake_entries_refuse_real_tensors(name):
    """The ``xbof::*`` custom ops are the dry run's fake entries only: a
    real tensor goes through `kernels.ops` (the kernels' autograd
    Functions on CUDA, the plain versions on the CPU), never through them."""
    with pytest.raises(RuntimeError, match="fake entry"):
        getattr(torch.ops.xbof, name)(*_real_args(name))
