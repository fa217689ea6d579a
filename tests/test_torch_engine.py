"""The slice end to end: `repro_torch.serving.engine.step` against
`repro.serving.engine.step`, on the CPU, from the same state
(`state_from_numpy`) with the reference's own decode activations fed to
the port each step. Integer and bool state matches bit for bit every step,
stats have the same keys with integer stats equal and float stats within
the stated tolerances; the 8-replica configuration reproduces its
harvesting counts. Also: the port imports neither JAX nor `repro`, its
entry points default to CUDA, the configurations earlier slices refused
(the failure plane's) now step as the reference does, and what a later
slice still refuses raises."""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import engine as E
from repro_torch.launch import serve as tserve
from repro_torch.serving import engine as TE

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]

# float stats: attn_norm and the table / pool floats differ only through
# the float32 matmuls producing K/V and q (XLA vs PyTorch summation order,
# ~1e-7 relative); quant_err_norm sums squared int8 read-back errors, where
# one code step flipped by those last bits moves a term by ~scale^2
FLOAT_RTOL = {"quant_err_norm": 2e-2}
DEFAULT_RTOL = 1e-4

CFG = E.EngineConfig(n_replicas=4, seq_slots=4, shadow_slots=2,
                     pages_per_replica=32, page=8, max_pages=8)
LINK = E.EngineConfig(n_replicas=4, seq_slots=3, shadow_slots=1,
                      pages_per_replica=8, page=4, max_pages=8,
                      link_pages_per_step=1)
NARROW8 = E.EngineConfig(n_replicas=8, seq_slots=64, shadow_slots=16,
                         pages_per_replica=48, page=16, max_pages=16)


def _pressured(state, cfg):
    """Replica 0 memory-full with page-hungry sequences
    (tests/test_serving.py::TestLinkBudget)."""
    pool = state.pool._replace(
        used=state.pool.used.at[0].set(True),
        seq_active=state.pool.seq_active.at[0, : cfg.seq_slots].set(True))
    return state._replace(pool=pool,
                          remaining=state.remaining.at[0, : cfg.seq_slots].set(16))


SCENARIOS = {
    # name: (config, arrivals per step, steps, prepare, (redirected summed,
    #        offsite_pages and log_commits at the last step) or None)
    "serving": (CFG, lambda i: [5, 0, 0, 0] if i % 3 else [3, 1, 0, 2], 10,
                None, None),
    "int8": (CFG._replace(kv_quant="int8"), lambda i: [5, 0, 0, 1], 10,
             None, None),
    "link_budget": (LINK, lambda i: [0, 0, 0, 0], 6, _pressured, None),
    "link_budget_int8": (LINK._replace(kv_quant="int8"),
                         lambda i: [2, 0, 1, 0], 12, _pressured, None),
    "narrow8": (NARROW8, lambda i: [16, 4, 0, 0, 0, 0, 0, 0], 32, None,
                (325, 88, 120)),
}


def port_cfg(cfg):
    return TE.EngineConfig(**{f: getattr(cfg, f) for f in cfg._fields
                              if f not in ("obs", "reclaim")},
                           obs=TE.obs_m.ObsConfig(*cfg.obs),
                           reclaim=TE.tele_reclaim.ReclaimConfig(*cfg.reclaim))


def _activations(cfg, i):
    """The reference step's own decode activations for step_count i: under
    its vmap over shards every shard draws the same [nl, St, d] tensor."""
    nl = cfg.n_replicas // cfg.n_shards
    shape = (nl, cfg.seq_slots + cfg.shadow_slots, cfg.n_heads * cfg.head_dim)
    key = jax.random.fold_in(jax.random.key(7), jnp.int32(i))
    return np.tile(np.array(jax.random.normal(key, shape) * 0.1),
                   (cfg.n_shards, 1, 1))


def _compare_leaves(jtree, ttree, where, int8_codes=False):
    items = ttree.items() if isinstance(ttree, dict) else zip(ttree._fields, ttree)
    for name, a in items:
        b = jtree[name] if isinstance(jtree, dict) else getattr(jtree, name)
        if a is None:
            continue
        if hasattr(a, "_fields") or isinstance(a, dict):
            _compare_leaves(b, a, f"{where}.{name}", int8_codes)
            continue
        b, a = np.asarray(b), a.numpy()
        if name in ("k", "v"):
            # the port's K/V planes are flat by global page id, plus a
            # scratch page
            a = a[:-1].reshape(b.shape)
        if b.dtype == np.uint32:
            # SHARDS addresses: the port holds uint32 values as int64
            b = b.astype(np.int64)
        assert a.dtype == b.dtype, (where, name, a.dtype, b.dtype)
        if a.dtype.kind in "biu":
            if int8_codes and name in ("k", "v"):
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{where}.{name}")
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{where}.{name}")


def _compare_stats(jst, tst, i):
    assert sorted(jst) == sorted(tst)
    for k in jst:
        a, b = np.asarray(jst[k]), tst[k].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (i, k)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f"step {i} {k}")
        else:
            np.testing.assert_allclose(
                b, a, rtol=FLOAT_RTOL.get(k, DEFAULT_RTOL), atol=1e-6,
                err_msg=f"step {i} {k}")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_step_matches_reference(name):
    cfg, arrivals, steps, prepare, expect = SCENARIOS[name]
    jstate = E.init(cfg, jax.random.key(0))
    if prepare is not None:
        jstate = prepare(jstate, cfg)
    tcfg = port_cfg(cfg)
    tstate = TE.state_from_numpy(tcfg, jax.tree.map(np.asarray, jstate), "cpu")
    _compare_leaves(jstate, tstate, "init")
    redirected = 0
    for i in range(steps):
        arr = np.asarray(arrivals(i), np.int32)
        x = _activations(cfg, i)
        jstate, jst = E.step(cfg, jstate, jnp.asarray(arr))
        tstate, tst = TE.step(tcfg, tstate, torch.from_numpy(arr),
                              x=torch.from_numpy(x))
        _compare_stats(jst, tst, i)
        _compare_leaves(jstate, tstate, f"step {i}",
                        int8_codes=cfg.kv_quant == "int8")
        redirected += int(tst["redirected"])
    if expect is not None:
        assert (redirected, int(tst["offsite_pages"]),
                int(tst["log_commits"])) == expect


@pytest.mark.parametrize("shadow,homes,queued", [(3, [0, 0, 1], 0),
                                                 (1, [0], 2)])
def test_admit_attributes_every_borrower(shadow, homes, queued):
    """Two borrowers redirecting to one lender in one step: each shadow
    admission is homed at its own borrower, and what the shadow slots
    cannot take stays queued (tests/test_serving.py)."""
    cfg = E.EngineConfig(n_replicas=4, seq_slots=2, shadow_slots=shadow,
                         pages_per_replica=16, page=4, max_pages=4)
    jstate = E.init(cfg, jax.random.key(0))
    tcfg = port_cfg(cfg)
    tstate = TE.state_from_numpy(tcfg, jax.tree.map(np.asarray, jstate), "cpu")
    kept = np.zeros(4, np.int32)
    sent = np.zeros((4, 4), np.int32)
    sent[0, 3], sent[1, 3] = 2, 1
    want = E._admit(cfg, jstate, jnp.asarray(kept), jnp.asarray(sent))
    got = TE._admit(tcfg, tstate, torch.from_numpy(kept), torch.from_numpy(sent))
    _compare_leaves(want, got, "admit")
    assert got.home_of[3, 2:].tolist() == homes
    assert int(got.queue[3]) == queued


def test_run_steps_stacks_step_stats():
    cfg = port_cfg(CFG)
    arr = torch.tensor([[5, 0, 0, 0], [1, 2, 0, 0]], dtype=torch.int32)
    xs = torch.randn((3, 4, 6, 128), generator=torch.Generator().manual_seed(1))
    s1, stacked = TE.run_steps(cfg, TE.init(cfg, device="cpu"), arr, k=3, xs=xs)
    s2 = TE.init(cfg, device="cpu")
    for i in range(3):
        s2, st = TE.step(cfg, s2, arr[i % 2], x=xs[i])
        for key in st:
            torch.testing.assert_close(stacked[key][i], st[key], atol=0, rtol=0)
    assert int(s1.step_count) == 3
    torch.testing.assert_close(s1.pool.k, s2.pool.k, atol=0, rtol=0)


def test_runtime_layer_harvests_on_cpu():
    out = tserve.run_runtime_layer(4, steps=6, device="cpu")
    assert out["redirected"] > 0 and len(out["utils"]) == 4


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.init(port_cfg(CFG))


@pytest.mark.parametrize("later", [
    # the options earlier slices refused: the failure plane's, beside the
    # telemetry and observability planes and the hierarchy; they now build
    # and step as the reference does
    dict(trace_driven=True, track_failures=True), dict(track_failures=True),
    dict(migrate_pages_per_step=1),
    dict(obs=E.obs_m.ObsConfig(enabled=True), migrate_pages_per_step=2),
    dict(n_shards=2, trace_driven=True, track_failures=True),
    # the model zoo's whisper, refused until the enc-dec slice: it serves
    None,
])
def test_later_slice_configs_raise(later):
    if later is None:
        out = tserve.run_model("whisper-tiny", 2, 4, 3, smoke=True, device="cpu")
        assert tuple(out["tokens"].shape) == (2, 3)
        assert bool(torch.isfinite(out["logits"]).all())
        return
    cfg = CFG._replace(**later)
    jstate = E.init(cfg, jax.random.key(0))
    tcfg = port_cfg(cfg)
    tstate = TE.state_from_numpy(tcfg, jax.tree.map(np.asarray, jstate), "cpu")
    assert (tstate.dead is None) != cfg.track_failures
    assert (tstate.reclaim is None) != (cfg.migrate_pages_per_step > 0)
    for i in range(4):
        arr = np.asarray([5, 0, 0, 1], np.int32)
        x = _activations(cfg, i)
        jstate, jst = E.step(cfg, jstate, jnp.asarray(arr))
        tstate, tst = TE.step(tcfg, tstate, torch.from_numpy(arr),
                              x=torch.from_numpy(x))
        _compare_stats(jst, tst, i)
        _compare_leaves(jstate, tstate, f"step {i}")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", *sorted((ROOT / "scripts").glob("torch_*.py")),
              *sorted((ROOT / "scripts").glob("*_bench.py"))]
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "repro"), (path, mod)
