"""The engine's telemetry and observability planes on the port against the
JAX reference, on the CPU: `repro_torch.serving.engine.step` with
``trace_driven`` and ``obs.enabled`` against `repro.serving.engine.step`
step by step, from the same state (`state_from_numpy`) and the reference's
own decode activations. Integer and bool state and stats are bit-equal
every step (the SHARDS table and clock, the obs cursor, the event log's
count and its rows' integer columns included); the SHARDS float leaves and
``want_pages`` are bit-equal too; every other float leaf is within the
tolerance of `test_torch_engine` (1e-5 for state, 1e-4 relative for
stats), since the decode products differ from XLA's in the last bits.

Configurations: tests/test_serving.py's trace-driven pair, the
``metered4`` config of tests/test_sharded.py (trace-driven, 4 shards),
tests/test_obs.py's `TestEngineObs.CFG` (ring wrap), the config of
tests/test_sharded.py's `test_obs_plane_matches_vmap`, and both planes on
2 shards with an event log that overflows. Then the properties: obs off
leaves no obs leaves, and obs on changes no engine output."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import metrics as jobs
from repro.serving import engine as E
from repro_torch.obs import spans as tspans
from repro_torch.serving import engine as TE
from test_torch_engine import _compare_leaves, _compare_stats, port_cfg

jax.config.update("jax_platform_name", "cpu")

# the integer columns of an event row: t, event, rtype, level, lender,
# borrower; amount and price are floats
INT_COLS = [tspans.FIELDS.index(f) for f in
            ("t", "event", "rtype", "level", "lender", "borrower")]
FLOAT_COLS = [tspans.FIELDS.index(f) for f in ("amount", "price")]


def _activations(cfg, i):
    """The reference step's decode activations for step_count i; under its
    vmap every shard draws the same [nl, St, d] tensor."""
    nl = cfg.n_replicas // cfg.n_shards
    shape = (nl, cfg.seq_slots + cfg.shadow_slots, cfg.n_heads * cfg.head_dim)
    key = jax.random.fold_in(jax.random.key(7), jnp.int32(i))
    x = np.array(jax.random.normal(key, shape) * 0.1)
    return np.tile(x, (cfg.n_shards, 1, 1))


def _arr(n, hot):
    a = np.zeros(n, np.int32)
    for i, v in hot:
        a[i] = v
    return a


SERVING = dict(n_replicas=4, seq_slots=4, shadow_slots=2, pages_per_replica=32,
               page=8, max_pages=8)
OBS_CFG = dict(n_replicas=8, n_shards=2, seq_slots=2, shadow_slots=2,
               link_pages_per_step=2, cross_shard=True)
CASES = {
    # name: (config, arrivals, steps)
    "serving_trace": (dict(SERVING, trace_driven=True), [3, 3, 0, 0], 10),
    "serving_default": (SERVING, [2, 2, 1, 1], 6),
    "metered4": (dict(n_replicas=16, n_shards=4, link_pages_per_step=2,
                      trace_driven=True, cross_shard=True),
                 _arr(16, ((0, 4), (1, 2), (5, 3))), 5),
    "engine_obs": (dict(OBS_CFG, obs=jobs.ObsConfig(
        enabled=True, ring_depth=4, event_capacity=512)), [5, 5, 5, 5, 0, 0, 0, 0], 9),
    "obs_plane_vmap": (dict(n_replicas=16, n_shards=4, link_pages_per_step=2,
                            cross_shard=True,
                            obs=jobs.ObsConfig(enabled=True, ring_depth=16,
                                               event_capacity=256)),
                       _arr(16, ((0, 4), (1, 2), (5, 3))), 5),
    # both planes, 2 shards, a log too small for the run (overflow)
    "both_2shard": (dict(n_replicas=8, n_shards=2, seq_slots=3, shadow_slots=2,
                         pages_per_replica=16, page=4, max_pages=6,
                         link_pages_per_step=1, trace_driven=True,
                         obs=jobs.ObsConfig(enabled=True, ring_depth=4,
                                            event_capacity=24)),
                    [4, 3, 0, 0, 3, 0, 0, 0], 8),
}


def _check_planes(jstate, tstate, where):
    """What must be bit-equal beyond `_compare_leaves`: the SHARDS float
    leaves, and the event log's integer columns."""
    if tstate.mrc is not None:
        for f in ("hist", "cold", "total"):
            np.testing.assert_array_equal(getattr(tstate.mrc, f).numpy(),
                                          np.asarray(getattr(jstate.mrc, f)),
                                          err_msg=f"{where} mrc.{f}")
    if tstate.obs is not None:
        jb = np.asarray(jstate.obs.events.buf)
        tb = tstate.obs.events.buf.numpy()
        np.testing.assert_array_equal(tb[..., INT_COLS], jb[..., INT_COLS],
                                      err_msg=f"{where} events (integer columns)")
        np.testing.assert_allclose(tb[..., FLOAT_COLS], jb[..., FLOAT_COLS],
                                   rtol=1e-5, atol=1e-5, err_msg=f"{where} events")


def _run_pair(name):
    kw, arrivals, steps = CASES[name]
    cfg = E.EngineConfig(**kw)
    tcfg = port_cfg(cfg)
    jstate = E.init(cfg, jax.random.key(0))
    tstate = TE.state_from_numpy(tcfg, jax.tree.map(np.asarray, jstate), "cpu")
    _compare_leaves(jstate, tstate, "init")
    arr = np.asarray(arrivals, np.int32)
    hist = []
    for i in range(steps):
        jstate, jst = E.step(cfg, jstate, jnp.asarray(arr))
        tstate, tst = TE.step(tcfg, tstate, torch.from_numpy(arr),
                              x=torch.from_numpy(_activations(cfg, i)))
        _compare_stats(jst, tst, i)
        np.testing.assert_array_equal(tst["want_pages"].numpy(),
                                      np.asarray(jst["want_pages"]),
                                      err_msg=f"step {i} want_pages")
        _compare_leaves(jstate, tstate, f"step {i}")
        _check_planes(jstate, tstate, f"step {i}")
        hist.append({k: v.numpy() for k, v in tst.items()})
    return cfg, jstate, tstate, hist


@pytest.mark.parametrize("name", list(CASES))
def test_step_matches_reference(name):
    cfg, jstate, tstate, hist = _run_pair(name)
    if cfg.trace_driven:
        assert tstate.mrc.addrs.dtype == torch.int64
        assert float(tstate.mrc.hist.sum()) > 0     # reuse reached the curve
        loaded = [i for i, a in enumerate(CASES[name][1]) if a > 0]
        assert (hist[-1]["want_pages"][loaded] > 0).any()
    else:
        assert tstate.mrc is None
        assert all(float(h["want_pages"].sum()) == 0.0 for h in hist)
    if cfg.obs.enabled:
        jh, th = E.obs_history(jstate), TE.obs_history(tstate)
        assert sorted(jh) == sorted(th)
        for k in jh:
            assert jh[k].shape == th[k].shape, k
            np.testing.assert_allclose(th[k], jh[k], rtol=1e-4, atol=1e-5, err_msg=k)
        jt, tt = E.obs_totals(jstate), TE.obs_totals(tstate)
        for k in jt:
            np.testing.assert_allclose(tt[k], jt[k], rtol=1e-4, atol=1e-5, err_msg=k)
        (jrec, jdrop), (trec, tdrop) = E.obs_events(jstate), TE.obs_events(tstate)
        assert tdrop == jdrop and len(trec) == len(jrec)
        for a, b in zip(trec, jrec):
            for f in ("t", "event", "rtype", "level", "lender", "borrower", "lane"):
                assert a[f] == b[f], (f, a, b)
            assert a["amount"] == pytest.approx(b["amount"], rel=1e-5, abs=1e-5)
            assert a["price"] == pytest.approx(b["price"], rel=1e-6)
        assert len(trec) > 0
        if cfg.n_shards > 1 and cfg.cross_shard:
            assert any(r["level"] >= 1 for r in trec)
        if name == "both_2shard":
            assert tdrop > 0        # the log overflowed; count kept the total
    else:
        assert tstate.obs is None


def _port_run(cfg, arrivals, steps, seed=0):
    state = TE.init(cfg, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    d = cfg.n_heads * cfg.head_dim
    out = []
    for _ in range(steps):
        x = torch.randn((cfg.n_replicas, TE.total_slots(cfg), d), generator=gen) * 0.1
        state, st = TE.step(cfg, state, torch.as_tensor(arrivals), x=x)
        out.append(st)
    return state, out


def test_obs_off_leaves_no_obs_leaves():
    cfg = TE.EngineConfig(**OBS_CFG, trace_driven=True)
    state, _ = _port_run(cfg, [5, 5, 5, 5, 0, 0, 0, 0], 3)
    assert state.obs is None
    assert TE.obs_history(state) == {} and TE.obs_totals(state) == {}
    assert TE.obs_events(state) == ([], 0)


@pytest.mark.parametrize("trace", [False, True])
def test_obs_enabled_changes_no_engine_output(trace):
    base = TE.EngineConfig(**OBS_CFG, trace_driven=trace)
    on = base._replace(obs=TE.obs_m.ObsConfig(enabled=True, ring_depth=8,
                                              event_capacity=512))
    arr = [5, 5, 5, 5, 0, 0, 0, 0]
    s_off, h_off = _port_run(base, arr, 7)
    s_on, h_on = _port_run(on, arr, 7)
    for a, b in zip(h_off, h_on):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for f in TE.EngineState._fields:
        if f == "obs":
            continue
        for x, y in zip(jax.tree.leaves(TE._tree_map(lambda t: t, getattr(s_off, f))),
                        jax.tree.leaves(TE._tree_map(lambda t: t, getattr(s_on, f)))):
            assert torch.equal(x, y), f
    assert int(s_on.obs.metrics.cursor[0]) == 7
    assert int(s_on.obs.events.count.sum()) > 0
