"""The engine's multi-rank step (`serving.engine.make_sharded_step`) on 2
and 4 gloo ranks on the CPU, against the JAX reference's `step` (its
shards under vmap) and against the port's single-process `step`, over
STEPS steps from the same state with the same activations.

The ranks (`torch_ranks.engine_worker`, spawned once per world size for
the whole module, no JAX imported) each step their block of the state
(`split_state`); the blocks join back to the canonical layout
(`join_states`). Configurations: tests/test_sharded.py::
TestShardMapParity's (16 replicas in 4 shards, link_pages_per_step=2,
trace_driven, cross_shard off and on; its obs-plane configuration), the
4-shard enclosure configuration with int8 pages and shards 1 and 2
memory-full (link allowance borrowed at both levels), and a 2-shard
metered fp32 one.

Tolerances: against the port's single-process step, integer stats and
integer and bool state bit for bit, float stats within STATS_RTOL and
float state within STATE_TOL (tests/test_sharded.py:399-408: sums across
ranks run in another order); against the JAX step, the port's own
tolerances of tests/test_torch_engine.py (`_compare_stats`,
`_compare_leaves`: int8 codes within one step)."""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as R
from repro.obs import metrics as jobs_m
from repro.serving import engine as E
from repro_torch.serving import engine as TE
from test_torch_engine import _activations, _compare_leaves, _compare_stats, port_cfg

jax.config.update("jax_platform_name", "cpu")

STEPS = 5
STATS_RTOL = 1e-5
STATE_TOL = 1e-6

SHARDMAP = dict(n_replicas=16, n_shards=4, link_pages_per_step=2,
                trace_driven=True)
SHARDMAP_ARRIVALS = [4, 2, 0, 0, 0, 3] + [0] * 10


def _pressured(lo, hi):
    """Replicas lo..hi-1 memory-full with two 16-token sequences each."""
    def prepare(state):
        pool = state.pool._replace(
            used=state.pool.used.at[lo:hi].set(True),
            seq_active=state.pool.seq_active.at[lo:hi, :2].set(True))
        return state._replace(
            pool=pool, remaining=state.remaining.at[lo:hi, :2].set(16))
    return prepare


# name: (config, arrivals, prepare, exchanges across shards)
CASES = {
    "shardmap_cross_off": (dict(SHARDMAP, cross_shard=False), SHARDMAP_ARRIVALS,
                           None, False),
    # TestShardMapParity's cross-shard and obs-plane configurations in one
    "shardmap_cross_on_obs": (dict(SHARDMAP, cross_shard=True,
                                   obs=jobs_m.ObsConfig(enabled=True, ring_depth=16,
                                                        event_capacity=256)),
                              SHARDMAP_ARRIVALS, None, True),
    "enclosure_int8": (dict(n_replicas=16, n_shards=4, seq_slots=2, shadow_slots=2,
                            shards_per_enclosure=2, link_pages_per_step=2,
                            kv_quant="int8"),
                       [6] * 4 + [0] * 12, _pressured(4, 12), True),
    "metered2": (dict(n_replicas=8, n_shards=2, seq_slots=2, shadow_slots=2,
                      pages_per_replica=8, max_pages=8, link_pages_per_step=1),
                 [5, 5, 5, 5, 0, 0, 0, 0], None, True),
}


def _inputs(name):
    kw, arrivals, prepare, _ = CASES[name]
    cfg = E.EngineConfig(**kw)
    jstate = E.init(cfg, jax.random.key(0))
    if prepare is not None:
        jstate = prepare(jstate)
    tcfg = port_cfg(cfg)
    tstate = TE.state_from_numpy(tcfg, jax.tree.map(np.asarray, jstate), "cpu")
    xs = [_activations(cfg, i).astype(np.float32) for i in range(STEPS)]
    return cfg, jstate, tcfg, tstate, np.asarray(arrivals, np.int32), xs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through the ranks (both world sizes started at once),
    the JAX step and the port's single-process step."""
    inputs = {name: _inputs(name) for name in CASES}
    started = {}
    for world in (2, 4):
        names = [n for n in CASES if CASES[n][0]["n_shards"] == world]
        cases = [(inputs[n][2], R.to_numpy(inputs[n][3]), inputs[n][4], inputs[n][5])
                 for n in names]
        store = str(tmp_path_factory.mktemp(f"engine{world}") / "store")
        started[world] = (names, R.Ranks(R.engine_worker, world, store, cases))
    out = {}
    for name, (cfg, jstate, tcfg, tstate, arrivals, xs) in inputs.items():
        jstats, tstats = [], []
        for i in range(STEPS):
            jstate, jst = E.step(cfg, jstate, jnp.asarray(arrivals))
            tstate, tst = TE.step(tcfg, tstate, torch.from_numpy(arrivals),
                                  x=torch.from_numpy(xs[i]))
            jstats.append(jst)
            tstats.append(tst)
        out[name] = dict(cfg=cfg, tcfg=tcfg, jstate=jstate, jstats=jstats,
                         tstate=tstate, tstats=tstats)
    for world, (names, ranks) in started.items():
        ranks_out = ranks.results()
        for i, per_rank in enumerate(zip(*ranks_out)):
            blocks = [R.to_torch(block) for block, _ in per_rank]
            out[names[i]].update(
                rank_state=TE.join_states(out[names[i]]["tcfg"], blocks),
                rank_stats=[stats for _, stats in per_rank])
    return out


def _compare_port(a, b, where):
    """Port state ``b`` against port state ``a``: ints and bools equal,
    floats within STATE_TOL (the K/V planes without the scratch page)."""
    if a is None:
        assert b is None, where
        return
    if isinstance(a, dict) or hasattr(a, "_fields"):
        items = a.items() if isinstance(a, dict) else zip(a._fields, a)
        for k, v in items:
            _compare_port(v, b[k] if isinstance(b, dict) else getattr(b, k),
                          f"{where}.{k}")
        return
    if where.endswith((".k", ".v")):
        a, b = a[:-1], b[:-1]
    assert a.shape == b.shape and a.dtype == b.dtype, (where, a.shape, b.shape)
    if a.dtype.is_floating_point:
        torch.testing.assert_close(b, a, rtol=STATE_TOL, atol=STATE_TOL, msg=where)
    else:
        assert torch.equal(a, b), where


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_match_port_step(runs, name):
    r = runs[name]
    for rank_stats in r["rank_stats"]:
        for i, (want, got) in enumerate(zip(r["tstats"], rank_stats)):
            assert sorted(want) == sorted(got)
            for k, w in want.items():
                w, g = w.numpy(), got[k]
                assert w.shape == g.shape and w.dtype == g.dtype, (i, k)
                if w.dtype.kind in "biu":
                    np.testing.assert_array_equal(g, w, err_msg=f"step {i} {k}")
                else:
                    np.testing.assert_allclose(g, w, rtol=STATS_RTOL, atol=1e-6,
                                               err_msg=f"step {i} {k}")
    _compare_port(r["tstate"], r["rank_state"], name)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_match_jax_step(runs, name):
    r = runs[name]
    for i, (jst, got) in enumerate(zip(r["jstats"], r["rank_stats"][0])):
        _compare_stats(jst, {k: torch.from_numpy(v) for k, v in got.items()}, i)
    _compare_leaves(r["jstate"], r["rank_state"], name,
                    int8_codes=r["cfg"].kv_quant == "int8")


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_agree_and_exchange(runs, name):
    """Every rank returns the same global stats, bit for bit; the cases
    with the exchange on move requests or link bytes across shards."""
    r = runs[name]
    first = r["rank_stats"][0]
    for other in r["rank_stats"][1:]:
        for a, b in zip(first, other):
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    crossed = sum(float(s["cross_redirected"]) + float(s["cross_link_borrowed_bytes"])
                  for s in first)
    assert (crossed > 0) == CASES[name][3], crossed


def test_obs_plane_holds_every_shards_rows(runs):
    """The joined obs plane: every shard's rings advanced, and exchange
    grants (level >= 1) in the event log, as the single-process step's."""
    r = runs["shardmap_cross_on_obs"]
    got, _ = TE.obs_events(r["rank_state"])
    want, _ = TE.obs_events(r["tstate"])
    assert got == want and any(rec["level"] >= 1 for rec in got)
    assert r["rank_state"].obs.metrics.cursor.tolist() == [STEPS] * 4


def test_refuses_one_shard():
    with pytest.raises(ValueError, match="n_shards >= 2"):
        TE.make_sharded_step(TE.EngineConfig(n_replicas=4, n_shards=1))


@pytest.mark.parametrize("name", ["enclosure_int8", "shardmap_cross_on_obs"])
def test_split_then_join_is_the_state(name):
    _, _, tcfg, tstate, _, _ = _inputs(name)
    blocks = [TE.split_state(tcfg, tstate, s) for s in range(tcfg.n_shards)]
    assert all(b.queue.shape == (TE.local_replicas(tcfg),) for b in blocks)
    assert all(b.pool.logs.commits.shape == (1,) for b in blocks)
    joined = TE.join_states(tcfg, blocks)
    _compare_port(tstate, joined, name)
    with pytest.raises(ValueError):
        TE.split_state(tcfg, tstate, tcfg.n_shards)


def test_rank_workers_import_no_jax():
    tree = ast.parse((pathlib.Path(__file__).parent / "torch_ranks.py").read_text())
    mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    assert not {m.split(".")[0] for m in mods} & {"jax", "jaxlib", "repro"}, mods
