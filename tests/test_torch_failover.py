"""The failure, migration and reclaim plane of the port against the JAX
reference, on the CPU.

- `wal.commit` and `clear_segment`, flushes included, with and without
  leading axes;
- the pool's scalar API (`alloc_page`, `append_token`, `release_sequence`),
  `lender_failure` and `drain_offsite` on pools carried from the
  reference, fp32 and int8, ``second_mask`` set or None, budgets of 0, 1
  and more than the pages held;
- `manager.revoke_nodes` on hypothesis tables, with and without leading
  axes, and its idempotence;
- the engine step with ``track_failures`` and live migration on 1 and 2
  shards (lender pools pinned between steps, a replica failed on one
  shard): integer and bool state bit-equal every step, floats within the
  engine tests' tolerance;
- `scenarios.drive_events` against the reference's for baseline,
  ``ssd_fail``, ``ssd_hot_remove``, ``lender_reclaim`` and
  ``enclosure_drop``, and fig. 23's table
  (benchmarks/baselines/fig23_failover.json);
- the pool's invariants (tests/test_conservation.py `_check_pool`) every
  step of a hypothesis-drawn crash, and `fail_replica` refusing
  ``n_shards > 1`` with a message naming the reference's fault.

Integer state is compared bit for bit; fp32 K/V to 1e-6, int8 codes to
one code step and scales to 1e-6 relative (the token rows come from float
products whose last bits differ between XLA and PyTorch)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import descriptors as JD
from repro.core import events as JEV
from repro.core import manager as JM
from repro.core import wal as JW
from repro.serving import engine as E
from repro.serving import kv_pool as JK
from repro.serving import scenarios as JS
from repro_torch.core import descriptors as TD
from repro_torch.core import events as TEV
from repro_torch.core import manager as TM
from repro_torch.core import wal as TW
from repro_torch.serving import engine as TE
from repro_torch.serving import kv_pool as TK
from repro_torch.serving import scenarios as TS
from test_torch_engine import _activations, _compare_leaves, _compare_stats, port_cfg

jax.config.update("jax_platform_name", "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))    # a writable copy


def _same(got, want, where):
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=f"{where}.{name}")


# ------------------------------------------------------------------- WAL
_commit = jax.jit(JW.commit)
_clear = jax.jit(JW.clear_segment)


@pytest.mark.parametrize("epp", [3, 512])
def test_wal_commit_and_clear_bit_equal(epp):
    rng = np.random.default_rng(epp)
    jlog = JW.make_log(5, entries_per_page=epp)
    tlog = TW.make_log(5, entries_per_page=epp, device="cpu")
    for i in range(40):
        seg, key, val = (int(x) for x in rng.integers(0, 5, 3))
        en = bool(rng.random() < 0.8)
        jlog = _commit(jlog, jnp.int32(seg), jnp.int32(key + i), jnp.int32(val),
                       jnp.asarray(en))
        tlog = TW.commit(tlog, seg, torch.tensor(key + i), val, enable=en)
        _same(tlog, jlog, f"commit {i}")
        if i % 13 == 12:
            jlog, tlog = _clear(jlog, jnp.int32(seg)), TW.clear_segment(tlog, seg)
            _same(tlog, jlog, f"clear {i}")
    if epp == 3:
        assert int(tlog.flushes) > 0


def test_wal_commit_with_leading_axes_is_one_log_each():
    """A log [S, nseg, epp] takes one entry per log; each equals the
    reference's log on its own."""
    rng = np.random.default_rng(1)
    jlogs = [JW.make_log(4, entries_per_page=3) for _ in range(2)]
    tlog = TW.make_log(4, entries_per_page=3, device="cpu")
    tlog = TW.LogPages(*(torch.stack([x, x]) for x in tlog))
    for i in range(20):
        seg = rng.integers(0, 4, 2)
        en = rng.random(2) < 0.7
        jlogs = [_commit(lg, jnp.int32(seg[s]), jnp.int32(i), jnp.int32(7 * i + s),
                         jnp.asarray(en[s])) for s, lg in enumerate(jlogs)]
        tlog = TW.commit(tlog, _t(seg), i, _t(7 * i + np.arange(2)), enable=_t(en))
        for s in range(2):
            _same(TW.LogPages(*(x[s] for x in tlog)), jlogs[s], f"log {s} step {i}")
    tlog = TW.clear_segment(tlog, _t(np.array([1, 3])))
    jlogs = [_clear(jlogs[0], jnp.int32(1)), _clear(jlogs[1], jnp.int32(3))]
    for s in range(2):
        _same(TW.LogPages(*(x[s] for x in tlog)), jlogs[s], f"cleared log {s}")


# ------------------------------------------------------------------ pool
R, P, PAGE, KV, DH, S, MP = 4, 6, 4, 2, 8, 3, 4
_append = jax.jit(JK.append_tokens)
_alloc = jax.jit(JK.alloc_page)
_append1 = jax.jit(JK.append_token)
_release1 = jax.jit(JK.release_sequence)
_drain = jax.jit(JK.drain_offsite)
_drain_one = jax.jit(lambda pool, m, b: JK.drain_offsite(pool, m, b))
_fail = jax.jit(JK.lender_failure)


def _carry(jpool):
    """The port's pool holding a reference pool's values."""
    quant = "int8" if jpool.k.dtype == jnp.int8 else "none"
    tpool = TK.make_pool(R, P, PAGE, KV, DH, S, MP, dtype=torch.float32,
                         quant=quant, device="cpu")
    planes = {f: torch.cat([_t(getattr(jpool, f)).reshape(getattr(tpool, f)[:-1].shape),
                            getattr(tpool, f)[-1:]]) for f in ("k", "v")}
    return tpool._replace(
        logs=TW.LogPages(*(_t(x) for x in jpool.logs)), **planes,
        **{f: _t(getattr(jpool, f)) for f in TK._META})


def _assert_pool(tpool, jpool, where):
    for name in ("used", "owner_seq", "page_table", "seq_len", "seq_active"):
        np.testing.assert_array_equal(getattr(tpool, name).numpy(),
                                      np.asarray(getattr(jpool, name)),
                                      err_msg=f"{where}.{name}")
    _same(tpool.logs, jpool.logs, f"{where}.logs")
    for name in ("k", "v"):
        got = getattr(tpool, name)[:-1].reshape(getattr(jpool, name).shape).numpy()
        want = np.asarray(getattr(jpool, name))
        if want.dtype == np.int8:
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, (where, name)
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, err_msg=f"{where}.{name}")
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(tpool, name).numpy(),
                                   np.asarray(getattr(jpool, name)), rtol=1e-6,
                                   err_msg=f"{where}.{name}")


def _spilled_pool(quant, seed):
    """A reference pool whose replicas 0 and 1 ran out of pages and spilled
    onto 2 and 3 (every slot of 0 and 1 active for 11 tokens)."""
    jpool = JK.make_pool(R, P, PAGE, KV, DH, S, MP, dtype=jnp.float32, quant=quant)
    rng = np.random.default_rng(seed)
    active = np.zeros((R, S), bool)
    active[:2] = True
    jpool = jpool._replace(seq_active=jnp.asarray(active))
    lenders = jnp.asarray([False, False, True, True])
    for _ in range(11):
        kt = jnp.asarray(rng.normal(size=(R, S, KV, DH)), jnp.float32)
        vt = jnp.asarray(rng.normal(size=(R, S, KV, DH)), jnp.float32)
        jpool, _ = _append(jpool, kt, vt, jnp.asarray(active), lenders)
    assert int(np.asarray(JK.offsite_pages(jpool)).sum()) >= 4
    return jpool


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_scalar_api_bit_equal(quant):
    """`alloc_page` / `append_token` / `release_sequence`, one call at a
    time, from an empty pool past the home pools' size (offsite pages,
    their WAL commits, a full pool denying a page)."""
    jpool = JK.make_pool(R, P, PAGE, KV, DH, S, MP, dtype=jnp.float32, quant=quant)
    tpool = _carry(jpool)
    rng = np.random.default_rng(3)
    lenders = np.array([False, True, True, False])
    jpool, jphys = _alloc(jpool, jnp.int32(3), jnp.int32(1), jnp.asarray(lenders))
    tpool, tphys = TK.alloc_page(tpool, 3, 1, _t(lenders))
    assert int(tphys) == int(jphys)
    _assert_pool(tpool, jpool, "alloc")
    for i in range(70):
        home, slot = int(rng.integers(0, 2)), int(rng.integers(0, S))
        kt = rng.normal(size=(KV, DH)).astype(np.float32)
        vt = rng.normal(size=(KV, DH)).astype(np.float32)
        jpool = _append1(jpool, jnp.int32(home), jnp.int32(slot), jnp.asarray(kt),
                         jnp.asarray(vt), jnp.asarray(lenders))
        tpool = TK.append_token(tpool, home, slot, _t(kt), _t(vt), _t(lenders))
        _assert_pool(tpool, jpool, f"append {i}")
        if i % 23 == 22:
            jpool = _release1(jpool, jnp.int32(home), jnp.int32(slot))
            tpool = TK.release_sequence(tpool, home, slot)
            _assert_pool(tpool, jpool, f"release {i}")
    assert int(np.asarray(jpool.logs.commits)) > 0
    # every page taken: the next page boundary is denied
    full = jpool._replace(used=jnp.ones_like(jpool.used))
    _, jphys = _alloc(full, jnp.int32(0), jnp.int32(0), jnp.asarray(lenders))
    _, tphys = TK.alloc_page(tpool._replace(used=torch.ones_like(tpool.used)), 0, 0,
                             _t(lenders))
    assert int(tphys) == int(jphys) == -1


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("failed", range(R))
def test_lender_failure_bit_equal(quant, failed):
    jpool = _spilled_pool(quant, failed)
    got = TK.lender_failure(_carry(jpool), failed)
    _assert_pool(got, _fail(jpool, jnp.int32(failed)), f"fail {failed}")


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("budget", [0, 1, 9])
@pytest.mark.parametrize("second", [None, "calm", "busy_home"])
def test_drain_offsite_bit_equal(quant, budget, second):
    """Drain lender 2 (pass A home when the home pool has room, pass B to
    replica 3), budgets of none, one page and more than held."""
    jpool = _spilled_pool(quant, budget)
    if second == "busy_home":
        # the homes' pools stay full: every move goes lender to lender
        jpool = jpool._replace(used=jpool.used.at[:2].set(True))
    else:
        # free a few home pages so pass A has somewhere to go
        jpool = _release1(jpool, jnp.int32(0), jnp.int32(0))
    src = jnp.asarray([False, False, True, False])
    bud = jnp.full((R,), budget, jnp.int32)
    tpool = _carry(jpool)
    if second is None:
        jout, jmoved = _drain_one(jpool, src, bud)
        tout, tmoved = TK.drain_offsite(tpool, _t(src), _t(bud))
    else:
        mask = jnp.asarray([True, False, False, True])
        jout, jmoved = _drain(jpool, src, bud, mask)
        tout, tmoved = TK.drain_offsite(tpool, _t(src), _t(bud), _t(mask))
    np.testing.assert_array_equal(tmoved.numpy(), np.asarray(jmoved))
    assert tmoved.dtype == torch.int32
    _assert_pool(tout, jout, "drain")
    held = int(np.asarray(JK.offsite_pages(jpool)).sum())
    if budget and held:
        assert int(tmoved.sum()) > 0


def test_drain_offsite_with_shard_axis_is_each_shard_alone():
    """Two shards' pools stacked ([2, R, ...], planes flat by global page
    id) drain as each does alone."""
    pools = [_spilled_pool("none", s) for s in (5, 6)]
    src = np.array([[False, False, True, False], [False, False, False, True]])
    bud = np.array([[2, 9, 0, 0], [1, 1, 1, 1]], np.int32)
    mask = np.array([[True, False, False, True], [False, False, True, False]])
    want = [_drain(p, jnp.asarray(src[s]), jnp.asarray(bud[s]), jnp.asarray(mask[s]))
            for s, p in enumerate(pools)]
    carried = [_carry(p) for p in pools]
    stacked = carried[0]._replace(
        k=torch.cat([c.k[:-1] for c in carried] + [carried[0].k[-1:]]),
        v=torch.cat([c.v[:-1] for c in carried] + [carried[0].v[-1:]]),
        logs=TW.LogPages(*(torch.stack(x) for x in zip(*(c.logs for c in carried)))),
        **{f: torch.stack([getattr(c, f) for c in carried]) for f in TK._META})
    out, moved = TK.drain_offsite(stacked, _t(src), _t(bud), _t(mask))
    for s in range(2):
        np.testing.assert_array_equal(moved[s].numpy(), np.asarray(want[s][1]))
        one = out._replace(
            k=torch.cat([out.k[s * R * P:(s + 1) * R * P], out.k[-1:]]),
            v=torch.cat([out.v[s * R * P:(s + 1) * R * P], out.v[-1:]]),
            logs=TW.LogPages(*(x[s] for x in out.logs)),
            **{f: getattr(out, f)[s] for f in TK._META})
        _assert_pool(one, want[s][0], f"shard {s}")


# --------------------------------------------------------------- revoke
_revoke = jax.jit(JM.revoke_nodes)


def _table(rng, n, s):
    valid = rng.random((n, s)) < 0.6
    bid = np.where(rng.random((n, s)) < 0.5, rng.integers(0, n, (n, s)), JD.FREE)
    return JD.IdleResourceTable(
        valid=jnp.asarray(valid), rtype=jnp.asarray(rng.integers(0, 3, (n, s)), jnp.int8),
        borrower_id=jnp.asarray(bid, jnp.int32),
        amount_a=jnp.asarray(rng.random((n, s)), jnp.float32),
        amount_b=jnp.asarray(rng.random((n, s)), jnp.float32),
        info_a=jnp.zeros((n, s), jnp.int32), info_b=jnp.zeros((n, s), jnp.int32))


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.sampled_from([3, 8]),
       lead=st.sampled_from([0, 1, 3]))
def test_revoke_nodes_bit_equal(seed, n, lead):
    rng = np.random.default_rng(seed)
    tables = [_table(rng, n, 3) for _ in range(max(lead, 1))]
    deads = rng.random((max(lead, 1), n)) < 0.3
    want = [_revoke(t, jnp.asarray(d)) for t, d in zip(tables, deads)]
    if lead:
        ttable = TD.IdleResourceTable(*(torch.stack([_t(x) for x in xs])
                                        for xs in zip(*tables)))
        got, count = TM.revoke_nodes(ttable, _t(deads))
        got = [TD.IdleResourceTable(*(x[i] for x in got)) for i in range(lead)]
        counts = count
    else:
        one, counts = TM.revoke_nodes(TD.IdleResourceTable(*map(_t, tables[0])),
                                      _t(deads[0]))
        got, counts = [one], counts[None]
    assert counts.dtype == torch.int32
    for i, (wt, wc) in enumerate(want):
        _same(got[i], wt, f"table {i}")
        assert int(counts[i]) == int(wc)
    # idempotent: re-revoking the dead counts zero and changes nothing
    again, zero = TM.revoke_nodes(TD.IdleResourceTable(*map(_t, want[0][0])),
                                  _t(deads[0]))
    assert int(zero) == 0
    _same(again, want[0][0], "again")


# --------------------------------------------------------------- engine
def _pin(state, rows, xp):
    """Take the 3 lowest free pages of each of ``rows`` (a lender's own load
    returning, as `drive_events` ramps it), in either package."""
    used = np.array(state.pool.used)
    for r in rows:
        used[r, np.nonzero(~used[r])[0][:3]] = True
    return state._replace(pool=state.pool._replace(used=xp(used)))


ENGINE_RUNS = {
    # name: (config overrides, the lenders pinned at steps 13 and 14, when
    #        the borrowers' pages have spilled onto them; the replica failed
    #        at step 15 or None)
    "shards1": (dict(), (2,), 2),
    "shards1_int8_unmetered": (dict(kv_quant="int8", link_pages_per_step=0),
                               (3,), 3),
    "shards2": (dict(n_replicas=8, n_shards=2, cross_shard=False), (2, 7), None),
    "shards2_cross_int8": (dict(n_replicas=8, n_shards=2, kv_quant="int8"),
                           (3, 6), None),
}


@pytest.mark.parametrize("name", list(ENGINE_RUNS))
def test_engine_with_failures_and_migration_matches_reference(name):
    """track_failures and migration on: the predictor sees the pinned
    lenders' pressure rise and drains their pages (WAL-logged moves), then
    a replica dies; every step's stats and state against the reference."""
    over, pinned, failed = ENGINE_RUNS[name]
    base, _ = JS.failover_scenario(migrate=3)
    cfg = base._replace(**over, obs=E.obs_m.ObsConfig(enabled=True, ring_depth=32,
                                                      event_capacity=256))
    jstate = E.init(cfg, jax.random.key(0))
    tcfg = port_cfg(cfg)
    tstate = TE.state_from_numpy(tcfg, jax.tree.map(np.asarray, jstate), "cpu")
    for i in range(20):
        if i == 15 and failed is not None:
            jstate, jrep = E.fail_replica(cfg, jstate, failed)
            tstate, trep = TE.fail_replica(tcfg, tstate, failed)
            assert tuple(trep) == tuple(jrep)
            _compare_leaves(jstate, tstate, f"fail {i}", int8_codes=True)
        if i in (13, 14):
            jstate = _pin(jstate, pinned, jnp.asarray)
            tstate = _pin(tstate, pinned, torch.from_numpy)
        arr = np.zeros(cfg.n_replicas, np.int32)
        if i in (0, 2):
            arr[[0, 1]] = 3
            if cfg.n_shards > 1:
                arr[[4, 5]] = 3
        jstate, jst = E.step(cfg, jstate, jnp.asarray(arr))
        tstate, tst = TE.step(tcfg, tstate, torch.from_numpy(arr),
                              x=torch.from_numpy(_activations(cfg, i)))
        _compare_stats(jst, tst, i)
        _compare_leaves(jstate, tstate, f"step {i}", int8_codes=True)
    migrated = int(TE.obs_totals(tstate)["migrated_pages"].sum())
    assert migrated == int(np.asarray(E.obs_totals(jstate)["migrated_pages"]).sum())
    assert migrated > 0


def test_fail_replica_refuses_shards():
    cfg = TE.EngineConfig(n_replicas=8, n_shards=2, track_failures=True)
    state = TE.init(cfg, device="cpu")
    with pytest.raises(ValueError, match="global replica id") as err:
        TE.fail_replica(cfg, state, 3)
    assert "engine.py:358-359" in str(err.value) and "kv_pool.py:608-609" in str(err.value)
    with pytest.raises(ValueError, match="global replica id"):
        TS.drive_events(cfg, state, TEV.schedule(TEV.ssd_fail(1, 3)),
                        lambda t: np.zeros(8, np.int64), 3, settle=0)
    with pytest.raises(ValueError, match="track_failures"):
        TE.fail_replica(TE.EngineConfig(), TE.init(TE.EngineConfig(), device="cpu"), 0)


# ------------------------------------------------------------- scenarios
def _arrivals(t):
    """fig. 23's arrivals (benchmarks/fig23_failover.py:70-78)."""
    a = np.zeros(4, np.int64)
    if t in (0, 2):
        a[0] = a[1] = 3
    return a


SCHEDULES = {
    # name: (migrate, obs, events of the schedule, reclaim_lead)
    "baseline": (0, False, [], 8),
    "unpredicted": (0, False, [("ssd_fail", 15, 2)], 8),
    "predicted": (4, True, [("ssd_hot_remove", 15, 2)], 2),
    "lender_reclaim": (4, True, [("lender_reclaim", 10, 2, 6), ("ssd_fail", 18, 3)], 8),
    "enclosure_drop": (0, False, [("enclosure_drop", 14, 0)], 8),
}
# benchmarks/baselines/fig23_failover.json: completed, lost_sequences,
# lost_tokens, requeued, revoked, seq_steps, migrated_pages
FIG23 = {"baseline": (12, 0, 0, 0, 0, 180, 0), "unpredicted": (12, 0, 18, 1, 2, 210, 0),
         "predicted": (12, 0, 6, 1, 1, 198, 4)}


def _sched(mod, events, lead):
    return mod.schedule(*(getattr(mod, kind)(*args) for kind, *args in events),
                        reclaim_lead=lead)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, (migrate, obs, events, lead) in SCHEDULES.items():
        cfg, st = JS.failover_scenario(migrate=migrate, obs=obs)
        want = JS.drive_events(cfg, st, _sched(JEV, events, lead), _arrivals, 30)
        cfg, st = TS.failover_scenario(migrate=migrate, obs=obs, device="cpu")
        got = TS.drive_events(cfg, st, _sched(TEV, events, lead), _arrivals, 30)
        out[name] = (got, want)
    return out


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_drive_events_matches_reference(runs, name):
    got, want = runs[name]
    assert got._fields == want._fields
    assert tuple(got) == tuple(want)
    assert got.lost_sequences == 0 and got.drained


def test_fig23_table_and_spikes(runs):
    for name, row in FIG23.items():
        r = runs[name][0]
        assert (r.completed, r.lost_sequences, r.lost_tokens, r.requeued, r.revoked,
                r.seq_steps, r.migrated_pages) == row, name
    base = runs["baseline"][0].seq_steps
    assert runs["unpredicted"][0].seq_steps - base == 30
    assert runs["predicted"][0].seq_steps - base == 18
    # the enclosure drop fails every replica of the one shard
    assert runs["enclosure_drop"][0].aborted + runs["enclosure_drop"][0].completed == 12


def _check_pool(cfg, pool):
    """tests/test_conservation.py `_check_pool` on the port's pool."""
    used, owner = pool.used.numpy(), pool.owner_seq.numpy()
    pt, sl, sa = pool.page_table.numpy(), pool.seq_len.numpy(), pool.seq_active.numpy()
    r, p = used.shape
    phys = pt[pt >= 0]
    # no aliasing: a physical page appears in at most one table slot
    assert len(phys) == len(np.unique(phys))
    # referenced <=> used-and-owned, exactly (no leak, no double free)
    ref = np.zeros(r * p, bool)
    ref[phys] = True
    np.testing.assert_array_equal(ref.reshape(r, p), used & (owner >= 0))
    # allocation matches sequence length
    np.testing.assert_array_equal((pt >= 0).sum(axis=2),
                                  np.where(sa, -(-sl // cfg.page), 0))


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 10_000), crash_t=st.integers(5, 20))
def test_migrated_pages_never_double_freed(seed, crash_t):
    """tests/test_conservation.py's property on the port: with the drain on
    and a lender crash mid-run, every physical page is referenced at most
    once, every owned page exactly once, and allocation matches length."""
    cfg, state = TS.failover_scenario(migrate=4, device="cpu")
    rng = np.random.default_rng(seed)
    for t in range(30):
        if t == crash_t:
            state, _ = TE.fail_replica(cfg, state, 2)
        arr = rng.integers(0, 3, size=cfg.n_replicas).astype(np.int64)
        arr[2:] = 0  # lenders take no own work
        arr = np.where(state.dead.numpy(), 0, arr)
        state, _ = TE.step(cfg, state, torch.from_numpy(arr.astype(np.int32)))
        _check_pool(cfg, state.pool)


def test_failover_fp32_pin_equals_reference():
    """chip_smoke.py's `failover_fp32` pin is the reference's FailoverRun,
    and the port's CPU path gives it too. Computed at FULL_WIDTH's geometry
    with 1 head of 8: unmetered, the counts depend on the pool's geometry
    only. Its target is the lender holding the most offsite pages at the
    crash window."""
    from test_torch_sim import _chip_smoke
    cs = _chip_smoke()
    extra, (kind, t, target), lead, expect = cs.FAILOVER["failover_fp32"]
    assert kind == "ssd_fail" and "link_pages_per_step" not in extra
    cfg = E.EngineConfig(**dict(cs.FULL_WIDTH, n_heads=1, kv_heads=1, head_dim=8),
                         **extra)
    arrivals = lambda _: np.asarray(cs.ARRIVALS)
    jstate = E.init(cfg, jax.random.key(0))
    for _ in range(t):
        jstate, _ = E.step(cfg, jstate, jnp.asarray(cs.ARRIVALS, jnp.int32))
    pt = np.asarray(jstate.pool.page_table)
    owner = np.where(pt >= 0, pt // cfg.pages_per_replica, -1)
    held = [int(((owner == l) & (np.arange(cfg.n_replicas)[:, None, None] != l)).sum())
            for l in range(cfg.n_replicas)]
    assert int(np.argmax(held)) == target and max(held) > 0
    want = JS.drive_events(cfg, E.init(cfg, jax.random.key(0)),
                           JEV.schedule(JEV.ssd_fail(t, target), reclaim_lead=lead),
                           arrivals, cs.STEPS)
    assert want._asdict() == expect
    tcfg = port_cfg(cfg)
    got = TS.drive_events(tcfg, TE.init(tcfg, device="cpu"),
                          TEV.schedule(TEV.ssd_fail(t, target), reclaim_lead=lead),
                          arrivals, cs.STEPS)
    assert got._asdict() == expect
