"""The observability plane of the port against the JAX reference, on the
CPU: `MetricSet.record` / `history` / `totals` (gauges, counters,
histograms; partial fill and ring wrap; a batched local view as the
engine's shard axis carries it), `merge_lead`; `EventLog` `append` and
`decode` with masked rows and overflow accounting; `manager.
table_transitions`, `spans.table_event_rows` and `grant_event_rows`; and
the export functions, whose text must equal the reference's.

Every comparison is exact except where stated: the recorded values are
given in float32 on both sides, the histogram bins follow the compiled
reference's reciprocal of the bin width, and the rows carry small whole
numbers."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import descriptors as jd
from repro.core import manager as jmgr
from repro.obs import export as jx
from repro.obs import metrics as jm
from repro.obs import spans as js
from repro_torch.core import descriptors as td
from repro_torch.core import manager as tmgr
from repro_torch.obs import export as tx
from repro_torch.obs import metrics as tm
from repro_torch.obs import spans as ts

jax.config.update("jax_platform_name", "cpu")


def _sets():
    """The same registry on both sides: node gauge and counter, scalar
    gauge and counter, a histogram."""
    out = []
    for mod in (jm, tm):
        m = mod.MetricSet("t")
        m.gauge("g", per="node")
        m.counter("c", per="node", reduce="sum")
        m.gauge("sg", per="scalar", reduce="first")
        m.counter("sc", per="scalar", reduce="first")
        m.histogram("h", bins=8, lo=0.0, hi=1.6)
        out.append(m)
    return out


def _values(rng, n):
    # histogram inputs on and near the bin edges (multiples of 0.2)
    edges = np.float32(np.arange(9) * np.float32(0.2))
    h = np.concatenate([edges, np.nextafter(edges, np.float32(-1)),
                        rng.random(n).astype(np.float32) * 1.8 - 0.1])
    return {"g": rng.random(n).astype(np.float32),
            "c": rng.integers(0, 5, n).astype(np.float32),
            "sg": np.float32(rng.random()), "sc": np.float32(rng.integers(0, 9)),
            "h": h.astype(np.float32)}


@pytest.mark.parametrize("windows", [3, 5, 11])
def test_record_history_totals_match_reference(windows):
    """Depth 5: a partial fill (3), exactly full (5), wrapped twice (11)."""
    jset, tset = _sets()
    n = 6
    jcfg, tcfg = jm.ObsConfig(True, 5, 16), tm.ObsConfig(True, 5, 16)
    jms = jset.init(n, jcfg)
    tms = tset.init(n, tcfg, device="cpu")
    rec = jax.jit(jset.record)
    rng = np.random.default_rng(windows)
    for _ in range(windows):
        v = _values(rng, n)
        jms = rec(jms, {k: jnp.asarray(x) for k, x in v.items()})
        tms = tset.record(tms, {k: torch.as_tensor(x) for k, x in v.items()})
    jh, th = jset.history(jms), tset.history(tms)
    assert sorted(jh) == sorted(th)
    for k in jh:
        assert th[k].shape == jh[k].shape == (min(windows, 5),) + jh[k].shape[1:]
        np.testing.assert_array_equal(th[k], jh[k], err_msg=k)
    jt, tt = jset.totals(jms), tset.totals(tms)
    assert sorted(jt) == sorted(tt) == ["c", "sc"]
    for k in jt:
        np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
    np.testing.assert_array_equal(tms.cursor.numpy(), np.asarray(jms.cursor))
    assert th["h"].sum() == min(windows, 5) * len(_values(rng, n)["h"])


def test_record_on_a_batched_shard_view_and_merge_lead():
    """The engine records all shards at once on their [S, ...] local views;
    the result merges to the reference's vmap over shards."""
    jset, tset = _sets()
    s, nl = 3, 4
    jcfg, tcfg = jm.ObsConfig(True, 4, 8), tm.ObsConfig(True, 4, 8)
    split = lambda x: x.reshape(s, x.shape[0] // s, *x.shape[1:])
    jms = jax.tree.map(split, jset.init(s * nl, jcfg, lead=s))
    t0 = tset.init(s * nl, tcfg, lead=s, device="cpu")
    tms = tm.MetricsState(split(t0.cursor), {k: split(v) for k, v in t0.rings.items()},
                          {k: split(v) for k, v in t0.totals.items()})
    rng = np.random.default_rng(4)
    for _ in range(6):
        vals = [_values(rng, nl) for _ in range(s)]
        stacked = {k: np.stack([v[k] for v in vals]) for k in vals[0]}
        jms = jax.vmap(jset.record)(jms, {k: jnp.asarray(x) for k, x in stacked.items()})
        tms = tset.record(tms, {k: torch.as_tensor(x) for k, x in stacked.items()})
    jmerged, tmerged = jm.merge_lead(jms), tm.merge_lead(tms)
    jh, th = jset.history(jmerged), tset.history(tmerged)
    for k in jh:
        np.testing.assert_array_equal(th[k], jh[k], err_msg=k)
    for k, v in jset.totals(jmerged).items():
        np.testing.assert_array_equal(tset.totals(tmerged)[k], v, err_msg=k)
    assert tuple(tmerged.cursor.shape) == (s,)


def test_registry_is_strict_and_disabled_init_is_none():
    _, tset = _sets()
    assert tset.init(4, tm.ObsConfig()) is None
    tms = tset.init(2, tm.ObsConfig(True, 4, 8), device="cpu")
    with pytest.raises(KeyError, match="missing"):
        tset.record(tms, {"g": torch.zeros(2)})
    v = {k: torch.as_tensor(x) for k, x in _values(np.random.default_rng(0), 2).items()}
    with pytest.raises(KeyError, match="unregistered"):
        tset.record(tms, {**v, "nope": torch.zeros(2)})
    assert tset.names() == ("g", "c", "sg", "sc", "h")


# ----------------------------------------------------------------- events

def _rows(rng, m):
    r = rng.integers(0, 50, (m, ts.NF)).astype(np.float32)
    r[:, -2:] = rng.random((m, 2)).astype(np.float32) * 100
    r[:, 1] = rng.integers(0, 6, m)
    r[:, 2] = rng.integers(0, 4, m)
    r[:, 3] = rng.integers(0, 3, m)
    r[:, 5] = rng.integers(-1, 8, m)
    return r


@pytest.mark.parametrize("cap,batches", [(64, 3), (10, 4), (1, 2)])
def test_append_and_decode_match_reference(cap, batches):
    """Masked rows skip; rows past capacity drop while ``count`` keeps
    the total offered."""
    rng = np.random.default_rng(cap)
    jl, tl = js.make_log(cap), ts.make_log(cap, device="cpu")
    app = jax.jit(js.append)
    for b in range(batches):
        rows = _rows(rng, 7)
        mask = rng.random(7) < 0.6
        mask[b % 7] = True
        jl = app(jl, jnp.asarray(rows), jnp.asarray(mask))
        tl = ts.append(tl, torch.from_numpy(rows), torch.from_numpy(mask))
        np.testing.assert_array_equal(tl.buf.numpy(), np.asarray(jl.buf))
        np.testing.assert_array_equal(tl.count.numpy(), np.asarray(jl.count))
    assert ts.decode(tl) == js.decode(jl)
    _, dropped = ts.decode(tl)
    assert (dropped > 0) == (int(tl.count[0]) > cap)


def test_append_on_batched_lanes_and_decode_with_stride():
    rng = np.random.default_rng(9)
    s, cap = 3, 12
    jl = js.make_log(cap, lead=s)
    tl = ts.make_log(cap, lead=s, device="cpu")
    split = lambda x: x.reshape(s, 1, *x.shape[1:])
    jl = jax.tree.map(split, jl)
    tl = ts.EventLog(split(tl.buf), split(tl.count))
    for _ in range(3):
        rows = np.stack([_rows(rng, 6) for _ in range(s)])
        mask = rng.random((s, 6)) < 0.7
        jl = jax.vmap(js.append)(jl, jnp.asarray(rows), jnp.asarray(mask))
        tl = ts.append(tl, torch.from_numpy(rows), torch.from_numpy(mask))
    merge = lambda x: x.reshape(s, *x.shape[2:])
    jl, tl = jax.tree.map(merge, jl), ts.EventLog(merge(tl.buf), merge(tl.count))
    np.testing.assert_array_equal(tl.buf.numpy(), np.asarray(jl.buf))
    for stride in (0, 5):
        assert ts.decode(tl, id_stride=stride) == js.decode(jl, id_stride=stride)


def _tables(rng, n, slots, batch=()):
    shape = batch + (n, slots)
    valid = rng.random(shape) < 0.6
    borrower = np.where(rng.random(shape) < 0.5, jd.FREE,
                        rng.integers(0, n, shape)).astype(np.int32)
    return dict(valid=valid, rtype=rng.integers(0, 4, shape).astype(np.int8),
                borrower_id=borrower,
                amount_a=(rng.random(shape) * 10).astype(np.float32),
                amount_b=rng.random(shape).astype(np.float32),
                info_a=np.zeros(shape, np.int32), info_b=np.zeros(shape, np.int32))


def _pair(d):
    return (jd.IdleResourceTable(**{k: jnp.asarray(v) for k, v in d.items()}),
            td.IdleResourceTable(**{k: torch.from_numpy(v.copy()) for k, v in d.items()}))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_transitions_and_event_rows_match_reference(seed):
    rng = np.random.default_rng(seed)
    jp, tp = _pair(_tables(rng, 5, 3))
    jn, tn = _pair(_tables(rng, 5, 3))
    for a, b in zip(tmgr.table_transitions(tp, tn), jmgr.table_transitions(jp, jn)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    t = jnp.int32(7)
    jr, jmask = js.table_event_rows(jp, jn, t, base=10)
    tr, tmask = ts.table_event_rows(tp, tn, torch.tensor(7, dtype=torch.int32), base=10)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


def test_table_event_rows_batched_over_shards():
    rng = np.random.default_rng(3)
    s, n = 2, 4
    prev, new = _tables(rng, n, 3, (s,)), _tables(rng, n, 3, (s,))
    base = torch.arange(s, dtype=torch.int32) * n
    tr, tmask = ts.table_event_rows(_pair(prev)[1], _pair(new)[1],
                                    torch.tensor(3, dtype=torch.int32), base=base)
    for i in range(s):
        one = lambda d: {k: v[i] for k, v in d.items()}
        jr, jmask = js.table_event_rows(_pair(one(prev))[0], _pair(one(new))[0],
                                        jnp.int32(3), base=i * n)
        np.testing.assert_array_equal(tr[i].numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tmask[i].numpy(), np.asarray(jmask))


@pytest.mark.parametrize("level,code", [(1, js.ASSIST), (2, js.FABRIC_GRANT)])
def test_grant_event_rows_match_reference(level, code):
    rng = np.random.default_rng(level)
    g = np.where(rng.random((3, 4)) < 0.5, 0, rng.random((3, 4)) * 9).astype(np.float32)
    jr, jmask = js.grant_event_rows(jnp.asarray(g), rtype=jd.LINK_BW, level=level,
                                    t=jnp.int32(4), price=123.456, code=code,
                                    lender_base=2, borrower_base=1)
    tr, tmask = ts.grant_event_rows(torch.from_numpy(g), rtype=td.LINK_BW, level=level,
                                    t=torch.tensor(4, dtype=torch.int32), price=123.456,
                                    code=code, lender_base=2, borrower_base=1)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


def test_price0_matches_reference():
    assert ts._price0() == js._price0()


# ----------------------------------------------------------------- export

def _history_and_records():
    rng = np.random.default_rng(12)
    history = {"util": rng.random((5, 4)).astype(np.float32),
               "util_hist": rng.integers(0, 4, (5, 2, 8)).astype(np.float32),
               "attn_norm": rng.random((5, 2)).astype(np.float32)}
    totals = {"redirected": rng.integers(0, 9, 4).astype(np.float32)}
    tl = ts.make_log(64, lead=2, device="cpu")
    tl = ts.EventLog(tl.buf.reshape(2, 1, 64, ts.NF), tl.count.reshape(2, 1))
    rows = np.zeros((2, 9, ts.NF), np.float32)
    ev = [(0, ts.PUBLISH, 1, 0, 0, -1), (1, ts.CLAIM, 0, 0, 1, 2), (3, ts.RELEASE, 0, 0, 1, 2),
          (2, ts.WITHDRAW, 1, 0, 0, -1), (1, ts.ASSIST, 0, 1, 0, 1),
          (2, ts.FABRIC_GRANT, 3, 2, 1, 0), (4, ts.CLAIM, 3, 0, 2, 3), (4, ts.PUBLISH, 3, 0, 3, -1),
          (0, ts.CLAIM, 1, 0, 0, 5)]
    for lane in range(2):
        for i, (t, code, rt, lv, le, bo) in enumerate(ev):
            rows[lane, i, :6] = (t + lane, code, rt, lv, le, bo)
            rows[lane, i, 6:] = (1.5 + i, 64.0 * (lane + 1))
    tl = ts.append(tl, torch.from_numpy(rows), torch.ones((2, 9), dtype=torch.bool))
    tl = ts.EventLog(tl.buf.reshape(2, 64, ts.NF), tl.count.reshape(2))
    jl = js.EventLog(jnp.asarray(tl.buf.numpy()), jnp.asarray(tl.count.numpy()))
    return history, totals, ts.decode(tl)[0], js.decode(jl)[0]


def test_export_text_equals_reference(tmp_path):
    history, totals, trec, jrec = _history_and_records()
    assert trec == jrec
    assert tx.metrics_jsonl(history, totals) == jx.metrics_jsonl(history, totals)
    assert tx.metrics_jsonl({}) == jx.metrics_jsonl({}) == ""
    assert tx.events_jsonl(trec) == jx.events_jsonl(jrec)
    for kw in ({}, {"window_us": 250.0, "substrate": "sim", "t_end": 3.0}):
        assert json.dumps(tx.to_perfetto(history, trec, **kw)) == \
            json.dumps(jx.to_perfetto(history, jrec, **kw))
    p_t = tx.write_report(tmp_path / "t", history, totals, trec)
    p_j = jx.write_report(tmp_path / "j", history, totals, jrec)
    for name in ("engine_metrics.jsonl", "engine_events.jsonl",
                 "engine_trace.perfetto.json"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
    assert p_t.endswith("engine_trace.perfetto.json") and p_j.endswith(
        "engine_trace.perfetto.json")


def test_annotate_and_scope_are_profiler_ranges():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tx.annotate("outer"), tx.scope("obs_record"):
            torch.ones(3).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"outer", "obs_record"} <= names
