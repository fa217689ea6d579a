"""The port's management plane (`repro_torch.core`) against `repro.core`
on the same inputs: descriptors, the manager round (the consumer styles of
tests/test_manager.py), the WAL multi-append and its per-entry oracle
(the cases of tests/test_wal_vectorized.py), load balance, harvest triggers, costs and
topology. Integer and bool leaves match bit for bit; float leaves are
computed by the same elementwise float32 operations and match exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import costs as jcosts
from repro.core import descriptors as jd
from repro.core import harvest as jhv
from repro.core import loadbalance as jlb
from repro.core import manager as jmgr
from repro.core import topology as jtopo
from repro.core import wal as jwal
from repro_torch.core import costs as tcosts
from repro_torch.core import descriptors as td
from repro_torch.core import harvest as thv
from repro_torch.core import loadbalance as tlb
from repro_torch.core import manager as tmgr
from repro_torch.core import topology as ttopo
from repro_torch.core import wal as twal

jax.config.update("jax_platform_name", "cpu")

CPU = "cpu"
N = 6


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_tree_equal(jtree, ttree):
    """Leaf by leaf: same dtype, same values."""
    for name, a, b in zip(ttree._fields, jtree, ttree):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


def _styles(mod):
    """The consumer styles of tests/test_manager.py, built from ``mod``."""
    P = mod.ResourcePolicy
    return {
        "sim": mod.ManagerConfig(n_slots=4, policies=(
            P(rtype=td.PROCESSOR, slot0=0, slots=4, claim_rounds=4,
              watermark=0.75, gate_watermark=0.95, preserve_claims=True,
              gate_new_only=True),)),
        "engine": mod.ManagerConfig(n_slots=2, policies=(
            P(rtype=td.PROCESSOR, slot0=0, slots=1, claim_rounds=1,
              watermark=0.75, gate_watermark=0.98),
            P(rtype=td.DRAM, slot0=1, slots=1, claim_rounds=0,
              min_amount=4.0, amount_gated=True))),
        "harvest": mod.ManagerConfig(n_slots=2, policies=(
            P(rtype=td.PROCESSOR, slot0=0, slots=1, claim_rounds=1,
              max_lenders=1, watermark=0.75, preserve_claims=True),)),
        "xbof+": mod.ManagerConfig(n_slots=8, policies=(
            P(rtype=td.PROCESSOR, slot0=0, slots=4, claim_rounds=4,
              watermark=0.75, gate_watermark=0.95, preserve_claims=True,
              gate_new_only=True),
            P(rtype=td.FLASH_BW, slot0=4, slots=2, claim_rounds=4,
              watermark=0.75, gate_watermark=0.98, preserve_claims=True,
              gate_new_only=True),
            P(rtype=td.LINK_BW, slot0=6, slots=2, claim_rounds=4,
              watermark=0.75, preserve_claims=True, gate_new_only=True))),
    }


def _round_inputs(mod, cfg, arrays, conv):
    rtypes = {pol.rtype for pol in cfg.policies}
    inp = {td.PROCESSOR: mod.RoundInputs(util=conv(arrays["proc"]),
                                         gate_util=conv(arrays["data"]))}
    if td.DRAM in rtypes:
        inp[td.DRAM] = mod.RoundInputs(amount=conv(arrays["dram"]))
    if td.FLASH_BW in rtypes:
        inp[td.FLASH_BW] = mod.RoundInputs(
            util=conv(arrays["flash"]), gate_util=conv(arrays["link"]),
            amount=conv(np.maximum(1.0 - arrays["flash"], 0.0)))
    if td.LINK_BW in rtypes:
        inp[td.LINK_BW] = mod.RoundInputs(
            util=conv(arrays["link"]),
            amount=conv(np.maximum(1.0 - arrays["link"], 0.0)))
    return inp


def _utils(rng):
    """Per-round utilizations with ties (quantized to eighths) and values
    on both sides of the watermarks."""
    q = lambda: (rng.integers(0, 9, N) / 8.0).astype(np.float32)
    return dict(proc=q(), data=q(), flash=q(), link=q(),
                dram=rng.integers(0, 9, N).astype(np.float32))


@pytest.mark.parametrize("style", ["sim", "engine", "harvest", "xbof+"])
def test_manager_rounds_match_reference(style):
    jcfg, tcfg = _styles(jmgr)[style], _styles(tmgr)[style]
    jm, tm = jmgr.ResourceManager(jcfg), tmgr.ResourceManager(tcfg)
    jt, tt = jm.init_table(N), tm.init_table(N, device=CPU)
    jround = jax.jit(jm.round)
    rng = np.random.default_rng(len(style))
    for _ in range(6):
        arr = _utils(rng)
        jt = jround(jt, _round_inputs(jmgr, jcfg, arr, jnp.asarray))
        tt = tm.round(tt, _round_inputs(tmgr, tcfg, arr, _t))
        _assert_tree_equal(jt, tt)
        for pol in tcfg.policies:
            if pol.claim_rounds:
                np.testing.assert_array_equal(
                    np.asarray(jm.assist_matrix(jt, pol.rtype)),
                    tm.assist_matrix(tt, pol.rtype).numpy())
            np.testing.assert_array_equal(
                np.asarray(jm.slot_mask(pol.rtype)),
                tm.slot_mask(pol.rtype, device=CPU).numpy())


def test_ties_break_to_lowest_id():
    """Equal utilizations: the stable busiest-first order claims the lowest
    lender id for the lowest borrower id (tests/test_manager.py)."""
    tm = tmgr.ResourceManager(_styles(tmgr)["harvest"])
    proc = torch.tensor([0.9, 0.9, 0.9, 0.1, 0.1, 0.1])
    t = tm.round(tm.init_table(N, device=CPU), {td.PROCESSOR: tmgr.RoundInputs(
        util=proc, gate_util=torch.full((N,), 0.3))})
    assert td.lenders_of(t, 0, td.PROCESSOR).tolist() == [
        False, False, False, True, False, False]


@pytest.mark.parametrize("rtype,amounts,utils,winner", [
    (td.FLASH_BW, [0.0, 0.2, 0.9, 0.0], [0.0] * 4, 2),   # largest amount
    (td.PROCESSOR, [0.0] * 4, [0.0, 0.1, 0.3, 0.2], 1),  # most idle lender
    (td.DRAM, [0.0, 5.0, 5.0, 5.0], [0.0] * 4, 1),       # tie: lowest index
    (td.LINK_BW, [0.0] * 4, [0.0] * 4, -1),              # nothing published
])
def test_claim_best_matches_reference(rtype, amounts, utils, winner):
    jt, tt = jd.make_table(4, 2), td.make_table(4, 2, device=CPU)
    for node in range(1, 4):
        if winner >= 0:
            jt = jd.publish(jt, node, 0, rtype, amounts[node], utils[node])
            tt = td.publish(tt, node, 0, rtype, amounts[node], utils[node])
    jt2, jl, js, jok = jd.claim_best(jt, 0, rtype)
    tt2, tl, ts, tok = td.claim_best(tt, 0, rtype)
    _assert_tree_equal(jt2, tt2)
    assert int(tl) == int(jl) == winner and int(ts) == int(js)
    assert bool(tok) == bool(jok) == (winner >= 0)


def test_sync_utilization_matches_reference():
    rng = np.random.default_rng(3)
    for _ in range(5):
        n, s = 5, 4
        fields = dict(
            valid=rng.random((n, s)) < 0.7,
            rtype=rng.integers(0, 4, (n, s)).astype(np.int8),
            borrower_id=np.where(rng.random((n, s)) < 0.5, td.FREE,
                                 rng.integers(0, n, (n, s))).astype(np.int32),
            amount_a=rng.random((n, s)).astype(np.float32),
            amount_b=rng.random((n, s)).astype(np.float32),
            info_a=np.zeros((n, s), np.int32), info_b=np.zeros((n, s), np.int32))
        utils = {r: rng.random(n).astype(np.float32) for r in range(4)}
        amts = {r: rng.random(n).astype(np.float32) for r in (1, 2, 3)}
        jt = jd.sync_utilization(
            jd.IdleResourceTable(**{k: jnp.asarray(v) for k, v in fields.items()}),
            {k: jnp.asarray(v) for k, v in utils.items()},
            {k: jnp.asarray(v) for k, v in amts.items()})
        tt = td.sync_utilization(
            td.IdleResourceTable(**{k: _t(v) for k, v in fields.items()}),
            {k: _t(v) for k, v in utils.items()},
            {k: _t(v) for k, v in amts.items()})
        _assert_tree_equal(jt, tt)


def test_fill_by_rank_matches_reference():
    rng = np.random.default_rng(7)
    fill = jax.jit(jmgr.fill_by_rank)
    for _ in range(20):
        cap = rng.integers(0, 9, 8).astype(np.int32)
        total = int(rng.integers(0, 40))
        np.testing.assert_array_equal(
            np.asarray(fill(jnp.asarray(cap), total)),
            tmgr.fill_by_rank(_t(cap), total).numpy())
    assert tmgr.fill_by_rank(torch.tensor([3, 0, 5, 2, 7]), 9).tolist() == [
        3, 0, 5, 1, 0]


_commit = jax.jit(jwal.commit)
_commit_batch = jax.jit(jwal.commit_batch)
_commit_batch_scan = jax.jit(jwal.commit_batch_scan)


def _wal_case(seed, nseg=4, epp=8, batch=24, prefill=0):
    """A random batch over a log with ``prefill`` earlier commits (the
    generator of tests/test_wal_vectorized.py)."""
    rng = np.random.default_rng(seed)
    log = jwal.make_log(nseg, epp)
    for _ in range(prefill):
        log = _commit(log, jnp.int32(rng.integers(0, nseg)),
                      jnp.int32(rng.integers(0, 100)),
                      jnp.int32(rng.integers(0, 100)))
    segs = rng.integers(0, nseg, batch).astype(np.int32)
    keys = rng.integers(0, 1000, batch).astype(np.int32)
    vals = rng.integers(0, 1000, batch).astype(np.int32)
    mask = rng.random(batch) < 0.7
    return log, segs, keys, vals, mask


def _tlog(jlog):
    return twal.LogPages(*[_t(np.asarray(a)) for a in jlog])


WAL_CASES = ["no_flush", "flush_mid_batch", "exact_page_multiple", "mask",
             "preexisting_partial", "randomized"]


def _wal_cases(case):
    """The (log, segments, keys, vals, mask) of one case of
    tests/test_wal_vectorized.py, as the reference's log and numpy."""
    if case == "randomized":
        return [_wal_case(seed, prefill=seed % 7) for seed in range(40)]
    log = jwal.make_log(*{"no_flush": (3, 64), "flush_mid_batch": (2, 4),
                          "exact_page_multiple": (1, 4), "mask": (2, 8),
                          "preexisting_partial": (2, 6)}[case])
    segs = {"no_flush": [0, 1, 0, 2, 1, 0], "flush_mid_batch": [0] * 10,
            "exact_page_multiple": [0] * 8, "mask": [0, 1, 0, 1],
            "preexisting_partial": [0, 0, 0, 1]}[case]
    segs = np.asarray(segs, np.int32)
    keys = np.arange(len(segs), dtype=np.int32) + 10
    mask = (np.array([True, False, True, False]) if case == "mask"
            else np.ones(len(segs), bool))
    if case == "preexisting_partial":
        for i in range(4):
            log = _commit(log, jnp.int32(0), jnp.int32(i), jnp.int32(i))
    return [(log, segs, keys, keys * 10, mask)]


@pytest.mark.parametrize("case", WAL_CASES)
def test_commit_batch_matches_reference(case):
    """The cases of tests/test_wal_vectorized.py through both packages."""
    for log, segs, keys, vals, mask in _wal_cases(case):
        want = _commit_batch(log, *map(jnp.asarray, (segs, keys, vals, mask)))
        got = twal.commit_batch(_tlog(log), *map(_t, (segs, keys, vals, mask)))
        _assert_tree_equal(want, got)


@pytest.mark.parametrize("case", WAL_CASES + ["per_shard"])
def test_commit_batch_matches_scan_oracles(case):
    """The port's `commit_batch` equals its own per-entry oracle
    `commit_batch_scan` and the reference's, bit for bit, over masks and
    pages that fill mid-batch; "per_shard" runs the port's pair on a log
    with a leading shard axis (each shard its own entries)."""
    if case == "per_shard":
        rng = np.random.default_rng(5)
        log = twal.make_log(4, 4, device="cpu")
        log = twal.LogPages(*(torch.stack([x, x]) for x in log))
        log = twal.commit_batch(log, _t(rng.integers(0, 4, (2, 5)).astype(np.int32)),
                                _t(np.arange(10, dtype=np.int32).reshape(2, 5)),
                                _t(np.arange(10, dtype=np.int32).reshape(2, 5)))
        args = (rng.integers(0, 4, (2, 30)).astype(np.int32),
                rng.integers(0, 1000, (2, 30)).astype(np.int32),
                rng.integers(0, 1000, (2, 30)).astype(np.int32), rng.random((2, 30)) < 0.7)
        got = twal.commit_batch(log, *map(_t, args))
        _assert_tree_equal(twal.commit_batch_scan(log, *map(_t, args)), got)
        assert int(got.flushes.sum()) > 0
        return
    for log, segs, keys, vals, mask in _wal_cases(case):
        args = (segs, keys, vals, mask)
        got = twal.commit_batch(_tlog(log), *map(_t, args))
        _assert_tree_equal(twal.commit_batch_scan(_tlog(log), *map(_t, args)), got)
        _assert_tree_equal(_commit_batch_scan(log, *map(jnp.asarray, args)), got)


def test_replay_matches_reference():
    log = jwal.make_log(4, 16)
    segs = jnp.array([0, 1, 0, 2, 3, 3], jnp.int32)
    keys = jnp.array([5, 9, 5, 30, 9, 70], jnp.int32)
    vals = jnp.array([50, 90, 55, 7, 91, 3], jnp.int32)
    log = jwal.commit_batch(log, segs, keys, vals)
    base = np.full((64,), -1, np.int32)
    want = np.asarray(jwal.replay(log, jnp.asarray(base)))
    got = twal.replay(_tlog(log), _t(base)).numpy()
    np.testing.assert_array_equal(want, got)
    assert got[5] == 55 and got[9] == 91 and got[30] == 7 and got[63] == 3


def test_split_commands_matches_reference_per_borrower():
    """The port batches the reference's one-borrower split over rows."""
    rng = np.random.default_rng(11)
    w = dict(w_borrow_sq=4.0, w_shadow_sq=1.0, sum_w_borrow=12.0,
             sum_w_lend=12.0)
    for _ in range(10):
        n = 6
        demand = rng.integers(0, 20, n).astype(np.int32)
        util = (rng.integers(0, 13, n) / 8.0).astype(np.float32)
        mask = rng.random((n, n)) < 0.3
        kept, sent = tlb.split_commands(_t(demand), _t(util), _t(util),
                                        _t(mask), **w)
        for i in range(n):
            jk, js = jlb.split_commands(jnp.int32(demand[i]),
                                        jnp.float32(util[i]),
                                        jnp.asarray(util),
                                        jnp.asarray(mask[i]), **w)
            assert int(jk) == int(kept[i])
            np.testing.assert_array_equal(np.asarray(js), sent[i].numpy())
    # paper example: N_borrow / N_lend == 3 -> p == 0.25
    p = tlb.redirect_probability(torch.tensor(0.5), torch.tensor(1.5))
    assert abs(float(p) - 0.25) < 1e-6
    np.testing.assert_array_equal(np.asarray(jlb.wrr_weights(5, 1.0, 4.0)),
                                  tlb.wrr_weights(5, 1.0, 4.0, device=CPU).numpy())


def test_harvest_triggers_match_reference():
    rng = np.random.default_rng(5)
    own = (rng.integers(0, 9, 32) / 8.0).astype(np.float32)
    gate = (rng.integers(0, 9, 32) / 8.0).astype(np.float32)
    for wm, gw in [(0.75, None), (0.75, 0.95), (0.5, 0.98)]:
        jl, jb = jhv.harvest_triggers(jnp.asarray(own), jnp.asarray(gate), wm, gw)
        tl, tb = thv.harvest_triggers(_t(own), _t(gate), wm, gw)
        np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    mrc = np.sort(rng.random((4, 8)).astype(np.float32), axis=1)[:, ::-1].copy()
    miss = rng.random(4).astype(np.float32)
    cached = rng.integers(0, 64, 4).astype(np.int32)
    total = np.full(4, 64, np.int32)
    util = (rng.integers(0, 9, 4) / 8.0).astype(np.float32)
    data = (rng.integers(0, 9, 4) / 8.0).astype(np.float32)
    want = jhv.decide(*map(jnp.asarray, (util, data, miss, mrc, cached, total)))
    got = thv.decide(*map(_t, (util, data, miss, mrc, cached, total)))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    grid = np.linspace(0.125, 1.0, 8).astype(np.float32)
    rate = rng.random(4).astype(np.float32) * 2
    np.testing.assert_array_equal(
        np.asarray(jhv.want_fraction(jnp.asarray(mrc.T.copy()),
                                     jnp.asarray(rate), jnp.asarray(grid))),
        thv.want_fraction(_t(mrc.T.copy()), _t(rate), _t(grid)).numpy())
    # the harvest-style persistent round, three times over
    jt, tt = jd.make_table(4, 2), td.make_table(4, 2, device=CPU)
    for proc in ([0.9, 0.1, 0.5, 0.5], [0.9, 0.1, 0.5, 0.5], [0.2, 0.1, 0.5, 0.5]):
        proc = np.asarray(proc, np.float32)
        gate = np.full(4, 0.2, np.float32)
        jt = jhv.apply_processor_round(jt, jnp.asarray(proc), jnp.asarray(gate))
        tt = thv.apply_processor_round(tt, _t(proc), _t(gate))
        _assert_tree_equal(jt, tt)


def test_costs_and_topology_match_reference():
    for rtype in range(4):
        for level in range(5):
            assert tcosts.tier_link_bytes(rtype, 4096.0, level=level) == \
                jcosts.tier_link_bytes(rtype, 4096.0, level=level)
            assert tcosts.tier_overhead_s(rtype, level) == \
                jcosts.tier_overhead_s(rtype, level)
    svc = np.array([1e-9, 1e-6, 1e-3], np.float32)
    np.testing.assert_array_equal(
        np.asarray(jcosts.overhead_frac(0, jnp.asarray(svc))),
        tcosts.overhead_frac(0, _t(svc)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jcosts.assist_link_bps(2, 65536.0, jnp.asarray(svc))),
        tcosts.assist_link_bps(2, 65536.0, _t(svc)).numpy())
    assert tcosts.REDIRECT_CMD_BYTES == jcosts.REDIRECT_CMD_BYTES == 64.0
    for make in (lambda m: m.flat(4), lambda m: m.two_level(2, 3)):
        jt, tt = make(jtopo), make(ttopo)
        assert tuple(tt) == tuple(jt) and tt.depth == jt.depth
        assert [tt.level_name(i) for i in range(len(tt.group_sizes))] == \
            [jt.level_name(i) for i in range(len(jt.group_sizes))]
    ttopo.flat(4).validate(4)
    with pytest.raises(ValueError):
        ttopo.two_level(2, 3).validate(4)
