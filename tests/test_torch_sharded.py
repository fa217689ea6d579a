"""The hierarchical engine (`n_shards > 1`) of the port against the JAX
reference, on the CPU: the exchange primitives (`manager.shard_exchange`,
`topology.hierarchical_exchange`, `hierarchical_round`,
`invalidate_block_grants`) against the compiled reference, the engine
`step` step by step against the reference `step` (integer and bool state
and integer stats equal, float stats within DEFAULT_RTOL), the port
counterparts of tests/test_sharded.py's engine properties, and the
link-account scenario's totals.

The reference runs the exchange compiled, where XLA divides by a constant
as a product with its float32 reciprocal and sums a short axis left to
right; its eager functions take other last bits on many inputs. The port
follows the compiled values, which are what the reference engine runs.
Under the reference's vmap every shard decodes the same activations (the
key is not batched), so the port is fed the per-shard tensor tiled over
the shards."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import descriptors as jd
from repro.core import manager as jmgr
from repro.core import topology as jtopo
from repro.serving import engine as E
from repro.serving import scenarios as JS
from repro_torch.core import descriptors as td
from repro_torch.core import manager as tmgr
from repro_torch.core import topology as ttopo
from repro_torch.serving import engine as TE
from repro_torch.serving import scenarios as TS
from test_torch_engine import (DEFAULT_RTOL, _compare_leaves, _compare_stats,
                               port_cfg)

jax.config.update("jax_platform_name", "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))    # a writable copy


# ---------------------------------------------------------------- exchange

_jit_exchange = jax.jit(jmgr.shard_exchange, static_argnums=2)


def _random_summary(rng, s):
    spare = (rng.random(s) * 100).astype(np.float32)
    want = (rng.random(s) * 100).astype(np.float32)
    return spare, want, float(rng.random() * 0.3)


def _check_conservation(g, r, spare, want, overhead):
    """tests/test_sharded.py::TestShardExchangePrimitive._check."""
    assert (g >= -1e-6).all() and (r >= -1e-6).all()
    assert (np.abs(np.diag(g)) < 1e-6).all()
    assert (g.sum(axis=1) <= np.maximum(spare - want, 0.0) + 1e-4).all()
    assert (r <= np.maximum(want - spare, 0.0) + 1e-4).all()
    np.testing.assert_allclose(r.sum() * (1.0 + overhead), g.sum(),
                               rtol=1e-5, atol=1e-5)
    assert g.sum() <= spare.sum() + 1e-3


class TestShardExchange:
    def test_matches_compiled_reference_over_50_seeds(self):
        rng = np.random.default_rng(0)
        eager_differs = 0
        for _ in range(50):
            spare, want, oh = _random_summary(rng, int(rng.integers(2, 9)))
            jg, jr = map(np.asarray, _jit_exchange(spare, want, oh))
            tg, tr = tmgr.shard_exchange(_t(spare), _t(want), oh)
            np.testing.assert_array_equal(tg.numpy(), jg)
            np.testing.assert_array_equal(tr.numpy(), jr)
            _check_conservation(tg.numpy(), tr.numpy(), spare, want, oh)
            eg, er = jmgr.shard_exchange(spare, want, oh)
            eager_differs += not (np.array_equal(eg, jg)
                                  and np.array_equal(er, jr))
        # the compiled and the eager reference disagree in the last bit on
        # some of these inputs; the port holds to the compiled one
        assert eager_differs > 0

    def test_last_axis_batches_independent_rows(self):
        rng = np.random.default_rng(1)
        spare = (rng.random((3, 4)) * 50).astype(np.float32)
        want = (rng.random((3, 4)) * 50).astype(np.float32)
        g, r = tmgr.shard_exchange(_t(spare), _t(want), 0.1)
        for i in range(3):
            gi, ri = tmgr.shard_exchange(_t(spare[i]), _t(want[i]), 0.1)
            assert torch.equal(g[i], gi) and torch.equal(r[i], ri)

    def test_fill_by_rank_last_axis(self):
        cap = torch.tensor([[3, 0, 2, 5], [1, 4, 0, 2]])
        got = tmgr.fill_by_rank(cap, torch.tensor([[6], [99]]))
        for i, total in enumerate((6, 99)):
            want = jmgr.fill_by_rank(jnp.asarray(cap[i].numpy()), total)
            assert got[i].tolist() == np.asarray(want).tolist()
        assert got.sum(dim=1).tolist() == [6, 7]


TOPOLOGIES = {
    "flat8": (jtopo.flat(8), ttopo.flat(8)),
    "two_level_2x2": (jtopo.two_level(2, 2), ttopo.two_level(2, 2)),
    "two_level_2x4": (jtopo.two_level(2, 4), ttopo.two_level(2, 4)),
    "deep_2x2x2": (jtopo.Topology((2, 2, 2)), ttopo.Topology((2, 2, 2))),
    "tiers_4x2": (jtopo.Topology((4, 2), tiers=(2, 2)),
                  ttopo.Topology((4, 2), tiers=(2, 2))),
}


def _t_exchange(spare, want, topo_, overheads=None):
    g, r = ttopo.hierarchical_exchange(_t(np.asarray(spare, np.float32)),
                                       _t(np.asarray(want, np.float32)),
                                       topo_, overheads)
    return g.numpy(), r.numpy()


class TestHierarchicalExchange:
    @pytest.mark.parametrize("taxed", [False, True])
    @pytest.mark.parametrize("name", sorted(TOPOLOGIES))
    def test_matches_compiled_reference(self, name, taxed):
        """Grants bit for bit at the first two levels (all the engine
        runs), received at the first. The compiled reference computes the
        want a level leaves over twice, in two fusions: as one FMA where
        the next level's grants use it, and from the rounded product where
        its received does. The port takes the grants' value, so an outer
        level's received, and a third level's grants, may differ from the
        reference's by an ulp of the summaries' scale (inputs < 100)."""
        jt, tt = TOPOLOGIES[name]
        rng = np.random.default_rng(7)
        ohs = (tuple(float(x) for x in rng.random(len(jt.group_sizes)) * 0.3)
               if taxed else None)
        compiled = jax.jit(
            lambda s, w: jtopo.hierarchical_exchange(s, w, jt, ohs))
        for _ in range(20):
            spare, want, _ = _random_summary(rng, jt.n_leaves)
            jg, jr = map(np.asarray, compiled(spare, want))
            tg, tr = _t_exchange(spare, want, tt, ohs)
            ulp = float(np.spacing(np.float32(100)))
            np.testing.assert_array_equal(tg[:2], jg[:2])
            np.testing.assert_allclose(tg[2:], jg[2:], rtol=0, atol=ulp)
            np.testing.assert_array_equal(tr[0], jr[0])
            np.testing.assert_allclose(tr[1:], jr[1:], rtol=0, atol=ulp)

    def test_single_level_is_shard_exchange(self):
        rng = np.random.default_rng(3)
        spare, want, oh = _random_summary(rng, 6)
        g, r = _t_exchange(spare, want, ttopo.flat(6), (oh,))
        g0, r0 = tmgr.shard_exchange(_t(spare), _t(want), oh)
        np.testing.assert_array_equal(g[0], g0.numpy())
        np.testing.assert_array_equal(r[0], r0.numpy())

    def test_nearest_level_first(self):
        g, r = _t_exchange([0.0, 5.0, 3.0, 3.0], [2.0, 0.0, 0.0, 0.0],
                           ttopo.two_level(2, 2))
        assert r[0][0] == pytest.approx(2.0)
        assert np.abs(g[1]).sum() == 0.0

    def test_spills_outward_only_when_local_pool_dry(self):
        g, r = _t_exchange([0.0, 1.0, 6.0, 6.0], [4.0, 0.0, 0.0, 0.0],
                           ttopo.two_level(2, 2))
        assert r[0][0] == pytest.approx(1.0)
        assert r[1][0] == pytest.approx(3.0)
        assert g[1].sum() == pytest.approx(3.0)

    def test_level_grants_are_block_diagonal(self):
        rng = np.random.default_rng(3)
        spare, want, _ = _random_summary(rng, 8)
        g, _ = _t_exchange(spare, want, ttopo.two_level(2, 4))
        blocks = np.arange(8) // 2
        assert (g[0][blocks[:, None] != blocks[None, :]] == 0.0).all()

    def test_own_want_nets_before_any_boundary(self):
        g, r = _t_exchange([5.0, 0.0, 0.0, 0.0], [2.0, 0.0, 6.0, 0.0],
                           ttopo.two_level(2, 2))
        assert r[:, 0].sum() == 0.0
        assert g[:, 0, :].sum() <= 3.0 + 1e-5

    def test_enclosure_local_grants_win_before_fabric(self):
        """tests/test_sharded.py::TestEnclosureGroupedTopology."""
        g, r = _t_exchange([0.0, 10.0, 10.0, 10.0], [4.0, 0.0, 0.0, 0.0],
                           ttopo.two_level(2, 2))
        assert g[0].sum() > 0 and g[1].sum() == 0
        np.testing.assert_allclose(r.sum(axis=0)[0], 4.0, rtol=1e-6)

    def test_overheads_validated(self):
        with pytest.raises(ValueError, match="one overhead per level"):
            _t_exchange([1.0, 0.0], [0.0, 1.0], ttopo.flat(2), (0.1, 0.2))


class TestHierarchicalRound:
    """tests/test_topology.py::TestHierarchicalRound, port against the
    compiled reference."""

    def test_matches_reference(self):
        pol = dict(rtype=jd.PROCESSOR, slot0=0, slots=2, claim_rounds=2,
                   watermark=0.75, gate_watermark=0.98, min_amount=0.0)
        jm = jmgr.ResourceManager(jmgr.ManagerConfig(
            n_slots=2, policies=(jmgr.ResourcePolicy(**pol),)))
        tm = tmgr.ResourceManager(tmgr.ManagerConfig(
            n_slots=2, policies=(tmgr.ResourcePolicy(**pol),)))
        rng = np.random.default_rng(5)
        util = (rng.random((4, 3)) * 1.2).astype(np.float32)
        amount = np.ones((4, 3), np.float32)
        spare = np.asarray([3.0, 0.0, 1.0, 0.0], np.float32)
        want = np.asarray([0.0, 2.0, 0.0, 3.0], np.float32)
        topo2 = (jtopo.two_level(2, 2), ttopo.two_level(2, 2))
        jtables = jax.vmap(lambda _: jm.init_table(3))(jnp.arange(4))
        jr = jax.jit(lambda t, u, s, w: jtopo.hierarchical_round(
            jm, t, {jd.PROCESSOR: jmgr.RoundInputs(util=u, gate_util=u,
                                                   amount=jnp.asarray(amount))},
            s, w, topo2[0]))(jtables, util, spare, want)
        ttables = td.IdleResourceTable(*(
            _t(np.asarray(x)) for x in jax.tree.leaves(jtables)))
        tr = ttopo.hierarchical_round(
            tm, ttables, {td.PROCESSOR: tmgr.RoundInputs(
                util=_t(util), gate_util=_t(util), amount=_t(amount))},
            _t(spare), _t(want), topo2[1])
        assert tr.tables.valid.shape == (4, 3, 2)
        for name in td.IdleResourceTable._fields:
            np.testing.assert_array_equal(
                getattr(tr.tables, name).numpy(),
                np.asarray(getattr(jr.tables, name)), err_msg=name)
        for name in ("grants", "received", "lent", "spare_resid", "want_resid"):
            np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                          np.asarray(getattr(jr, name)),
                                          err_msg=name)
        recv = tr.received.numpy().sum(axis=0)
        np.testing.assert_allclose(tr.lent.numpy().sum(), recv.sum(), rtol=1e-6)


class TestInvalidateBlockGrants:
    def _grants(self):
        rng = np.random.default_rng(11)
        spare, want, _ = _random_summary(rng, 8)
        return torch.from_numpy(_t_exchange(spare, want, ttopo.two_level(2, 4))[0])

    def test_matches_reference_and_kills_exactly_the_dead_blocks(self):
        g = self._grants()
        dead = torch.zeros(8, dtype=torch.bool)
        dead[3] = True
        g2, released = ttopo.invalidate_block_grants(g, dead)
        jg2, jrel = jtopo.invalidate_block_grants(jnp.asarray(g.numpy()),
                                                  jnp.asarray(dead.numpy()))
        np.testing.assert_array_equal(g2.numpy(), np.asarray(jg2))
        assert float(released) == pytest.approx(float(jrel), rel=1e-6)
        assert (g2[:, 3, :] == 0).all() and (g2[:, :, 3] == 0).all()
        keep = torch.ones_like(g, dtype=torch.bool)
        keep[:, 3, :] = keep[:, :, 3] = False
        assert torch.equal(g2[keep], g[keep])
        assert float(released) == pytest.approx(float(g.sum() - g2.sum()),
                                                rel=1e-6)

    def test_reapplication_releases_zero(self):
        dead = torch.zeros(8, dtype=torch.bool)
        dead[5] = True
        g2, _ = ttopo.invalidate_block_grants(self._grants(), dead)
        g3, rel = ttopo.invalidate_block_grants(g2, dead)
        assert torch.equal(g3, g2) and float(rel) == 0.0

    def test_all_dead_releases_everything(self):
        g = self._grants()
        g2, released = ttopo.invalidate_block_grants(
            g, torch.ones(8, dtype=torch.bool))
        assert float(g2.abs().sum()) == 0.0
        assert float(released) == pytest.approx(float(g.sum()), rel=1e-6)


# ------------------------------------------------------------------ engine

def _activations(cfg, i):
    """The reference step's decode activations for step_count i: under its
    vmap every shard draws the same [nl, St, d] tensor."""
    nl = cfg.n_replicas // cfg.n_shards
    shape = (nl, cfg.seq_slots + cfg.shadow_slots, cfg.n_heads * cfg.head_dim)
    key = jax.random.fold_in(jax.random.key(7), jnp.int32(i))
    x = np.array(jax.random.normal(key, shape) * 0.1)
    return np.tile(x, (cfg.n_shards, 1, 1))


def _shard1_pressure(state, cfg):
    """Shard 1 (replicas 4-7) memory-full with two 16-token sequences per
    replica that cannot get a page: 8 active rows of length 0, whose
    attention reads shard 1's own page 0; shard 1 borrows shard 0's
    leftover link allowance every step."""
    pool = state.pool._replace(
        used=state.pool.used.at[4:].set(True),
        seq_active=state.pool.seq_active.at[4:, :2].set(True))
    return state._replace(pool=pool, remaining=state.remaining.at[4:, :2].set(16))


def _pressured(lo, hi):
    """Replicas lo..hi-1 memory-full with two 16-token sequences each."""
    def prepare(state, cfg):
        pool = state.pool._replace(
            used=state.pool.used.at[lo:hi].set(True),
            seq_active=state.pool.seq_active.at[lo:hi, :2].set(True))
        return state._replace(
            pool=pool, remaining=state.remaining.at[lo:hi, :2].set(16))
    return prepare


UNMETERED = dict(n_replicas=8, n_shards=2, seq_slots=2, shadow_slots=2,
                 cross_shard=True)
METERED = dict(UNMETERED, pages_per_replica=8, max_pages=8,
               link_pages_per_step=1)
ENCLOSURE = dict(n_replicas=16, n_shards=4, seq_slots=2, shadow_slots=2,
                 cross_shard=True, shards_per_enclosure=2,
                 link_pages_per_step=2)
ENGINE_CASES = {
    # tests/test_sharded.py CASES["unmetered"], ["metered"] and
    # TestEnclosureGroupedTopology._cfg(link_pages_per_step=2)
    "unmetered": (UNMETERED, [6, 6, 6, 6, 0, 0, 0, 0], None),
    # shard 1 exports: imports into shard 0 are homed at shard 1's base
    "unmetered_shard1_hot": (UNMETERED, [0, 0, 0, 0, 6, 6, 6, 6], None),
    "metered": (METERED, [5, 5, 5, 5, 0, 0, 0, 0], None),
    "enclosure": (ENCLOSURE, [6] * 4 + [0] * 12, None),
    "shard1_pressure": (METERED, [3, 3, 0, 0, 0, 0, 0, 0], _shard1_pressure),
    # LINK_BW want in both shards of enclosure 0: two borrowers share the
    # fabric level's spare (the exchange's sums take several terms)
    "enclosure_fabric": (ENCLOSURE, [0] * 16, _pressured(0, 8)),
    # want in shards 1 and 2: each borrows from its sibling at the
    # enclosure level, the rest across the fabric
    "enclosure_two_levels": (ENCLOSURE, [2] * 4 + [0] * 12, _pressured(4, 12)),
}
STEPS = 8


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_step_matches_reference(name, quant):
    kw, arrivals, prepare = ENGINE_CASES[name]
    cfg = E.EngineConfig(**kw, kv_quant=quant)
    jstate = E.init(cfg, jax.random.key(0))
    if prepare is not None:
        jstate = prepare(jstate, cfg)
    tcfg = port_cfg(cfg)
    tstate = TE.state_from_numpy(tcfg, jax.tree.map(np.asarray, jstate), "cpu")
    _compare_leaves(jstate, tstate, "init")
    arr = np.asarray(arrivals, np.int32)
    cross, borrowed = 0.0, []
    for i in range(STEPS):
        jstate, jst = E.step(cfg, jstate, jnp.asarray(arr))
        tstate, tst = TE.step(tcfg, tstate, torch.from_numpy(arr),
                              x=torch.from_numpy(_activations(cfg, i)))
        _compare_stats(jst, tst, i)
        _compare_leaves(jstate, tstate, f"step {i}",
                        int8_codes=quant == "int8")
        cross += float(tst["cross_redirected"])
        borrowed.append(float(tst["cross_link_borrowed_bytes"]))
    assert tstate.pool.logs.commits.shape == (cfg.n_shards,)
    if prepare is None:
        assert cross > 0
    elif name != "shard1_pressure":
        assert all(b > 0 for b in borrowed)
    else:
        # the case this config exists for: non-integer bytes borrowed
        # across shards every step, and length-0 rows in shard 1
        assert all(b > 0 and b != int(b) for b in borrowed)
        active0 = tstate.pool.seq_active & (tstate.pool.seq_len == 0)
        assert int(active0[4:].sum()) == 8


def _run(cfg, arrivals, steps, state=None, xs_seed=0):
    state = TE.init(cfg, device="cpu") if state is None else state
    gen = torch.Generator().manual_seed(xs_seed)
    hist = []
    for _ in range(steps):
        state, st = TE.step(cfg, state, torch.as_tensor(arrivals),
                            generator=gen)
        hist.append({k: v.numpy() for k, v in st.items()})
    return state, hist


class TestHierarchyIsIndependentEnginesWhenCrossOff:
    """tests/test_sharded.py's layer 1 on the port, trace-driven as the
    reference's: n_shards=S with cross_shard=False is S disjoint engines,
    each with its own SHARDS estimators."""

    S, NL, STEPS = 4, 4, 6

    def test_matches_blockdiagonal_single_shard_runs(self):
        big = TE.EngineConfig(n_replicas=self.S * self.NL, n_shards=self.S,
                              cross_shard=False, link_pages_per_step=2,
                              trace_driven=True)
        small = big._replace(n_replicas=self.NL, n_shards=1)
        arr = np.zeros((self.S, self.NL), np.int32)
        arr[0, 0], arr[0, 1], arr[2, 1] = 4, 2, 3
        gen = torch.Generator().manual_seed(3)
        d = big.n_heads * big.head_dim
        xs = [torch.randn((self.S * self.NL, TE.total_slots(big), d),
                          generator=gen) * 0.1 for _ in range(self.STEPS)]
        sb = TE.init(big, device="cpu")
        hb = []
        for i in range(self.STEPS):
            sb, st = TE.step(big, sb, torch.from_numpy(arr.reshape(-1)), x=xs[i])
            hb.append(st)
        parts, phist = [], []
        for s in range(self.S):
            st_s, h = TE.init(small, device="cpu"), []
            for i in range(self.STEPS):
                st_s, stats = TE.step(small, st_s, torch.from_numpy(arr[s]),
                                      x=xs[i][s * self.NL:(s + 1) * self.NL])
                h.append(stats)
            parts.append(st_s)
            phist.append(h)
        assert any(bool((h["want_pages"] > 0).any()) for h in hb)
        for t in range(self.STEPS):
            for k in ("util", "link_budget_bytes", "link_redirect_bytes",
                      "link_spill_bytes", "want_pages"):
                assert torch.equal(hb[t][k], torch.cat(
                    [phist[s][t][k] for s in range(self.S)])), k
            for k in ("active", "queued", "redirected", "offsite_pages",
                      "log_commits"):
                assert int(hb[t][k]) == sum(int(phist[s][t][k])
                                            for s in range(self.S)), k
            torch.testing.assert_close(
                hb[t]["attn_norm"],
                sum(phist[s][t]["attn_norm"] for s in range(self.S)),
                rtol=1e-5, atol=0)
            assert float(hb[t]["cross_redirected"]) == 0
            assert float(hb[t]["cross_link_borrowed_bytes"]) == 0
        p = big.pages_per_replica
        for s in range(self.S):
            lo, hi = s * self.NL, (s + 1) * self.NL
            ind = parts[s]
            exp_home = torch.where(ind.home_of >= 0, ind.home_of + lo,
                                   ind.home_of)
            assert torch.equal(sb.home_of[lo:hi], exp_home)
            assert torch.equal(sb.remaining[lo:hi], ind.remaining)
            assert torch.equal(sb.queue[lo:hi], ind.queue)
            for f in ("used", "owner_seq", "page_table", "seq_len",
                      "seq_active", "k_scale", "v_scale"):
                assert torch.equal(getattr(sb.pool, f)[lo:hi],
                                   getattr(ind.pool, f)), f
            for f in ("k", "v"):
                assert torch.equal(getattr(sb.pool, f)[lo * p:hi * p],
                                   getattr(ind.pool, f)[:-1]), f
            for f in ("keys", "vals", "count"):
                assert torch.equal(getattr(sb.pool.logs, f)[lo * p:hi * p],
                                   getattr(ind.pool.logs, f)), f
            assert int(sb.pool.logs.commits[s]) == int(ind.pool.logs.commits)
            for f in ind.mrc._fields:
                assert torch.equal(getattr(sb.mrc, f)[lo:hi],
                                   getattr(ind.mrc, f)), f
            for f in td.IdleResourceTable._fields:
                assert torch.equal(getattr(sb.table, f)[lo:hi],
                                   getattr(ind.table, f)), f


class TestCrossShardExchange:
    """tests/test_sharded.py's layer 3a on the port."""

    CFG = TE.EngineConfig(n_replicas=8, n_shards=2, seq_slots=2,
                          shadow_slots=2, cross_shard=True)
    HOT = [6, 6, 6, 6, 0, 0, 0, 0]

    def test_overflow_exports_to_idle_shard(self):
        _, hist = _run(self.CFG, self.HOT, 6)
        assert sum(float(h["cross_redirected"]) for h in hist) > 0
        _, hist_off = _run(self.CFG._replace(cross_shard=False), self.HOT, 6)
        assert all(float(h["cross_redirected"]) == 0 for h in hist_off)
        assert int(hist[-1]["queued"]) < int(hist_off[-1]["queued"])

    @pytest.mark.parametrize("hot", [0, 1])
    def test_imported_sequences_homed_to_source_shard(self, hot):
        arrivals = self.HOT if hot == 0 else self.HOT[4:] + self.HOT[:4]
        state, hist = _run(self.CFG, arrivals, 4)
        assert sum(float(h["cross_redirected"]) for h in hist) > 0
        host = slice(4, 8) if hot == 0 else slice(0, 4)
        home = state.home_of[host]
        src = range(4 * hot, 4 * hot + 4)
        imported = (state.pool.seq_active[host] & (home >= src.start)
                    & (home < src.stop))
        # attributed at shard granularity: the source shard's base id
        assert bool(imported.any())
        assert bool((home[imported] == src.start).all())

    def test_metered_link_account_holds_across_shards(self):
        cfg = self.CFG._replace(pages_per_replica=8, max_pages=8,
                                link_pages_per_step=1)
        _, hist = _run(cfg, [5, 5, 5, 5, 0, 0, 0, 0], 8)
        for h in hist:
            assert (h["link_redirect_bytes"] + h["link_spill_bytes"]
                    <= h["link_budget_bytes"] + 1e-4).all()


class TestEnclosureGroupedTopology:
    """tests/test_sharded.py's depth-3 engine tests on the port."""

    def _cfg(self, **kw):
        base = dict(n_replicas=16, n_shards=4, seq_slots=2, shadow_slots=2,
                    cross_shard=True, shards_per_enclosure=2)
        base.update(kw)
        return TE.EngineConfig(**base)

    def test_overflow_still_exports_and_link_account_holds(self):
        cfg = self._cfg(link_pages_per_step=2)
        assert TE.shard_topology(cfg) == ttopo.two_level(2, 2)
        _, hist = _run(cfg, [6] * 4 + [0] * 12, 6)
        assert sum(float(h["cross_redirected"]) for h in hist) > 0
        for h in hist:
            assert (h["link_redirect_bytes"] + h["link_spill_bytes"]
                    <= h["link_budget_bytes"] + 1e-4).all()

    def test_bad_enclosure_grouping_rejected(self):
        with pytest.raises(ValueError, match="shards_per_enclosure"):
            TE.init(self._cfg(shards_per_enclosure=3), device="cpu")

    def test_explicit_single_enclosure_is_flat(self):
        cfg = self._cfg(shards_per_enclosure=4)
        assert TE.shard_topology(cfg) == ttopo.flat(4)


@pytest.mark.parametrize("later", [
    dict(trace_driven=True, migrate_pages_per_step=1), dict(track_failures=True),
    dict(migrate_pages_per_step=1),
    dict(obs=E.obs_m.ObsConfig(enabled=True), track_failures=True),
])
def test_later_slice_options_raise_with_shards(later):
    """The failure plane's options, refused with shards until they were
    ported, step on the hierarchy as the reference's vmap does."""
    cfg = E.EngineConfig(n_replicas=8, n_shards=2, shards_per_enclosure=0,
                         **later)
    jstate = E.init(cfg, jax.random.key(0))
    tcfg = port_cfg(cfg)
    tstate = TE.state_from_numpy(tcfg, jax.tree.map(np.asarray, jstate), "cpu")
    for i in range(4):
        arr = np.ones(8, np.int32)
        jstate, jst = E.step(cfg, jstate, jnp.asarray(arr))
        tstate, tst = TE.step(tcfg, tstate, torch.from_numpy(arr),
                              x=torch.from_numpy(_activations(cfg, i)))
        _compare_stats(jst, tst, i)
        _compare_leaves(jstate, tstate, f"step {i}")


# ----------------------------------------------------------- link account

@pytest.mark.parametrize("quant,link_pages", [("none", 1), ("int8", 2)])
def test_drive_link_account_matches_reference_totals(quant, link_pages):
    """The port's scenario and `drive_link_account` give the reference's
    totals (the harvesting does not depend on the weights or
    activations)."""
    jcfg, jstate = JS.link_account_scenario(link_pages=link_pages, quant=quant)
    want = JS.drive_link_account(
        jcfg, jstate, lambda i: jnp.zeros((4,), jnp.int32).at[1].set(8), 10)
    cfg, state = TS.link_account_scenario(link_pages=link_pages, quant=quant,
                                          device="cpu")
    got = TS.drive_link_account(
        cfg, state, lambda i: torch.tensor([0, 8, 0, 0], dtype=torch.int32), 10)
    assert got.saw_redirect and got.saw_spill
    for f in ("cmd_saturated", "saw_redirect", "saw_spill"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("redirect_bytes", "spill_bytes", "budget_bytes"):
        assert getattr(got, f) == pytest.approx(getattr(want, f),
                                                rel=DEFAULT_RTOL), f
