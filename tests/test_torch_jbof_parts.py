"""The JBOF simulator's building blocks on the port against the JAX
reference, on the CPU: the SSD model, the platforms and the BOM (plain
Python, equal values), the workloads (Table 2, the constructors, and the
seeded arrival matrices bit for bit), the parametric MRC and the static
want grid, the manager's `fluid_transfer` and `busy_split` on drawn inputs
(with and without a leading axis; within 1e-6 relative, since the port
sums the pledges left to right as the compiled reference does and the
eager reference may not) plus tests/test_conservation.py's conservation
properties, the descriptors' `spec_of`, `withdraw` and `release` bit for
bit, and the compiled reference's sums that the simulator mirrors: the
product fused into a row sum (`manager.fma_rowsum`) and the blocked prefix
sum of a 64-bucket curve (`shards_mrc.prefix_sum`), both bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import costs as JC
from repro.core import descriptors as JD
from repro.core import manager as JM
from repro.jbof import bom as JB
from repro.jbof import platforms as JP
from repro.jbof import sim as JS
from repro.jbof import ssd as JSSD
from repro.jbof import workloads as JW
from repro_torch.core import costs as TC
from repro_torch.core import descriptors as TD
from repro_torch.core import manager as TM
from repro_torch.core import shards_mrc as TSM
from repro_torch.jbof import bom as TB
from repro_torch.jbof import platforms as TP
from repro_torch.jbof import sim as TS
from repro_torch.jbof import ssd as TSSD
from repro_torch.jbof import workloads as TW

jax.config.update("jax_platform_name", "cpu")


def t32(a):
    return torch.from_numpy(np.array(a, np.float32))


# --------------------------------------------------------------- constants
def test_ssd_constants_equal_reference():
    names = [k for k in vars(JSSD) if k.isupper()]
    assert len(names) > 50
    for k in names:
        assert getattr(TSSD, k) == getattr(JSSD, k), k
    for cores, dram, cxl in ((6, 1.0, False), (3, 0.5, True), (0.0, 1 / 3, False)):
        a = JSSD.SSDConfig(cores, dram, cxl)
        b = TSSD.SSDConfig(cores, dram, cxl)
        assert tuple(a) == tuple(b)
        assert a.proc_clocks_per_s == b.proc_clocks_per_s
        assert a.dram_segments == b.dram_segments
    for read in (True, False):
        for io in (512.0, 4096.0, 65536.0, 1 << 20):
            assert TSSD.proc_clocks_per_cmd(read, io) == JSSD.proc_clocks_per_cmd(read, io)
            assert TSSD.flash_pages_per_cmd(read, io) == JSSD.flash_pages_per_cmd(read, io)
            assert (TSSD.service_latency_s(read, io, 3, 0.2, 0.5)
                    == JSSD.service_latency_s(read, io, 3, 0.2, 0.5))


@pytest.mark.parametrize("name", list(JP.ALL))
def test_platform_equals_reference(name):
    a, b = JP.ALL[name](), TP.ALL[name]()
    assert a._fields == b._fields
    assert tuple(a) == tuple(b)
    assert tuple(a.ssd_config) == tuple(b.ssd_config)
    assert a.ssd_config.dram_segments == b.ssd_config.dram_segments
    pols_a, slots_a = JS._policies(a)
    pols_b, slots_b = TS._policies(b)
    assert slots_a == slots_b
    assert [tuple(p) for p in pols_a] == [tuple(p) for p in pols_b]


def test_platform_constructors_with_arguments():
    for f in ("shrunk", "vh", "vh_ideal", "proch", "xbof", "xbof_full"):
        assert tuple(getattr(JP, f)(cores=2.0, dram_frac=0.08)) == tuple(
            getattr(TP, f)(cores=2.0, dram_frac=0.08))
    assert list(JP.ALL) == list(TP.ALL)


@pytest.mark.parametrize("name", ["Conv", "OC", "Shrunk", "VH", "VH(ideal)",
                                  "ProcH", "XBOF"])
def test_bom_equals_reference(name):
    for cap in (2.0, 4.0):
        assert TB.platform_cost(name, cap) == JB.platform_cost(name, cap)
        assert TB.cost_efficiency(3.1e9, name, cap) == JB.cost_efficiency(3.1e9, name, cap)
    assert TB.ssd_cost(4.0, 0.5, 0.25, cxl=True) == JB.ssd_cost(4.0, 0.5, 0.25, cxl=True)
    with pytest.raises(ValueError):
        TB.platform_cost("XBOF+")


def test_bom_saving_is_the_papers():
    conv = TB.platform_cost("Conv")["total"]
    assert abs(TB.platform_cost("XBOF")["total"] / conv - 1 - (-0.19)) < 0.01


# --------------------------------------------------------------- workloads
def _tw(wls):
    return [TW.Workload(*w) for w in wls]


def test_workload_tables_equal_reference():
    assert list(TW.TABLE2) == list(JW.TABLE2) == TW.REAL_WORKLOADS
    for k in JW.TABLE2:
        assert tuple(TW.TABLE2[k]) == tuple(JW.TABLE2[k])
        assert TW.capacity_bps(TW.TABLE2[k]) == JW.capacity_bps(JW.TABLE2[k])
        assert TW.mean_cmd_bytes(TW.TABLE2[k]) == JW.mean_cmd_bytes(JW.TABLE2[k])
    for args in ((True, 64.0), (False, 4.0, 1), (True, 4.0, 8, True), (False, 128.0, 32)):
        assert tuple(TW.micro(*args)) == tuple(JW.micro(*args))
    assert tuple(TW.idle()) == tuple(JW.idle())
    for args in ((), (True, 16.0, 32), (False, 4.0, 2)):
        assert tuple(TW.moderate(*args)) == tuple(JW.moderate(*args))


ARRIVAL_CASES = {
    "fig9_micro_read": ([JW.micro(True, 64.0)] * 6 + [JW.idle()] * 6, 400, 0, True),
    "table2_mix": ([JW.TABLE2[k] for k in JW.REAL_WORKLOADS[:8]], 120, 3, True),
    "unstaggered": ([JW.TABLE2["Ali-0"]] * 4 + [JW.moderate()] * 2, 64, 11, False),
    "fig20": ([JW.micro(True, 4.0, qd=8, random_access=True)] * 4
              + [JW.idle()] * 4, 480, 0, True),
}


@pytest.mark.parametrize("case", list(ARRIVAL_CASES))
def test_arrivals_bit_equal(case):
    wls, n, seed, stagger = ARRIVAL_CASES[case]
    want = np.asarray(JW.arrivals(wls, n, seed=seed, phase_stagger=stagger))
    got = TW.arrivals(_tw(wls), n, seed=seed, phase_stagger=stagger)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wname", ["src", "Tencent-0", "Ali-1", "micro"])
def test_mrc_curve_matches_reference(wname):
    w = JW.micro(True, 4.0) if wname == "micro" else JW.TABLE2[wname]
    c = np.linspace(-0.1, 1.2, 57).astype(np.float32)
    want = np.asarray(JW.mrc_curve(w, jnp.asarray(c)))
    got = TW.mrc_curve(TW.Workload(*w), torch.from_numpy(c))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


WANT_SETS = {
    "micro_read": [JW.micro(True, 64.0)] * 6 + [JW.idle()] * 6,
    "rand_read": [JW.micro(True, 4.0, qd=1, random_access=True)] * 6 + [JW.idle()] * 6,
    "table2": [JW.TABLE2[k] for k in JW.REAL_WORKLOADS],
    "moderate": [JW.moderate(True, 4.0, q) for q in (1, 8, 32)],
}


@pytest.mark.parametrize("wset", list(WANT_SETS))
def test_static_want_frac_and_miss_ratio(wset):
    """The want grid is an index into 33 exact fractions: equal; the miss
    ratio (a power) within 1e-6."""
    wls = WANT_SETS[wset]
    jv = JS.workload_vec(wls)
    tv = TS.workload_vec(_tw(wls), device="cpu")
    np.testing.assert_array_equal(TS.static_want_frac(tv).numpy(),
                                  np.asarray(JS.static_want_frac(jv)))
    cf = np.linspace(0.0, 1.0, len(wls)).astype(np.float32)
    np.testing.assert_allclose(
        TS._miss_ratio(tv, torch.from_numpy(cf)).numpy(),
        np.asarray(JS._miss_ratio(jv, jnp.asarray(cf))), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------- manager: transfers
def _transfer_inputs(n, seed, lead=()):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 3, lead + (n, n)).astype(np.float32)
    for idx in np.ndindex(*lead):
        np.fill_diagonal(counts[idx], 0.0)
    slots = 4.0
    counts = np.minimum(counts, slots)
    assist = counts / np.maximum(counts.sum(-1, keepdims=True), slots)
    surplus = (rng.random(lead + (n,)) * 1e-3).astype(np.float32)
    deficit = (rng.random(lead + (n,)) * 3e-3).astype(np.float32)
    surplus[..., 0] = 0.0
    return assist.astype(np.float32), surplus, deficit


@settings(max_examples=20, deadline=None)
@given(n=st.integers(2, 16), seed=st.integers(0, 10_000),
       kind=st.sampled_from(["zero", "scalar", "vector"]))
def test_fluid_transfer_and_busy_split_match_reference(n, seed, kind):
    assist, surplus, deficit = _transfer_inputs(n, seed)
    rng = np.random.default_rng(seed + 1)
    oh_vec = (rng.random(n) * 0.5).astype(np.float32)
    j_oh = {"zero": 0.0, "scalar": 0.031, "vector": jnp.asarray(oh_vec)}[kind]
    t_oh = {"zero": 0.0, "scalar": 0.031, "vector": t32(oh_vec)}[kind]
    # the compiled reference (as the simulator runs it)
    jf = jax.jit(lambda a, s, d: JM.fluid_transfer(a, s, d, j_oh))
    want_in, want_from = (np.asarray(x) for x in jf(assist, surplus, deficit))
    got_in, got_from, lent = TM.fluid_transfer(
        t32(assist), t32(surplus), t32(deficit), t_oh, lent=True)
    np.testing.assert_allclose(got_in.numpy(), want_in, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(got_from.numpy(), want_from, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(lent.numpy(), want_from.sum(1), rtol=1e-5, atol=1e-12)
    work = (rng.random(n) * 4e-3).astype(np.float32)
    cap = np.full(n, 3e-3, np.float32)
    want = JM.busy_split(jnp.asarray(work), jnp.asarray(cap), jnp.asarray(want_in),
                         jnp.asarray(want_from))
    got = TM.busy_split(t32(work), t32(cap), got_in, got_from)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("lead", [(3,), (2, 2)])
def test_transfer_leading_axes_equal_per_table(lead):
    """A stack of tables ([..., N, N]) gives each table's own transfer bit
    for bit."""
    n = 6
    assist, surplus, deficit = _transfer_inputs(n, 5, lead)
    oh = t32((np.random.default_rng(2).random(lead + (n,)) * 0.2))
    a_in, a_from, a_lent = TM.fluid_transfer(t32(assist), t32(surplus),
                                             t32(deficit), oh, lent=True)
    work = t32(np.random.default_rng(3).random(lead + (n,)) * 4e-3)
    cap = torch.full(lead + (n,), 3e-3)
    split = TM.busy_split(work, cap, a_in, a_from)
    for idx in np.ndindex(*lead):
        b_in, b_from, b_lent = TM.fluid_transfer(
            t32(assist[idx]), t32(surplus[idx]), t32(deficit[idx]), oh[idx], lent=True)
        assert torch.equal(a_in[idx], b_in) and torch.equal(a_from[idx], b_from)
        assert torch.equal(a_lent[idx], b_lent)
        one = TM.busy_split(work[idx], cap[idx], b_in, b_from)
        for x, y in zip(split, one):
            assert torch.equal(x[idx], y)


@settings(max_examples=25, deadline=None)
@given(n=st.integers(2, 8), seed=st.integers(0, 1000))
def test_fluid_transfer_conserves_capacity(n, seed):
    """tests/test_conservation.py's properties on the port: a lender never
    gives more than its surplus, a borrower never gets more than its
    deficit, and what is received is what was drawn net of the tax."""
    assist, surplus, deficit = _transfer_inputs(n, seed)
    for overhead in (0.0, 0.031, 0.05, 0.02):
        got, used_from = TM.fluid_transfer(t32(assist), t32(surplus),
                                           t32(deficit), overhead)
        assert (used_from.sum(1) <= t32(surplus) + 1e-7).all()
        assert (got <= t32(deficit) + 1e-7).all()
        np.testing.assert_allclose(float(got.sum()) * (1.0 + overhead),
                                   float(used_from.sum()), rtol=1e-4, atol=1e-9)
        own, remote, out = TM.busy_split(t32(deficit) + 1e-3, t32(surplus), got,
                                         used_from)
        assert (remote <= got + 1e-9).all() and (out >= 0).all()


def test_fma_rowsum_and_blocked_prefix_sum_bit_equal_compiled_reference():
    rng = np.random.default_rng(0)
    for n in (6, 12, 16):
        for _ in range(8):
            p = (rng.random((n, n)) * 1e-3).astype(np.float32)
            d = rng.random(n).astype(np.float32)
            want = np.asarray(jax.jit(lambda p, d: (p * d[None, :]).sum(1))(p, d))
            got = TM.fma_rowsum(t32(p), t32(d)[None, :])
            np.testing.assert_array_equal(got.numpy(), want)
    for b in (16, 17, 33, 64, 100, 300):
        x = (rng.random((8, b)) * rng.choice([1e-3, 1.0, 1e3], (8, b))).astype(np.float32)
        want = np.asarray(jax.jit(lambda x: jnp.cumsum(x, axis=-1))(x))
        np.testing.assert_array_equal(TSM.prefix_sum(t32(x)).numpy(), want)


def test_assist_link_bps_takes_a_tensor_of_io_sizes():
    rng = np.random.default_rng(4)
    io = (rng.random(12) * 65536).astype(np.float32)
    svc = (rng.random(12) * 1e-5).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b: JC.assist_link_bps(
        JD.FLASH_BW, a, b, payload_ratio=0.25))(io, svc))
    got = TC.assist_link_bps(TD.FLASH_BW, t32(io), t32(svc), payload_ratio=0.25)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# ---------------------------------------------------------- descriptors
def _random_table(seed, n=6, s=4):
    rng = np.random.default_rng(seed)
    jt = JD.make_table(n, s)
    jt = jt._replace(valid=jnp.asarray(rng.random((n, s)) < 0.6),
                     rtype=jnp.asarray(rng.integers(0, 4, (n, s)), jnp.int8),
                     borrower_id=jnp.asarray(
                         np.where(rng.random((n, s)) < 0.5, JD.FREE,
                                  rng.integers(0, n, (n, s))), jnp.int32),
                     amount_a=jnp.asarray(rng.random((n, s)), jnp.float32))
    tt = TD.IdleResourceTable(*(torch.from_numpy(np.array(x)) for x in jt))
    return jt, tt


def _assert_table_equal(tt, jt):
    for name, a, b in zip(jt._fields, tt, jt):
        b = np.asarray(b)
        assert a.dtype == torch.from_numpy(np.array(b)).dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_of_withdraw_release_bit_equal(seed):
    for r in (JD.PROCESSOR, JD.DRAM, JD.FLASH_BW, JD.LINK_BW):
        assert tuple(TD.spec_of(r)) == tuple(JD.spec_of(r))
        assert TD.spec_of(np.int8(r)) == TD.spec_of(r)
    jt, tt = _random_table(seed)
    for node, slot in ((0, 0), (3, 2), (5, 3)):
        jt = JD.withdraw(jt, node, slot)
        tt = TD.withdraw(tt, node, slot)
        _assert_table_equal(tt, jt)
    for b in (0, 2, 4, JD.FREE):
        _assert_table_equal(TD.release(tt, b), JD.release(jt, b))
    # one borrower per table of a stack
    stack = TD.IdleResourceTable(*(torch.stack([x, x]) for x in tt))
    got = TD.release(stack, torch.tensor([[1], [2]], dtype=torch.int32))
    for i, b in enumerate((1, 2)):
        _assert_table_equal(TD.IdleResourceTable(*(x[i] for x in got)),
                            JD.release(jt, b))
