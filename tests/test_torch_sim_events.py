"""The JBOF simulator's failure/reclaim plane (`SimConfig(events=...)`) on
the port against the JAX reference, on the CPU.

Cases: fig. 23's simulator run (benchmarks/fig23_failover.py:93-131: 8
SSDs, 4 random 4 KB writers and 4 random readers, two lenders' loads
ramping before their forced reclaims at windows 50 and 70, an SSD failing
at 90, 120 windows, XBOF, obs on) on one JBOF; and fig. 22's fleet at 256
SSDs (16 enclosures of 16, federated, 1 extra fabric hop) with a lender
reclaim, an SSD failure and two enclosure drops — `chip_smoke.py`'s
`sim_fleet_events` schedule, whose `revoked_grants` sum here is its pin.

Gates as in tests/test_torch_sim.py (descriptor tables bit for bit,
floats within 1e-5 relative with its stated bounds), the
`revoked_grants` ring equal exactly, the obs plane's decoded events
equal, and fig. 23's simulator gates: PROCESSOR withdraws
[(50, 4), (70, 5)], the predictor's score 1.0 / 1.0 / 3.0, 6 grants
revoked (benchmarks/baselines/fig23_failover.json)."""
import numpy as np
import pytest

from repro.core import events as JE
from repro.jbof import platforms as JP
from repro.jbof import sim as JS
from repro.jbof import workloads as JW
from repro.obs import metrics as JO
from repro.telemetry import reclaim as JR
from repro_torch.core import events as TE
from repro_torch.jbof import platforms as TP
from repro_torch.jbof import sim as TS
from repro_torch.obs import metrics as TO
from repro_torch.telemetry import reclaim as TR
from test_torch_sim import (_chip_smoke, assert_result_close, assert_state_close,
                            port_run, ref_run)
from test_torch_sim_fabric_obs import EV_INT, _fleet


def _sched(mod, events):
    return mod.schedule(*(getattr(mod, kind)(*args) for kind, *args in events))


@pytest.fixture(scope="module")
def fig23():
    c = _chip_smoke().SIM_EVENTS8
    wls, arr = _chip_smoke().sim_events8_inputs(JW)
    obs = dict(enabled=True, ring_depth=c["windows"])
    want, carry = ref_run(JP.xbof(), wls, arr, JS.SimConfig(
        events=_sched(JE, c["events"]), obs=JO.ObsConfig(**obs)))
    got, traj = port_run(TP.xbof(), wls, arr, TS.SimConfig(
        events=_sched(TE, c["events"]), obs=TO.ObsConfig(**obs)))
    return c, wls, arr, want, carry, got, traj


def test_fig23_run_matches_reference(fig23):
    _, wls, arr, want, carry, got, traj = fig23
    assert_result_close(got, want, arr=arr, warmup=traj.warmup, wls=wls,
                        cmd_count=carry[0].cmd_count)
    assert_state_close(traj.state, carry[0], arr)
    np.testing.assert_array_equal(got.rings["revoked_grants"].numpy(),
                                  np.asarray(want.rings["revoked_grants"]))
    ge, we = got.obs["events"], want.obs["events"]
    assert [tuple(r[k] for k in EV_INT) for r in ge] == \
        [tuple(r[k] for k in EV_INT) for r in we]


def test_fig23_gates(fig23):
    c, _, _, want, _, got, _ = fig23
    gates = _chip_smoke().sim_events8_gates(got, TR.evaluate)
    assert gates == _chip_smoke().sim_events8_gates(want, JR.evaluate)
    assert gates == (c["withdraws"], c["score"], c["revoked"])
    assert c["withdraws"] == [(50, 4), (70, 5)] and c["score"] == (1.0, 1.0, 3.0)
    assert c["revoked"] == 6.0
    # the dead SSD serves nothing after window 90
    assert float(got.rings["revoked_grants"][90]) > 0
    assert not got.rings["revoked_grants"][91:].any()


@pytest.fixture(scope="module")
def fleet():
    cs = _chip_smoke()
    wls, arr, _ = cs.fleet_inputs(JW, 256)
    arr = arr[:cs.SIM_FLEET_EVENTS["windows"]]
    e = 256 // cs.SIM_FLEET["per_enclosure"]
    jp = JP.xbof()._replace(fabric_extra_hops=cs.SIM_FLEET["extra_hops"])
    tp = TP.xbof()._replace(fabric_extra_hops=cs.SIM_FLEET["extra_hops"])
    ev = cs.SIM_FLEET_EVENTS["events"]
    want, carry = ref_run(jp, wls, arr, JS.SimConfig(
        warmup=50, n_enclosures=e, events=_sched(JE, ev)))
    got, traj = port_run(tp, wls, arr, TS.SimConfig(
        warmup=50, n_enclosures=e, events=_sched(TE, ev)))
    return cs, wls, arr, want, carry, got, traj


def test_fleet_with_events_matches_reference(fleet):
    _, wls, arr, want, carry, got, traj = fleet
    assert_result_close(got, want, arr=arr, warmup=traj.warmup, wls=wls,
                        cmd_count=carry[0].cmd_count)
    assert_state_close(traj.state, carry[0], arr)
    np.testing.assert_array_equal(got.rings["revoked_grants"].numpy(),
                                  np.asarray(want.rings["revoked_grants"]))


def test_fleet_events_pin_equals_reference(fleet):
    """chip_smoke.py's `sim_fleet_events` gate holds the card's
    revoked-grant sum at 256 SSDs to the reference's: the pin must be it.
    The SSD failure and both drops revoke; the fabric carry of a dropped
    enclosure counts in grant units."""
    cs, _, arr, want, _, got, _ = fleet
    # the same inputs as tests/test_torch_sim_fabric_obs.py's fleet, cut
    wls, full, _, _ = _fleet(256, JW)
    np.testing.assert_array_equal(arr, full[:len(arr)])
    assert arr.shape[0] == 130 < full.shape[0]
    ring = np.asarray(want.rings["revoked_grants"])
    assert cs.SIM_FLEET_EVENTS_PIN == float(ring.astype(np.float64).sum())
    assert float(got.rings["revoked_grants"].double().sum()) == cs.SIM_FLEET_EVENTS_PIN
    assert np.count_nonzero(ring) == 3
