"""The JBOF simulator's other kinds of run on the port against the JAX
reference, on the CPU: several enclosures (the reference vmaps the window
step over them; the port carries a leading enclosure axis), with the
fabric level federated or not, the observability plane on, and the
trace-driven DRAM want.

Cases: tests/test_obs.py's scenario (`TestSimObs._scenario`: 4 random
4 KB writers at QD 4, 4 idle, 120 windows, seed 7) on XBOF with 1, 2 and
4 enclosures, federation on and off, ``fabric_extra_hops`` 1 and 64, obs
on and off; fig. 20's trace-driven scenario at 240 windows (burst over
windows 70-170) with obs on; and fig. 22's fleet at 256 SSDs (16
enclosures), federated and isolated, whose busy-SSD latency is also
`chip_smoke.py`'s `sim_fleet4096` pin.

Gates as in tests/test_torch_sim.py (the descriptor tables bit for bit,
floats within 1e-5 relative with its stated bounds); the obs plane's
rings, totals and decoded events (integer columns exact, amount and
price within 1e-5), the SHARDS estimators bit for bit; and the port's own
properties: one enclosure is the flat run bit for bit, obs on changes no
physics, an enclosure count that does not divide the SSDs raises
``ValueError``, a bare run knob raises ``TypeError``, and a run with
``events`` matches the reference (tests/test_torch_sim_events.py holds the
event plane to it in full)."""
import numpy as np
import pytest
import torch

from repro.core import events as JE
from repro.jbof import platforms as JP
from repro.jbof import sim as JS
from repro.jbof import workloads as JW
from repro.obs import metrics as JO
from repro.telemetry import traces as JT
from repro_torch.core import events as TE
from repro_torch.jbof import platforms as TP
from repro_torch.jbof import sim as TS
from repro_torch.jbof import workloads as TW
from repro_torch.obs import metrics as TO
from repro_torch.telemetry import traces as TT
from test_torch_sim import (RTOL, _chip_smoke, assert_result_close,
                            assert_state_close, port_run, ref_run, tw)

OBS_WLS = [JW.micro(False, 4.0, qd=4, random_access=True)] * 4 + [JW.idle()] * 4
RING, EVENTS = 32, 512

# (enclosures, federation, fabric_extra_hops, obs)
CASES = {
    "flat-obs": (1, True, None, True),
    "e2-fed-obs": (2, True, None, True),
    "e2-iso-obs": (2, False, None, True),
    "e4-fed-hops1-obs": (4, True, 1.0, True),
    "e4-fed-hops64": (4, True, 64.0, False),
    "e4-iso-hops64": (4, False, 64.0, False),
}

EV_INT = ("t", "event", "rtype", "level", "lender", "borrower", "lane")


def _plats(hops):
    jp, tp = JP.xbof(), TP.xbof()
    if hops is not None:
        jp, tp = (p._replace(fabric_extra_hops=hops) for p in (jp, tp))
    return jp, tp


def _cfgs(e, fed, obs, **kw):
    return (JS.SimConfig(n_enclosures=e, fabric_federation=fed,
                         obs=JO.ObsConfig(enabled=obs, ring_depth=RING,
                                          event_capacity=EVENTS), **kw),
            TS.SimConfig(n_enclosures=e, fabric_federation=fed,
                         obs=TO.ObsConfig(enabled=obs, ring_depth=RING,
                                          event_capacity=EVENTS), **kw))


def assert_obs_close(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert set(got["metrics"]) == set(want["metrics"])
    for k, w in want["metrics"].items():
        floor = RTOL * float(np.max(np.abs(w))) if w.size else 0.0
        np.testing.assert_allclose(got["metrics"][k], w, rtol=RTOL,
                                   atol=max(floor, 1e-30), err_msg=k)
    for k, w in want["totals"].items():
        np.testing.assert_allclose(got["totals"][k], w, rtol=RTOL, err_msg=k)
    assert got["events_dropped"] == want["events_dropped"]
    ge, we = got["events"], want["events"]
    assert len(ge) == len(we) > 0
    assert [tuple(r[k] for k in EV_INT) for r in ge] == \
        [tuple(r[k] for k in EV_INT) for r in we]
    for k in ("amount", "price"):
        np.testing.assert_allclose([r[k] for r in ge], [r[k] for r in we],
                                   rtol=RTOL, atol=1e-9, err_msg=k)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    e, fed, hops, obs = CASES[request.param]
    arr = np.asarray(JW.arrivals(OBS_WLS, 120, seed=7))
    jp, tp = _plats(hops)
    jc, tc = _cfgs(e, fed, obs)
    want, carry = ref_run(jp, OBS_WLS, arr, jc)
    got, traj = port_run(tp, OBS_WLS, arr, tc)
    return request.param, want, carry, got, traj, arr


def test_result_matches_reference(case):
    _, want, carry, got, traj, arr = case
    assert_result_close(got, want, arr=arr, warmup=traj.warmup, wls=OBS_WLS,
                        cmd_count=carry[0].cmd_count)


def test_state_matches_reference(case):
    _, _, carry, _, traj, arr = case
    assert int(carry[1]) == traj.miss.shape[0]
    assert_state_close(traj.state, carry[0], arr)


def test_obs_matches_reference(case):
    name, want, _, got, _, _ = case
    assert_obs_close(got.obs, want.obs)
    e, fed, _, obs = CASES[name]
    if obs and e > 1 and fed:
        assert any(r["event"] == "fabric_grant" for r in got.obs["events"])


def test_federation_moves_segments(case):
    name, _, _, got, _, _ = case
    e, fed, _, _ = CASES[name]
    far = float(got.borrowed_far.sum())
    if e > 1 and fed:
        assert far > 0.0
    else:
        assert far == 0.0


def _port(e=1, fed=True, obs=False, n=60, device="cpu"):
    arr = TW.arrivals(tw(OBS_WLS), n, seed=7)
    _, tc = _cfgs(e, fed, obs)
    return TS.simulate(TP.xbof(), tw(OBS_WLS), arr, tc, device=device)


PHYSICS = ("throughput_bps", "read_bps", "write_bps", "latency_s", "proc_util",
           "flash_util", "miss_ratio", "dwpd", "energy_j", "host_util",
           "log_commits", "cxl_bytes", "borrowed_seg", "borrowed_far")


def test_one_enclosure_is_the_flat_run_bitwise():
    arr = TW.arrivals(tw(OBS_WLS), 60, seed=7)
    a = TS.simulate(TP.xbof(), tw(OBS_WLS), arr, device="cpu")
    b = TS.simulate(TP.xbof(), tw(OBS_WLS), arr, TS.SimConfig(n_enclosures=1),
                    device="cpu")
    for f in PHYSICS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("e", [1, 2])
def test_obs_on_changes_no_physics(e):
    a, b = _port(e=e), _port(e=e, obs=True)
    assert a.obs is None and b.obs is not None
    for f in PHYSICS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for k in a.rings:
        assert torch.equal(a.rings[k], b.rings[k]), k


def test_enclosures_must_divide_the_ssds():
    arr = TW.arrivals(tw(OBS_WLS), 10, seed=0)
    with pytest.raises(ValueError, match="enclosure"):
        TS.simulate(TP.xbof(), tw(OBS_WLS), arr, TS.SimConfig(n_enclosures=3),
                    device="cpu")


def test_events_and_legacy_keywords_are_refused():
    """``events`` runs since the failure plane was ported (an SSD failing
    at window 10 of 16, as the reference runs it); a bare run knob is
    still refused."""
    arr = TW.arrivals(tw(OBS_WLS), 16, seed=0)
    want, _ = ref_run(JP.xbof(), OBS_WLS, np.asarray(arr), JS.SimConfig(
        warmup=4, events=JE.schedule(JE.ssd_fail(10, 3))))
    got, traj = port_run(TP.xbof(), OBS_WLS, arr, TS.SimConfig(
        warmup=4, events=TE.schedule(TE.ssd_fail(10, 3))))
    assert_result_close(got, want, arr=arr, warmup=traj.warmup, wls=OBS_WLS,
                        cmd_count=traj.state.cmd_count)
    with pytest.raises(TypeError, match="cfg=SimConfig"):
        TS.simulate(TP.xbof(), tw(OBS_WLS), arr, device="cpu", n_enclosures=2)


# ---------------------------------------------------- trace-driven, fig. 20
def _fig20_traces(mod, n, burst, busy, refs=48):
    sched = [mod.phase_change(n, burst[0], burst[1], mod.segments(360),
                              mod.segments(12), refs) for _ in range(busy)]
    return mod.synth_trace(n, sched + [[]] * busy, refs, seed=1)


@pytest.fixture(scope="module")
def fig20():
    n, burst = 240, (70, 170)
    wls = [JW.micro(True, 4.0, qd=8, random_access=True)] * 4 + [JW.idle()] * 4
    arr = np.asarray(JW.arrivals(wls, n, seed=0))
    jt = np.asarray(_fig20_traces(JT, n, burst, 4))
    tt = _fig20_traces(TT, n, burst, 4)
    np.testing.assert_array_equal(tt, jt)
    obs = dict(enabled=True, ring_depth=64, event_capacity=1024)
    want, carry = ref_run(JP.xbof(dram_frac=0.08), wls, arr,
                          JS.SimConfig(traces=jt, obs=JO.ObsConfig(**obs)))
    got, traj = port_run(TP.xbof(dram_frac=0.08), wls, arr,
                         TS.SimConfig(traces=tt, obs=TO.ObsConfig(**obs)))
    return want, carry, got, traj, arr, wls, burst


def test_trace_driven_matches_reference(fig20):
    want, carry, got, traj, arr, wls, _ = fig20
    assert_result_close(got, want, arr=arr, warmup=traj.warmup, wls=wls,
                        cmd_count=carry[0].cmd_count)
    assert_state_close(traj.state, carry[0], arr)
    assert_obs_close(got.obs, want.obs)
    # the SHARDS estimators bit for bit
    for name in carry[0].mrc._fields:
        a = getattr(traj.state.mrc, name)
        b = np.asarray(getattr(carry[0].mrc, name))
        np.testing.assert_array_equal(a.reshape(b.shape).numpy().astype(b.dtype), b,
                                      err_msg=name)


def test_trace_driven_returns_segments(fig20):
    """fig. 20's gate on the port: the busy SSDs borrow during the burst
    and give the segments back after it."""
    _, _, got, _, _, _, burst = fig20
    busy = got.rings["borrowed_seg"][:, :4].sum(dim=1).numpy()
    peak = float(busy[burst[0]:burst[1]].max())
    assert peak >= 50.0
    assert float(busy[burst[1] + 40:].max()) <= 0.1 * peak


# ------------------------------------------------------ fleet, fig. 22
def _fleet(n, wmod):
    e = n // 16
    n_busy = (e // 2) * 16
    wls = ([wmod.micro(read=False, io_kb=4, qd=4, random_access=True)] * n_busy
           + [wmod.micro(read=True, io_kb=128, qd=1)] * (n - n_busy))
    arr = np.zeros((200, n, 2), np.float32)
    arr[:, :n_busy, 1] = 900e6 * 1e-3
    arr[:, n_busy:, 0] = 1e6 * 1e-3
    return wls, arr, e, n_busy


@pytest.fixture(scope="module", params=["federated", "isolated"])
def fleet(request):
    fed = request.param == "federated"
    wls, arr, e, n_busy = _fleet(256, JW)
    jp, tp = _plats(1.0)
    want, carry = ref_run(jp, wls, arr, JS.SimConfig(
        warmup=50, n_enclosures=e, fabric_federation=fed))
    got, traj = port_run(tp, wls, arr, TS.SimConfig(
        warmup=50, n_enclosures=e, fabric_federation=fed))
    return request.param, want, carry, got, traj, arr, wls, n_busy


def test_fleet_matches_reference(fleet):
    _, want, carry, got, traj, arr, wls, _ = fleet
    assert_result_close(got, want, arr=arr, warmup=traj.warmup, wls=wls,
                        cmd_count=carry[0].cmd_count)
    assert_state_close(traj.state, carry[0], arr)


def test_fleet_pin_equals_reference(fleet):
    """chip_smoke.py's `sim_fleet4096` gate holds the card's busy-SSD
    latency to the reference's mean at 256 SSDs: the pin must be it."""
    mode, want, _, got, _, _, _, n_busy = fleet
    ref = float(np.asarray(want.latency_s)[:n_busy].astype(np.float64).mean())
    assert _chip_smoke().SIM_FLEET_PINS[mode] == ref
    lat = got.latency_s[:n_busy].double().mean().item()
    assert abs(lat - ref) <= RTOL * ref
    assert float(np.ptp(np.asarray(want.latency_s)[:n_busy])) == 0.0
