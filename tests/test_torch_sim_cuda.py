"""The JBOF simulator on the card against the port's own CPU path (its
plain version) on the same inputs. Marked ``cuda``: it skips where there
is no CUDA device, and imports neither JAX nor `repro`, so the card's
machine runs it as it is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_sim_cuda.py

Cases: a short static run of fig. 9's JBOF on XBOF and XBOF+ (120
windows), two enclosures federated (60 windows), and a short trace-driven
run with the observability plane (fig. 20's scenario, 150 windows, the
burst over windows 40-100). Gates: the descriptor tables bit for bit, the
window loop without a host sync (the sync debug mode raises on one), one
`shards_window` launch a window on the trace-driven run, the SHARDS
tables and the decoded events' integer columns equal, every float within
1e-4 relative (a floor of 1e-4 times the field's largest value;
``latency_s`` also takes qd × window_s for each window in which an SSD's
backlog is only a rounding residue, tests/test_torch_sim.py)."""
import numpy as np
import pytest
import torch

from repro_torch.jbof import platforms as P
from repro_torch.jbof import sim as S
from repro_torch.jbof import workloads as W
from repro_torch.kernels import shards_window as sw
from repro_torch.obs import metrics as obs_m
from repro_torch.telemetry import traces as T

pytestmark = pytest.mark.cuda

TOL = 1e-4
INT_LEAVES = ("valid", "rtype", "borrower_id", "info_a", "info_b")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _loop(prepared):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return S.run_prepared(prepared)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _compare(plat, cfg, wls, arr, dev):
    gt = _loop(S.prepare(plat, wls, arr, cfg, device=dev))
    ct = S.run_prepared(S.prepare(plat, wls, arr, cfg, device="cpu"))
    for name in INT_LEAVES:
        assert torch.equal(getattr(gt.state.table, name).cpu(),
                           getattr(ct.state.table, name)), name
    g, c = S.summarize(plat, cfg, gt), S.summarize(plat, cfg, ct)
    k = (np.asarray(arr)[gt.warmup:].sum(axis=-1) == 0).sum(axis=0)
    qd = np.array([w.qd for w in wls])
    cmd = ct.state.cmd_count.reshape(-1).numpy()
    for name in g._fields:
        a, b = getattr(g, name), getattr(c, name)
        if a is None or isinstance(a, dict):
            continue
        a, b = a.cpu().double().numpy(), b.double().numpy()
        floor = TOL * float(np.max(np.abs(b))) if b.size else 0.0
        bound = TOL * np.abs(b) + floor
        if name == "latency_s":
            bound = TOL * np.abs(b) + qd * cfg.window_s * k / np.maximum(cmd, 1.0)
        if name == "host_util":
            bound = 1e-3 * np.abs(b)
        assert (np.abs(a - b) <= bound + 1e-30).all(), (name, a, b)
    return gt, ct, g, c


@pytest.mark.parametrize("name", ["XBOF", "XBOF+"])
def test_static_jbof_matches_cpu_path(name, dev):
    wls = [W.micro(True, 64.0)] * 6 + [W.idle()] * 6
    arr = W.arrivals(wls, 120, seed=0)
    _compare(P.ALL[name](), S.SimConfig(warmup=20), wls, arr, dev)


def test_two_enclosures_match_cpu_path(dev):
    wls = [W.micro(False, 4.0, qd=4, random_access=True)] * 4 + [W.idle()] * 4
    arr = W.arrivals(wls, 60, seed=7)
    _, _, g, _ = _compare(P.xbof(), S.SimConfig(warmup=10, n_enclosures=2), wls,
                          arr, dev)
    assert float(g.borrowed_far.sum()) > 0.0


def test_trace_driven_with_obs_matches_cpu_path(dev):
    n, burst = 150, (40, 100)
    wls = [W.micro(True, 4.0, qd=8, random_access=True)] * 4 + [W.idle()] * 4
    arr = W.arrivals(wls, n, seed=0)
    sched = [T.phase_change(n, burst[0], burst[1], T.segments(360), T.segments(12), 48)
             for _ in range(4)] + [[]] * 4
    cfg = S.SimConfig(warmup=20, traces=T.synth_trace(n, sched, 48, seed=1),
                      obs=obs_m.ObsConfig(enabled=True, ring_depth=32,
                                          event_capacity=512))
    sw.shards_window.launches = 0
    gt, ct, g, c = _compare(P.xbof(dram_frac=0.08), cfg, wls, arr, dev)
    assert sw.shards_window.launches == n
    for name in ("addrs", "last_seen", "clock"):
        assert torch.equal(getattr(gt.state.mrc, name).cpu(), getattr(ct.state.mrc, name))
    cols = ("t", "event", "rtype", "level", "lender", "borrower", "lane")
    assert g.obs["events"] and [tuple(r[k] for k in cols) for r in g.obs["events"]] == \
        [tuple(r[k] for k in cols) for r in c.obs["events"]]
