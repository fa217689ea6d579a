"""The JBOF simulator on the port against the JAX reference, on the CPU:
`repro_torch.jbof.sim.simulate` against `repro.jbof.sim.simulate` on the
same seeded arrivals, per `SimResult` field, and the final state of the
window loop against the final carry of the reference's `lax.scan`.

Cases: the eight platforms of `platforms.ALL` on tests/test_jbof.py's
MICRO_READ (6 busy SSDs of 64 KB sequential reads at QD 64, 6 idle) at
fig. 9's 400 windows, which is also `chip_smoke.py`'s `sim_jbof12`
phase, so these reference runs also recompute its pins; MICRO_WRITE for
VH, VH(ideal) and XBOF+; RAND_READ for XBOF; XBOF with ``flat_sync``
(200 windows each).

Gates: the descriptor table's integer and bool leaves (valid, rtype,
borrower_id, info_a, info_b) bit for bit; every float field and leaf
within ``RTOL`` = 1e-5 relative, with an absolute floor of ``RTOL`` times
the field's largest magnitude. The port mirrors the compiled reference's
arithmetic where a threshold reads it (constant divisors as float32
reciprocals, the transfers' sums as FMA chains, the blocked prefix sum of
the curve); its other rewrites (FMA contraction of the demand sums,
folded constant factors, small matrix products) leave floats an ulp or
so apart, which three quantities magnify, each gated by a stated bound:

- the backlogs left after service (``q_r``, ``q_w``) are differences of
  near-equal numbers: a lender that donates all its surplus serves its own
  demand at a scale of 1 within rounding, leaving bytes of residue of
  demands of 1e5 to 1e8 bytes; they are compared with an absolute floor
  of ``RTOL`` times the run's largest arrival of one window;
- in a window with no arrivals at an SSD, its backlog is that residue
  alone, and the latency the reference books for it (qd / rate times the
  commands served, `src/repro/jbof/sim.py:842-850`) is qd × window_s
  whenever the residue's scale is not 0, on either side: ``latency_s``
  may differ by qd × window_s for each such measured window, over the
  SSD's command count (`residue_windows`);
- the same scale enters ``host_util`` through the mean over the SSDs
  (`sim.py:938`): ``HOST_RTOL`` = 1e-3 relative (1.04e-4 at most here)."""
import sys
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.jbof import platforms as JP
from repro.jbof import sim as JS
from repro.jbof import workloads as JW
from repro_torch.jbof import platforms as TP
from repro_torch.jbof import sim as TS
from repro_torch.jbof import workloads as TW

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
HOST_RTOL = 1e-3
TABLE_INT = ("valid", "rtype", "borrower_id", "info_a", "info_b")

MICRO_READ = [JW.micro(True, 64.0)] * 6 + [JW.idle()] * 6
MICRO_WRITE = [JW.micro(False, 64.0)] * 6 + [JW.idle()] * 6
RAND_READ = [JW.micro(True, 4.0, qd=1, random_access=True)] * 6 + [JW.idle()] * 6
# chip_smoke.py's sim_jbof12 (fig. 9: benchmarks/fig09_processor.py:18)
JBOF12_WINDOWS = 400


def tw(wls):
    return [TW.Workload(*w) for w in wls]


def ref_run(plat, wls, arr, cfg=None):
    """`repro.jbof.sim.simulate`, and the final carry of its outer
    `lax.scan` (the reference returns no state): the outermost scan is the
    last to return."""
    captured = []
    scan = jax.lax.scan

    def spy(*a, **k):
        out = scan(*a, **k)
        captured.append(out)
        return out

    with mock.patch.object(jax.lax, "scan", spy):
        res = JS.simulate(plat, wls, arr, cfg=cfg)
    return res, captured[-1][0]


def port_run(plat, wls, arr, cfg=None):
    cfg = TS.SimConfig() if cfg is None else cfg
    traj = TS.run_prepared(TS.prepare(plat, tw(wls), np.asarray(arr), cfg, device="cpu"))
    return TS.summarize(plat, cfg, traj), traj


def close(got, want, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    floor = RTOL * float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=max(floor, 1e-30),
                               err_msg=name)


def residue_windows(arr, warmup):
    """Per SSD, the measured windows with no arrivals (its backlog is then
    only the residue of earlier service). ``arr``: [T, n, 2]."""
    arr = np.asarray(arr)
    return (arr[warmup:].sum(axis=-1) == 0).sum(axis=0)


def assert_result_close(got, want, *, arr, warmup, wls, cmd_count,
                        window_s=1e-3):
    errors = []
    k = residue_windows(arr, warmup)
    qd = np.array([w.qd for w in wls], np.float64)
    for name in want._fields:
        try:
            if name == "latency_s":
                w = np.asarray(want.latency_s, np.float64)
                bound = RTOL * np.abs(w) + qd * window_s * k / np.maximum(
                    np.asarray(cmd_count, np.float64).reshape(-1), 1.0)
                diff = np.abs(got.latency_s.numpy().astype(np.float64) - w)
                assert (diff <= bound + 1e-12).all(), (name, diff, bound)
            elif name == "host_util":
                np.testing.assert_allclose(got.host_util.numpy(), want.host_util,
                                           rtol=HOST_RTOL, err_msg=name)
            else:
                _field_close(got, want, name)
        except AssertionError as e:
            errors.append(str(e).strip().splitlines()[:8])
    assert not errors, errors


def _field_close(got, want, name):
    w = getattr(want, name)
    if name == "rings":
        assert set(got.rings) == set(w)
        for k in w:
            close(got.rings[k], w[k], f"rings[{k}]")
    elif name == "obs":
        assert (got.obs is None) == (w is None)
    elif w is None:
        assert getattr(got, name) is None or name == "borrowed_far"
    else:
        close(getattr(got, name), w, name)


def assert_table_equal(table, ref_table):
    """The port's table [E, nl, S] against the reference's ([n, S] flat,
    [E, nl, S] under its vmap)."""
    for name in table._fields:
        a, b = getattr(table, name), np.asarray(getattr(ref_table, name))
        a = a.reshape(b.shape)
        if name in TABLE_INT:
            assert a.dtype == torch.from_numpy(np.array(b)).dtype, name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f"table.{name}")
        else:
            close(a, b, f"table.{name}")


STATE_FLOATS = ("q_r", "q_w", "vh_debt", "borrowed_seg", "borrowed_far",
                "prev_proc_own", "prev_flash", "prev_flash_own", "prev_link",
                "prev_link_own", "served_r", "served_w", "proc_busy", "flash_busy",
                "flash_written", "lat_sum", "cmd_count", "log_commits", "cxl_bytes")


def assert_state_close(state, ref_state, arr):
    assert_table_equal(state.table, ref_state.table)
    for name in STATE_FLOATS:
        b = np.asarray(getattr(ref_state, name))
        a = getattr(state, name).reshape(b.shape)
        if name in ("q_r", "q_w"):
            np.testing.assert_allclose(
                a.numpy(), b, rtol=RTOL, atol=RTOL * float(np.max(arr)),
                err_msg=f"state.{name}")
        elif name == "lat_sum":
            continue   # gated through latency_s (`assert_result_close`)
        else:
            close(a, b, f"state.{name}")
    np.testing.assert_allclose(state.host_busy.reshape(np.shape(ref_state.host_busy)),
                               ref_state.host_busy, rtol=HOST_RTOL,
                               err_msg="state.host_busy")


CASES = {f"micro_read-{p}": (p, MICRO_READ, JBOF12_WINDOWS, {}) for p in JP.ALL}
CASES.update({
    "micro_write-VH": ("VH", MICRO_WRITE, 200, {}),
    "micro_write-VH(ideal)": ("VH(ideal)", MICRO_WRITE, 200, {}),
    "micro_write-XBOF+": ("XBOF+", MICRO_WRITE, 200, {}),
    "rand_read-XBOF": ("XBOF", RAND_READ, 200, {}),
    "micro_read-XBOF-flat_sync": ("XBOF", MICRO_READ, 200, {"flat_sync": True}),
})


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    name, wls, n, kw = CASES[request.param]
    arr = np.asarray(JW.arrivals(wls, n, seed=0))
    want, carry = ref_run(JP.ALL[name]()._replace(**kw), wls, arr)
    got, traj = port_run(TP.ALL[name]()._replace(**kw), wls, arr)
    return request.param, want, carry, got, traj, arr, wls


def test_result_fields_match_reference(case):
    _, want, carry, got, traj, arr, wls = case
    assert_result_close(got, want, arr=arr, warmup=traj.warmup, wls=wls,
                        cmd_count=carry[0].cmd_count)


def test_final_state_matches_reference(case):
    """The descriptor table bit for bit, every accumulator and utilization
    within tolerance."""
    _, _, carry, _, traj, arr, _ = case
    ref_state, steps = carry
    assert int(steps) == traj.miss.shape[0]
    assert_state_close(traj.state, ref_state, arr)


def test_harvesting_shows_in_the_table(case):
    """The cases exercise the claim machinery: harvesting platforms hold
    claims at the end, the others never publish."""
    name, _, _, _, traj, _, _ = case
    plat = TP.ALL[CASES[name][0]]()
    valid = traj.state.table.valid
    claimed = valid & (traj.state.table.borrower_id != 0xFF)
    if TS._any_harvest(plat):
        assert bool(claimed.any())
    else:
        assert not bool(valid.any())


def test_jbof12_pins_equal_reference(case):
    """chip_smoke.py's `sim_jbof12` gates hold the card to these runs'
    values: the pins must be the reference's, bit for bit."""
    name, want = case[:2]
    if not name.startswith("micro_read-") or CASES[name][3]:
        return  # not a sim_jbof12 run
    chip_smoke = _chip_smoke()
    plat = CASES[name][0]
    pins = chip_smoke.SIM_JBOF12_PINS[plat]
    assert set(pins) == set(chip_smoke.SIM_JBOF12_METRICS)
    for metric, values in pins.items():
        np.testing.assert_array_equal(
            np.asarray(values, np.float32), np.asarray(getattr(want, metric)),
            err_msg=f"{plat}.{metric}")


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def test_jbof12_pins_cover_every_platform():
    chip_smoke = _chip_smoke()
    assert list(chip_smoke.SIM_JBOF12_PINS) == list(TP.ALL)
    assert chip_smoke.SIM_JBOF12 == dict(windows=JBOF12_WINDOWS, warmup=50, seed=0,
                                         busy=6, idle=6, io_kb=64.0)
