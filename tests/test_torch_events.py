"""The failure plane's schedules and the reclaim predictor of the port
(`repro_torch.core.events`, `repro_torch.telemetry.reclaim`) against the
JAX reference, on the CPU.

`schedule` and `compile` give bit-equal streams (and the same
``ValueError``s) over hypothesis-drawn schedules: every kind and invalid
ones, times past the run, durations of 0, several warning leads, targets
past the run's shape. `reclaim.update` is bit-equal to the reference's
*jitted* step over random utilisation series (the compiled step fuses the
level's update into one multiply-add); `run`'s flags and `evaluate`'s
scores are equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import events as JE
from repro.telemetry import reclaim as JR
from repro_torch.core import events as TE
from repro_torch.telemetry import reclaim as TR

jax.config.update("jax_platform_name", "cpu")

N_NODES, N_ENCL, STEPS = 6, 2, 12

events = st.lists(st.tuples(st.integers(-1, 4), st.integers(-1, STEPS + 4),
                            st.integers(-1, N_NODES + 1), st.integers(-1, 5)),
                  max_size=6)


def _outcome(mod, evs, lead):
    """(schedule, streams) of one package, or the error it raised."""
    try:
        sched = mod.schedule(*(mod.Event(*e) for e in evs), reclaim_lead=lead)
        arrays = mod.compile(sched, STEPS, N_NODES, N_ENCL, **(
            {"device": "cpu"} if mod is TE else {}))
    except ValueError as e:
        return ("ValueError", str(e))
    return (tuple(tuple(e) for e in sched.events), sched.reclaim_lead,
            tuple(np.asarray(a).tolist() for a in arrays))


@settings(max_examples=60, deadline=None)
@given(evs=events, lead=st.sampled_from([0, 1, 2, 8]))
def test_schedule_and_compile_match_reference(evs, lead):
    assert _outcome(TE, evs, lead) == _outcome(JE, evs, lead)


def test_constructors_views_and_kinds():
    assert TE.KIND_NAMES == JE.KIND_NAMES
    for t_ev, j_ev in ((TE.lender_reclaim(3, 1, 4), JE.lender_reclaim(3, 1, 4)),
                       (TE.ssd_fail(5, 2), JE.ssd_fail(5, 2)),
                       (TE.ssd_hot_remove(7, 0), JE.ssd_hot_remove(7, 0)),
                       (TE.enclosure_drop(2, 1), JE.enclosure_drop(2, 1))):
        assert tuple(t_ev) == tuple(j_ev)
    assert not TE.schedule() and TE.schedule(TE.ssd_fail(1, 0))
    sched = TE.schedule(TE.ssd_hot_remove(6, 1), TE.enclosure_drop(4, 1),
                        reclaim_lead=3)
    arrays = TE.compile(sched, STEPS, N_NODES, N_ENCL, device="cpu")
    assert all(a.dtype == torch.bool for a in arrays)
    view = TE.node_view(arrays)
    assert torch.equal(view.reclaim, arrays.reclaim) and torch.equal(view.dead, arrays.dead)
    one = TE.step_view(arrays, 5)
    assert one.dead.shape == (N_NODES,) and one.drop.shape == (N_ENCL,)
    assert one.reclaim[1] and not one.dead[1] and one.drop[1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TE.compile(sched, STEPS, N_NODES, N_ENCL)


_update = jax.jit(JR.update, static_argnums=(2,))
N_LENDERS = 16


def _series(seed, steps=120):
    """Utilisation series of every shape the engine feeds the predictor:
    uniform noise, ramps toward and past the threshold, steps, and the
    engine's discrete pressure levels (k / pages)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.0, 1.5, (steps, N_LENDERS))
    u[:, 0] = np.linspace(0.0, 1.0, steps)
    u[:, 1] = np.where(np.arange(steps) % 20 < 10, 0.2, 0.95)
    u[:, 2:6] = rng.integers(0, 13, (steps, 4)) / 12.0
    u[:, 6] = np.minimum(np.arange(steps) / 40.0, 1.0)
    return u.astype(np.float32)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("knobs", [(), (0.2, 0.7, 0.6, 4), (0.45, 0.5, 0.85, 3)])
def test_update_bit_equal_to_jitted_reference(seed, knobs):
    jcfg, tcfg = JR.ReclaimConfig(*knobs), TR.ReclaimConfig(*knobs)
    assert tuple(jcfg) == tuple(TR.ReclaimConfig(*knobs))
    js = JR.init(N_LENDERS)
    ts = TR.init(N_LENDERS, device="cpu")
    for u in _series(seed):
        js, jrisk = _update(js, jnp.asarray(u), jcfg)
        ts, trisk = TR.update(ts, torch.from_numpy(u), tcfg)
        np.testing.assert_array_equal(ts.ewma.numpy(), np.asarray(js.ewma))
        np.testing.assert_array_equal(ts.slope.numpy(), np.asarray(js.slope))
        np.testing.assert_array_equal(trisk.numpy(), np.asarray(jrisk))
        # resume from the reference's carry so every step is held alone
        ts = TR.ReclaimState(torch.from_numpy(np.array(js.ewma)),
                             torch.from_numpy(np.array(js.slope)))


@pytest.mark.parametrize("seed", range(3))
def test_run_and_evaluate_match_reference(seed):
    hist = _series(seed, steps=90)[:, :8]
    risks = TR.run(hist)
    np.testing.assert_array_equal(risks, JR.run(hist))
    assert risks.any() and not risks.all()
    rng = np.random.default_rng(seed)
    truth = [(int(t), int(l)) for t, l in zip(rng.integers(0, 90, 6),
                                               rng.integers(-1, 9, 6))]
    for horizon in (None, 3):
        got = TR.evaluate(hist, truth, horizon=horizon)
        want = JR.evaluate(hist, truth, horizon=horizon)
        assert tuple(got) == tuple(want)
    assert tuple(TR.evaluate(hist, [])) == tuple(JR.evaluate(hist, []))
    assert TR.run(torch.from_numpy(hist)).tolist() == risks.tolist()
