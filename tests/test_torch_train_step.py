"""The port's trainer against the JAX reference on the CPU: `lm_loss` and
every gradient leaf against ``jax.value_and_grad`` for the ten ported
smoke configs (DeepSeek-v3's MTP term and v2's aux loss included;
whisper's and qwen2-vl's frontend stubs' embeddings from the batch); three
`train_step`s with ``n_micro`` 1 and 2 against the reference's compiled
step, every leaf of the state after each; remat on against remat off;
and the restart trajectory.

Both packages start from the same weights: the port's, drawn from a seed,
handed to the reference as numpy arrays (drawing them with the
reference's eager `init_params` costs more compiles than the test); the
reference's optimizer state comes across through `train_state_from_numpy`.
The batches come from each package's own pipeline (bit-equal:
tests/test_torch_training.py).

Tolerances, fp32 on both sides with the order of summation differing:
the loss within 1e-5 relative; a gradient leaf within 1e-4 of its largest
magnitude (its terms are summed over tokens and heads in another order;
a near-tie of two router scores would route a token elsewhere, and the
seeds' routings agree, as tests/test_torch_moe_models.py checks). After
a step, the moments within 1e-4 of their leaf's largest magnitude plus
1e-5 relative; each parameter by its update, new minus old, against
the reference's (`_state_close`): the bound is what the two sides' own
moments allow, so a missing or sign-flipped update fails."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.models import transformer as JT
from repro.training import optimizer as JOPT
from repro.training import train_step as JTS
from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tpipe
from repro_torch.models import transformer as TT
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import train_step as TTS
from repro_torch.training import tree as tr

jax.config.update("jax_platform_name", "cpu")

ARCHS = list(tconfigs.PORTED)
B, S = 2, 16


def _pair(arch):
    return jconfigs.smoke(arch), tconfigs.smoke(arch)


def _params(tcfg, seed):
    """(the reference's params, the port's): the same seeded weights."""
    tparams = TT.init_params(tcfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    as_np = lambda t: t.float().numpy().astype(np.float32) if t.dtype == torch.float32 \
        else t.numpy()
    jparams = jax.tree.map(jax.numpy.asarray, tr.tree_map(as_np, tparams))
    return jparams, tparams


def _jstate(tcfg, seed=0):
    jparams, _ = _params(tcfg, seed)
    zeros = lambda p: np.zeros(p.shape, np.float32)
    return JTS.TrainState(jparams, JOPT.AdamWState(
        jax.numpy.int32(0), jax.tree.map(zeros, jparams), jax.tree.map(zeros, jparams)))


def _tstate(tcfg, jstate):
    return TTS.train_state_from_numpy(tcfg, jax.tree.map(np.asarray, jstate), "cpu")


def _grads_close(got, want, tol=1e-4):
    """Each leaf within ``tol`` of its largest magnitude."""
    got_flat, want_flat = tr.leaves(got), jax.tree.leaves(want)
    assert len(got_flat) == len(want_flat)
    for i, (g, w) in enumerate(zip(got_flat, want_flat)):
        w = np.asarray(w, np.float32)
        g = g.detach().float().numpy()
        assert g.shape == w.shape, i
        scale = float(np.abs(w).max()) if w.size else 0.0
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale + 1e-7,
                                   err_msg=f"leaf {i}")


_jloss_grad = jax.jit(
    lambda cfg, p, b: jax.value_and_grad(
        lambda q: JT.lm_loss(cfg, q, b.get("tokens"), b["targets"],
                             input_embeds=b.get("input_embeds"),
                             enc_embeds=b.get("enc_embeds")), has_aux=True)(p),
    static_argnums=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_every_gradient_match_reference(arch):
    jcfg, tcfg = _pair(arch)
    jparams, tparams = _params(tcfg, 1)
    batch = jpipe.batch_for_step(jcfg, 3, B, S, seed=1)
    (jtotal, (jloss, jaux)), jgrads = _jloss_grad(
        jcfg, jparams, {k: v for k, v in batch.items() if v is not None})

    flat, treedef = tr.flatten(tparams)
    leaves = [p.requires_grad_() for p in flat]
    tb = tpipe.batch_for_step(tcfg, 3, B, S, seed=1, device="cpu")
    assert ("tokens" in tb) == (batch.get("tokens") is not None)
    total, (loss, aux) = TT.lm_loss(tcfg, tr.unflatten(treedef, leaves), tb.get("tokens"),
                                    tb["targets"], input_embeds=tb.get("input_embeds"),
                                    enc_embeds=tb.get("enc_embeds"))
    grads = torch.autograd.grad(total, leaves, allow_unused=True, materialize_grads=True)
    for got, want in ((total, jtotal), (loss, jloss), (aux, jaux)):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-7)
    if arch == "deepseek-v2-236b":
        assert float(jaux) > 0          # the aux loss is in the objective
    if arch == "deepseek-v3-671b":
        assert "mtp" in tparams         # the MTP term is
    _grads_close(tr.unflatten(treedef, list(grads)), jgrads)


_jtrain_step = JTS.train_step


# `optimizer.update`'s defaults (the reference's)
LR, B1, B2, EPS, WD, WARMUP = 3e-4, 0.9, 0.95, 1e-8, 0.1, 100


def _direction(m, v, step):
    """AdamW's d = m_hat / (sqrt(v_hat) + eps), in float64."""
    m, v = np.asarray(m, np.float64), np.asarray(v, np.float64)
    return (m / (1 - B1 ** step)) / (np.sqrt(v / (1 - B2 ** step)) + EPS)


def _state_close(got, want, got_old, want_old):
    """The step's state against the reference's, from the states each side
    started it from: the moments within 1e-4 of their leaf's largest
    magnitude plus 1e-5 relative; each parameter by its update, new - old,
    which is -lr_t * (d + wd * old) with d from the side's own moments: the
    two updates differ by lr_t * (|d - d_ref| + wd * |old - old_ref|)
    (lr_t * 2 where a gradient near zero took the other sign of zero, next
    to nothing elsewhere) plus the rounding of the new values (2^-22 of
    their magnitude: an fp32 ulp each side) plus lr_t * 1e-5 (d's own
    fp32 rounding). A missing or sign-flipped update fails."""
    step = int(want.opt.step)
    assert int(got.opt.step) == step
    for name in ("m", "v"):
        for i, (g, w) in enumerate(zip(tr.leaves(getattr(got.opt, name)),
                                       jax.tree.leaves(getattr(want.opt, name)))):
            w = np.asarray(w)
            scale = float(np.abs(w).max()) if w.size else 0.0
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-4 * scale + 1e-12,
                                       err_msg=f"{name} {i}")
    lr_t = LR * min(1.0, step / WARMUP)
    leaves = zip(tr.leaves(got.params), tr.leaves(got_old.params),
                 jax.tree.leaves(want.params), jax.tree.leaves(want_old.params),
                 tr.leaves(got.opt.m), tr.leaves(got.opt.v),
                 jax.tree.leaves(want.opt.m), jax.tree.leaves(want.opt.v))
    for i, (new, old, rnew, rold, m, v, rm, rv) in enumerate(leaves):
        new, old, rnew, rold = (np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                                           else x, np.float64)
                                for x in (new, old, rnew, rold))
        diff = np.abs((new - old) - (rnew - rold))
        bound = lr_t * (np.abs(_direction(m.numpy(), v.numpy(), step) - _direction(rm, rv, step))
                        + WD * np.abs(old - rold) + 1e-5) \
            + 2.0 ** -22 * np.maximum(np.abs(new), np.abs(rnew))
        assert (diff <= bound).all(), (f"param {i}: update differs by {diff.max()}, "
                                       f"{(diff - bound).max()} past its bound")


@pytest.mark.parametrize("arch,n_micro", [("granite-8b", 1), ("granite-8b", 2),
                                          ("h2o-danube-1.8b", 2),
                                          ("deepseek-v2-236b", 1),
                                          ("whisper-tiny", 2), ("qwen2-vl-2b", 1)])
def test_train_steps_match_reference(arch, n_micro):
    jcfg, tcfg = _pair(arch)
    jstate = _jstate(tcfg)
    tstate = _tstate(tcfg, jstate)
    for step in range(3):
        jb = jpipe.batch_for_step(jcfg, step, B, S)
        tb = tpipe.batch_for_step(tcfg, step, B, S, device="cpu")
        j_old, t_old = jstate, tstate
        jstate, jm = _jtrain_step(jcfg, jstate, jb, n_micro=n_micro)
        tstate, tm = TTS.train_step(tcfg, tstate, tb, n_micro=n_micro)
        for key in ("loss", "grad_norm"):
            assert tm[key].shape == () and tm[key].dtype == torch.float32
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5)
        _state_close(tstate, jstate, t_old, j_old)


def test_train_step_leaves_its_arguments_and_marks_no_grad():
    """Functional, as the reference: the state handed in is unchanged and
    the new leaves carry no autograd history."""
    _, tcfg = _pair("qwen3-14b")
    state = TTS.init_state(tcfg, TT.init_params(tcfg, device="cpu"))
    before = [t.clone() for t in tr.leaves(state)]
    new, _ = TTS.train_step(tcfg, state, tpipe.batch_for_step(tcfg, 0, B, S, device="cpu"))
    for a, b in zip(before, tr.leaves(state)):
        assert torch.equal(a, b)
    assert not any(t.requires_grad for t in tr.leaves(new))
    assert int(new.opt.step) == 1


@pytest.mark.parametrize("arch", ["internlm2-20b", "recurrentgemma-9b", "rwkv6-3b",
                                  "deepseek-v2-236b"])
def test_remat_on_equals_remat_off(arch):
    """Layer checkpointing recomputes the same values: one step's metrics
    and state equal bit for bit."""
    _, tcfg = _pair(arch)
    params = TT.init_params(tcfg, device="cpu", generator=torch.Generator().manual_seed(4))
    batch = tpipe.batch_for_step(tcfg, 0, B, S, device="cpu")
    outs = []
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        outs.append(TTS.train_step(cfg, TTS.init_state(cfg, params), batch, n_micro=2))
    (s1, m1), (s2, m2) = outs
    assert torch.equal(m1["loss"], m2["loss"]) and torch.equal(m1["grad_norm"],
                                                               m2["grad_norm"])
    for a, b in zip(tr.leaves(s1), tr.leaves(s2)):
        assert torch.equal(a, b)


def test_restart_resumes_identical_trajectory(tmp_path):
    """Train, checkpoint, restore into a fresh state, continue: the losses
    and grad norms of an uninterrupted run, to the reference's rtol=1e-6
    (tests/test_training.py)."""
    _, tcfg = _pair("granite-8b")

    def run(n_steps, state=None, start=0):
        if state is None:
            state = TTS.init_state(tcfg, TT.init_params(tcfg, device="cpu"))
        out = []
        for step in range(start, n_steps):
            state, m = TTS.train_step(tcfg, state,
                                      tpipe.batch_for_step(tcfg, step, 4, 16, device="cpu"))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return state, out

    _, ref_run = run(6)
    state, _ = run(3)
    tckpt.save(tmp_path, state, 2)
    restored, step = tckpt.restore(
        tmp_path, TTS.init_state(tcfg, TT.init_params(tcfg, device="cpu")))
    _, resumed = run(6, state=restored, start=step + 1)
    np.testing.assert_allclose(resumed, ref_run[3:], rtol=1e-6)
