"""The plain gradients of the RG-LRU scan, the WKV scan and the top-k
router (`repro_torch.kernels.ref.rglru_bwd`, `rwkv6_wkv_bwd`,
`topk_router_bwd`: what the backward kernels are held against on the card)
against ``jax.vjp`` of the reference's oracles (`repro.kernels.ref`), the
reference's training gradient, on the CPU; and a train step of the
recurrentgemma and rwkv6 smoke configs against the reference's compiled
step.

The same seeded numpy inputs go to both; cotangents on both outputs of
each scan (out and h_T; out and the final state). Tolerances, per element
|got - want| <= c1 |want| + c2 rms(want): fp32 (1e-5, 1e-6), the sums and
the scans' order differing (the reference's RG-LRU is an associative
scan; its autodiff walks the transposed scan); bf16 (2^-7, 2^-7), one
rounding of each bf16 output (up to an ulp, 2^-7 of the value, where the
two fp32 results straddle a rounding) and, for the RG-LRU, h_T's
cotangent, which the port adds into out's last row in bf16 (autograd sums
the two bf16 cotangents) and the reference in fp32. Where the reference's
gradient is not finite (|a| = 1: the sqrt's derivative) the port's holds
the same value at the same place."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from test_torch_train_step import (B, S, _jstate, _jtrain_step, _pair, _state_close,
                                   _tstate)
from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe
from repro_torch.training import train_step as TTS

jax.config.update("jax_platform_name", "cpu")

TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2 ** -7, 2 ** -7)}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _close(got, want, dtype):
    """Per element within TOL over the finite wants; the non-finite ones
    equal value for value (NaN where NaN)."""
    c1, c2 = TOL[dtype]
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    if fin.any():
        rms = float(np.sqrt(np.mean(want[fin] ** 2)))
        err = np.abs(got[fin] - want[fin])
        bound = c1 * np.abs(want[fin]) + c2 * rms + 1e-30
        assert (err <= bound).all(), f"{(err - bound).max()} past the bound"


def _t(a, dtype):
    """A copy (jax may still read the numpy array it was handed)."""
    return torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype))


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32), _JDT[dtype])


# ------------------------------------------------------------ RG-LRU
# (b, t, w, h0, kind): the model's a (sigmoid), a = 1 on a quarter of the
# elements with x = 0 on half of those, a = 0 and a = 1 exactly
RGLRU = {"sigmoid": (2, 37, 24, False, "sigmoid"),
         "sigmoid-h0": (2, 37, 24, True, "sigmoid"),
         "one-x0-h0": (2, 37, 24, True, "one-x0"),
         "zero-one": (2, 37, 24, False, "zero-one")}


@jax.jit
def _jrglru_vjp(x, a, h0, dout, dh):
    """The reference's gradient (compiled once a shape: its associative
    scan costs seconds of dispatch run eagerly)."""
    _, vjp = jax.vjp(lambda *p: jref.rglru(*p[:2], h0=p[2] if len(p) > 2 else None),
                     *((x, a) if h0 is None else (x, a, h0)))
    return vjp((dout, dh))


def _rglru_inputs(shape, seed):
    b, t, w, h0, kind = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, w)).astype(np.float32)
    a = (1 / (1 + np.exp(-rng.standard_normal((b, t, w)) - 2))).astype(np.float32)
    pick = rng.random((b, t, w))
    if kind == "one-x0":
        a = np.where(pick < 0.25, 1.0, a).astype(np.float32)
        x = np.where(pick < 0.125, 0.0, x).astype(np.float32)
    elif kind == "zero-one":
        a = np.where(pick < 0.25, 0.0, np.where(pick > 0.75, 1.0, a)).astype(np.float32)
    h = rng.standard_normal((b, w)).astype(np.float32) if h0 else None
    dout = rng.standard_normal((b, t, w)).astype(np.float32)
    dh = rng.standard_normal((b, w)).astype(np.float32)
    return x, a, h, dout, dh


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(RGLRU))
def test_rglru_bwd_matches_jax_vjp(name, dtype):
    x, a, h0, dout, dh = _rglru_inputs(RGLRU[name], len(name))
    want = _jrglru_vjp(_j(x, dtype), _j(a, dtype), None if h0 is None else jnp.asarray(h0),
                       _j(dout, dtype), _j(dh, dtype))
    # the port's Function returns out; h_T's cotangent lands in out's last
    # row, summed in out's dtype as autograd sums it
    d_all = _t(dout, dtype)
    d_all[:, -1] += _t(dh, dtype)
    got = tref.rglru_bwd(_t(x, dtype), _t(a, dtype),
                         None if h0 is None else torch.from_numpy(h0), d_all)
    assert (got[2] is None) == (h0 is None)
    for g_, w_ in zip(got, want):
        assert g_.dtype == getattr(torch, dtype) or g_.dtype == torch.float32
        _close(g_, w_, dtype)
    if name == "one-x0-h0":
        da = np.asarray(want[1], np.float32)
        assert np.isneginf(da).any() and np.isnan(da).any()


# ------------------------------------------------------------ WKV
# (b, t, h, k, s0, decay): sigmoid(N + 2), and w = 0 / w = 1 exactly
WKV = {"sigmoid": (2, 21, 2, 16, False, "sigmoid"),
       "sigmoid-s0": (1, 19, 3, 16, True, "sigmoid"),
       "zero-one-s0": (2, 17, 2, 16, True, "zero-one")}


def _wkv_inputs(shape, seed):
    b, t, h, k, s0, kind = shape
    rng = np.random.default_rng(seed)
    r, kk, v = (0.5 * rng.standard_normal((b, t, h, k)).astype(np.float32) for _ in range(3))
    w = (1 / (1 + np.exp(-rng.standard_normal((b, t, h, k)) - 2))).astype(np.float32)
    if kind == "zero-one":
        pick = rng.random((b, t, h, k))
        w = np.where(pick < 0.25, 0.0, np.where(pick > 0.75, 1.0, w)).astype(np.float32)
    u = (0.1 * rng.standard_normal((h, k))).astype(np.float32)
    s = (0.5 * rng.standard_normal((b, h, k, k))).astype(np.float32) if s0 else None
    dout = rng.standard_normal((b, t, h, k)).astype(np.float32)
    ds = rng.standard_normal((b, h, k, k)).astype(np.float32)
    return (r, kk, v, w), u, s, dout, ds


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(WKV))
def test_rwkv6_wkv_bwd_matches_jax_vjp(name, dtype):
    (r, k, v, w), u, s0, dout, ds = _wkv_inputs(WKV[name], len(name))
    jargs = [_j(a, dtype) for a in (r, k, v, w)] + [jnp.asarray(u)] + (
        [jnp.asarray(s0)] if s0 is not None else [])
    f = lambda *p: jref.rwkv6_wkv(*p[:5], s0=p[5] if len(p) > 5 else None,
                                  return_state=True)
    _, vjp = jax.vjp(f, *jargs)
    want = vjp((_j(dout, dtype), _j(ds, dtype)))
    got = tref.rwkv6_wkv_bwd(*(_t(a, dtype) for a in (r, k, v, w)), torch.from_numpy(u),
                             None if s0 is None else torch.from_numpy(s0),
                             _t(dout, dtype), _t(ds, dtype))
    assert (got[5] is None) == (s0 is None)
    for g_, w_ in zip(got, want):
        _close(g_, w_, dtype)
    # without the final state's cotangent (the trainer discards the state)
    want = vjp((_j(dout, dtype), jnp.zeros(ds.shape, _JDT[dtype])))
    got = tref.rwkv6_wkv_bwd(*(_t(a, dtype) for a in (r, k, v, w)), torch.from_numpy(u),
                             None if s0 is None else torch.from_numpy(s0), _t(dout, dtype))
    for g_, w_ in zip(got, want):
        _close(g_, w_, dtype)


# ------------------------------------------------------------ router
# (t, e, k, pattern, bias): softmax scores; exact ties (four values a
# row); k = E; picks summing below 1e-9 (the clamp's branch)
ROUTER = {"softmax": (32, 16, 4, "softmax", False), "softmax-bias": (32, 16, 4, "softmax", True),
          "ties-bias": (24, 12, 3, "ties", True), "k-eq-e": (16, 8, 8, "softmax", False),
          "tiny": (16, 8, 2, "tiny", False)}


@pytest.mark.parametrize("name", list(ROUTER))
def test_topk_router_bwd_matches_jax_vjp(name):
    t, e, k, pattern, bias = ROUTER[name]
    rng = np.random.default_rng(len(name))
    if pattern == "ties":
        scores = (rng.integers(0, 4, (t, e)) / 8).astype(np.float32)
    elif pattern == "tiny":
        scores = (rng.random((t, e)) * 1e-12).astype(np.float32)
    else:
        z = rng.standard_normal((t, e))
        scores = (np.exp(z) / np.exp(z).sum(-1, keepdims=True)).astype(np.float32)
    b = (0.1 * rng.standard_normal(e)).astype(np.float32) if bias else None
    dw = rng.standard_normal((t, k)).astype(np.float32)
    jb = None if b is None else jnp.asarray(b)
    (_, jidx), vjp = jax.vjp(lambda s, bb: jref.topk_router(s, k, bias=bb),
                             jnp.asarray(scores), jb if bias else jnp.zeros(e))
    want_s, want_b = vjp((jnp.asarray(dw), np.zeros((t, k), jax.dtypes.float0)))
    # the port's selection is the reference's
    tw, tidx = tref.topk_router(torch.from_numpy(scores), k,
                                bias=None if b is None else torch.from_numpy(b))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    got = tref.topk_router_bwd(torch.from_numpy(scores), tidx, torch.from_numpy(dw))
    _close(got, want_s, "float32")
    assert int((got != 0).sum(-1).max()) <= k
    # the bias only selects: no gradient on either side
    assert not np.asarray(want_b).any()
    leaf = torch.from_numpy(np.zeros(e, np.float32) if b is None else b).requires_grad_()
    w_, _ = tref.topk_router(torch.from_numpy(scores).requires_grad_(), k, bias=leaf)
    assert torch.autograd.grad(w_.sum(), leaf, allow_unused=True)[0] is None


# ------------------------------------------------- the families' train step
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-3b"])
def test_recurrent_train_step_matches_reference(arch):
    """One `train_step` of the smoke config (two microbatches) on the CPU
    path through `kernels.ops` against the reference's compiled step: loss,
    grad norm, the moments and each parameter's update
    (tests/test_torch_train_step.py's `_state_close`)."""
    jcfg, tcfg = _pair(arch)
    jstate = _jstate(tcfg)
    tstate = _tstate(tcfg, jstate)
    jb = jpipe.batch_for_step(jcfg, 0, B, S)
    tb = tpipe.batch_for_step(tcfg, 0, B, S, device="cpu")
    jnew, jm = _jtrain_step(jcfg, jstate, jb, n_micro=2)
    tnew, tm = TTS.train_step(tcfg, tstate, tb, n_micro=2)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5)
    _state_close(tnew, jnew, tstate, jstate)
