"""The port's recurrences against the JAX reference: its plain versions
(`repro_torch.kernels.ref.rglru`, `rwkv6_wkv` and their decode steps)
against the Pallas scan kernels in interpret mode and the jnp oracles on
the CPU, over the sweeps of tests/test_kernels.py, a ragged length, an
initial state (h0, s0) and the final state (``return_state``). The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_cuda_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru as pallas_rglru
from repro.kernels.rwkv6_scan import rwkv6_wkv as pallas_wkv
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as trg
from repro_torch.kernels import rwkv6_scan as twkv

jax.config.update("jax_platform_name", "cpu")

# the gates of tests/test_kernels.py (rglru 3e-4, rwkv6 5e-4 in fp32); bf16
# outputs differ by a rounding of the fp32 result, at most one bf16 ulp
TOL = {"rglru": {"float32": 3e-4, "bfloat16": 3e-2},
       "rwkv6": {"float32": 5e-4, "bfloat16": 3e-2}}
RGLRU_SWEEP = [(2, 256, 64), (1, 512, 128), (3, 128, 256)]   # (b, t, w)
RWKV6_SWEEP = [(1, 256, 2, 64), (2, 128, 4, 128)]             # (b, t, h, dk)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _both(arrs, dtype):
    """numpy fp32 draws, handed to both packages in ``dtype`` (both round
    to bf16 the same way)."""
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


def _rglru_inputs(b, t, w, seed, h0=False):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, t, w)).astype(np.float32),
            _sigmoid(rng.standard_normal((b, t, w))).astype(np.float32)]
    if h0:
        arrs.append(rng.standard_normal((b, w)).astype(np.float32))
    return arrs


def _rwkv6_inputs(b, t, h, dk, seed, s0=False):
    rng = np.random.default_rng(seed)
    mk = lambda: (rng.standard_normal((b, t, h, dk)) * 0.5).astype(np.float32)
    r, k, v = mk(), mk(), mk()
    w = _sigmoid(rng.standard_normal((b, t, h, dk)) + 2).astype(np.float32)
    u = (rng.standard_normal((h, dk)) * 0.1).astype(np.float32)
    arrs = [r, k, v, w, u]
    if s0:
        arrs.append((rng.standard_normal((b, h, dk, dk)) * 0.5).astype(np.float32))
    return arrs


# ------------------------------------------------------------- rg-lru
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,w", RGLRU_SWEEP)
def test_rglru_plain_matches_pallas_and_oracle(b, t, w, dtype):
    (jx, ja), (tx, ta) = _both(_rglru_inputs(b, t, w, seed=b + t), dtype)
    out, h_t = tref.rglru(tx, ta)
    assert out.dtype == tx.dtype and tuple(out.shape) == (b, t, w)
    assert torch.equal(h_t, out[:, -1])
    tol = TOL["rglru"][dtype]
    p_out, p_h = pallas_rglru(jx, ja, interpret=True)
    _close(out, p_out, tol)
    _close(h_t, p_h, tol)
    o_out, o_h = jref.rglru(jx, ja)
    _close(out, o_out, tol)
    _close(h_t, o_h, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_ragged_length_and_h0_match_oracle(dtype):
    """T = 200 (no multiple of the TPU kernel's chunk) from a given h0:
    the reference's dispatcher sends h0 to its oracle, which folds it in
    as a virtual first step."""
    (jx, ja, jh), (tx, ta, th) = _both(_rglru_inputs(2, 200, 96, seed=7, h0=True),
                                       dtype)
    out, h_t = tops.rglru(tx, ta, h0=th)
    o_out, o_h = jref.rglru(jx, ja, h0=jh)
    _close(out, o_out, TOL["rglru"][dtype])
    _close(h_t, o_h, TOL["rglru"][dtype])
    p_out, _ = pallas_rglru(jx, ja, interpret=True)
    _close(tref.rglru(tx, ta)[0], p_out, TOL["rglru"][dtype])


def test_rglru_a_rounded_to_one_shuts_the_input_off():
    """In bf16 an a within half an ulp of 1 is 1.0: its gain sqrt(1 - a^2)
    is 0, so h carries over unchanged whatever x is."""
    x = torch.randn(1, 4, 8, generator=torch.Generator().manual_seed(0)).bfloat16()
    a = torch.full((1, 4, 8), 0.999, dtype=torch.float32).bfloat16()
    assert float(a[0, 0, 0]) == 1.0
    h0 = torch.ones(1, 8)
    out, _ = tref.rglru(x, a, h0=h0)
    assert torch.equal(out, torch.ones_like(out))


def test_rglru_step_matches_scan():
    (_, _), (tx, ta) = _both(_rglru_inputs(2, 12, 16, seed=0), "float32")
    _, h_t = tref.rglru(tx, ta)
    h = torch.zeros(2, 16)
    for i in range(12):
        h = tref.rglru_step(h, tx[:, i], ta[:, i])
    torch.testing.assert_close(h, h_t, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_step_matches_oracle_step(dtype):
    """The decode step in the cache's dtype: fp32 math, h rounded back."""
    (jx, ja, jh), (tx, ta, th) = _both(_rglru_inputs(3, 1, 40, seed=2, h0=True), dtype)
    got = tops.rglru_step(th, tx[:, 0], ta[:, 0])
    want = jref.rglru_step(jh, jx[:, 0], ja[:, 0])
    assert got.dtype == th.dtype
    _close(got, want, 1e-6 if dtype == "float32" else 1e-2)


# ------------------------------------------------------------- rwkv6 wkv
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,dk", RWKV6_SWEEP)
def test_rwkv6_plain_matches_pallas_and_oracle(b, t, h, dk, dtype):
    arrs = _rwkv6_inputs(b, t, h, dk, seed=b + t + h)
    (jr, jk, jv, jw, _), (tr, tk, tv, tw, _) = _both(arrs, dtype)
    ju, tu = jnp.asarray(arrs[4]), torch.from_numpy(arrs[4])
    out = tref.rwkv6_wkv(tr, tk, tv, tw, tu)
    assert out.dtype == tr.dtype and tuple(out.shape) == (b, t, h, dk)
    tol = TOL["rwkv6"][dtype]
    _close(out, pallas_wkv(jr, jk, jv, jw, ju, interpret=True), tol)
    _close(out, jref.rwkv6_wkv(jr, jk, jv, jw, ju), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dk", [16, 32, 64])
def test_rwkv6_s0_and_final_state_match_oracle(dk, dtype):
    """A ragged T = 200 from a given s0, with the final state (the
    prefill's form): out and S in r's dtype."""
    arrs = _rwkv6_inputs(2, 200, 3, dk, seed=dk, s0=True)
    (jr, jk, jv, jw, _, js), (tr, tk, tv, tw, _, ts) = _both(arrs, dtype)
    ju, tu = jnp.asarray(arrs[4], getattr(jnp, dtype)), torch.from_numpy(arrs[4]).to(
        getattr(torch, dtype))
    out, S = tops.rwkv6_wkv(tr, tk, tv, tw, tu, s0=ts, return_state=True)
    o_out, o_S = jref.rwkv6_wkv(jr, jk, jv, jw, ju, s0=js, return_state=True)
    assert S.dtype == tr.dtype and tuple(S.shape) == (2, 3, dk, dk)
    _close(out, o_out, TOL["rwkv6"][dtype])
    _close(S, o_S, TOL["rwkv6"][dtype])


def test_rwkv6_step_matches_scan():
    """Decode-step recurrence == full-scan recurrence, token by token."""
    b, t, h, dk = 1, 16, 2, 32
    arrs = _rwkv6_inputs(b, t, h, dk, seed=5)
    r, k, v, w, u = (torch.from_numpy(a) for a in arrs)
    want, S_want = tref.rwkv6_wkv(r, k, v, w, u, return_state=True)
    S = torch.zeros(b, h, dk, dk)
    outs = []
    for i in range(t):
        S, o = tref.rwkv6_wkv_step(S, r[:, i], k[:, i], v[:, i], w[:, i], u)
        outs.append(o)
    torch.testing.assert_close(torch.stack(outs, 1), want, atol=1e-4, rtol=0)
    torch.testing.assert_close(S, S_want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_step_matches_oracle_step(dtype):
    """The decode step with S in the cache's dtype: in bf16 the reference
    rounds the new state back to bf16 at every step, and so does the port."""
    arrs = _rwkv6_inputs(2, 1, 4, 16, seed=9, s0=True)
    (jr, jk, jv, jw, ju, js), (tr, tk, tv, tw, tu, ts) = _both(arrs, dtype)
    S, o = tops.rwkv6_wkv_step(ts, tr[:, 0], tk[:, 0], tv[:, 0], tw[:, 0], tu)
    jS, jo = jref.rwkv6_wkv_step(js, jr[:, 0], jk[:, 0], jv[:, 0], jw[:, 0], ju)
    assert S.dtype == ts.dtype and o.dtype == tr.dtype
    tol = 1e-5 if dtype == "float32" else 1e-2
    _close(S, jS, tol)
    _close(o, jo, tol)


# ------------------------------------------------------------- dispatch
def test_dispatchers_run_the_plain_versions_for_cpu_tensors():
    (_, _), (tx, ta) = _both(_rglru_inputs(1, 8, 4, seed=1), "float32")
    before = trg.rglru.launches
    for got, want in zip(tops.rglru(tx, ta), tref.rglru(tx, ta)):
        assert torch.equal(got, want)
    r, k, v, w, u = (torch.from_numpy(a) for a in _rwkv6_inputs(1, 8, 2, 16, seed=1))
    before_wkv = twkv.rwkv6_wkv.launches
    assert torch.equal(tops.rwkv6_wkv(r, k, v, w, u), tref.rwkv6_wkv(r, k, v, w, u))
    assert trg.rglru.launches == before and twkv.rwkv6_wkv.launches == before_wkv


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA kernel"):
        trg.rglru(x, x)
    r = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA kernel"):
        twkv.rwkv6_wkv(r, r, r, r, torch.zeros(2, 16))
