"""The chunked algorithm of the bf16 WKV kernel (`csrc/rwkv6_scan.cu`,
`wkv_chunk_kernel`), emulated in plain PyTorch on the CPU and held
against the port's plain version (`repro_torch.kernels.ref.rwkv6_wkv`)
and the JAX oracle (`repro.kernels.ref.rwkv6_wkv`) on the same seeded
numpy inputs.

The emulation repeats the kernel's chunking step for step: chunks of C =
16 rows anchored at the chunk's first row, rows past T padded with r = k
= v = 0 and w = 1; the decay factors as running products of w (never a
logarithm, so w = 0 and w = 1 are exact and nothing overflows); the
chunk's matrix A, with the bonus on its diagonal, in fp32 within each
half of the chunk and, across the halves, as a product of the two
halves' operands anchored at the chunk's ninth row;
every tensor-core operand that is not bf16 already (the decayed r and
k, A, and the state S read by r . S) split into two bf16 halves, hi and
lo, each product taken as hi hi + hi lo + lo hi, fp32 sums and an fp32
state. It lives here
and not in the package: the kernel is the package's form of it.

Decays: the sweeps' sigmoid(N + 2); w = exp(-exp(N / 10)), about e^-1,
as rwkv6-3b's zero-initialised `w_base` gives; w = exp(-U(0, 30)), down to
e^-30; and a mix holding w = 0 and w = 1 exactly. Gate: the bf16 gate
of the CUDA tests, |got - want| <= 3e-2 (1 + |want|)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

jax.config.update("jax_platform_name", "cpu")

C = 16          # rows per chunk, as the kernel's
HALF = C // 2   # the diagonal phase works on half a chunk
TOL = 3e-2      # the bf16 gate: |got - want| <= TOL * (1 + |want|)
DECAYS = ("sigmoid", "main", "near0", "zero-one")


def _split(x):
    """x as hi + lo, two bf16 tensor-core operands: hi = bf16(x), lo =
    bf16(x - hi)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _mm(a, b):
    """a @ b of fp32 values, each split into two bf16 operands, as the
    kernel's three products: hi hi + hi lo + lo hi (lo lo, below 2^-16 of
    the product, is left out); exact inputs (v) have no lo."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return ah @ bh + ah @ bl + al @ bh


def wkv_chunked(r, k, v, w, u, s0=None):
    """The bf16 kernel's arithmetic: r, k, v, w bf16 [B, T, H, K], u [H,
    K], s0 fp32 [B, H, K, K] or None -> (out bf16 [B, T, H, K], final
    state bf16 [B, H, K, K])."""
    b, t, h, dk = r.shape
    rf, kf, vf, wf = (x.float().transpose(1, 2) for x in (r, k, v, w))  # [B, H, T, K]
    uf = u.float()[None, :, None, :]
    S = (torch.zeros((b, h, dk, dk)) if s0 is None else s0.float()).clone()
    outs = []
    for c0 in range(0, t, C):
        n = min(C, t - c0)
        pad = (0, 0, 0, C - n)
        rc, kc, vc = (F.pad(x[:, :, c0:c0 + n], pad) for x in (rf, kf, vf))
        wc = F.pad(wf[:, :, c0:c0 + n], pad, value=1.0)
        # the diagonal phase, one thread per row s, on s's half of the
        # chunk (rows h0 .. h0 + 7): P_s = prod w over the half's rows
        # before s; D_s = k_s prod_{s<m<t} w_m while t walks the half, so
        # that A[t, s] = r_t . D_s for s < t; Go_s = prod w over the other
        # half
        rows = torch.arange(C)
        h0 = rows & HALF
        P = torch.ones((b, h, C, dk))
        D = torch.zeros((b, h, C, dk))
        Go = torch.ones((b, h, C, dk))
        A = torch.zeros((b, h, C, C))
        for i in range(HALF):
            ts = h0 + i                                  # row t of each s
            rt, wt = rc[:, :, ts], wc[:, :, ts]
            A[:, :, ts, rows] = torch.einsum("bhsk,bhsk->bhs", rt, D)
            P = torch.where((ts < rows)[:, None], P * wt, P)
            D = torch.where((ts == rows)[:, None], kc, D * wt)
            Go = Go * wc[:, :, (ts + HALF) % C]
            if i == HALF - 1:
                g = P[:, :, C - 1] * wt[:, :, C - 1] * Go[:, :, C - 1]
        A = torch.tril(A, diagonal=-1)
        beta = torch.einsum("bhtk,bhtk->bht", rc * uf, kc)      # the bonus
        A = A + torch.diag_embed(beta)
        rl = rc * P
        second = (h0 > 0)[:, None]
        # the cross-half quadrant on the tensor cores: X = k_s D(s, 8) in
        # the first half, r_t D(7, t) in the second
        X = torch.where(second, rl, D)
        A[:, :, HALF:, :HALF] = _mm(X[:, :, HALF:], X[:, :, :HALF].transpose(-1, -2))
        rd = torch.where(second, rl * Go, rl)
        kd = torch.where(second, D, D * Go)
        out = _mm(rd, S) + _mm(A, vc)
        S = g[..., None] * S + _mm(kd.transpose(-1, -2), vc)
        outs.append(out[:, :, :n])
    out = torch.cat(outs, dim=2).transpose(1, 2).to(torch.bfloat16)
    return out, S.to(torch.bfloat16)


def _inputs(b, t, h, dk, decay, seed):
    rng = np.random.default_rng(seed)
    mk = lambda: (rng.standard_normal((b, t, h, dk)) * 0.5).astype(np.float32)
    r, k, v = mk(), mk(), mk()
    z = rng.standard_normal((b, t, h, dk))
    if decay == "sigmoid":
        w = 1.0 / (1.0 + np.exp(-(z + 2)))
    elif decay == "main":
        w = np.exp(-np.exp(0.1 * z))
    elif decay == "near0":
        w = np.exp(-rng.uniform(0.0, 30.0, (b, t, h, dk)))
    else:
        w = 1.0 / (1.0 + np.exp(-(z + 2)))
        pick = rng.uniform(size=w.shape)
        w = np.where(pick < 0.25, 0.0, np.where(pick > 0.75, 1.0, w))
    u = (rng.standard_normal((h, dk)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((b, h, dk, dk)) * 0.5).astype(np.float32)
    return [r, k, v, w.astype(np.float32)], u, s0


def _check(got, want):
    got = got.float()
    want = want.float() if torch.is_tensor(want) else torch.from_numpy(
        np.asarray(want, np.float32))
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    bad = err > TOL * (1 + want.abs())
    assert not bad.any(), f"max abs err {float(err.max())}"


def _run_both(b, t, h, dk, decay, seed, with_s0):
    arrs, u, s0 = _inputs(b, t, h, dk, decay, seed)
    tr, tk, tv, tw = (torch.from_numpy(a).bfloat16() for a in arrs)
    jr, jk, jv, jw = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    ts0 = torch.from_numpy(s0) if with_s0 else None
    js0 = jnp.asarray(s0) if with_s0 else None
    got, got_S = wkv_chunked(tr, tk, tv, tw, torch.from_numpy(u), s0=ts0)
    want, want_S = tref.rwkv6_wkv(tr, tk, tv, tw, torch.from_numpy(u), s0=ts0,
                                  return_state=True)
    o_out, o_S = jref.rwkv6_wkv(jr, jk, jv, jw, jnp.asarray(u), s0=js0,
                                return_state=True)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert got_S.dtype == torch.bfloat16 and got_S.shape == want_S.shape
    for g, w in ((got, want), (got, o_out), (got_S, want_S), (got_S, o_S)):
        _check(g, w)


@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("dk", [16, 64, 128])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 200])
def test_chunked_emulation_matches_plain_and_oracle(t, dk, decay):
    """From an initial state, with the final state: T across the chunk's
    edges, K = 16, 64 and 128, every decay."""
    _run_both(1, t, 2, dk, decay, seed=t * 1000 + dk + DECAYS.index(decay), with_s0=True)


@pytest.mark.parametrize("dk", [16, 32, 64, 128])
def test_chunked_emulation_from_zeros(dk):
    """The prefill's form: no s0, every head dim, rwkv6-3b's decay."""
    _run_both(2, 70, 3, dk, "main", seed=dk, with_s0=False)


def test_chunked_emulation_keeps_the_state_through_padded_rows():
    """T = 17: the second chunk holds one row; its 15 padded rows (w = 1,
    k = v = 0) leave the state as the recurrence leaves it."""
    arrs, u, s0 = _inputs(1, 17, 1, 16, "zero-one", seed=3)
    tr, tk, tv, tw = (torch.from_numpy(a).bfloat16() for a in arrs)
    _, S = wkv_chunked(tr, tk, tv, tw, torch.from_numpy(u), s0=torch.from_numpy(s0))
    _, S16 = wkv_chunked(tr[:, :16], tk[:, :16], tv[:, :16], tw[:, :16],
                         torch.from_numpy(u), s0=torch.from_numpy(s0))
    _, want = tref.rwkv6_wkv(tr, tk, tv, tw, torch.from_numpy(u),
                             s0=torch.from_numpy(s0), return_state=True)
    _check(S, want)
    assert not torch.equal(S, S16)          # the 17th row did reach the state
