"""The design of the WKV backward kernel (`csrc/rwkv6_scan_bwd.cu`),
emulated in plain PyTorch on the CPU and held against the port's plain
gradient (`repro_torch.kernels.ref.rwkv6_wkv_bwd`) and ``jax.vjp`` of the
JAX oracle (`repro.kernels.ref.rwkv6_wkv`) on the same seeded numpy
inputs.

The emulation repeats the kernel's split: phase A walks S forward from
s0 (or zeros) and keeps it at the start of every group of G rows (G = 64,
32 at K = 128), and walks dS backward from the final state's cotangent
(or zeros) and keeps it at the end of every group; phase B takes each
group alone, walks S forward from its snapshot keeping S at the start of
each sub-chunk of 8 rows, then per sub-chunk, last to first, recomputes
S_{t-1} of its rows from that checkpoint and walks dS back from the
group's end snapshot. The per-row sums run over slices of VS columns (32
at K = 128, else all of V) added in slice order; du is summed per (batch,
group) in row order, then over the groups in order, then over the batch.
It lives here and not in the package: the kernel is the package's form
of it.

Every S_{t-1} and dS_t the groups use must equal a straight walk's bit
for bit: both repeat the recurrences' fp32 operations (w * S + k * v, w *
dS + r * dout, each product and sum rounded on its own). The gradients
are held to the card's gate, `chip_smoke.WKV_BWD_TOL`'s fp32 limits: per
element |got - want| <= 1e-5 |want| + 1e-4 rms(want), the sums' order
differing. Inputs: T = 1, G - 1, G, G + 1 and 2 G + 3 at K = 16, 64 and
128, with s0 and the final state's cotangent both given and both absent,
and decays with a quarter of w exactly 0 and a quarter exactly 1."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

jax.config.update("jax_platform_name", "cpu")

C = 8                  # rows of a sub-chunk
TOL = (1e-5, 1e-4)     # chip_smoke.WKV_BWD_TOL["fp32"]


def group_rows(k):
    return 32 if k == 128 else 64


def slice_cols(k):
    return 32 if k == 128 else k


def _step_s(S, w, k, v):
    """S <- diag(w) S + k v^T: one rounding per product and per sum."""
    return w[..., :, None] * S + k[..., :, None] * v[..., None, :]


def _step_ds(dS, w, r, d):
    """dS <- diag(w) dS + r dout^T."""
    return w[..., :, None] * dS + r[..., :, None] * d[..., None, :]


def _slice_sum(x, vs):
    """Sum over the last axis, slice by slice of vs columns, the slices'
    sums added in slice order."""
    parts = x.unflatten(-1, (x.shape[-1] // vs, vs)).sum(-1)
    acc = parts[..., 0]
    for i in range(1, parts.shape[-1]):
        acc = acc + parts[..., i]
    return acc


def straight_walk(r, k, v, w, s0, dout, ds_final):
    """S_{t-1} and dS_t of every row, walked straight through T."""
    b, t, h, dk = r.shape
    S = torch.zeros((b, h, dk, dk)) if s0 is None else s0.clone()
    dS = torch.zeros((b, h, dk, dk)) if ds_final is None else ds_final.clone()
    s_prev, ds_cur = [], [None] * t
    for i in range(t):
        s_prev.append(S)
        S = _step_s(S, w[:, i], k[:, i], v[:, i])
    for i in reversed(range(t)):
        ds_cur[i] = dS
        dS = _step_ds(dS, w[:, i], r[:, i], dout[:, i])
    return s_prev, ds_cur


def grouped_bwd(r, k, v, w, u, s0, dout, ds_final):
    """The kernel's design: (dr, dk, dv, dw, du, ds0) and the S_{t-1} and
    dS_t each group used, by row."""
    b, t, h, dk = r.shape
    G, vs = group_rows(dk), slice_cols(dk)
    ng = -(-t // G)
    # phase A: the two chains
    S = torch.zeros((b, h, dk, dk)) if s0 is None else s0.clone()
    s_snap = []
    for i in range((ng - 1) * G):
        if i % G == 0:
            s_snap.append(S)
        S = _step_s(S, w[:, i], k[:, i], v[:, i])
    s_snap.append(S)
    dS = torch.zeros((b, h, dk, dk)) if ds_final is None else ds_final.clone()
    ds_snap = [None] * ng
    for i in range(t - 1, G - 1, -1):
        if i == t - 1 or (i + 1) % G == 0:
            ds_snap[i // G] = dS
        dS = _step_ds(dS, w[:, i], r[:, i], dout[:, i])
    ds_snap[0] = dS
    # phase B: the groups, each alone
    rho = (v * dout).sum(-1)                          # [B, T, H]
    sig = (u * (r * k)).sum(-1)
    dr, dk_, dv, dw = (torch.empty_like(x) for x in (r, k, v, w))
    du_part = torch.empty((b, ng, h, dk))
    s_used, ds_used = [None] * t, [None] * t
    ds0 = None
    for g in range(ng):
        t0, n = g * G, min(G, t - g * G)
        nsc = -(-n // C)
        S, ckpt = s_snap[g], []
        for sc in range(nsc - 1):
            ckpt.append(S)
            for j in range(C):
                i = t0 + sc * C + j
                S = _step_s(S, w[:, i], k[:, i], v[:, i])
        dS = ds_snap[g]
        for sc in reversed(range(nsc)):
            if sc < nsc - 1:
                S = ckpt[sc]
            nj = min(C, n - sc * C)
            sp = []
            for j in range(nj):
                sp.append(S)
                if j + 1 < nj:
                    i = t0 + sc * C + j
                    S = _step_s(S, w[:, i], k[:, i], v[:, i])
            for j in reversed(range(nj)):
                i = t0 + sc * C + j
                s_used[i], ds_used[i] = sp[j], dS
                d_i = dout[:, i]
                rho_i = rho[:, i, :, None]
                dr[:, i] = _slice_sum(sp[j] * d_i[..., None, :], vs) + u * (k[:, i] * rho_i)
                dk_[:, i] = _slice_sum(dS * v[:, i, :, None, :], vs) + u * (r[:, i] * rho_i)
                dw[:, i] = _slice_sum(dS * sp[j], vs)
                dv[:, i] = (dS * k[:, i, :, :, None]).sum(-2) + d_i * sig[:, i, :, None]
                dS = _step_ds(dS, w[:, i], r[:, i], d_i)
        if g == 0:
            ds0 = dS
        acc = torch.zeros((b, h, dk))
        for j in range(n):                            # du: the group's rows in order
            acc = acc + r[:, t0 + j] * k[:, t0 + j] * rho[:, t0 + j, :, None]
        du_part[:, g] = acc
    du = torch.zeros((h, dk))
    for bb in range(b):                               # groups in order, then batches
        acc = torch.zeros((h, dk))
        for g in range(ng):
            acc = acc + du_part[bb, g]
        du = du + acc
    return (dr, dk_, dv, dw, du, None if s0 is None else ds0), s_used, ds_used


def _inputs(b, t, h, dk, state, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (0.5 * rng.standard_normal((b, t, h, dk)).astype(np.float32) for _ in range(3))
    w = (1 / (1 + np.exp(-rng.standard_normal((b, t, h, dk)) - 2))).astype(np.float32)
    pick = rng.random((b, t, h, dk))
    w = np.where(pick < 0.25, 0.0, np.where(pick > 0.75, 1.0, w)).astype(np.float32)
    u = (0.1 * rng.standard_normal((h, dk))).astype(np.float32)
    dout = (0.5 * rng.standard_normal((b, t, h, dk))).astype(np.float32)
    s0 = (0.5 * rng.standard_normal((b, h, dk, dk))).astype(np.float32) if state else None
    ds = (0.5 * rng.standard_normal((b, h, dk, dk))).astype(np.float32) if state else None
    return r, k, v, w, u, s0, dout, ds


def _close(got, want):
    """Per element within TOL of want, rms over want."""
    c1, c2 = TOL
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    rms = float(np.sqrt(np.mean(want ** 2))) + 1e-30
    err = np.abs(got - want)
    bound = c1 * np.abs(want) + c2 * rms
    assert (err <= bound).all(), f"{(err - bound).max()} past the bound (rms {rms})"


@jax.jit
def _jax_vjp(r, k, v, w, u, s0, dout, ds):
    """jax.vjp of the JAX oracle from s0 (zeros stand for none: the same
    gradients, so the cases with and without a state share a compile)."""
    _, vjp = jax.vjp(lambda *p: jref.rwkv6_wkv(*p, return_state=True), r, k, v, w, u, s0)
    return vjp((dout, ds))


CASES = [(dk, t, state) for dk in (16, 64, 128)
         for t in (1, group_rows(dk) - 1, group_rows(dk), group_rows(dk) + 1,
                   2 * group_rows(dk) + 3)
         for state in (False, True)]


@pytest.mark.parametrize("dk,t,state", CASES)
def test_grouped_design_matches_straight_walk_and_references(dk, t, state):
    b, h = 2, 2
    arrays = _inputs(b, t, h, dk, state, seed=dk * 1000 + t * 2 + state)
    r, k, v, w, u, s0, dout, ds = (None if a is None else torch.from_numpy(a) for a in arrays)
    got, s_used, ds_used = grouped_bwd(r, k, v, w, u, s0, dout, ds)

    s_prev, ds_cur = straight_walk(r, k, v, w, s0, dout, ds)
    for i in range(t):
        assert torch.equal(s_used[i], s_prev[i]), f"S_(t-1) at row {i}"
        assert torch.equal(ds_used[i], ds_cur[i]), f"dS_t at row {i}"

    want = tref.rwkv6_wkv_bwd(r, k, v, w, u, s0, dout, ds)
    assert (got[5] is None) == (want[5] is None) == (s0 is None)
    for g_, w_ in zip(got, want):
        if w_ is not None:
            _close(g_.numpy(), w_.numpy())

    zeros = np.zeros((b, h, dk, dk), np.float32)   # s0 and ds_final when absent
    jwant = _jax_vjp(*(jnp.asarray(a) for a in arrays[:5]),
                     jnp.asarray(zeros if s0 is None else arrays[5]), jnp.asarray(arrays[6]),
                     jnp.asarray(zeros if ds is None else arrays[7]))
    for g_, w_ in zip(got, jwant):
        if g_ is not None:
            _close(g_.numpy(), w_)
