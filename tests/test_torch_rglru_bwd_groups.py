"""The design of the RG-LRU backward kernels (`csrc/rglru_scan_bwd.cu`),
emulated in plain PyTorch on the CPU and held against the port's plain
gradient (`repro_torch.kernels.ref.rglru_bwd`) and ``jax.vjp`` of the JAX
oracle (`repro.kernels.ref.rglru`) on the same seeded numpy inputs.

The emulation repeats the kernels' split. Phase A walks the state chain h
forward from h0 (or zeros) and keeps h at the start of every group of G =
8 rows; it walks the cotangent chain back from the last row, carry =
(dout_t + carry) * a_t from carry = 0 * 0, keeps the carry that enters
every group's last row, and ends with dh0, the carry out of row 0. Phase
B takes each group alone: it walks h forward from the group's snapshot,
keeping h_{t-1} and s = sqrt(max(1 - a^2, 0)) of every row, then walks g
back from the group's carry, writing dx = g s and da = 2 (-(g x / (2 s))
[1 - a^2 >= 0]) a + g h_{t-1}. It lives here and not in the package: the
kernels are the package's form of it.

Every h_{t-1} and g_t the groups use must equal a straight walk's bit for
bit, and the gradients the plain gradient's value for value, NaN where it
has NaN: both do the same fp32 operations in the same order (each a
PyTorch operation here, so the CPU's own roundings, of its sqrt included,
are on both sides). Against ``jax.vjp`` of the JAX oracle, run in fp32
on the same input values and the same cotangent of out (`_check` says why
not on bf16 arrays), the gates of tests/test_torch_scan_router_bwd.py
hold: per element |got - want| <= c1 |want| + c2 rms(want), fp32 (1e-5,
1e-6), bf16 (2^-7, 2^-7: one rounding of each bf16 output); non-finite
wants equal value for value. Inputs: T = 1, G - 1, G, G + 1 and ragged
lengths; W = 5, 33, 40 and 130 (off the kernels' channel tiles of 32 and
128); h0 given and not; a = 0 and a = 1 exactly, with x = 0 on half of
the ones (da = -inf, and NaN where x = 0); fp32 a = 1 + 1 ulp (1 - a^2 < 0
clamped); dout with -0.0 entries; fp32 and bf16."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

jax.config.update("jax_platform_name", "cpu")

G = 8                  # rows a group, as the kernels'
TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2 ** -7, 2 ** -7)}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# (b, t, w, h0, kind): T around the group, ragged lengths, W off the
# channel tiles; the a = 0 / 1 kinds and -0.0 cotangents share a shape
CASES = {
    "t1-h0": (2, 1, 40, True, "sigmoid"),
    "t7-w33": (1, 7, 33, False, "sigmoid"),
    "t8-h0": (2, 8, 40, True, "sigmoid"),
    "t9-w5": (1, 9, 5, False, "sigmoid"),
    "t70-w130-h0": (2, 70, 130, True, "sigmoid"),
    "zero-one-h0": (2, 37, 40, True, "zero-one"),
    "one-x0-h0": (2, 37, 40, True, "one-x0"),
    "one-x0": (1, 33, 24, False, "one-x0"),
    "neg-zero-dout": (1, 33, 24, False, "neg-zero"),
}


def _gain(a):
    """u = 1 - a^2 and s = sqrt(max(u, 0)), the forward's operations."""
    u = 1.0 - a * a
    return u, torch.sqrt(torch.clamp(u, min=0.0))


def chains(x, a, h0, dout):
    """Phase A on fp32 x, a, dout [B, T, W] and h0 [B, W] or None: (the
    states at every group's start [B, ng, W], the carries into every
    group's last row [B, ng, W], dh0 [B, W])."""
    b, t, w = x.shape
    ng = -(-t // G)
    ck_h, ck_g = torch.empty((b, ng, w)), torch.empty((b, ng, w))
    gx = _gain(a)[1] * x                        # the state chain's producers
    h = torch.zeros((b, w)) if h0 is None else h0.float()
    for i in range(t):
        if i % G == 0:
            ck_h[:, i // G] = h
        h = a[:, i] * h + gx[:, i]
    carry = torch.zeros((b, w))                 # 0 * 0 past the last row
    for i in reversed(range(t)):
        if i % G == G - 1 or i == t - 1:
            ck_g[:, i // G] = carry
        carry = (dout[:, i] + carry) * a[:, i]
    return ck_h, ck_g, carry


def groups(x, a, dout, ck_h, ck_g):
    """Phase B: each group from its snapshots. Returns (dx, da) in fp32 and
    the h_{t-1} and g_t of every row [B, T, W]."""
    t = x.shape[1]
    dx, da, hs, gs = (torch.empty_like(x) for _ in range(4))
    for j in range(ck_h.shape[1]):
        rows = range(j * G, min(j * G + G, t))
        h, s = ck_h[:, j], {}
        for i in rows:
            hs[:, i] = h
            s[i] = _gain(a[:, i])[1]
            h = a[:, i] * h + s[i] * x[:, i]
        carry = ck_g[:, j]
        for i in reversed(rows):
            g = dout[:, i] + carry
            gs[:, i] = g
            u = _gain(a[:, i])[0]
            gc = (g * x[:, i]) / (2.0 * s[i])
            t1 = -torch.where(u >= 0.0, gc, 0.0) * a[:, i]
            dx[:, i] = g * s[i]
            da[:, i] = (t1 + t1) + g * hs[:, i]
            carry = g * a[:, i]
    return dx, da, hs, gs


def rglru_bwd_split(x, a, h0, dout):
    """The two phases: (dx, da in x's dtype, dh0 in h0's or None)."""
    xf, af, df = x.float(), a.float(), dout.float()
    ck_h, ck_g, dh0 = chains(xf, af, h0, df)
    dx, da, _, _ = groups(xf, af, df, ck_h, ck_g)
    return dx.to(x.dtype), da.to(a.dtype), None if h0 is None else dh0.to(h0.dtype)


def straight_walk(x, a, h0, dout):
    """h_{t-1} and g_t of every row, walked straight through T."""
    b, t, w = x.shape
    hs, gs = torch.empty_like(x), torch.empty_like(x)
    h = torch.zeros((b, w)) if h0 is None else h0.float()
    for i in range(t):
        hs[:, i] = h
        h = a[:, i] * h + _gain(a[:, i])[1] * x[:, i]
    g_next, a_next = torch.zeros((b, w)), torch.zeros((b, w))
    for i in reversed(range(t)):
        g_next = dout[:, i] + g_next * a_next
        a_next = a[:, i]
        gs[:, i] = g_next
    return hs, gs


def _inputs(b, t, w, h0, kind, seed):
    """numpy fp32 draws: x ~ N(0, 1), a = sigmoid(N(0, 1) + 2) (the
    model's range, near 1), h0 ~ N(0, 1) or None, dout and h_T's cotangent
    dh ~ N(0, 1); a edited by ``kind``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, w)).astype(np.float32)
    a = (1 / (1 + np.exp(-rng.standard_normal((b, t, w)) - 2))).astype(np.float32)
    pick = rng.random((b, t, w))
    dout = rng.standard_normal((b, t, w)).astype(np.float32)
    if kind == "zero-one":
        a = np.where(pick < 0.25, 0.0, np.where(pick > 0.75, 1.0, a)).astype(np.float32)
    elif kind == "one-x0":
        a = np.where(pick < 0.25, 1.0, a).astype(np.float32)
        x = np.where(pick < 0.125, 0.0, x).astype(np.float32)
    elif kind == "above-one":
        a = np.full((b, t, w), np.nextafter(np.float32(1), np.float32(2)), np.float32)
    elif kind == "neg-zero":
        dout = np.where(pick < 0.5, np.float32(-0.0), dout).astype(np.float32)
    h = rng.standard_normal((b, w)).astype(np.float32) if h0 else None
    dh = rng.standard_normal((b, w)).astype(np.float32)
    return x, a, h, dout, dh


def _t(v, dtype):
    return torch.tensor(np.asarray(v, np.float32)).to(getattr(torch, dtype))


def _j(v, dtype):
    return jnp.asarray(np.asarray(v, np.float32), _JDT[dtype])


@jax.jit
def _jrglru_vjp(x, a, h0, dout, dh):
    """The reference's gradient, compiled once a shape."""
    _, vjp = jax.vjp(lambda *p: jref.rglru(*p[:2], h0=p[2] if len(p) > 2 else None),
                     *((x, a) if h0 is None else (x, a, h0)))
    return vjp((dout, dh))


def _same_values(got, want):
    """Equal element by element, NaN where the other has NaN."""
    for g_, w_ in zip(got, want):
        assert (g_ is None) == (w_ is None)
        if g_ is None:
            continue
        assert g_.dtype == w_.dtype and g_.shape == w_.shape
        g_, w_ = g_.float(), w_.float()
        assert bool(((g_ == w_) | (g_.isnan() & w_.isnan())).all())


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


def _check(case, dtype, seed):
    """The split against the plain gradient value for value, its h_{t-1}
    and g_t against a straight walk bit for bit; returns (its gradients,
    the JAX oracle's on the same values in fp32)."""
    b, t, w, h0, kind = case
    x, a, h, dout, dh = _inputs(b, t, w, h0, kind, seed)
    tx, ta = _t(x, dtype), _t(a, dtype)
    th = None if h is None else torch.from_numpy(h)
    # the port's Function returns out; h_T's cotangent lands in out's last
    # row, summed in out's dtype as autograd sums it
    d_all = _t(dout, dtype)
    d_all[:, -1] += _t(dh, dtype)
    got = rglru_bwd_split(tx, ta, th, d_all)
    _same_values(got, tref.rglru_bwd(tx, ta, th, d_all))
    # every h_{t-1} and g_t of the groups is the straight walk's
    xf, af, df = tx.float(), ta.float(), d_all.float()
    ck_h, ck_g, _ = chains(xf, af, th, df)
    _, _, hs, gs = groups(xf, af, df, ck_h, ck_g)
    want_hs, want_gs = straight_walk(xf, af, th, df)
    assert torch.equal(hs, want_hs) and torch.equal(gs, want_gs)
    # the oracle in fp32 on the same values and cotangent: run on bf16
    # arrays, JAX's gradient of a is the bf16 sum of its partial cotangents
    # (each `astype`'s transpose rounds one to bf16), not the one rounding
    # of their fp32 sum that the plain gradient and the kernels give; at T
    # = 70 that put it 2 bf16 ulps from its own fp32 value (24.75 against
    # 24.9635 in fp32 and the port's 25.0)
    want = _jrglru_vjp(*(jnp.asarray(v.numpy()) for v in (xf, af)),
                       None if h is None else jnp.asarray(h), jnp.asarray(df.numpy()),
                       jnp.zeros((b, w), jnp.float32))
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_split_equals_plain_gradient_and_jax_vjp(name, dtype):
    got, want = _check(CASES[name], dtype, seed=len(name))
    for g_, w_ in zip(got, want):
        _close(g_, w_, dtype)
    if "one-x0" in name:
        da = got[1].float()
        assert bool(torch.isneginf(da).any()) and bool(torch.isnan(da).any())


@pytest.mark.parametrize("h0", [False, True])
def test_split_fp32_a_one_ulp_above_one(h0):
    """1 - a^2 < 0 is clamped: s = 0 and the clamp's mask drops the sqrt's
    term, so dx = 0 and da = g h_{t-1}, finite, the plain gradient's. The
    reference's autodiff gives NaN for da there (the clip's zero
    derivative times the sqrt's infinite one at 0); dx and dh0 agree with
    it. The model's a (a sigmoid's power) never exceeds 1."""
    (dx, da, dh0), want = _check((1, 40, 40, h0, "above-one"), "float32", seed=7)
    assert bool((dx == 0).all()) and bool(torch.isfinite(da).all())
    assert bool(np.isnan(np.asarray(want[1])).all())
    _close(dx, want[0], "float32")
    if h0:
        _close(dh0, want[2], "float32")
