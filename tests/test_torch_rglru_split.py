"""The split of the RG-LRU kernel (`csrc/rglru_scan.cu`), emulated in plain
PyTorch on the CPU and held against the port's plain version
(`repro_torch.kernels.ref.rglru`), the JAX Pallas kernel in interpret mode
(`repro.kernels.rglru_scan.rglru`) and the JAX oracle
(`repro.kernels.ref.rglru`) on the same seeded numpy inputs.

The kernel splits the work, not the order: its producer warps compute a
and g = sqrt(max(1 - a^2, 0)) * x in fp32 for a chunk of TC = 32 steps,
then its consumer threads walk h <- a * h + g over the chunk's steps, from
h0 or zeros, the last chunk ragged. The emulation does the same: g for
every step first, then the walk in chunks, each operation one IEEE fp32
operation. So it must equal the plain version bit for bit, and the
kernel, which repeats it on the card, equals both. It lives here and not
in the package: the kernel is the package's form of it.

Edges: T = 1, TC - 1, TC and TC + 1 and a ragged length; W = 40 and 130
(no multiple of the kernel's 64-channel tile) with h0; a = 0 and a = 1
exactly; fp32 a = 1 + 1 ulp, where 1 - a^2 < 0 is clamped to 0. Gates
against the JAX side: those of tests/test_torch_recurrent_kernels.py (3e-4
fp32, 3e-2 bf16, one rounding of the fp32 result)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru as pallas_rglru
from repro_torch.kernels import ref as tref

jax.config.update("jax_platform_name", "cpu")

TC = 32   # steps per chunk, as the kernel's
TOL = {"float32": 3e-4, "bfloat16": 3e-2}
# (b, t, w, h0): T across the chunk (1, TC - 1, TC, TC + 1), a ragged
# length, W off the kernel's channel tile
SHAPES = {"t1-h0": (2, 1, 64, True), "t31": (1, 31, 40, False),
          "t32-w130-h0": (2, 32, 130, True), "t33": (3, 33, 64, False),
          "ragged-200-h0": (2, 200, 96, True), "w40-t65-h0": (1, 65, 40, True)}


def rglru_split(x, a, h0=None):
    """The kernel's split: x, a [B, T, W] (fp32 or bf16), h0 [B, W] or None
    -> (out [B, T, W] in x's dtype, out[:, -1])."""
    b, t, w = x.shape
    af, xf = a.float(), x.float()
    g = torch.sqrt(torch.clamp(1.0 - af * af, min=0.0)) * xf   # the producers
    h = torch.zeros((b, w)) if h0 is None else h0.float()
    out = torch.empty_like(x)
    for c0 in range(0, t, TC):                                 # the consumers
        for i in range(c0, min(c0 + TC, t)):
            h = af[:, i] * h + g[:, i]
            out[:, i] = h
    return out, out[:, -1]


def _inputs(b, t, w, h0, seed, a=None):
    """numpy fp32 draws: x ~ N(0, 1), a = sigmoid(N(0, 1)) unless given,
    h0 ~ N(0, 1) or None."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, w)).astype(np.float32)
    if a is None:
        a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, w))))).astype(np.float32)
    h = rng.standard_normal((b, w)).astype(np.float32) if h0 else None
    return x, a, h


def _torch(x, a, h, dtype):
    dt = getattr(torch, dtype)
    return (torch.from_numpy(x).to(dt), torch.from_numpy(a).to(dt),
            None if h is None else torch.from_numpy(h))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_split_equals_plain_version(name, dtype):
    b, t, w, h0 = SHAPES[name]
    x, a, h = _torch(*_inputs(b, t, w, h0, seed=len(name)), dtype)
    out, h_t = rglru_split(x, a, h)
    want, want_h = tref.rglru(x, a, h0=h)
    assert out.dtype == x.dtype and out.shape == x.shape
    assert torch.equal(out, want) and torch.equal(h_t, want_h)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_split_matches_pallas_and_oracle(name, dtype):
    """The oracle from h0 where one is given; the Pallas kernel, which takes
    no h0, from zeros."""
    b, t, w, h0 = SHAPES[name]
    x, a, h = _inputs(b, t, w, h0, seed=len(name) + 1)
    tx, ta, th = _torch(x, a, h, dtype)
    jx, ja = (jnp.asarray(v, getattr(jnp, dtype)) for v in (x, a))
    jh = None if h is None else jnp.asarray(h)
    out, h_t = rglru_split(tx, ta, th)
    o_out, o_h = jref.rglru(jx, ja, h0=jh)
    _close(out, o_out, TOL[dtype])
    _close(h_t, o_h, TOL[dtype])
    out0, h0_t = rglru_split(tx, ta)
    p_out, p_h = pallas_rglru(jx, ja, interpret=True)
    _close(out0, p_out, TOL[dtype])
    _close(h0_t, p_h, TOL[dtype])


def _edge_a(kind, shape, seed):
    """a with a quarter of its entries exactly 0 and a quarter exactly 1
    ("zero-one"), or every entry 1 + 1 fp32 ulp ("above-one")."""
    rng = np.random.default_rng(seed)
    if kind == "above-one":
        return np.full(shape, np.nextafter(np.float32(1), np.float32(2)), np.float32)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))).astype(np.float32)
    pick = rng.random(shape)
    return np.where(pick < 0.25, 0.0, np.where(pick > 0.75, 1.0, a)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h0", [False, True])
def test_split_a_exactly_zero_and_one(dtype, h0):
    """a = 0: h = x; a = 1: g = 0 * x = +-0, h carries over unchanged."""
    b, t, w = 2, 70, 130
    x, _, h = _inputs(b, t, w, h0, seed=11)
    a = _edge_a("zero-one", (b, t, w), seed=12)
    tx, ta, th = _torch(x, a, h, dtype)
    out, h_t = rglru_split(tx, ta, th)
    want, want_h = tref.rglru(tx, ta, h0=th)
    assert torch.equal(out, want) and torch.equal(h_t, want_h)
    zero = ta == 0
    assert torch.equal(out[zero], tx[zero])
    prev = torch.cat([(torch.zeros(b, 1, w) if th is None else th[:, None]).to(tx.dtype),
                      out[:, :-1]], dim=1)
    one = ta == 1
    assert torch.equal(out[one], prev[one])
    jx, ja = (jnp.asarray(v, getattr(jnp, dtype)) for v in (x, a))
    o_out, _ = jref.rglru(jx, ja, h0=None if h is None else jnp.asarray(h))
    _close(out, o_out, TOL[dtype])


@pytest.mark.parametrize("h0", [False, True])
def test_split_fp32_a_one_ulp_above_one(h0):
    """1 - a^2 < 0 is clamped, so g = 0 and h_t = a * h_{t-1}: zeros stay
    zeros, h0 grows by a at every step."""
    b, t, w = 1, 40, 40
    x, _, h = _inputs(b, t, w, h0, seed=13)
    a = _edge_a("above-one", (b, t, w), seed=14)
    tx, ta, th = _torch(x, a, h, "float32")
    out, h_t = rglru_split(tx, ta, th)
    want, want_h = tref.rglru(tx, ta, h0=th)
    assert torch.equal(out, want) and torch.equal(h_t, want_h)
    hh = torch.zeros(b, w) if th is None else th.clone()
    for i in range(t):
        hh = ta[:, i] * hh
        assert torch.equal(out[:, i], hh)
    o_out, _ = jref.rglru(jnp.asarray(x), jnp.asarray(a),
                          h0=None if h is None else jnp.asarray(h))
    _close(out, o_out, TOL["float32"])
