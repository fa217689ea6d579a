"""The selection of the port's top-k router kernel (`csrc/moe_router.cu`),
emulated with numpy step by step, against the port's plain version
(`repro_torch.kernels.ref.topk_router`) and the JAX side: the Pallas
kernel in interpret mode and the jnp oracle, on the CPU.

The emulation follows the kernel: sel = scores + bias (one fp32 add);
each sel as an order-preserving uint32 key, -0.0 folded onto +0.0 first;
lane l holding experts l, l + 32, ... (the kernel's slot count per lane);
each lane's (key, index) pairs packed into 64 bits and sorted, best first,
by the kernel's networks (Batcher's for 8 slots, a 9-exchange one for 5,
odd-even transposition otherwise), so that the head of a lane's list is
its cached best; per pick the warp's largest head key, then the lowest
index among the lanes that hold it, after which only the owner lane
(index & 31) moves its list on by one; the picked unbiased scores summed
in pick order in fp32, then each divided by max(sum, 1e-9).
Cases: E = 31, 32, 33, 160, 256 and 1024 with k = 1 and 16, T = 1, 4 and
1000 at DeepSeek's two shapes, rows of -0.0 and +0.0, rows of one value,
and a bias that makes every sel negative, each with and without a bias.
Gates: indices equal, weights within 1e-6. The JAX oracle's `lax.top_k`
ranks -0.0 below +0.0 (a total order), where the plain version's stable
sort, the Pallas kernel's argmax and the CUDA kernel take them as a tie
(lowest index first): on rows of zeros the oracle's picks are compared by
their sel values."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.moe_router import topk_router as pallas_router
from repro_torch.kernels import ref as tref

jax.config.update("jax_platform_name", "cpu")

W_TOL = 1e-6
# name -> (t, e, k, pattern)
CASES = {f"e{e}-k{k}": (9, e, k, "random") for e in (31, 32, 33, 160, 256, 1024)
         for k in (1, 16)}
CASES.update({f"t{t}-e{e}": (t, e, k, "random") for t in (1, 4, 1000)
              for e, k in ((160, 6), (256, 8))})
CASES.update({f"{pattern}-e{e}-k{k}": (16, e, k, pattern)
              for e, k in ((160, 6), (256, 8), (33, 16))
              for pattern in ("zeros", "equal", "negbias")})


def sort_key(x: np.ndarray) -> np.ndarray:
    """The kernel's `sort_key`: fp32 -> uint32 in the same order, -0.0 and
    +0.0 one key."""
    u = (x.astype(np.float32) + np.float32(0.0)).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))


def per_lane(e: int) -> int:
    """Slots a lane holds: ceil(E / 32) for 160 and 256 (5 and 8), else
    the next power of two, as the C entry instantiates the kernel."""
    n = -(-e // 32)
    return n if n == 5 else 1 << (n - 1).bit_length()


# the kernel's networks for 8 and 5 slots (Batcher's odd-even merge sort;
# a 9-exchange network), as (i, j) compare-exchanges in order
NETWORKS = {
    8: [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7), (1, 2), (5, 6),
        (0, 4), (1, 5), (2, 6), (3, 7), (2, 4), (3, 5), (1, 2), (3, 4), (5, 6)],
    5: [(0, 1), (3, 4), (2, 4), (2, 3), (1, 4), (0, 3), (0, 2), (1, 3), (1, 2)],
}


def sort_desc(c: np.ndarray) -> np.ndarray:
    """The kernel's `sort_desc` over the last axis, largest first: its
    network for 8 or 5 slots, odd-even transposition otherwise."""
    c = c.copy()
    n = c.shape[-1]
    pairs = NETWORKS.get(n, [(i, i + 1) for r in range(n) for i in range(r & 1, n - 1, 2)])
    for i, j in pairs:
        a, b = c[..., i].copy(), c[..., j].copy()
        c[..., i], c[..., j] = np.maximum(a, b), np.minimum(a, b)
    return c


def emulate(scores: np.ndarray, k: int, bias: np.ndarray | None):
    """(weights [T, k] fp32, indices [T, k] int32) as the CUDA kernel
    computes them."""
    t, e = scores.shape
    n = per_lane(e)
    sel = scores if bias is None else (scores + bias).astype(np.float32)
    slot_e = np.arange(n)[None, :] * 32 + np.arange(32)[:, None]       # [32, n]
    real = slot_e < e
    keys = np.where(real, sort_key(sel[:, np.minimum(slot_e, e - 1)]), 0).astype(np.uint64)
    low = (~slot_e.astype(np.uint32)).astype(np.uint64)
    c = np.where(real, keys << np.uint64(32) | low, np.uint64(0))       # [T, 32, n]
    c = sort_desc(c)
    rows = np.arange(t)
    w_sum = np.zeros(t, np.float32)
    w, idx = np.zeros((t, k), np.float32), np.zeros((t, k), np.int32)
    for p in range(k):
        head = c[:, :, 0]
        key = (head >> np.uint64(32)).astype(np.uint32)
        top = key.max(axis=1)
        mine = np.where(key == top[:, None], ~head.astype(np.uint32), np.uint32(0xFFFFFFFF))
        win = mine.min(axis=1).astype(np.int64)
        owner = win & 31
        c[rows, owner, :-1] = c[rows, owner, 1:].copy()
        c[rows, owner, -1] = 0
        score = scores[rows, win]
        w_sum = (w_sum + score).astype(np.float32)
        w[:, p], idx[:, p] = score, win
    return (w / np.maximum(w_sum, np.float32(1e-9))[:, None]).astype(np.float32), idx


def _inputs(t, e, pattern, bias, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    if pattern == "zeros":       # -0.0 and +0.0 tie; a small positive every 7th
        scores = np.where(rng.random((t, e)) < 0.5, np.float32(-0.0), np.float32(0.0))
        scores[:, ::7] = rng.random((t, (e + 6) // 7)) * 0.01
    elif pattern == "equal":
        scores = np.full((t, e), 1.0 / e)
    elif pattern == "negbias":
        scores = 1.0 / (1.0 + np.exp(-logits))
    else:
        z = np.exp(logits - logits.max(-1, keepdims=True))
        scores = z / z.sum(-1, keepdims=True)
    b = rng.standard_normal(e) * 0.1 - (2.0 if pattern == "negbias" else 0.0)
    return scores.astype(np.float32), b.astype(np.float32) if bias else None


def _close(got_w, got_idx, want_w, want_idx):
    np.testing.assert_array_equal(np.asarray(got_idx), np.asarray(want_idx))
    np.testing.assert_allclose(np.asarray(got_w), np.asarray(want_w), atol=W_TOL, rtol=0)


@pytest.mark.parametrize("bias", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("name", list(CASES))
def test_emulated_kernel_matches_plain_pallas_and_oracle(name, bias):
    t, e, k, pattern = CASES[name]
    scores, b = _inputs(t, e, pattern, bias, seed=len(name) + 7 * bias)
    w, idx = emulate(scores, k, b)
    plain = tref.topk_router(torch.from_numpy(scores), k,
                             bias=None if b is None else torch.from_numpy(b))
    _close(w, idx, plain[0].numpy(), plain[1].numpy())
    js, jb = jnp.asarray(scores), None if b is None else jnp.asarray(b)
    _close(w, idx, *pallas_router(js, k, bias=jb, interpret=True))
    o_w, o_idx = jref.topk_router(js, k, bias=jb)
    if pattern == "zeros" and b is None:
        # the oracle ranks -0.0 below +0.0: the same sel values, as floats
        sel = scores if b is None else scores + b
        np.testing.assert_array_equal(np.take_along_axis(sel, idx, 1),
                                      np.take_along_axis(sel, np.asarray(o_idx), 1))
    else:
        _close(w, idx, o_w, o_idx)
    if pattern == "equal" and b is None:
        np.testing.assert_array_equal(idx, np.broadcast_to(np.arange(k), (t, k)))


@pytest.mark.parametrize("seed", range(3))
def test_sort_key_orders_as_floats_and_folds_zero(seed):
    """In float order the keys never fall, and two neighbours share a key
    exactly when they are equal as floats: over normals of every scale,
    subnormals, both zeros, the largest finite values and the infinities."""
    rng = np.random.default_rng(seed)
    big, tiny = np.finfo(np.float32).max, np.finfo(np.float32).tiny
    x = np.concatenate([
        rng.standard_normal(3000) * 10.0 ** rng.integers(-30, 30, 3000),
        rng.random(300) * tiny, -rng.random(300) * tiny,
        [0.0, -0.0, 0.0, -0.0, np.inf, -np.inf, big, -big]]).astype(np.float32)
    x = np.concatenate([x, x[:500]])                  # exact repeats
    xs = np.sort(x)
    ks = sort_key(xs)
    assert (ks > 0).all()
    assert (ks[1:] >= ks[:-1]).all()
    np.testing.assert_array_equal(ks[1:] == ks[:-1], xs[1:] == xs[:-1])
    assert sort_key(np.float32([-0.0]))[0] == sort_key(np.float32([0.0]))[0]


@pytest.mark.parametrize("n", [1, 2, 4, 5, 8, 16])
def test_sort_networks_sort_every_zero_one_input(n):
    """The kernel's networks sort (the 0-1 principle: a network that sorts
    every 0/1 input sorts every input), here on all 2^n inputs for n <= 8
    and 4096 random ones for 16."""
    if n <= 8:
        bits = (np.arange(1 << n)[:, None] >> np.arange(n)) & 1
    else:
        bits = np.random.default_rng(n).integers(0, 2, (4096, n))
    got = sort_desc(bits.astype(np.uint64))
    np.testing.assert_array_equal(got, -np.sort(-bits, axis=1))
