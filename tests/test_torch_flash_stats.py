"""The flash attention's softmax statistics and the backward's given-o
wants on the CPU, against the JAX reference and the plain gradient.

- `ref.attention_stats` (the forward kernel's saved m and l, natural
  units) against the max and ``jax.nn.logsumexp`` of the reference's
  masked scaled scores, built with `repro.kernels.ref`'s mask rule and
  NEG_INF from numpy inputs: m within 1e-6 relative, m + log(l) within
  1e-5 of the log-sum-exp; rows with no valid key (causal, S > T) at m =
  NEG_INF exactly with l = T, where one log-sum-exp would round to NEG_INF;
- `chip_smoke.bwd_given_o` with fp32 operands against `ref.attention_bwd`
  in fp32 (within 1e-5 * (1 + |want|)), and with bf16 operands (P and dS
  rounded before the three products, as the tensor-core kernel does)
  within the rounding's own bound of the fp32 mode: per element at most
  2^-8 (bf16's unit roundoff) of the sum of the rounded terms'
  magnitudes, and not equal to it;
- `chip_smoke.bf16_flip` (the want's rounding allowance) and the
  bf16-operand gate against a stand-in kernel whose fp32 P differs in its
  last bits, `chip_smoke.stats_check`, `flash_bwd_work`'s design count,
  and the wrapper's operands, splits and kernel counts."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as tref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# (b, s, t, h, kv, d, causal, window): the three masks, GQA groups 1, 2
# and 4, S < T, rows with no valid key (S > T, with and without a window),
# and S past the plain version's row chunk of 1024
SHAPES = [(2, 16, 16, 4, 2, 8, True, 0), (1, 12, 30, 4, 1, 16, True, 0),
          (1, 20, 20, 4, 4, 8, False, 0), (2, 24, 40, 8, 2, 8, True, 9),
          (1, 30, 18, 2, 1, 8, True, 0), (2, 40, 25, 4, 1, 16, True, 6),
          (1, 1100, 1100, 2, 1, 8, True, 300)]


def _inputs(shape, seed):
    b, s, t, h, kv, d, _, _ = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d), (b, s, h, d))]


def _jax_masked_scores(q, k, causal, window):
    """The reference's masked scaled scores [B, KV, G, S, T]
    (`repro.kernels.ref.attention_dense`'s rule and NEG_INF)."""
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    qg = jnp.asarray(q).reshape(b, s, kv, h // kv, dh)
    scores = jnp.einsum("bskgd,btkd->bkgst", qg, jnp.asarray(k)) * dh ** -0.5
    if causal:
        qpos = jnp.arange(s)[:, None] + (t - s)
        kpos = jnp.arange(t)[None, :]
        mask = kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        scores = jnp.where(mask[None, None, None], scores, jref.NEG_INF)
    return scores.astype(jnp.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_attention_stats_match_jax_logsumexp(shape):
    b, s, t, h, kv, d, causal, window = shape
    q, k, _, _ = _inputs(shape, sum(shape))
    got = tref.attention_stats(torch.from_numpy(q), torch.from_numpy(k), causal=causal,
                               window=window)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, b, h, s)
    scores = _jax_masked_scores(q, k, causal, window)
    want_m = np.asarray(scores.max(axis=-1)).reshape(b, h, s)
    want_lse = np.asarray(jax.nn.logsumexp(scores, axis=-1)).reshape(b, h, s)
    m, l = got[0].numpy(), got[1].numpy()
    none = np.arange(s) + (t - s) < 0 if causal else np.zeros(s, bool)
    none = np.broadcast_to(none, (b, h, s))
    assert (m[none] == np.float32(jref.NEG_INF)).all() and (l[none] == t).all()
    # the trap the two statistics avoid: NEG_INF + log(T) is NEG_INF in fp32
    assert (want_lse[none] == np.float32(jref.NEG_INF)).all()
    np.testing.assert_allclose(m[~none], want_m[~none], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(m[~none] + np.log(l[~none]), want_lse[~none],
                               rtol=1e-5, atol=1e-5)
    assert (l >= 1).all()


@pytest.mark.parametrize("shape", SHAPES[:6], ids=lambda s: "-".join(map(str, s)))
def test_bwd_given_o_fp32_matches_plain_gradient(shape):
    causal, window = shape[6], shape[7]
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(shape, sum(shape) + 1))
    o = tref.attention(q, k, v, causal=causal, window=window)
    got, allow = chip_smoke.bwd_given_o(q, k, v, o, dout, causal, window, operands="fp32")
    assert allow is None
    want = tref.attention_bwd(q, k, v, o, None, dout, causal=causal, window=window)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES[:6], ids=lambda s: "-".join(map(str, s)))
def test_bwd_given_o_bf16_operands_within_their_rounding(shape):
    """The bf16 mode differs from the fp32 mode by no more than rounding P
    and dS can: per element 2^-8 (bf16's unit roundoff: 8 significant
    bits, round to nearest) of sum |P| |dO| for dv and of scale * sum |dS|
    |k| / |q| for dq / dk, plus fp32 slack; its rounding allowance is at
    most 2^-7 (a bf16 ulp) of the same sums."""
    b, s, t, h, kv, d, causal, window = shape
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(shape, sum(shape) + 2))
    o = tref.attention(q, k, v, causal=causal, window=window)
    exact, _ = chip_smoke.bwd_given_o(q, k, v, o, dout, causal, window)
    rounded, allow = chip_smoke.bwd_given_o(q, k, v, o, dout, causal, window,
                                            operands="bf16")
    # |P| and |dS| of the fp32 mode, by the same formulas, for the bound
    g, scale = h // kv, d ** -0.5
    qg = q.reshape(b, s, kv, g, d)
    sc = torch.einsum("bskgd,btkd->bkgst", qg, k) * scale
    mask = torch.ones(s, t, dtype=torch.bool)
    pos = torch.arange(s)[:, None] + (t - s)
    cols = torch.arange(t)[None, :]
    if causal:
        mask &= cols <= pos
    if window:
        mask &= cols > pos - window
    p = torch.softmax(torch.where(mask, sc, tref.NEG_INF), dim=-1)
    og, dog = o.reshape(b, s, kv, g, d), dout.reshape(b, s, kv, g, d)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v)
    delta = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]
    ds = torch.where(mask, p * (dp - delta), 0.0)
    bound_dv = torch.einsum("bkgst,bskgd->btkd", p.abs(), dog.abs())
    bound_dq = scale * torch.einsum("bkgst,btkd->bskgd", ds.abs(), k.abs()).reshape(b, s, h, d)
    bound_dk = scale * torch.einsum("bkgst,bskgd->btkd", ds.abs(), qg.abs())
    for name, x, y, a, bound in zip(("dq", "dk", "dv"), exact, rounded, allow,
                                    (bound_dq, bound_dk, bound_dv)):
        gap = (x - y).abs()
        assert (gap <= 2 ** -8 * bound * (1 + 1e-4) + 1e-6).all(), name
        assert gap.max() > 0, name          # the operands were rounded
        # the want's allowance: a bf16 ulp (at most 2^-7 of a term) for the
        # terms in doubt, never more than that of all of them
        assert (a >= 0).all() and (a <= 2 ** -7 * bound * (1 + 1e-4) + 1e-6).all(), name
    with pytest.raises(ValueError, match="operands"):
        chip_smoke.bwd_given_o(q, k, v, o, dout, causal, window, operands="tf32")


def test_bf16_flip_marks_values_near_a_rounding_midpoint():
    """`chip_smoke.bf16_flip`: one bf16 ulp where a value lies within the
    radius of a midpoint between two bf16 neighbours, else 0."""
    one_ulp = 2.0 ** -7                      # bf16's ulp in [1, 2)
    mid = 1 + one_ulp / 2                    # halfway between 1 and 1 + 2^-7
    x = torch.tensor([mid, mid + 2 ** -20, mid + 2 ** -12, 1.0, -mid, 2 * mid])
    got = chip_smoke.bf16_flip(x, torch.full_like(x, 2 ** -16))
    want = torch.tensor([one_ulp, one_ulp, 0, 0, one_ulp, 2 * one_ulp])
    assert torch.equal(got, want)
    assert torch.equal(chip_smoke.bf16_flip(x, torch.zeros_like(x)),
                       torch.tensor([one_ulp, 0, 0, 0, one_ulp, 2 * one_ulp]))


@pytest.mark.parametrize("shape", [SHAPES[3], (1, 200, 300, 4, 2, 64, True, 0),
                                   (1, 128, 128, 2, 2, 64, False, 0)],
                         ids=lambda s: "-".join(map(str, s)))
def test_bf16_operand_gate_takes_rounding_flips_and_catches_errors(shape):
    """The bf16-operand given-o gate (BWD_O_TOL with the want's rounding
    allowance): a stand-in kernel whose fp32 P differs from the want's by
    1e-6 relative (inside the doubt radius) rounds some terms the other way and
    passes, though it fails the same gate without the allowance; one
    wrong weight in one row fails it."""
    b, s, t, h, kv, d, causal, window = shape
    q, k, v, dout = (torch.from_numpy(x).bfloat16() for x in _inputs(shape, sum(shape) + 4))
    o = tref.attention(q, k, v, causal=causal, window=window)
    want, allow = chip_smoke.bwd_given_o(q, k, v, o, dout, causal, window, operands="bf16")
    assert all((a >= 0).all() for a in allow)
    softmax, rng = torch.softmax, torch.Generator().manual_seed(5)

    def stand_in(scale_row=None):
        def noisy(x, dim=-1):
            p = softmax(x, dim=dim)
            p = p * (1 + 1e-6 * torch.randn(p.shape, generator=rng))
            if scale_row is not None:        # a wrong weight: one key of one row
                p[(..., scale_row, -1)] *= 1.5
            return p
        torch.softmax = noisy
        try:
            got, _ = chip_smoke.bwd_given_o(q, k, v, o, dout, causal, window, operands="bf16")
        finally:
            torch.softmax = softmax
        return tuple(x.bfloat16() for x in got)

    tol = chip_smoke.BWD_O_TOL["bf16"]
    got = stand_in()
    assert chip_smoke.bwd_compare(got, want, tol, allow)[3]
    assert not chip_smoke.bwd_compare(got, want, tol)[3]
    assert not chip_smoke.bwd_compare(stand_in(scale_row=s - 1), want, tol, allow)[3]


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[4], SHAPES[5]],
                         ids=lambda s: "-".join(map(str, s)))
def test_stats_check_holds_plain_and_catches_errors(shape):
    """chip_smoke's gate on the forward's statistics: the plain statistics
    pass, a relative error of 2 * STATS_TOL in one m or one l fails, and so
    does a row with no valid key whose m is off NEG_INF."""
    causal, window = shape[6], shape[7]
    q, k, _, _ = (torch.from_numpy(x) for x in _inputs(shape, 3))
    want = tref.attention_stats(q, k, causal=causal, window=window)
    assert chip_smoke.stats_check(want.clone(), q, k, causal, window)["ok"]
    last = (0, 0, shape[1] - 1)              # the last row always has a valid key
    for i in (0, 1):
        bad = want.clone()
        bad[(i, *last)] += 2 * chip_smoke.STATS_TOL * (1 + bad[(i, *last)].abs())
        assert not chip_smoke.stats_check(bad, q, k, causal, window)["ok"]
    gate = chip_smoke.stats_check(want, q, k, causal, window)
    if gate["no_key_rows"]:
        bad = want.clone()
        bad[0, 0, 0, 0] = tref.NEG_INF * 0.5
        assert not chip_smoke.stats_check(bad, q, k, causal, window)["ok"]


def test_design_flops_operands_and_split():
    """The row's design count is 14 / 10 of the bound's, and the wrapper
    names the operands, the splits and the kernels of each form as the
    source's dispatch does: bf16 on the tensor cores (the delta pass, dq,
    dk / dv in one walk, two above head dim 128, and the splits' sum when
    a walk is cut), fp32 on the CUDA cores (two kernels)."""
    q, k = torch.zeros(1, 256, 4, 64), torch.zeros(1, 256, 2, 64)
    _, flops = chip_smoke.flash_bwd_work(q, k, True, 0)
    _, design = chip_smoke.flash_bwd_work(q, k, True, 0, per_pair=14)
    assert design * 10 == flops * 14
    bf16, fp32 = torch.bfloat16, torch.float32
    assert (fa.bwd_operands(bf16), fa.bwd_operands(fp32)) == ("bf16", "fp32")
    # (b, t, kv) on 132 SMs: h2o-danube, whisper-tiny's cross, qwen2-vl-2b,
    # recurrentgemma-9b, a short single-head call (capped)
    for (b, t, kv), n in (((1, 8192, 8), 1), ((8, 1500, 6), 1), ((1, 4096, 2), 5),
                          ((1, 4096, 1), 9), ((1, 100, 1), 16)):
        assert fa.bwd_split(bf16, b, t, kv, 132) == n
        assert fa.bwd_split(fp32, b, t, kv, 132) == 1
    for dtype, d, n_split, n in ((bf16, 8, 1, 3), (bf16, 128, 5, 4), (bf16, 136, 1, 4),
                                 (bf16, 256, 9, 5), (fp32, 80, 1, 2), (fp32, 256, 1, 2)):
        assert fa.bwd_kernels_per_call(dtype, d, n_split) == n
