"""The port's paged attention against the JAX reference: its plain
versions (`repro_torch.kernels.ref`) against the Pallas kernel in
interpret mode and the jnp oracle on the CPU, over the sweeps of
tests/test_kernels.py plus the serving engine's shapes, with holes and a
row of length 0. The CUDA kernel is held against these plain versions on
the card by tests/test_torch_cuda_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as pallas_pa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref

jax.config.update("jax_platform_name", "cpu")

# fp32 3e-5 and bf16 3e-2 are the gates of tests/test_kernels.py; the int8
# form is held to 1e-5 of the quantized oracle, as there
TOL = {"float32": 3e-5, "bfloat16": 3e-2}
INT8_TOL = 1e-5

SWEEP = [  # (b, h, kv, d, page, mp, pool) of tests/test_kernels.py
    (2, 4, 2, 128, 8, 6, 16),
    (1, 8, 8, 128, 16, 4, 8),
    (3, 2, 1, 256, 8, 3, 12),
]
# the engine's default layer and the qwen3-14b attention width; mp is a
# multiple of the Pallas kernel's page block so its length-0 rows average
# over the same columns as the oracle
ENGINE_SHAPES = [
    (5, 4, 2, 32, 16, 6, 24),
    (4, 40, 8, 128, 16, 8, 24),
]
ENGINE_IDS = ["H4-KV2-D32-page16", "H40-KV8-D128-page16"]


def _tables(rng, b, mp, pool, page, holes):
    """Random page tables and lengths. With ``holes``: unmapped columns
    inside the live range, and the last row of length 0."""
    pt = np.full((b, mp), -1, np.int32)
    lens = np.zeros((b,), np.int32)
    for i in range(b):
        n = int(rng.integers(1, mp + 1))
        pt[i, :n] = rng.choice(pool, n, replace=False)
        lens[i] = int(rng.integers(1, n * page + 1))
        if holes and n > 1:
            pt[i, rng.integers(0, n - 1)] = -1
    if holes:
        lens[-1] = 0
    return pt, lens


def _inputs(shape, dtype, holes, seed):
    b, h, kv, d, page, mp, pool = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((pool, page, kv, d)).astype(np.float32)
    vp = rng.standard_normal((pool, page, kv, d)).astype(np.float32)
    pt, lens = _tables(rng, b, mp, pool, page, holes)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jx = [jnp.asarray(a, jd) for a in (q, kp, vp)]
    tx = [torch.from_numpy(a).to(td) for a in (q, kp, vp)]
    return jx, tx, pt, lens


def _quant_inputs(shape, holes, seed):
    b, h, kv, d, page, mp, pool = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    planes, scales = [], []
    for _ in range(2):
        x = rng.standard_normal((pool, page, kv, d)).astype(np.float32)
        s = (np.abs(x).max(axis=(1, 2, 3)) / 127.0).astype(np.float32)
        planes.append(np.clip(np.round(x / s[:, None, None, None]),
                              -127, 127).astype(np.int8))
        scales.append(s)
    pt, lens = _tables(rng, b, mp, pool, page, holes)
    return q, planes, scales, pt, lens


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,holes", [(s, False) for s in SWEEP]
                         + [(s, True) for s in ENGINE_SHAPES],
                         ids=[f"sweep{i}" for i in range(len(SWEEP))]
                         + ENGINE_IDS)
def test_plain_matches_pallas_and_oracle(shape, holes, dtype):
    jx, tx, pt, lens = _inputs(shape, dtype, holes, seed=sum(shape))
    jpt, jl = jnp.asarray(pt), jnp.asarray(lens)
    got = tref.paged_attention(*tx, torch.from_numpy(pt),
                               torch.from_numpy(lens))
    assert got.dtype == tx[0].dtype and tuple(got.shape) == tuple(jx[0].shape)
    got = got.float().numpy()
    _close(got, jref.paged_attention(*jx, jpt, jl), TOL[dtype])
    if dtype == "float32" or holes:
        # bf16 over the sweeps: tests/test_kernels.py already holds the
        # Pallas kernel to the oracle there, and interpret mode is slow
        _close(got, pallas_pa(*jx, jpt, jl, interpret=True), TOL[dtype])


@pytest.mark.parametrize("shape,holes", [(s, False) for s in SWEEP]
                         + [(s, True) for s in ENGINE_SHAPES],
                         ids=[f"sweep{i}" for i in range(len(SWEEP))]
                         + ENGINE_IDS)
def test_plain_int8_matches_pallas_and_oracle(shape, holes):
    q, (kq, vq), (ks, vs), pt, lens = _quant_inputs(shape, holes,
                                                    seed=sum(shape) + 1)
    j = [jnp.asarray(a) for a in (q, kq, vq, ks, vs, pt, lens)]
    got = tref.paged_attention_quant(
        *[torch.from_numpy(a) for a in (q, kq, vq, ks, vs, pt, lens)]).numpy()
    _close(got, jref.paged_attention_quant(*j), INT8_TOL)
    _close(got, pallas_pa(j[0], j[1], j[2], j[5], j[6], k_scale=j[3],
                          v_scale=j[4], interpret=True), INT8_TOL)
    # within the int8 information loss of the fp32 oracle on the dequantized
    # values (the bound of tests/test_kernels.py)
    want_f = tref.paged_attention(
        torch.from_numpy(q), tref.dequantize_pages(torch.from_numpy(kq),
                                                   torch.from_numpy(ks)),
        tref.dequantize_pages(torch.from_numpy(vq), torch.from_numpy(vs)),
        torch.from_numpy(pt), torch.from_numpy(lens)).numpy()
    assert np.linalg.norm(got - want_f) <= 5e-2 * np.linalg.norm(want_f)


def test_length_zero_row_averages_every_gathered_row():
    """The finite NEG_INF: a row with no valid slot gets the mean of V over
    all max_pages * page gathered rows (holes clip to page 0), not NaN."""
    shape = ENGINE_SHAPES[0]
    _, (q, kp, vp), pt, lens = _inputs(shape, "float32", True, seed=3)
    out = tref.paged_attention(q, kp, vp, torch.from_numpy(pt),
                               torch.from_numpy(lens))
    b, h, kv, d, page = shape[:5]
    rows = vp[torch.from_numpy(pt[-1]).long().clamp(min=0)]  # [mp, page, kv, d]
    want = rows.reshape(-1, kv, d).mean(dim=0)                # [kv, d]
    want = want.repeat_interleave(h // kv, dim=0)
    torch.testing.assert_close(out[-1], want, atol=1e-6, rtol=1e-6)


def test_ops_dispatch_takes_plain_version_for_cpu_tensors():
    _, tx, pt, lens = _inputs(SWEEP[0], "float32", False, seed=5)
    args = (*tx, torch.from_numpy(pt), torch.from_numpy(lens))
    torch.testing.assert_close(tops.paged_attention(*args),
                               tref.paged_attention(*args), atol=0, rtol=0)
    q, (kq, vq), (ks, vs), pt, lens = _quant_inputs(SWEEP[0], False, seed=6)
    t = [torch.from_numpy(a) for a in (q, kq, vq, ks, vs, pt, lens)]
    torch.testing.assert_close(
        tops.paged_attention(t[0], t[1], t[2], t[5], t[6], k_scale=t[3],
                             v_scale=t[4]),
        tref.paged_attention_quant(*t), atol=0, rtol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches for CUDA tensors only: a CPU tensor is
    an error there, never a silent fall back (ops does the dispatch)."""
    before = tpa.paged_attention.launches
    _, tx, pt, lens = _inputs(SWEEP[0], "float32", False, seed=7)
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention(*tx, torch.from_numpy(pt), torch.from_numpy(lens))
    assert tpa.paged_attention.launches == before
