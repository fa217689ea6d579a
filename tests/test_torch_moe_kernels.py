"""The port's MoE router and FTL lookup against the JAX reference: its
plain versions (`repro_torch.kernels.ref.topk_router` and `ftl_lookup`)
against the Pallas kernels in interpret mode and the jnp oracles on the
CPU, over the sweeps of tests/test_kernels.py, the DeepSeek shapes (E =
160, k = 6; E = 256, k = 8) at a length that is not a multiple of the
Pallas block, rows with exact ties (lowest index first), PPNs past fp32's
exact integers, and out-of-range LPNs (against the oracle only: the Pallas
kernel's one-hot walk gives such LPNs slot 0). Gates: indices and FTL
results exact, router weights within 1e-6. The CUDA kernels are held
against these plain versions on the card by
tests/test_torch_cuda_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ftl_lookup import ftl_lookup as pallas_ftl
from repro.kernels.moe_router import topk_router as pallas_router
from repro_torch.jbof import ssd as tssd
from repro_torch.kernels import ftl_lookup as tftl
from repro_torch.kernels import moe_router as tmr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

jax.config.update("jax_platform_name", "cpu")

# (t, e, k): the sweep of tests/test_kernels.py, then DeepSeek-v2's and
# -v3's router shapes at a ragged length (the Pallas block is 256 rows)
ROUTER_SWEEP = [(256, 128, 6), (512, 256, 8), (128, 160, 2),
                (300, 160, 6), (300, 256, 8)]
# (n_seg, n_slots, entries, n): the sweep of tests/test_kernels.py
FTL_SWEEP = [(64, 16, 128, 512), (128, 32, 256, 1024), (16, 4, 512, 256)]
W_TOL = 1e-6


def _router_inputs(t, e, bias, seed, sigmoid=False):
    """Scores as the models make them: a softmax over normal logits, or
    (with the aux-free bias) their sigmoid; and a bias of scale 0.1."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    if sigmoid:
        scores = 1.0 / (1.0 + np.exp(-logits))
    else:
        z = np.exp(logits - logits.max(-1, keepdims=True))
        scores = z / z.sum(-1, keepdims=True)
    b = (rng.standard_normal(e) * 0.1).astype(np.float32) if bias else None
    return scores.astype(np.float32), b


def _router_all(scores, k, b):
    """(Pallas in interpret mode, jnp oracle, port's plain version)."""
    js, jb = jnp.asarray(scores), None if b is None else jnp.asarray(b)
    ts, tb = torch.from_numpy(scores), None if b is None else torch.from_numpy(b)
    return (pallas_router(js, k, bias=jb, interpret=True),
            jref.topk_router(js, k, bias=jb), tref.topk_router(ts, k, bias=tb))


def _router_close(got, want):
    w, idx = got
    assert idx.dtype == torch.int32 and w.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(w.numpy(), np.asarray(want[0]), atol=W_TOL, rtol=0)


# --------------------------------------------------------------- router
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("t,e,k", ROUTER_SWEEP)
def test_topk_router_plain_matches_pallas_and_oracle(t, e, k, bias):
    scores, b = _router_inputs(t, e, bias, seed=t + e + k, sigmoid=bias)
    pallas, oracle, plain = _router_all(scores, k, b)
    _router_close(plain, oracle)
    _router_close(plain, pallas)
    np.testing.assert_allclose(plain[0].sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("bias", [False, True])
def test_topk_router_ties_go_to_the_lowest_index(bias):
    """Scores drawn from four values, so every row has exact ties; with
    the bias, ties in sel = scores + bias where the bias is a constant."""
    rng = np.random.default_rng(11)
    t, e, k = 64, 160, 6
    scores = (rng.integers(0, 4, (t, e)) / 8.0).astype(np.float32)
    scores[0] = 0.25                       # a row of one value: picks 0..k-1
    b = np.full(e, 0.5, np.float32) if bias else None
    pallas, oracle, plain = _router_all(scores, k, b)
    _router_close(plain, oracle)
    _router_close(plain, pallas)
    np.testing.assert_array_equal(plain[1][0].numpy(), np.arange(k))
    # within a row, equal picked values come in increasing index order
    idx = plain[1].numpy()
    picked = np.take_along_axis(scores, idx, 1)
    same = picked[:, 1:] == picked[:, :-1]
    assert (idx[:, 1:][same] > idx[:, :-1][same]).all()


def test_topk_router_weights_use_the_unbiased_scores():
    """A large bias on expert 3 makes every row pick it, but its weight is
    its own (unbiased) score over the picked scores' sum."""
    scores, _ = _router_inputs(32, 256, False, seed=5, sigmoid=True)
    b = np.zeros(256, np.float32)
    b[3] = 10.0
    _, oracle, (w, idx) = _router_all(scores, 8, b)
    assert (idx[:, 0] == 3).all()
    picked = np.take_along_axis(scores, idx.numpy().astype(np.int64), 1)
    np.testing.assert_allclose(w.numpy(), picked / picked.sum(-1, keepdims=True),
                               atol=W_TOL)
    _router_close((w, idx), oracle)


# ------------------------------------------------------------ ftl lookup
def _ftl_inputs(n_seg, n_slots, entries, n, seed, ppn_max=1 << 20):
    rng = np.random.default_rng(seed)
    directory = np.where(rng.random(n_seg) < 0.6, rng.integers(0, n_slots, n_seg),
                         -1).astype(np.int32)
    cache = rng.integers(0, ppn_max, (n_slots, entries)).astype(np.int32)
    lpns = rng.integers(0, n_seg * entries, n).astype(np.int32)
    return lpns, directory, cache


def _ftl_close(got, want):
    ppn, hit = got
    assert ppn.dtype == torch.int32 and hit.dtype == torch.bool
    np.testing.assert_array_equal(ppn.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("n_seg,n_slots,entries,n", FTL_SWEEP)
def test_ftl_plain_matches_pallas_and_oracle(n_seg, n_slots, entries, n):
    lpns, directory, cache = _ftl_inputs(n_seg, n_slots, entries, n, seed=n_seg + n)
    plain = tref.ftl_lookup(torch.from_numpy(lpns), torch.from_numpy(directory),
                            torch.from_numpy(cache), entries)
    j = [jnp.asarray(a) for a in (lpns, directory, cache)]
    _ftl_close(plain, jref.ftl_lookup(*j, entries))
    _ftl_close(plain, pallas_ftl(*j, entries, interpret=True))
    assert (plain[0][~plain[1]] == -1).all()
    assert 0 < int(plain[1].sum()) < n


def test_ftl_plain_is_exact_past_fp32_integers():
    """PPNs up to 2^31 - 2, as a 4 TB SSD's (some 2^30 slices): the plain
    version gives the oracle's integers, which fp32 cannot all hold (the
    Pallas kernel's one-hot matmuls round them; not compared)."""
    lpns, directory, cache = _ftl_inputs(32, 8, 256, 2048, seed=9,
                                         ppn_max=(1 << 31) - 1)
    plain = tref.ftl_lookup(torch.from_numpy(lpns), torch.from_numpy(directory),
                            torch.from_numpy(cache), 256)
    _ftl_close(plain, jref.ftl_lookup(*(jnp.asarray(a) for a in
                                        (lpns, directory, cache)), 256))
    hits = plain[0][plain[1]].long()
    assert bool((hits >= 1 << 24).any())
    assert not torch.equal(hits.float().long(), hits)   # fp32 would round


def test_ftl_out_of_range_lpns_follow_the_oracle():
    """Negative and too-large LPNs: floored // and %, a negative segment
    wraps once then clamps, a slot past the cache clamps, as the jnp
    oracle indexes. Nothing raises."""
    n_seg, n_slots, entries = 7, 3, 8
    directory = np.array([2, 0, -1, 1, 5, 2, -7], np.int32)   # 5 is past the cache
    cache = np.random.default_rng(2).integers(0, 1 << 30, (n_slots, entries)
                                              ).astype(np.int32)
    lpns = np.array([-100, -57, -56, -9, -1, 0, 5, 15, 31, 39, 55, 56, 57,
                     1000, 2**31 - 1, -2**31], np.int32)
    plain = tref.ftl_lookup(torch.from_numpy(lpns), torch.from_numpy(directory),
                            torch.from_numpy(cache), entries)
    _ftl_close(plain, jref.ftl_lookup(*(jnp.asarray(a) for a in
                                        (lpns, directory, cache)), entries))
    assert bool(plain[1].any()) and not bool(plain[1].all())


def test_ssd_geometry_sizes_a_4tb_mapping_table():
    from repro.jbof import ssd as jssd
    for name in ("SLICE_BYTES", "SSD_CAPACITY_TB", "SEGMENT_BYTES",
                 "FLASH_PER_SEGMENT", "SEGMENTS_FULL"):
        assert getattr(tssd, name) == getattr(jssd, name), name
    assert tssd.SEGMENTS_FULL == 1862
    assert tssd.SEGMENT_BYTES // 4 == 524288       # entries per segment


# -------------------------------------------------------------- dispatch
def test_dispatchers_run_the_plain_versions_for_cpu_tensors():
    scores, b = _router_inputs(16, 160, True, seed=1)
    ts, tb = torch.from_numpy(scores), torch.from_numpy(b)
    lpns, directory, cache = (torch.from_numpy(a) for a in
                              _ftl_inputs(16, 4, 64, 128, seed=1))
    before = (tmr.topk_router.launches, tftl.ftl_lookup.launches)
    for got, want in zip(tops.topk_router(ts, 6, bias=tb),
                         tref.topk_router(ts, 6, bias=tb)):
        assert torch.equal(got, want)
    for got, want in zip(tops.ftl_lookup(lpns, directory, cache, 64),
                         tref.ftl_lookup(lpns, directory, cache, 64)):
        assert torch.equal(got, want)
    assert (tmr.topk_router.launches, tftl.ftl_lookup.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA kernel"):
        tmr.topk_router(torch.zeros(4, 160), 6)
    z = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tftl.ftl_lookup(z, z, torch.zeros(2, 4, dtype=torch.int32), 4)
