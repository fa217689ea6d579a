"""The port's prefill attention against the JAX reference: its plain
versions (`repro_torch.kernels.ref.attention`, dense and chunked forms)
against the Pallas flash kernel in interpret mode and the jnp oracle on
the CPU, over the sweep of tests/test_kernels.py plus head_dim 80, queries
offset against a longer key sequence, rows with no valid key, the chunked
form at T = 4096 and sliding windows. The CUDA kernel is held against
these plain versions on the card by tests/test_torch_cuda_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_fa
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

jax.config.update("jax_platform_name", "cpu")

# the gates of tests/test_kernels.py
TOL = {"float32": 3e-5, "bfloat16": 3e-2}

SWEEP = [  # (b, s, h, kv, d) of tests/test_kernels.py
    (2, 256, 4, 2, 128),
    (1, 384, 6, 6, 128),
    (2, 128, 8, 1, 128),   # MQA
    (1, 512, 2, 2, 256),
]
MASKS = [(True, 0), (True, 128), (False, 0)]


def _inputs(b, s, t, h, kv, d, dtype, seed):
    """numpy fp32 draws, handed to both packages in ``dtype`` (both round
    to bf16 the same way)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("b,s,h,kv,d", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_matches_pallas_and_oracle(b, s, h, kv, d, dtype, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _inputs(b, s, s, h, kv, d, dtype, b * s + h + d)
    got = tref.attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want_kernel = pallas_fa(jq, jk, jv, causal=causal, window=window, interpret=True)
    want_oracle = jref.attention(jq, jk, jv, causal=causal, window=window)
    _close(got, want_kernel, TOL[dtype])
    _close(got, want_oracle, TOL[dtype])


# (b, s, t, h, kv, d, causal, window, through Pallas): head_dim 80
# (h2o-danube), queries offset by T - S, rows with no valid key (S > T),
# and a ragged length. A ragged T is held to the oracle alone: the Pallas
# kernel reads its last key block past T without masking it, and in
# interpret mode those padded V rows are NaN, which 0 * NaN carries into
# every row (a reference-side note in ROADMAP.md).
EXTRA = {
    "d80-causal": (1, 256, 256, 4, 2, 80, True, 0, True),
    "d80-window": (1, 256, 256, 4, 2, 80, True, 96, True),
    "s64-t256-causal": (2, 64, 256, 4, 2, 128, True, 0, True),
    "s256-t64-no-valid-key-rows": (1, 256, 64, 4, 2, 128, True, 0, True),
    "s256-t64-window": (1, 256, 64, 2, 1, 128, True, 32, True),
    "ragged-200-causal": (1, 200, 200, 4, 2, 128, True, 0, False),
    "ragged-200-noncausal": (1, 200, 200, 4, 2, 128, False, 0, False),
    "d16-causal": (2, 48, 48, 4, 2, 16, True, 0, False),
}


@pytest.mark.parametrize("name", list(EXTRA))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_extra_shapes(name, dtype):
    b, s, t, h, kv, d, causal, window, pallas = EXTRA[name]
    (jq, jk, jv), (tq, tk, tv) = _inputs(b, s, t, h, kv, d, dtype, len(name))
    got = tref.attention(tq, tk, tv, causal=causal, window=window)
    _close(got, jref.attention(jq, jk, jv, causal=causal, window=window), TOL[dtype])
    if pallas:
        want = pallas_fa(jq, jk, jv, causal=causal, window=window, interpret=True)
        _close(got, want, TOL[dtype])


def test_rows_with_no_valid_key_average_v():
    """Causal with S > T: the first S - T rows see no key, and the
    reference's finite NEG_INF gives them the plain mean of V."""
    _, (q, k, v) = _inputs(1, 96, 32, 2, 1, 16, "float32", 5)
    out = tref.attention(q, k, v, causal=True)
    mean = v.mean(dim=1, keepdim=True).repeat_interleave(2, dim=2)  # [1, 1, H, D]
    torch.testing.assert_close(out[:, :64], mean.expand(1, 64, 2, 16),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 1000), (False, 0)])
def test_chunked_form_matches_reference_at_4096(causal, window):
    b, s, h, kv, d = 1, 4096, 2, 1, 16
    (jq, jk, jv), (tq, tk, tv) = _inputs(b, s, s, h, kv, d, "float32", window + 1)
    got = tref.attention(tq, tk, tv, causal=causal, window=window)  # chunked
    _close(got, jref.attention(jq, jk, jv, causal=causal, window=window), TOL["float32"])
    dense = tref.attention_dense(tq, tk, tv, causal=causal, window=window)
    torch.testing.assert_close(got, dense, atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("fn", [tref.attention, tref.attention_dense,
                                tref.attention_chunked, tops.attention,
                                tfa.flash_attention])
def test_window_without_causal_is_refused(fn):
    q = torch.zeros((1, 1024, 2, 16))
    k = torch.zeros((1, 1024, 1, 16))
    with pytest.raises(ValueError, match="causal"):
        fn(q, k, k, causal=False, window=64)


def test_dispatcher_runs_the_plain_version_for_cpu_tensors():
    _, (q, k, v) = _inputs(1, 64, 64, 4, 2, 16, "float32", 3)
    before = tfa.flash_attention.launches
    torch.testing.assert_close(tops.attention(q, k, v, window=8),
                               tref.attention(q, k, v, window=8), atol=0, rtol=0)
    assert tfa.flash_attention.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    _, (q, k, v) = _inputs(1, 8, 8, 2, 1, 16, "float32", 4)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tfa.flash_attention(q, k, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_oracle(dtype):
    rng = np.random.default_rng(9)
    b, s_max, h, kv, d = 3, 40, 8, 2, 16
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, 1, h, d), (b, s_max, kv, d), (b, s_max, kv, d))]
    valid = np.arange(s_max) < 27
    want = jref.decode_attention(*[jnp.asarray(a, getattr(jnp, dtype)) for a in arrs],
                                 jnp.asarray(valid))
    got = tops.decode_attention(*[torch.from_numpy(a).to(getattr(torch, dtype))
                                  for a in arrs], torch.from_numpy(valid))
    _close(got, want, TOL[dtype])
