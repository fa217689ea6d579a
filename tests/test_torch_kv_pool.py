"""The port's paged KV pool (`repro_torch.serving.kv_pool`) against
`repro.serving.kv_pool`: multi-step append / release cycles over a pool
that fills up and spills to lenders under a LINK_BW budget, fp32 and int8.
Allocation state (`used`, `owner_seq`, `page_table`, `seq_len`) and the
WAL match bit for bit; fp32 K/V to 1e-6; int8 codes to one code step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import kv_pool as jkvp
from repro_torch.serving import kv_pool as tkvp

jax.config.update("jax_platform_name", "cpu")

R, P, PAGE, KV, DH, S, MP = 3, 6, 4, 2, 8, 4, 5
_append = jax.jit(jkvp.append_tokens)
_release = jax.jit(jkvp.release_sequences)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pools(quant):
    """The same pool in both packages: replica 0 starts with most of its
    pages taken (by no sequence), so its sequences spill early."""
    jpool = jkvp.make_pool(R, P, PAGE, KV, DH, S, MP, dtype=jnp.float32,
                           quant=quant)
    jpool = jpool._replace(used=jpool.used.at[0, : P - 2].set(True))
    tpool = tkvp.make_pool(R, P, PAGE, KV, DH, S, MP, dtype=torch.float32,
                           quant=quant, device="cpu")
    tpool = tpool._replace(used=_t(jpool.used))
    return jpool, tpool


def _assert_pool_matches(jpool, tpool, quant):
    for name in ("used", "owner_seq", "page_table", "seq_len", "seq_active"):
        a, b = np.asarray(getattr(jpool, name)), getattr(tpool, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in jkvp.wal.LogPages._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jpool.logs, name)),
                                      getattr(tpool.logs, name).numpy(),
                                      err_msg=f"logs.{name}")
    # the port's planes are flat by global page id, plus a scratch page
    planes = {name: getattr(tpool, name)[:-1].reshape(getattr(jpool, name).shape)
              for name in ("k", "v")}
    if quant == "int8":
        for plane in ("k", "v"):
            a = np.asarray(getattr(jpool, plane)).astype(np.int32)
            b = planes[plane].numpy().astype(np.int32)
            assert np.abs(a - b).max() <= 1, plane
        for s in ("k_scale", "v_scale"):
            np.testing.assert_allclose(np.asarray(getattr(jpool, s)),
                                       getattr(tpool, s).numpy(), rtol=1e-6)
    else:
        for plane in ("k", "v"):
            np.testing.assert_allclose(np.asarray(getattr(jpool, plane)),
                                       planes[plane].numpy(), atol=1e-6)


@pytest.mark.parametrize("metered", [False, True], ids=["unmetered", "budget"])
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_append_release_cycles_match_reference(quant, metered):
    rng = np.random.default_rng(17 + metered)
    jpool, tpool = _pools(quant)
    spilled_total = 0
    for step in range(14):
        active = rng.random((R, S)) < 0.75
        # growing magnitudes force int8 rescale-on-write
        k = (rng.standard_normal((R, S, KV, DH)) * (1 + step)).astype(np.float32)
        v = (rng.standard_normal((R, S, KV, DH)) * (1 + step)).astype(np.float32)
        lenders = rng.random(R) < 0.7
        budget = rng.integers(0, 3, R).astype(np.int32) if metered else None
        jpool, jsp = _append(jpool, jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(active), jnp.asarray(lenders),
                             None if budget is None else jnp.asarray(budget))
        tpool, tsp = tkvp.append_tokens(tpool, _t(k), _t(v), _t(active),
                                        _t(lenders),
                                        None if budget is None else _t(budget))
        np.testing.assert_array_equal(np.asarray(jsp), tsp.numpy())
        spilled_total += int(tsp.sum())
        np.testing.assert_array_equal(np.asarray(jkvp.offsite_pages(jpool)),
                                      tkvp.offsite_pages(tpool).numpy())
        _assert_pool_matches(jpool, tpool, quant)
        done = rng.random((R, S)) < 0.25
        jpool = _release(jpool, jnp.asarray(done))
        tpool = tkvp.release_sequences(tpool, _t(done))
        _assert_pool_matches(jpool, tpool, quant)
    assert spilled_total > 0     # the cycle exercised the lender spill + WAL
    assert int(tpool.logs.commits) == spilled_total


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_gather_kv_and_page_nbytes_match_reference(quant):
    rng = np.random.default_rng(3)
    jpool, tpool = _pools(quant)
    for _ in range(6):
        k = rng.standard_normal((R, S, KV, DH)).astype(np.float32)
        active = np.ones((R, S), bool)
        lenders = np.ones(R, bool)
        jpool, _ = _append(jpool, jnp.asarray(k), jnp.asarray(-k),
                           jnp.asarray(active), jnp.asarray(lenders), None)
        tpool, _ = tkvp.append_tokens(tpool, _t(k), _t(-k), _t(active),
                                      _t(lenders))
    assert tkvp.page_nbytes(tpool) == jkvp.page_nbytes(jpool)
    for home in range(R):
        for slot in range(S):
            want = jkvp.gather_kv(jpool, home, slot)
            got = tkvp.gather_kv(tpool, home, slot)
            np.testing.assert_array_equal(np.asarray(want[2]), got[2].numpy())
            for a, b in zip(want[:2], got[:2]):
                np.testing.assert_allclose(np.asarray(a), b.numpy(),
                                           atol=0.02 if quant == "int8" else 1e-6)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_pages_per_replica_matches_reference(quant):
    jpool, tpool = _pools(quant)
    assert tkvp.pages_per_replica(tpool) == jkvp.pages_per_replica(jpool) == P
    # the hierarchical engine's pools carry a leading shard axis
    assert tkvp.pages_per_replica(tkvp._with_shard_axis(tpool)) == P


def test_append_writes_in_place_and_needs_pool_planes():
    """K/V planes are updated in place (their last page, the scratch page,
    takes the masked writes); planes without the scratch page are refused."""
    pool = tkvp.make_pool(2, 4, 4, 1, 4, 2, 3, dtype=torch.float32,
                          device="cpu")
    assert tuple(pool.k.shape) == (2 * 4 + 1, 4, 1, 4)
    k_before = pool.k
    tok = torch.ones((2, 2, 1, 4))
    # slot 1 of replica 1 is inactive: its row goes to the scratch page
    active = torch.tensor([[True, True], [True, False]])
    out, _ = tkvp.append_tokens(pool, tok, tok, active,
                                torch.zeros(2, dtype=torch.bool))
    assert out.k is k_before and float(out.k[:-1].sum()) == 12.0
    with pytest.raises(ValueError, match="make_pool"):
        tkvp.append_tokens(pool._replace(k=pool.k[:-1], v=pool.v[:-1]), tok, tok,
                           torch.ones((2, 2), dtype=torch.bool),
                           torch.zeros(2, dtype=torch.bool))


def test_make_pool_rejects_unknown_quant_and_defaults_to_cuda():
    with pytest.raises(ValueError):
        tkvp.make_pool(2, 4, 4, 1, 4, 2, 3, quant="fp8", device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tkvp.make_pool(2, 4, 4, 1, 4, 2, 3)
