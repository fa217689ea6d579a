"""Sequence-sharded MLA decode (`attention.mla_decode_seq_sharded`) on 2
and 4 gloo ranks on the CPU: deepseek-v2-smoke's `decode_step` under a
(1, n) ("data", "model") serve mesh, each rank holding its contiguous
span of the latent cache (`launch.sharding.cache_specs`).

One prompt of PROMPT tokens fills a cache of MAX_LEN positions; STEPS
decode steps follow, fed the same tokens everywhere. With 2 ranks (spans
of 16) the prompt fills rank 0's span and part of rank 1's; with 4 ranks
(spans of 8) it spans ranks 0 and 1, the decode writes cross from rank 1
into rank 2, and rank 3's span stays empty. The ranks are held against:

- the port's unsharded `mla_decode` (same prefill cache): logits within
  PORT_TOL; layer 0's cache span and every position the decode did not
  write equal bit for bit; positions written at later layers (whose
  inputs went through the flash combine) within PORT_TOL;
- the JAX unsharded `mla_decode` and the JAX `mla_decode_seq_sharded` on
  a (1, 1) mesh: logits within JAX_TOL (tests/test_torch_moe_models.py's
  TOL: the port's matmuls against XLA's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as R
from repro import configs as jconfigs
from repro.launch import runtime as jruntime
from repro.models import decode as JD
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.launch import sharding as TSH
from repro_torch.models import decode as TD
from repro_torch.models import transformer as TT

jax.config.update("jax_platform_name", "cpu")

ARCH = "deepseek-v2-236b"
BATCH, PROMPT, MAX_LEN, STEPS = 2, 14, 32, 4
PORT_TOL = 1e-5
JAX_TOL = 1e-4
WORLDS = (2, 4)


class _Mesh:
    """Shape-only (1, n) mesh for `cache_specs`."""

    def __init__(self, n):
        self.shape = {"data": 1, "model": n}
        self.axis_names = ("data", "model")


def _jax_decode(jcfg, jparams, jcache, tokens, mesh=None):
    """The reference's decode_step over ``tokens``, unsharded or with
    ``mesh`` as its serve mesh (read at trace time, so jitted afresh)."""
    jruntime.set_serve_mesh(mesh)
    try:
        step = jax.jit(JD.decode_step, static_argnums=0)
        logits = []
        for tok in tokens:
            out, jcache = step(jcfg, jparams, jcache, jnp.asarray(tok))
            logits.append(np.asarray(out))
    finally:
        jruntime.set_serve_mesh(None)
    return np.stack(logits)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg, tcfg = jconfigs.smoke(ARCH), tconfigs.smoke(ARCH)
    jparams = JT.init_params(jcfg, jax.random.key(3))
    np_params = jax.tree.map(np.asarray, jparams)
    tparams = TT.params_from_numpy(tcfg, np_params, "cpu")
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, tcfg.vocab, (BATCH, PROMPT)).astype(np.int32)
    tokens = rng.integers(0, tcfg.vocab, (STEPS, BATCH)).astype(np.int32)
    _, tcache = TD.prefill(tcfg, tparams, torch.from_numpy(prompt), max_len=MAX_LEN)
    prefill_cache = {k: v.numpy().copy() for k, v in tcache.items()}
    started = {
        world: R.Ranks(R.mla_worker, world,
                       str(tmp_path_factory.mktemp(f"mla{world}") / "store"),
                       (tcfg, np_params, prefill_cache, tokens))
        for world in WORLDS}

    logits = []
    for tok in tokens:
        out, tcache = TD.decode_step(tcfg, tparams, tcache, torch.from_numpy(tok))
        logits.append(out.numpy())
    _, jcache = jax.jit(JD.prefill, static_argnums=0, static_argnames="max_len")(
        jcfg, jparams, jnp.asarray(prompt), max_len=MAX_LEN)
    jax_plain = _jax_decode(jcfg, jparams, jcache, tokens)
    mesh11 = jax.make_mesh((1, 1), ("data", "model"))
    jax_sharded = _jax_decode(jcfg, jparams, jcache, tokens, mesh11)
    return dict(prefill=prefill_cache, port_logits=np.stack(logits),
                port_cache={k: v.numpy() for k, v in tcache.items()},
                jax_plain=jax_plain, jax_sharded=jax_sharded,
                ranks={w: r.results() for w, r in started.items()})


@pytest.mark.parametrize("world", WORLDS)
def test_logits_match_the_unsharded_decode(runs, world):
    for rank, (logits, _) in enumerate(runs["ranks"][world]):
        np.testing.assert_allclose(logits, runs["port_logits"], rtol=PORT_TOL,
                                   atol=PORT_TOL, err_msg=f"rank {rank}")
        np.testing.assert_allclose(logits, runs["jax_plain"], rtol=JAX_TOL,
                                   atol=JAX_TOL, err_msg=f"rank {rank}")
        np.testing.assert_allclose(logits, runs["jax_sharded"], rtol=JAX_TOL,
                                   atol=JAX_TOL, err_msg=f"rank {rank}")


def test_jax_references_agree(runs):
    """The reference's two paths, the yardsticks above, agree."""
    np.testing.assert_allclose(runs["jax_sharded"], runs["jax_plain"],
                               rtol=JAX_TOL, atol=JAX_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_cache_spans_are_the_unsharded_cache(runs, world):
    span = MAX_LEN // world
    written = np.zeros(MAX_LEN, bool)
    written[PROMPT:PROMPT + STEPS] = True
    for rank, (_, cache) in enumerate(runs["ranks"][world]):
        assert int(cache["length"]) == PROMPT + STEPS
        part = slice(rank * span, (rank + 1) * span)
        for key in ("c_kv", "k_rope"):
            got, want = cache[key], runs["port_cache"][key][:, :, part]
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_array_equal(got[0], want[0], err_msg=f"{key} layer 0")
            kept = ~written[part]
            np.testing.assert_array_equal(got[:, :, kept], want[:, :, kept],
                                          err_msg=f"{key} unwritten")
            np.testing.assert_array_equal(got[:, :, kept],
                                          runs["prefill"][key][:, :, part][:, :, kept])
            np.testing.assert_allclose(got, want, rtol=PORT_TOL, atol=PORT_TOL,
                                       err_msg=key)
    if world == 4:
        last = runs["ranks"][4][3][1]["c_kv"]
        assert not last.any()   # rank 3's span: never written


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_holds_the_same_logits(runs, world):
    first = runs["ranks"][world][0][0]
    for logits, _ in runs["ranks"][world][1:]:
        np.testing.assert_array_equal(logits, first)


@pytest.mark.parametrize("world", WORLDS)
def test_cache_specs_shard_the_latent_cache_by_sequence(world):
    cache = TD.init_cache(tconfigs.smoke(ARCH), BATCH, MAX_LEN, device="meta")
    specs = TSH.cache_specs(tconfigs.smoke(ARCH), cache, _Mesh(world))
    assert specs["c_kv"] == specs["k_rope"] == (None, "data", "model", None)
    assert specs["length"] == ()
