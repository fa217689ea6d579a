"""The port's recurrent model families against the JAX reference on the
CPU: recurrentgemma (RG-LRU blocks and local attention in a (rec, rec,
attn) period) and rwkv6. For each smoke config the same parameters
(carried across by `params_from_numpy`) and the same tokens go through
`forward`, `prefill` (logits and every cache leaf) and six `decode_step`s
of both packages, with the same greedy tokens. Also: a prompt of 128 under
``REPRO_FORCE_PALLAS=1``, where the reference runs its Pallas RG-LRU and
RWKV6 kernels in interpret mode; recurrentgemma decoded past its 16-slot
local window; the launcher's `run_model`; and the short-prompt refusal.

fp32 is held at 1e-4 * (1 + |want|): the same fp32 math on both sides,
with only the order of summation (and the RG-LRU scan's association)
differing."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode as JD
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import decode as TD
from repro_torch.models import transformer as TT

jax.config.update("jax_platform_name", "cpu")

RECURRENT = ["recurrentgemma-9b", "rwkv6-3b"]
TOL = 1e-4

# the reference's serve path, compiled once per config and shape
_jforward = jax.jit(JT.forward, static_argnums=0)
_jprefill = jax.jit(JD.prefill, static_argnums=0, static_argnames="max_len")
_jdecode = jax.jit(JD.decode_step, static_argnums=0)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _models(arch, seed=0):
    jcfg, tcfg = jconfigs.smoke(arch), tconfigs.smoke(arch)
    jparams = JT.init_params(jcfg, jax.random.key(seed))
    tparams = TT.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _cache_close(tcache, jcache):
    assert set(tcache) == set(jcache)
    for key in jcache:
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        assert tcache[key].dtype == getattr(torch, str(jcache[key].dtype)), key
        _close(tcache[key], jcache[key])


@pytest.mark.parametrize("arch", RECURRENT)
def test_configs_are_the_references(arch):
    for jc, tc in ((jconfigs.get(arch), tconfigs.get(arch)),
                   (jconfigs.smoke(arch), tconfigs.smoke(arch))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert tc.param_dtype == getattr(torch, jc.dtype)
        assert tc.n_params() == jc.n_params()
        assert tc.layer_kinds() == jc.layer_kinds() and tc.head_dim == jc.head_dim
        for prop in ("attn_layers_exist", "is_attention_free", "sub_quadratic"):
            assert getattr(tc, prop) == getattr(jc, prop), prop


@pytest.mark.parametrize("arch", RECURRENT)
def test_init_params_has_the_references_tree(arch):
    """`init_params` draws the reference's tree: the same keys, shapes
    and dtypes (the values come from another generator)."""
    tcfg = tconfigs.smoke(arch)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        JT.abstract_params(jconfigs.smoke(arch)))
    got = TT.init_params(tcfg, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
                       got)
    assert got == want


@pytest.mark.parametrize("arch", RECURRENT)
def test_serve_path_matches_reference(arch):
    jcfg, tcfg, jparams, tparams = _models(arch)
    b, s, steps = 2, 12, 6
    toks = _tokens(jcfg.vocab, b, s, seed=len(arch))

    jlogits, _ = _jforward(jcfg, jparams, jnp.asarray(toks))
    tlogits, aux = TT.forward(tcfg, tparams, torch.from_numpy(toks))
    _close(tlogits, jlogits)
    assert float(aux) == 0.0

    max_len = s + steps
    jl, jcache = _jprefill(jcfg, jparams, jnp.asarray(toks), max_len=max_len)
    tl, tcache = TD.prefill(tcfg, tparams, torch.from_numpy(toks), max_len=max_len)
    _close(tl, jl)
    _cache_close(tcache, jcache)
    assert tcache["length"].dtype == torch.int32 and tcache["length"].dim() == 0
    assert int(tcache["length"]) == int(jcache["length"]) == s

    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = torch.argmax(tl, -1).to(torch.int32)
    for _ in range(steps):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jcache = _jdecode(jcfg, jparams, jcache, jtok)
        tl, tcache = TD.decode_step(tcfg, tparams, tcache, ttok)
        _close(tl, jl)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1).to(torch.int32)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert int(tcache["length"]) == int(jcache["length"]) == s + steps
    _cache_close(tcache, jcache)


@pytest.mark.parametrize("arch", RECURRENT)
def test_prompt_of_128_matches_pallas_kernels(arch, monkeypatch):
    """With REPRO_FORCE_PALLAS=1 and T = 128 the reference's forward runs
    its Pallas scan kernel (RG-LRU or RWKV6) in interpret mode in every
    recurrent layer, and so does its hybrid prefill (its rwkv6 prefill
    calls the oracle)."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    jcfg, tcfg, jparams, tparams = _models(arch, seed=3)
    toks = _tokens(jcfg.vocab, 2, 128, seed=4)
    jlogits, _ = JT.forward(jcfg, jparams, jnp.asarray(toks))
    tlogits, _ = TT.forward(tcfg, tparams, torch.from_numpy(toks))
    _close(tlogits, jlogits)
    jl, jcache = JD.prefill(jcfg, jparams, jnp.asarray(toks), max_len=136)
    tl, tcache = TD.prefill(tcfg, tparams, torch.from_numpy(toks), max_len=136)
    _close(tl, jl)
    _cache_close(tcache, jcache)


def test_hybrid_decodes_past_its_local_window():
    """recurrentgemma-smoke's local attention keeps a 16-slot ring: prefill
    12 tokens, then decode 14 more (the ring wraps at 16). Each step must
    give the reference's decode logits and cache, and the full forward's
    logits at that position (the forward applies the same window)."""
    jcfg, tcfg, jparams, tparams = _models("recurrentgemma-9b", seed=5)
    prompt, total = 12, 26
    toks = _tokens(jcfg.vocab, 2, total, seed=6)
    tt = torch.from_numpy(toks)
    full, _ = TT.forward(tcfg, tparams, tt)
    jl, jcache = _jprefill(jcfg, jparams, jnp.asarray(toks[:, :prompt]), max_len=total)
    tl, tcache = TD.prefill(tcfg, tparams, tt[:, :prompt], max_len=total)
    assert tcache["attn_k"].shape[2] == tcfg.local_window == 16
    for i in range(prompt, total):
        jl, jcache = _jdecode(jcfg, jparams, jcache, jnp.asarray(toks[:, i]))
        tl, tcache = TD.decode_step(tcfg, tparams, tcache, tt[:, i])
        _close(tl, jl)
        torch.testing.assert_close(tl, full[:, i], atol=3e-3, rtol=3e-3)
    _cache_close(tcache, jcache)


@pytest.mark.parametrize("arch", RECURRENT)
def test_run_model_on_cpu(arch):
    out = tserve.run_model(arch, 2, 16, 4, smoke=True, device="cpu")
    assert tuple(out["tokens"].shape) == (2, 4)
    assert out["tokens"].dtype == torch.int32
    assert tuple(out["logits"].shape) == (2, tconfigs.smoke(arch).vocab)
    assert bool(torch.isfinite(out["logits"]).all())
    assert out["prefill_ms"] > 0 and out["tok_per_s"] > 0
    sizes = jax.tree.leaves(jax.tree.map(lambda a: a.size, JT.abstract_params(
        jconfigs.smoke(arch))))
    assert out["n_params"] == sum(sizes)


def test_short_prompt_is_refused():
    """A hybrid prompt shorter than conv_width - 1 would leave a short
    conv tail (the reference stores one, which its decode misreads)."""
    tcfg = tconfigs.smoke("recurrentgemma-9b")
    params = TT.init_params(tcfg, device="cpu")
    with pytest.raises(ValueError, match="conv"):
        TD.prefill(tcfg, params, torch.zeros((1, tcfg.conv_width - 2), dtype=torch.int32))
    # conv_width - 1 tokens are enough
    TD.prefill(tcfg, params, torch.zeros((1, tcfg.conv_width - 1), dtype=torch.int32))


@pytest.mark.parametrize("arch", RECURRENT)
def test_entry_points_default_to_cuda(arch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_params(tconfigs.smoke(arch))
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.run_model(arch, 1, 4, 1, smoke=True)
