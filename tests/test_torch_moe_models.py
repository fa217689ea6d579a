"""The port's DeepSeek MoE/MLA family against the JAX reference on the
CPU: deepseek-v2-smoke (full-rank q, softmax router, 2 shared experts, an
aux loss) and deepseek-v3-smoke (q_lora 24, sigmoid router with the
aux-free bias, 1 shared expert, the MTP block). For each, the same
parameters (carried across by `params_from_numpy`) and the same tokens go
through `forward` (logits and aux loss), `prefill` (logits and every cache
leaf) and six `decode_step`s of both packages, with the same greedy
tokens. Also: `moe_ffn` on both sides of `SMALL_BATCH_TOKENS` (the
one-hot and the sorted-capacity dispatch) at a capacity factor at which
tokens drop; decode against a 4096-slot latent cache and a causal MLA over
4096 keys, where MLA takes its chunked online-softmax branch; a v3 variant
with 128 routed experts under ``REPRO_FORCE_PALLAS=1``, where the
reference routes through its Pallas router in interpret mode; the
launcher's `run_model` with a config it is given.

fp32 is held at 1e-4 * (1 + |want|) for logits and cache leaves, and
`moe_ffn` at 1e-5: the same fp32 math on both sides, with only the order
of summation differing."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import decode as JD
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as TA
from repro_torch.models import decode as TD
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

jax.config.update("jax_platform_name", "cpu")

DEEPSEEK = ["deepseek-v2-236b", "deepseek-v3-671b"]
TOL = 1e-4
MOE_TOL = 1e-5

# the reference's serve path, compiled once per config and shape
_jforward = jax.jit(JT.forward, static_argnums=0)
_jprefill = jax.jit(JD.prefill, static_argnums=0, static_argnames="max_len")
_jdecode = jax.jit(JD.decode_step, static_argnums=0)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _models(jcfg, tcfg, seed=0):
    jparams = JT.init_params(jcfg, jax.random.key(seed))
    tparams = TT.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jparams, tparams


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _cache_close(tcache, jcache):
    assert set(tcache) == set(jcache)
    for key in jcache:
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        assert tcache[key].dtype == getattr(torch, str(jcache[key].dtype)), key
        _close(tcache[key], jcache[key])


def _serve_both(jcfg, tcfg, jparams, tparams, toks, max_len, steps,
                jprefill=_jprefill, jdecode=_jdecode):
    """Prefill and ``steps`` greedy decode steps in both packages; every
    step's logits, the greedy tokens and the final caches must agree.
    Returns the port's last logits and cache."""
    jl, jcache = jprefill(jcfg, jparams, jnp.asarray(toks), max_len=max_len)
    tl, tcache = TD.prefill(tcfg, tparams, torch.from_numpy(toks), max_len=max_len)
    _close(tl, jl)
    _cache_close(tcache, jcache)
    jtok = jnp.argmax(jl, -1).astype(jnp.int32)
    ttok = torch.argmax(tl, -1).to(torch.int32)
    for _ in range(steps):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jl, jcache = jdecode(jcfg, jparams, jcache, jtok)
        tl, tcache = TD.decode_step(tcfg, tparams, tcache, ttok)
        _close(tl, jl)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1).to(torch.int32)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert int(tcache["length"]) == int(jcache["length"]) == toks.shape[1] + steps
    _cache_close(tcache, jcache)
    return tl, tcache


@pytest.mark.parametrize("arch", DEEPSEEK)
def test_configs_are_the_references(arch):
    for jc, tc in ((jconfigs.get(arch), tconfigs.get(arch)),
                   (jconfigs.smoke(arch), tconfigs.smoke(arch))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert tc.param_dtype == getattr(torch, jc.dtype)
        assert tc.n_params() == jc.n_params()
        assert tc.n_active_params() == jc.n_active_params()
        assert tc.layer_kinds() == jc.layer_kinds()


@pytest.mark.parametrize("arch", DEEPSEEK)
def test_init_params_has_the_references_tree(arch):
    """`init_params` draws the reference's tree: the same keys, shapes and
    dtypes (fp32 router and bias, [L, E, D, F] experts, the MTP block);
    the values come from another generator."""
    tcfg = tconfigs.smoke(arch)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        JT.abstract_params(jconfigs.smoke(arch)))
    got = TT.init_params(tcfg, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    assert ("mtp" in got) == bool(tcfg.mtp_depth)
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
                       got)
    assert got == want


@pytest.mark.parametrize("arch", DEEPSEEK)
def test_serve_path_matches_reference(arch):
    jcfg, tcfg = jconfigs.smoke(arch), tconfigs.smoke(arch)
    jparams, tparams = _models(jcfg, tcfg)
    toks = _tokens(jcfg.vocab, 2, 12, seed=len(arch))
    jlogits, jaux = _jforward(jcfg, jparams, jnp.asarray(toks))
    tlogits, taux = TT.forward(tcfg, tparams, torch.from_numpy(toks))
    _close(tlogits, jlogits)
    _close(taux, jaux, 1e-5)
    if tcfg.moe.aux_free_bias:
        assert float(taux) == 0.0
    else:
        assert float(taux) > 0.0
    _serve_both(jcfg, tcfg, jparams, tparams, toks, max_len=18, steps=6)


def _moe_case(arch, b, s, seed):
    """A smoke config at capacity factor 0.5, one MoE layer's parameters
    (router bias made non-zero) in both packages, and its input x."""
    jcfg = dataclasses.replace(
        jconfigs.smoke(arch),
        moe=dataclasses.replace(jconfigs.smoke(arch).moe, capacity_factor=0.5))
    tcfg = dataclasses.replace(
        tconfigs.smoke(arch),
        moe=dataclasses.replace(tconfigs.smoke(arch).moe, capacity_factor=0.5))
    jparams = JT.init_params(jcfg, jax.random.key(seed))
    jp = jax.tree.map(lambda a: np.asarray(a[0]), jparams["moe_layers"]["moe"])
    if "router_bias" in jp:
        jp["router_bias"] = (np.random.default_rng(seed).standard_normal(
            jp["router_bias"].shape) * 0.1).astype(np.float32)
    tp = TT.params_from_numpy(tcfg, jp, "cpu")
    x = np.random.default_rng(seed + 1).standard_normal(
        (b, s, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), tp, x


@pytest.mark.parametrize("arch", DEEPSEEK)
@pytest.mark.parametrize("b,s", [(2, 1024), (2, 1100)], ids=["one-hot", "sorted"])
def test_moe_ffn_matches_reference_with_drops(arch, b, s):
    """2048 tokens take the one-hot dispatch, 2200 the sorted-capacity
    one. At capacity factor 0.5 some (token, expert) pairs drop: the port
    must drop the same ones."""
    jcfg, tcfg, jp, tp, x = _moe_case(arch, b, s, seed=b * s)
    assert (b * s <= TM.SMALL_BATCH_TOKENS) == (b * s <= JM.SMALL_BATCH_TOKENS)
    jy, jaux = jax.jit(JM.moe_ffn, static_argnums=0)(jcfg, jp, jnp.asarray(x))
    ty, taux = TM.moe_ffn(tcfg, tp, torch.from_numpy(x))
    _close(ty, jy, MOE_TOL)
    _close(taux, jaux, MOE_TOL)
    # the capacity of the path taken is below some expert's demand
    e = tcfg.moe
    _, idx, _ = TM.route(tcfg, tp, torch.from_numpy(x).reshape(b * s, -1))
    if b * s <= TM.SMALL_BATCH_TOKENS:
        demand = torch.bincount(idx.reshape(-1).long(), minlength=e.n_routed).max()
        cap = max(int(b * s * e.top_k / e.n_routed * e.capacity_factor), 4)
    else:
        demand = max(torch.bincount(row.long(), minlength=e.n_routed).max()
                     for row in idx.reshape(b, s * e.top_k))
        cap = max(int(s * e.top_k / e.n_routed * e.capacity_factor), 4)
    assert int(demand) > cap


@pytest.mark.parametrize("arch", DEEPSEEK)
def test_decode_against_a_4096_slot_latent_cache(arch):
    """A cache of 4096 slots makes each decode step's MLA take the chunked
    online-softmax branch (4 chunks of 1024, three of them masked past
    the written slots). It must agree with the reference, and with the
    dense branch that a 4095-slot cache takes."""
    jcfg, tcfg = jconfigs.smoke(arch), tconfigs.smoke(arch)
    jparams, tparams = _models(jcfg, tcfg, seed=2)
    toks = _tokens(jcfg.vocab, 2, 10, seed=3)
    chunked, _ = _serve_both(jcfg, tcfg, jparams, tparams, toks, max_len=4096,
                             steps=2)
    tl, tcache = TD.prefill(tcfg, tparams, torch.from_numpy(toks), max_len=4095)
    for _ in range(2):
        tl, tcache = TD.decode_step(tcfg, tparams, tcache,
                                    torch.argmax(tl, -1).to(torch.int32))
    torch.testing.assert_close(chunked, tl, atol=1e-5, rtol=1e-5)


def test_causal_mla_over_4096_keys_matches_reference():
    """A prefill-length MLA (causal, S = T = 4096) takes the chunked branch
    with the causal mask across chunks."""
    arch = "deepseek-v3-671b"
    jcfg, tcfg = jconfigs.smoke(arch), tconfigs.smoke(arch)
    jparams, tparams = _models(jcfg, tcfg, seed=4)
    jp = jax.tree.map(lambda a: a[0], jparams["dense_layers"]["attn"])
    tp = TT.layer_params(tparams["dense_layers"]["attn"], 0)
    x = (np.random.default_rng(5).standard_normal((1, 4096, jcfg.d_model))
         * 0.5).astype(np.float32)
    jy, (jc, jk) = jax.jit(JA.mla_train, static_argnums=(0, 3))(
        jcfg, jp, jnp.asarray(x), True)
    ty, (tc, tk) = TA.mla_train(tcfg, tp, torch.from_numpy(x), return_latent=True)
    _close(ty, jy)
    _close(tc, jc)
    _close(tk, jk)


def test_pallas_router_variant_matches_reference(monkeypatch):
    """deepseek-v3-smoke with 128 routed experts: under REPRO_FORCE_PALLAS=1
    the reference routes every MoE layer through its Pallas router in
    interpret mode (its gate wants E >= 128), in forward, prefill and
    decode."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    arch = "deepseek-v3-671b"
    change = lambda c: dataclasses.replace(
        c, name="deepseek-v3-smoke-e128",
        moe=dataclasses.replace(c.moe, n_routed=128))
    jcfg, tcfg = change(jconfigs.smoke(arch)), change(tconfigs.smoke(arch))
    jparams, tparams = _models(jcfg, tcfg, seed=6)
    toks = _tokens(jcfg.vocab, 2, 8, seed=7)
    jlogits, _ = JT.forward(jcfg, jparams, jnp.asarray(toks))
    tlogits, _ = TT.forward(tcfg, tparams, torch.from_numpy(toks))
    _close(tlogits, jlogits)
    _serve_both(jcfg, tcfg, jparams, tparams, toks, max_len=11, steps=3,
                jprefill=JD.prefill, jdecode=JD.decode_step)


@pytest.mark.parametrize("arch", DEEPSEEK)
def test_run_model_on_cpu_with_a_given_config(arch):
    """`run_model`'s ``cfg`` replaces the named config (as a depth-cut
    full config does on the card): here the smoke config with one more
    MoE layer."""
    deeper = lambda c: dataclasses.replace(c, n_layers=c.n_layers + 1)
    cfg = deeper(tconfigs.smoke(arch))
    out = tserve.run_model(arch, 2, 16, 4, device="cpu", cfg=cfg)
    assert tuple(out["tokens"].shape) == (2, 4)
    assert out["tokens"].dtype == torch.int32
    assert tuple(out["logits"].shape) == (2, cfg.vocab)
    assert bool(torch.isfinite(out["logits"]).all())
    count = lambda c: sum(jax.tree.leaves(jax.tree.map(
        lambda a: a.size, JT.abstract_params(c))))
    assert out["n_params"] == count(deeper(jconfigs.smoke(arch)))
    assert out["n_params"] > count(jconfigs.smoke(arch))


@pytest.mark.parametrize("arch", DEEPSEEK)
def test_entry_points_default_to_cuda(arch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_params(tconfigs.smoke(arch))
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.run_model(arch, 1, 4, 1, smoke=True)
