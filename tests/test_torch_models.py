"""The port's dense model-zoo serve path against the JAX reference on the
CPU: for each dense smoke config, the same parameters (carried across by
`params_from_numpy`) and the same tokens go through `forward`, `prefill`
(logits and cache) and six `decode_step`s of both packages. Also: the
h2o-danube ring buffer decoded past its window, a head_dim-128 config
whose JAX prefill runs the Pallas flash kernel in interpret mode, the
launcher's `run_model`, the combinations of blocks the port refuses, and
the trees of the archs and options it once refused (whisper's enc-dec,
qwen2-vl's M-RoPE and frontend; their serve paths:
tests/test_torch_encdec_vlm.py).

fp32 is held at 1e-4 * (1 + |want|): the same fp32 math on both sides,
with only the order of summation differing."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode as JD
from repro.models import transformer as JT
from repro.models.config import ArchConfig as JArchConfig
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import decode as TD
from repro_torch.models import transformer as TT
from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig

jax.config.update("jax_platform_name", "cpu")

DENSE = ["qwen3-14b", "granite-8b", "internlm2-20b", "h2o-danube-1.8b"]
# rwkv6 and recurrentgemma: tests/test_torch_recurrent_models.py; the
# DeepSeek pair: tests/test_torch_moe_models.py; whisper and qwen2-vl:
# tests/test_torch_encdec_vlm.py. The last two were refused as a later
# slice once; `test_later_slice_archs_raise` keeps their cases.
LATER = ["whisper-tiny", "qwen2-vl-2b"]
TOL = 1e-4
# the narrow head_dim-128 config on which the JAX prefill reaches the
# Pallas flash kernel (prompt >= 128 and head_dim % 128 == 0)
NARROW = dict(name="narrow-d128", family="dense", n_layers=2, d_model=256,
              n_heads=4, n_kv_heads=2, d_head=128, d_ff=512, vocab=512,
              dtype="float32")


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


@pytest.mark.parametrize("arch", DENSE)
def test_configs_are_the_references(arch):
    for jc, tc in ((jconfigs.get(arch), tconfigs.get(arch)),
                   (jconfigs.smoke(arch), tconfigs.smoke(arch))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert tc.param_dtype == getattr(torch, jc.dtype)
        assert tc.n_params() == jc.n_params()
        assert tc.n_active_params() == jc.n_active_params()
        assert tc.layer_kinds() == jc.layer_kinds() and tc.head_dim == jc.head_dim


@pytest.mark.parametrize("arch", DENSE)
def test_serve_path_matches_reference(arch):
    jcfg, tcfg = jconfigs.smoke(arch), tconfigs.smoke(arch)
    jparams, tparams = _models(jcfg, tcfg)
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
    assert set(tcache) == set(jcache)
    for key in ("k", "v"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        _close(tcache[key], jcache[key])
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
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])


def test_sliding_window_ring_buffer_decode():
    """Prefill past h2o-danube's window of 16, then decode: the ring cache
    must give the full forward's last logits (which apply the same window
    mask), and the reference's decode logits and cache."""
    jcfg, tcfg = jconfigs.smoke("h2o-danube-1.8b"), tconfigs.smoke("h2o-danube-1.8b")
    jparams, tparams = _models(jcfg, tcfg)
    total = 40
    toks = _tokens(jcfg.vocab, 1, total, seed=2)
    tt = torch.from_numpy(toks)
    logits, _ = TT.forward(tcfg, tparams, tt)
    _, tcache = TD.prefill(tcfg, tparams, tt[:, :-1], max_len=total + 8)
    assert tcache["k"].shape[2] == tcfg.sliding_window
    lg, tcache = TD.decode_step(tcfg, tparams, tcache, tt[:, -1])
    torch.testing.assert_close(lg, logits[:, -1], atol=3e-3, rtol=3e-3)

    _, jcache = _jprefill(jcfg, jparams, jnp.asarray(toks[:, :-1]), max_len=total + 8)
    jl, jcache = _jdecode(jcfg, jparams, jcache, jnp.asarray(toks[:, -1]))
    _close(lg, jl)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])


def test_prefill_matches_pallas_flash_kernel(monkeypatch):
    """With REPRO_FORCE_PALLAS=1 the reference's prefill runs the Pallas
    flash kernel (interpret mode) in every layer at head_dim 128."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    jcfg, tcfg = JArchConfig(**NARROW), ArchConfig(**NARROW)
    jparams, tparams = _models(jcfg, tcfg, seed=3)
    toks = _tokens(jcfg.vocab, 2, 128, seed=4)
    jl, jcache = JD.prefill(jcfg, jparams, jnp.asarray(toks), max_len=136)
    tl, tcache = TD.prefill(tcfg, tparams, torch.from_numpy(toks), max_len=136)
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])


def test_run_model_on_cpu():
    out = tserve.run_model("qwen3-14b", 2, 16, 4, smoke=True, device="cpu")
    assert tuple(out["tokens"].shape) == (2, 4)
    assert out["tokens"].dtype == torch.int32
    vocab = tconfigs.smoke("qwen3-14b").vocab
    assert tuple(out["logits"].shape) == (2, vocab)
    assert bool(torch.isfinite(out["logits"]).all())
    assert out["prefill_ms"] > 0 and out["tok_per_s"] > 0


def test_init_params_draws_the_reference_distribution():
    cfg = tconfigs.smoke("granite-8b")
    p = TT.init_params(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(1))
    wq = p["layers"]["attn"]["wq"]
    assert tuple(wq.shape) == (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.head_dim)
    assert wq.dtype == cfg.param_dtype
    scaled = wq * cfg.d_model ** 0.5
    assert float(scaled.abs().max()) <= 2.0
    assert abs(float(scaled.std()) - 0.88) < 0.05   # std of N(0,1) cut at +-2
    assert not torch.equal(wq[0], wq[1])
    torch.testing.assert_close(p["layers"]["ln1"]["scale"],
                               torch.ones(cfg.n_layers, cfg.d_model))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_params(tconfigs.smoke("qwen3-14b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.run_model("qwen3-14b", 1, 4, 1, smoke=True)


def _leaf_shapes(tree):
    """(key path, shape, dtype) of each leaf, in the reference's order."""
    return [(jax.tree_util.keystr(path), tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for path, a in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("arch", LATER)
def test_later_slice_archs_raise(arch):
    """The archs a later slice brought (refused until it came): `get` and
    `smoke` load, and `init_params` on the meta device and on the CPU
    matches ``jax.eval_shape`` of the reference's, leaf for leaf."""
    for jc, tc in ((jconfigs.get(arch), tconfigs.get(arch)),
                   (jconfigs.smoke(arch), tconfigs.smoke(arch))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert _leaf_shapes(TT.abstract_params(tc)) == _leaf_shapes(JT.abstract_params(jc))
    jc, tc = jconfigs.smoke(arch), tconfigs.smoke(arch)
    drawn = TT.init_params(tc, device="cpu", generator=torch.Generator().manual_seed(2))
    assert _leaf_shapes(drawn) == _leaf_shapes(JT.abstract_params(jc))


@pytest.mark.parametrize("change", [
    dict(moe=MoEConfig()), dict(mla=MLAConfig()),
    # the combinations of blocks no config has still refuse
    dict(recurrent="rwkv6", moe=MoEConfig()),
    dict(recurrent="rglru", pattern_period=3, n_enc_layers=2),
    # refused until their slice came: they build as the reference does
    dict(n_enc_layers=2), dict(mrope_sections=(2, 3, 3)), dict(frontend="vision"),
])
def test_later_slice_configs_raise(change):
    """A combination of blocks that no config has raises "later slice";
    enc-dec, M-RoPE and a frontend stub, once refused the same way, now
    build with the reference's leaf shapes (params and cache)."""
    cfg = dataclasses.replace(tconfigs.smoke("qwen3-14b"), **change)
    if "moe" in change or "mla" in change or "recurrent" in change:
        with pytest.raises(NotImplementedError, match="later slice"):
            TT.init_params(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match="later slice"):
            TD.init_cache(cfg, 1, 8)
        return
    jcfg = dataclasses.replace(jconfigs.smoke("qwen3-14b"), **change)
    drawn = TT.init_params(cfg, device="cpu")
    assert _leaf_shapes(drawn) == _leaf_shapes(JT.abstract_params(jcfg))
    assert _leaf_shapes(TD.init_cache(cfg, 1, 8)) == _leaf_shapes(
        jax.eval_shape(lambda: JD.init_cache(jcfg, 1, 8)))
