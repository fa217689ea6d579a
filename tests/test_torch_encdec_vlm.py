"""The port's encoder-decoder (whisper) and M-RoPE (qwen2-vl) models
against the JAX reference on the CPU: for whisper-smoke and
qwen2-vl-smoke, the same parameters and the same inputs (the frontend
stubs' embeddings, numpy-seeded) go through `forward`, `prefill` (logits
and every cache leaf) and six `decode_step`s of both packages. Also:
whisper decoded past a short learned-position table (the reference's
clamp), `apply_mrope` with three distinct position streams, `gqa_decode`'s
ring and linear caches, `gqa_train` as cross-attention and unmasked, the
launcher's `run_model` and `draw_inputs`, and a narrow enc-dec config
whose JAX prefill runs the Pallas flash kernel in interpret mode.

Both packages start from the same weights: the port's, drawn from a seed,
handed to the reference as numpy arrays; `params_from_numpy` carries a
tree back. fp32 is held at 1e-4 * (1 + |want|): the same fp32 math on
both sides, with only the order of summation differing."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import decode as JD
from repro.models import transformer as JT
from repro.models.config import ArchConfig as JArchConfig
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import decode as TD
from repro_torch.models import transformer as TT
from repro_torch.models.config import ArchConfig
from repro_torch.training import tree as tr

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["whisper-tiny", "qwen2-vl-2b"]
TOL = 1e-4
# a narrow enc-dec config at which the JAX prefill reaches its Pallas flash
# kernel in every attention (queries >= 128, head_dim % 128 == 0)
NARROW_ENCDEC = dict(name="narrow-encdec", family="encdec", n_layers=1, n_enc_layers=1,
                     enc_seq=128, d_model=256, n_heads=2, n_kv_heads=2, d_head=128,
                     d_ff=512, vocab=512, norm="layernorm", act="gelu",
                     tie_embeddings=True, frontend="audio", dec_pos_len=256,
                     dtype="float32")

# the reference's serve path, compiled once per config and shape
_jforward = jax.jit(JT.forward, static_argnums=0)
_jprefill = jax.jit(JD.prefill, static_argnums=0, static_argnames="max_len")
_jdecode = jax.jit(JD.decode_step, static_argnums=0)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _models(jcfg, tcfg, seed=0):
    """(the reference's params, the port's): the port's seeded weights,
    handed to the reference as numpy arrays and carried back across by
    `params_from_numpy`."""
    drawn = TT.init_params(tcfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    as_np = tr.tree_map(lambda t: t.numpy(), drawn)
    return jax.tree.map(jnp.asarray, as_np), TT.params_from_numpy(tcfg, as_np, "cpu")


def _inputs(cfg, b, s, seed):
    """The serve path's inputs as numpy arrays: decoder tokens, or for a
    frontend model its ``input_embeds``; for an enc-dec its ``enc_embeds``
    too."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend and not cfg.is_encdec:
        out["input_embeds"] = rng.standard_normal((b, s, cfg.d_model), np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.is_encdec:
        out["enc_embeds"] = rng.standard_normal((b, cfg.enc_seq, cfg.d_model), np.float32)
    return out


def _cache_close(tcache, jcache):
    assert set(tcache) == set(jcache)
    for key in jcache:
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        assert tcache[key].dtype == getattr(torch, str(jcache[key].dtype)), key
        if key == "length":
            assert int(tcache[key]) == int(jcache[key])
        else:
            _close(tcache[key], jcache[key])


def _serve_both(jcfg, tcfg, jparams, tparams, inputs, max_len, steps):
    """Prefill and ``steps`` greedy decode steps in both packages; every
    step's logits, the greedy tokens and the caches must agree."""
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    jl, jcache = _jprefill(jcfg, jparams, max_len=max_len, **jin)
    tl, tcache = TD.prefill(tcfg, tparams, max_len=max_len, **tin)
    _close(tl, jl)
    _cache_close(tcache, jcache)
    assert tcache["length"].dtype == torch.int32 and tcache["length"].dim() == 0
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
    _cache_close(tcache, jcache)
    return tcache


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    for jc, tc in ((jconfigs.get(arch), tconfigs.get(arch)),
                   (jconfigs.smoke(arch), tconfigs.smoke(arch))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert tc.param_dtype == getattr(torch, jc.dtype)
        assert tc.n_params() == jc.n_params()
        assert tc.is_encdec == jc.is_encdec and tc.head_dim == jc.head_dim


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_path_matches_reference(arch):
    jcfg, tcfg = jconfigs.smoke(arch), tconfigs.smoke(arch)
    jparams, tparams = _models(jcfg, tcfg, seed=len(arch))
    b, s, steps = 2, 12, 6
    inputs = _inputs(jcfg, b, s, seed=len(arch))

    jlogits, _ = _jforward(jcfg, jparams, **{k: jnp.asarray(v) for k, v in inputs.items()})
    tlogits, aux = TT.forward(tcfg, tparams,
                              **{k: torch.from_numpy(v) for k, v in inputs.items()})
    _close(tlogits, jlogits)
    assert float(aux) == 0.0
    tcache = _serve_both(jcfg, tcfg, jparams, tparams, inputs, s + steps, steps)
    assert int(tcache["length"]) == s + steps


def test_decode_past_a_short_position_table():
    """whisper-smoke with dec_pos_len 8, a prompt of 4 and 8 decode steps:
    from slot 8 on, the decode step reads the table's last row, as the
    reference's dynamic_slice clamps."""
    jcfg = dataclasses.replace(jconfigs.smoke("whisper-tiny"), dec_pos_len=8)
    tcfg = dataclasses.replace(tconfigs.smoke("whisper-tiny"), dec_pos_len=8)
    jparams, tparams = _models(jcfg, tcfg, seed=5)
    tcache = _serve_both(jcfg, tcfg, jparams, tparams, _inputs(jcfg, 2, 4, seed=6), 12, 8)
    assert int(tcache["length"]) == 12


@pytest.mark.parametrize("dh,sections,theta", [
    (128, (16, 24, 24), 1e6),      # qwen2-vl-2b's
    (16, (2, 3, 3), 1e6),          # qwen2-vl-smoke's
    (16, (2, 2, 2), 1e4),          # two slots past the sections: stream 0
])
def test_apply_mrope_with_distinct_streams(dh, sections, theta):
    """Three different (t, h, w) position streams: the model path never
    makes them (text positions are equal), so M-RoPE is held here."""
    rng = np.random.default_rng(dh + len(sections))
    x = rng.standard_normal((2, 9, 3, dh), np.float32)
    pos = rng.integers(0, 4096, (2, 9, 3)).astype(np.int32)
    want = JC.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, theta)
    got = TC.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), sections, theta)
    _close(got, want)
    # the streams matter: the first section follows t, the others h and w
    moved = pos.copy()
    moved[..., 1] += 1
    got2 = TC.apply_mrope(torch.from_numpy(x), torch.from_numpy(moved), sections, theta)
    first = torch.arange(dh // 2) < sections[0]
    lanes = torch.cat([first, first])
    assert torch.equal(got2[..., lanes], got[..., lanes])
    assert not torch.equal(got2[..., ~lanes], got[..., ~lanes])


def test_mrope_on_text_positions_is_rope():
    """t = h = w: M-RoPE gives RoPE's values, bit for bit."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 7, 4, 128), np.float32))
    pos = torch.arange(7, dtype=torch.int32)[None].expand(2, 7)
    got = TC.apply_mrope(x, pos[..., None].expand(2, 7, 3), (16, 24, 24), 1e6)
    assert torch.equal(got, TC.apply_rope(x, pos, 1e6))


@pytest.mark.parametrize("branch,arch", [("ring", "qwen3-14b"), ("linear", "qwen3-14b"),
                                         ("ring", "qwen2-vl-2b"), ("linear", "qwen2-vl-2b")])
def test_gqa_decode_matches_reference(branch, arch):
    """`gqa_decode` step by step against the reference's: a ring of 4
    slots in a cache of 8 run for 10 steps, or a linear cache of 8 run
    for 6 (qk-norm with RoPE, or M-RoPE)."""
    jcfg, tcfg = jconfigs.smoke(arch), tconfigs.smoke(arch)
    jparams, tparams = _models(jcfg, tcfg, seed=7)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    tp = TT.layer_params(tparams["layers"], 0)["attn"]
    window, steps = (4, 10) if branch == "ring" else (0, 6)
    b, s_max, kv, dh = 2, 8, tcfg.n_kv_heads, tcfg.head_dim
    zeros = np.zeros((b, s_max, kv, dh), np.float32)
    jcache = JA.KVCache(jnp.asarray(zeros), jnp.asarray(zeros), jnp.int32(0))
    tcache = TA.KVCache(torch.zeros(b, s_max, kv, dh), torch.zeros(b, s_max, kv, dh),
                        torch.zeros((), dtype=torch.int32))
    step = jax.jit(lambda p, x, c: JA.gqa_decode(jcfg, p, x, c, window=window))
    rng = np.random.default_rng(8)
    for i in range(steps):
        x = rng.standard_normal((b, 1, tcfg.d_model), np.float32)
        jy, jcache = step(jp, jnp.asarray(x), jcache)
        ty, tcache = TA.gqa_decode(tcfg, tp, torch.from_numpy(x), tcache, window=window)
        _close(ty, jy)
        _close(tcache.k, jcache.k)
        _close(tcache.v, jcache.v)
        assert tcache.length.dtype == torch.int32
        assert int(tcache.length) == int(jcache.length) == i + 1


@pytest.mark.parametrize("case", ["cross", "cross_causal_flag", "self_unmasked",
                                  "self_without_rope"])
def test_gqa_train_options_match_reference(case):
    """`gqa_train` as cross-attention (12 queries over 37 keys from
    ``kv_source``: no RoPE, no mask, whatever ``causal`` says), and as
    self-attention unmasked or without RoPE."""
    jcfg, tcfg = jconfigs.smoke("whisper-tiny"), tconfigs.smoke("whisper-tiny")
    jparams, tparams = _models(jcfg, tcfg, seed=9)
    jp = jax.tree.map(lambda a: a[1], jparams["dec_layers"]["xattn"])
    tp = TT.layer_params(tparams["dec_layers"], 1)["xattn"]
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 12, tcfg.d_model), np.float32)
    src = rng.standard_normal((2, 37, tcfg.d_model), np.float32)
    kw = {"cross": dict(kv_source=src, causal=False),
          "cross_causal_flag": dict(kv_source=src),
          "self_unmasked": dict(causal=False),
          "self_without_rope": dict(use_rope=False)}[case]
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    jy, (jk, jv) = JA.gqa_train(jcfg, jp, jnp.asarray(x), return_kv=True, **jkw)
    ty, (tk, tv) = TA.gqa_train(tcfg, tp, torch.from_numpy(x), return_kv=True, **tkw)
    _close(ty, jy)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_model_on_cpu(arch):
    out = tserve.run_model(arch, 2, 6, 4, smoke=True, device="cpu")
    assert tuple(out["tokens"].shape) == (2, 4)
    assert out["tokens"].dtype == torch.int32
    assert tuple(out["logits"].shape) == (2, tconfigs.smoke(arch).vocab)
    assert bool(torch.isfinite(out["logits"]).all())
    sizes = jax.tree.leaves(jax.tree.map(lambda a: a.size, JT.abstract_params(
        jconfigs.smoke(arch))))
    assert out["n_params"] == sum(sizes)
    again = tserve.run_model(arch, 2, 6, 4, smoke=True, device="cpu")
    assert torch.equal(again["tokens"], out["tokens"])
    assert torch.equal(again["logits"], out["logits"])


@pytest.mark.parametrize("arch", ARCHS + ["qwen3-14b"])
def test_draw_inputs_as_the_reference_launcher(arch):
    """`draw_inputs` gives the inputs the reference's launcher gives
    `prefill` (`src/repro/launch/serve.py`): tokens, or a frontend's
    embeddings in their place, and an encoder-decoder's encoder input, at
    the same shapes and dtypes; the same seed draws the same values, and
    each input its own stream."""
    jcfg, tcfg = jconfigs.smoke(arch), tconfigs.smoke(arch)
    want = {}
    if jcfg.frontend and not jcfg.is_encdec:
        want["input_embeds"] = ((2, 5, jcfg.d_model), torch.float32)
    else:
        want["tokens"] = ((2, 5), torch.int64)
    if jcfg.is_encdec:
        want["enc_embeds"] = ((2, jcfg.enc_seq, jcfg.d_model), torch.float32)
    got = tserve.draw_inputs(tcfg, 2, 5, 0, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == want
    if "tokens" in got:
        assert int(got["tokens"].min()) >= 0 and int(got["tokens"].max()) < tcfg.vocab
    again = tserve.draw_inputs(tcfg, 2, 5, 0, "cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)
    other = tserve.draw_inputs(tcfg, 2, 5, 1, "cpu")
    assert all(not torch.equal(got[k], other[k]) for k in got)


def test_encdec_prefill_matches_pallas_flash_kernel(monkeypatch):
    """With REPRO_FORCE_PALLAS=1 the reference's enc-dec prefill runs the
    Pallas flash kernel (interpret mode) in the encoder, the decoder's
    self-attention and the cross-attention, at head_dim 128. ``enc_seq``
    is 128 because the Pallas kernel leaves padded key columns unmasked
    (a key length off its 128-key blocks gives NaN in interpret mode);
    whisper's ragged 1500 keys are checked against the plain version on
    the card (chip_smoke.py's flash checks)."""
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    jcfg, tcfg = JArchConfig(**NARROW_ENCDEC), ArchConfig(**NARROW_ENCDEC)
    jparams, tparams = _models(jcfg, tcfg, seed=11)
    inputs = _inputs(jcfg, 1, 128, seed=12)
    jl, jcache = JD.prefill(jcfg, jparams, max_len=136,
                            **{k: jnp.asarray(v) for k, v in inputs.items()})
    tl, tcache = TD.prefill(tcfg, tparams, max_len=136,
                            **{k: torch.from_numpy(v) for k, v in inputs.items()})
    _close(tl, jl)
    _cache_close(tcache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_default_to_cuda(arch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_params(tconfigs.smoke(arch))
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.run_model(arch, 1, 4, 1, smoke=True)
