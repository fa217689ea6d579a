"""The port's training substrate against the JAX reference on the CPU: the
AdamW update and `global_norm`, gradient compression, checkpoints across
the two packages, the data pipeline, `abstract_params` / `abstract_state`,
the launcher's restart, and the plain attention gradient.

- optimizer: three `update`s with clipping engaged against the
  reference's compiled update, within 1e-6 relative (fp32; the moments'
  products may contract into an FMA on one side);
- compression: codes and scales bit-equal, residuals within one ulp of
  the target (the reference runs it eagerly: true divisions);
- checkpoints: the reference's files restored by the port and the port's
  by the reference, bit for bit; bf16 leaves as their raw 16 bits;
- pipeline: every batch bit-equal;
- `ref.attention_bwd` against ``jax.vjp`` of `repro.kernels.ref.attention`
  over the mask sweep, within 1e-5 * (1 + |want|) (fp32 in both)."""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.kernels import ref as jref
from repro.models import transformer as JT
from repro.training import checkpoint as jckpt
from repro.training import compression as JC
from repro.training import optimizer as JOPT
from repro.training import train_step as JTS
from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ref as tref
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as TT
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import compression as TC
from repro_torch.training import optimizer as TOPT
from repro_torch.training import train_step as TTS
from repro_torch.training import tree as tr

jax.config.update("jax_platform_name", "cpu")


def _tree(seed, shapes=None):
    """A small params-like tree of fp32 numpy arrays (nested dicts; keys
    not in sorted order, so the leaf order matters)."""
    rng = np.random.default_rng(seed)
    shapes = shapes or {"w": (7, 5), "b": (5,), "layers": {"z": (3, 4, 2), "a": (9,)}}

    def make(node):
        return ({k: make(v) for k, v in node.items()} if isinstance(node, dict)
                else rng.standard_normal(node).astype(np.float32))
    return make(shapes)


def _to_torch(tree):
    return tr.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_tree_order_is_jax_order():
    tree = {"b": np.zeros(1), "a": {"d": np.ones(2), "c": np.full(3, 2.0)},
            "e": (np.zeros(4), np.zeros(5))}
    assert [x.shape for x in tr.leaves(tree)] == [x.shape for x in jax.tree.leaves(tree)]
    flat, treedef = tr.flatten(tree)
    assert tr.leaves(tr.unflatten(treedef, flat)) == flat


def test_global_norm_matches_reference():
    tree = _tree(0)
    want = float(JOPT.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = TOPT.global_norm(_to_torch(tree))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_update_matches_reference_over_three_steps_with_clipping():
    params = _tree(1)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js, ts = JOPT.init(jp), TOPT.init(tp)
    jupdate = jax.jit(JOPT.update, static_argnames=("lr", "warmup"))
    for step in range(3):
        grads = tr.tree_map(lambda a: a * 50.0, _tree(10 + step))   # norm >> 1: clipped
        jp, js, jn = jupdate(jp, jax.tree.map(jnp.asarray, grads), js, lr=0.01, warmup=3)
        tp, ts, tn = TOPT.update(tp, _to_torch(grads), ts, lr=0.01, warmup=3)
        assert float(jn) > 1.0
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert int(ts.step) == int(js.step) == step + 1
        for got, want in zip(tr.leaves((tp, ts.m, ts.v)), jax.tree.leaves((jp, js.m, js.v))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)


def test_update_keeps_bf16_params_bf16():
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    new, state, _ = TOPT.update(p, {"w": torch.full((4, 4), 1e6)}, TOPT.init(p), lr=0.1)
    assert new["w"].dtype == torch.bfloat16 and state.m["w"].dtype == torch.float32
    assert float((new["w"].float() - 1).abs().max()) < 0.5      # clipped


def test_compression_codes_bit_equal_to_reference():
    """Three error-feedback rounds over a tree with a leaf of one block, a
    ragged last block and an all-zero leaf: codes and scales bit for bit,
    residuals and the decompressed gradients within an ulp."""
    shapes = {"w": (300, 3), "b": (256,), "z": (10,)}
    jef = JC.init(jax.tree.map(jnp.asarray, _tree(2, shapes)))
    tef = TC.init(_to_torch(_tree(2, shapes)))
    for step in range(3):
        grads = _tree(20 + step, shapes)
        grads["z"][:] = 0.0
        jcomp, jef = JC.compress(jax.tree.map(jnp.asarray, grads), jef)
        tcomp, tef = TC.compress(_to_torch(grads), tef)
        for key in shapes:
            (jcodes, jscale), (tcodes, tscale) = jcomp[key], tcomp[key]
            assert tcodes.dtype == torch.int8 and tscale.dtype == torch.float32
            np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
            np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))
            np.testing.assert_allclose(tef.residual[key].numpy(),
                                       np.asarray(jef.residual[key]), rtol=0, atol=1e-6)
        jback = JC.decompress(jcomp, jax.tree.map(jnp.asarray, grads))
        tback = TC.decompress(tcomp, _to_torch(grads))
        for key in shapes:
            np.testing.assert_array_equal(tback[key].numpy(), np.asarray(jback[key]))


def _ref_state(jcfg):
    return JTS.init_state(jcfg, jax.random.key(0))


def _bf16(arch):
    return (dataclasses.replace(jconfigs.smoke(arch), dtype="bfloat16"),
            dataclasses.replace(tconfigs.smoke(arch), dtype="bfloat16"))


def _leaves_equal(tstate, jstate):
    t_flat, j_flat = tr.leaves(tstate), jax.tree.leaves(jstate)
    assert len(t_flat) == len(j_flat)
    for t, j in zip(t_flat, j_flat):
        j = np.asarray(j)
        if t.dtype == torch.bfloat16:
            assert j.dtype == ml_dtypes.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), j.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_restores_reference_checkpoint(tmp_path, dtype):
    jcfg, tcfg = ((jconfigs.smoke("qwen3-14b"), tconfigs.smoke("qwen3-14b"))
                  if dtype == "float32" else _bf16("qwen3-14b"))
    jstate = _ref_state(jcfg)
    jckpt.save(tmp_path, jstate, 7)
    like = TTS.init_state(tcfg, TT.init_params(tcfg, device="cpu"))
    restored, step = tckpt.restore(tmp_path, like)
    assert step == 7
    _leaves_equal(restored, jstate)


def test_reference_restores_port_checkpoint_fp32(tmp_path):
    jcfg, tcfg = jconfigs.smoke("granite-8b"), tconfigs.smoke("granite-8b")
    jstate = _ref_state(jcfg)
    tstate = TTS.train_state_from_numpy(tcfg, jax.tree.map(np.asarray, jstate), "cpu")
    tstate, _ = TTS.train_step(tcfg, tstate, tpipe.batch_for_step(tcfg, 0, 2, 8, device="cpu"))
    tckpt.save(tmp_path, tstate, 4, extra={"arch": "granite-8b"})
    manifest = json.loads((tmp_path / "slot0" / "manifest.json").read_text())
    assert manifest == {"step": 4, "n_leaves": len(jax.tree.leaves(jstate)),
                        "extra": {"arch": "granite-8b"}}
    restored, step = jckpt.restore(tmp_path, jstate)
    assert step == 4
    _leaves_equal(tstate, restored)


def test_port_bf16_checkpoint_holds_the_references_bytes(tmp_path):
    """The reverse direction in bf16: the port's file holds, leaf for leaf,
    the dtype (``|V2``) and bits the reference's own save writes, so a
    reader of one reads the other. (The reference's `restore` cannot cast a
    ``|V2`` leaf back, from its own files as from the port's: queue 3.)"""
    jcfg, tcfg = _bf16("granite-8b")
    jstate = _ref_state(jcfg)
    tstate = TTS.train_state_from_numpy(tcfg, jax.tree.map(np.asarray, jstate), "cpu")
    jckpt.save(tmp_path / "ref", jstate, 3)
    tckpt.save(tmp_path / "port", tstate, 3)
    with np.load(tmp_path / "ref/slot1/shard0.npz") as want, \
            np.load(tmp_path / "port/slot1/shard0.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        kinds = set()
        for name in want.files:
            assert got[name].dtype == want[name].dtype, name
            assert got[name].tobytes() == want[name].tobytes(), name
            kinds.add(want[name].dtype.str)
    assert "|V2" in kinds
    for path in ("ref", "port"):
        with pytest.raises(ValueError, match="cast"):
            jckpt.restore(tmp_path / path, jstate)


def test_two_slot_rotation_survives_partial_write(tmp_path):
    tcfg = tconfigs.smoke("granite-8b")
    state = TTS.init_state(tcfg, TT.init_params(tcfg, device="cpu"))
    tckpt.save(tmp_path, state, 4)
    tckpt.save(tmp_path, state, 5)
    (tmp_path / "slot0" / "manifest.json").unlink()   # a crash mid-write of slot0
    got = tckpt.restore(tmp_path, state)
    assert got is not None and got[1] == 5
    assert tckpt.latest_step(tmp_path / "none") is None
    assert tckpt.restore(tmp_path / "none", state) is None


@pytest.mark.parametrize("saved,crashed,want", [((9,), 19, None), ((4, 5), 6, 5)],
                         ids=["same-slot", "other-slot"])
def test_crash_between_the_replaces_never_mislabels_a_slot(tmp_path, monkeypatch,
                                                           saved, crashed, want):
    """A save that dies after its leaves land and before its manifest does
    (the module's ``os.replace`` raising on the manifest's) leaves its
    slot incomplete: `restore` gives the newest complete slot with its own
    leaves, or None; never a step whose manifest names other leaves."""
    tcfg = tconfigs.smoke("granite-8b")
    params = TT.init_params(tcfg, device="cpu")
    state_at = lambda step: TTS.init_state(tcfg, tr.tree_map(lambda t: t + step, params))
    for step in saved:
        tckpt.save(tmp_path, state_at(step), step)
    real = tckpt.os.replace

    def replace(src, dst):
        if Path(dst).name == "manifest.json":
            raise OSError("crash before the manifest's replace")
        real(src, dst)

    monkeypatch.setattr(tckpt.os, "replace", replace)
    with pytest.raises(OSError, match="crash"):
        tckpt.save(tmp_path, state_at(crashed), crashed)
    monkeypatch.setattr(tckpt.os, "replace", real)
    assert tckpt.latest_step(tmp_path) == want
    got = tckpt.restore(tmp_path, state_at(0))
    if want is None:
        assert got is None
        return
    restored, step = got
    assert step == want
    for a, b in zip(tr.leaves(restored), tr.leaves(state_at(want))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", list(tconfigs.PORTED) + ["vision", "encdec"])
def test_batch_for_step_bit_equal(arch):
    """Every ported arch, and a frontend and an enc-dec variant (the
    stubs' embeddings), at several (seed, step) pairs."""
    if arch in ("vision", "encdec"):
        extra = (dict(frontend="vision") if arch == "vision"
                 else dict(n_enc_layers=2, enc_seq=24))
        jcfg = dataclasses.replace(jconfigs.smoke("granite-8b"), **extra)
        tcfg = dataclasses.replace(tconfigs.smoke("granite-8b"), **extra)
    else:
        jcfg, tcfg = jconfigs.smoke(arch), tconfigs.smoke(arch)
    for seed, step in ((0, 0), (0, 5), (3, 1), (7, 123)):
        want = jpipe.batch_for_step(jcfg, step, 3, 20, seed)
        got = tpipe.batch_for_step(tcfg, step, 3, 20, seed, device="cpu")
        assert sorted(got) == sorted(want)
        for key in want:
            w = np.asarray(want[key])
            assert got[key].numpy().dtype == w.dtype, key
            np.testing.assert_array_equal(got[key].numpy(), w)
    stream = tpipe.stream(tcfg, 3, 20, seed=3, start_step=1, device="cpu")
    first = next(stream)
    np.testing.assert_array_equal(first["targets"].numpy(),
                                  np.asarray(jpipe.batch_for_step(jcfg, 1, 3, 20, 3)["targets"]))


def _shapes(tree):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", "")) for x in tr.leaves(tree)]


def _jshapes(tree):
    return [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("arch", list(tconfigs.PORTED))
def test_abstract_state_matches_eval_shape(arch):
    """The full published configs on the meta device: every leaf's shape
    and dtype, in order, as ``jax.eval_shape`` gives them."""
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    tstate = TTS.abstract_state(tcfg)
    assert all(x.device.type == "meta" for x in tr.leaves(tstate))
    assert _shapes(tstate) == _jshapes(JTS.abstract_state(jcfg))
    assert _shapes(TT.abstract_params(tcfg)) == _jshapes(JT.abstract_params(jcfg))


def test_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    args = ["--arch", "granite-8b", "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--ckpt", str(tmp_path), "--ckpt-every", "2"]
    tlaunch.main(args + ["--steps", "4"])
    first = capsys.readouterr().out.splitlines()
    assert first[0].startswith("step    0 loss=") and first[-1] == "done"
    assert tckpt.latest_step(tmp_path) == 3
    tlaunch.main(args + ["--steps", "6"])
    again = capsys.readouterr().out.splitlines()
    assert again[0] == "restored checkpoint at step 3"
    assert again[1].startswith("step    5 loss=") and again[-1] == "done"
    # the resumed step's numbers equal an uninterrupted run's
    tlaunch.main(["--arch", "granite-8b", "--smoke", "--device", "cpu", "--batch", "2",
                  "--seq", "16", "--steps", "6"])
    whole = capsys.readouterr().out.splitlines()
    assert whole[-2].split(" (")[0] == again[1].split(" (")[0]


def test_launcher_runs_on_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--arch", "granite-8b", "--smoke", "--steps", "1"])


# (b, s, t, h, kv, d, causal, window): the three masks, GQA, S < T, rows
# with no valid key (S > T), and the chunked plain form (T = 4096)
BWD_SWEEP = [(2, 16, 16, 4, 2, 8, True, 0), (1, 12, 30, 4, 1, 16, True, 0),
             (1, 20, 20, 4, 4, 8, False, 0), (2, 24, 40, 8, 2, 8, True, 9),
             (1, 30, 18, 2, 1, 8, True, 0), (1, 8, 4096, 2, 1, 8, True, 1000)]


@pytest.mark.parametrize("shape", BWD_SWEEP, ids=lambda s: "-".join(map(str, s)))
def test_attention_bwd_matches_jax_vjp(shape):
    b, s, t, h, kv, d, causal, window = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v, dout = (rng.standard_normal(sh).astype(np.float32)
                     for sh in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d), (b, s, h, d)))
    out, vjp = jax.vjp(lambda *a: jref.attention(*a, causal=causal, window=window),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tref.attention_bwd(tq, tk, tv, torch.from_numpy(np.array(out)),
                             tref.attention_stats(tq, tk, causal=causal, window=window),
                             torch.from_numpy(dout), causal=causal, window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
