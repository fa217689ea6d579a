"""The mesh trainer: one `train_step` on DTensor state placed by
`launch.sharding` (`state_specs`, `batch_specs`, `place`) on 2 and on 4
gloo ranks on the CPU, against the port's one-process `train_step` and the
JAX reference's compiled `train_step` on the same numpy state and batch.

The ranks (`torch_ranks.train_worker`, one launch per world size for
every config, no JAX imported) each hold their shards; rank 0 hands back
the whole new state. Configs: the smoke configs of granite-8b,
recurrentgemma-9b (both scans' families: the RG-LRU here), rwkv6-3b (the
WKV), whisper-tiny (enc-dec) and deepseek-v2 (MoE with its experts
sharded over "model", MLA). Meshes ("data", "model"): (2, 1) with FSDP,
(1, 2) tensor- and expert-parallel, (2, 2) with both.

The references take the batch as it is: the mesh trainer regroups a
row-sharded batch (one all-to-all) so that its microbatch i holds the
reference's rows i * mb to (i + 1) * mb (a MoE layer's aux loss and
capacity are per microbatch, so DeepSeek's (2, 2) mesh checks that).

Tolerances, fp32 on every side (the order of summation differs: partial
sums over ranks, the global norm's partial sums in mesh order): loss and
grad norm within 1e-5 relative; each moment within 1e-4 of its leaf's
largest magnitude plus 1e-5 relative, each parameter by its update
within what the two sides' own moments allow, and the step bit for bit
(tests/test_torch_train_step.py's `_state_close`). On each mesh each
config's parameters must really be split: its largest leaf's shard on
rank 0 smaller than the whole, and rank 0 holding at most 3/4 of all
the parameters' elements."""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as R
from repro_torch.data import pipeline as tpipe
from repro_torch.training import train_step as TTS
from repro_torch.training import tree as tr
from test_torch_train_step import LR, _jstate, _jtrain_step, _pair, _state_close, _tstate

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["granite-8b", "recurrentgemma-9b", "rwkv6-3b", "whisper-tiny", "deepseek-v2-236b"]
B, S, N_MICRO = 4, 16, 2
# world -> [(mesh shape, fsdp)]
MESHES = {2: [((2, 1), True), ((1, 2), False)], 4: [((2, 2), True)]}
CASES = [(arch, world, i) for world in MESHES for i in range(len(MESHES[world]))
         for arch in ARCHS]
LOSS_RTOL = 1e-5


def _batch(tcfg):
    return {k: v.numpy() for k, v in
            tpipe.batch_for_step(tcfg, 0, B, S, device="cpu").items()}


def _np_state(jstate):
    return jax.tree.map(np.asarray, jstate)


@pytest.fixture(scope="module")
def runs():
    """Both worlds' ranks started at once; the references computed while
    they run. Returns ({(arch, world, i): (rank 0's result, sizes)},
    {arch: (one-process port state, metrics, JAX state, metrics, the
    state they started from)})."""
    tmp = tempfile.mkdtemp(prefix="train_ranks_")
    started = {}
    for world, meshes in MESHES.items():
        cases = [(_pair(arch)[1], shape, fsdp, _np_state(_jstate(_pair(arch)[1])),
                  _batch(_pair(arch)[1]), N_MICRO, LR)
                 for shape, fsdp in meshes for arch in ARCHS]
        started[world] = R.Ranks(R.train_worker, world, os.path.join(tmp, f"store{world}"),
                                 cases)
    refs = {}
    for arch in ARCHS:
        jcfg, tcfg = _pair(arch)
        batch = _batch(tcfg)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jstate = _jstate(tcfg)
        tstate = _tstate(tcfg, jstate)
        t_new, tm = TTS.train_step(tcfg, tstate, tb, n_micro=N_MICRO, lr=LR)
        j_new, jm = _jtrain_step(jcfg, jstate, jb, n_micro=N_MICRO, lr=LR)
        refs[arch] = (t_new, tm, j_new, jm, tstate, jstate)
    results = {}
    for world, ranks in started.items():
        per_case = ranks.results()[0]
        for (shape_i, _), (arch_i, arch) in ((m, a) for m in enumerate(MESHES[world])
                                             for a in enumerate(ARCHS)):
            results[arch, world, shape_i] = per_case[shape_i * len(ARCHS) + arch_i]
    return results, refs


@pytest.mark.parametrize("arch,world,mesh_i", CASES)
def test_mesh_step_matches_one_process_and_reference(runs, arch, world, mesh_i):
    results, refs = runs
    (shape, fsdp) = MESHES[world][mesh_i]
    (state_np, metrics), sizes = results[arch, world, mesh_i]
    _, tcfg = _pair(arch)
    got = TTS.train_state_from_numpy(tcfg, state_np, "cpu")
    t_new, tm, j_new, jm, t_old, j_old = refs[arch]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(tm[key]), rtol=LOSS_RTOL,
                                   err_msg=f"{key} vs one process")
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]), rtol=LOSS_RTOL,
                                   err_msg=f"{key} vs reference")
    _state_close(got, tr.tree_map(lambda t: t.numpy(), t_new), t_old,
                 tr.tree_map(lambda t: t.numpy(), t_old))
    _state_close(got, j_new, t_old, j_old)
    # the parameters are split across the ranks: the largest leaf, and
    # rank 0 holds at most 3/4 of all the elements
    largest = max(sizes, key=lambda s: s[1])
    assert largest[0] < largest[1], (shape, fsdp, largest)
    local, whole = (sum(s[i] for s in sizes) for i in (0, 1))
    assert local <= 0.75 * whole, (shape, fsdp, local, whole)
