"""Rank workers for the port's multi-rank CPU tests.

`Ranks` starts ``world`` processes (`torch.multiprocessing`, spawn), each
joining one gloo process group through a `FileStore` (no TCP port to
pick), runs one worker of this module on its rank and hands back what it
returned. The ranks import this module and `repro_torch` only, never JAX:
the tests hold their results against the JAX reference in the pytest
process. Payloads and results are numpy arrays, which pickle by value.
"""
from __future__ import annotations

import datetime
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_TIMEOUT_S = 120


class Ranks:
    """``worker(rank, world, payload)`` started on ``world`` gloo ranks;
    `results` waits for them. The caller may work meanwhile (the tests run
    the JAX reference while the ranks run): the payload goes through a
    queue, whose feeder thread writes it while the ranks start, so that
    starting them does not wait for each to import and read it."""

    def __init__(self, worker, world: int, store_path: str, payload):
        ctx = mp.get_context("spawn")
        self.world = world
        self.queue = ctx.Queue()
        self.inbox = inbox = ctx.Queue()   # kept: the ranks read it
        self.procs = [ctx.Process(target=_main, args=(worker, r, world, store_path,
                                                      inbox, self.queue),
                                  daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()
        for _ in range(world):
            inbox.put(payload)

    def results(self) -> list:
        """Every rank's result in rank order. Raises with the traceback of
        a rank that failed; kills every rank still running."""
        out = {}
        try:
            for _ in range(self.world):
                rank, ok, res = self.queue.get(timeout=RANK_TIMEOUT_S)
                if not ok:
                    raise RuntimeError(f"rank {rank} of {self.world} failed:\n{res}")
                out[rank] = res
        finally:
            for p in self.procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
        return [out[r] for r in range(self.world)]


def _main(worker, rank, world, store_path, inbox, queue):
    try:
        payload = inbox.get(timeout=RANK_TIMEOUT_S)
        torch.set_num_threads(1)   # the suite runs several workers at once
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        try:
            out = worker(rank, world, payload)
        finally:
            dist.destroy_process_group()
        queue.put((rank, True, out))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))


def to_numpy(tree):
    from repro_torch.serving.engine import _tree_map
    return _tree_map(lambda t: t.numpy().copy(), tree)


def to_torch(tree):
    from repro_torch.serving.engine import _tree_map
    return _tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def engine_worker(rank, world, cases):
    """Each case ``(cfg, state, arrivals, xs)``: this rank's block of the
    canonical port state through `make_sharded_step` for len(xs) steps.
    Returns, per case, the final block and every step's stats."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import engine as TE

    mesh = make_serving_mesh(world, device_type="cpu")
    out = []
    for cfg, state, arrivals, xs in cases:
        step = TE.make_sharded_step(cfg, mesh)
        block = TE.split_state(cfg, to_torch(state), rank)
        stats = []
        for x in xs:
            block, st = step(block, torch.from_numpy(arrivals), x=torch.from_numpy(x))
            stats.append({k: v.numpy() for k, v in st.items()})
        out.append((to_numpy(block), stats))
    return out


def mla_worker(rank, world, payload):
    """deepseek decode on a (1, world) ("data", "model") serve mesh: this
    rank's span of the prefill's latent cache, then one `decode_step` per
    token of ``tokens`` [steps, B]. Returns the logits of every step and
    the final cache span."""
    from repro_torch.launch import runtime
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decode
    from repro_torch.models import transformer as TT

    cfg, params, cache, tokens = payload
    mesh = make_mesh((1, world), ("data", "model"), device_type="cpu")
    params = TT.params_from_numpy(cfg, params, "cpu")
    span = cache["c_kv"].shape[2] // world
    local = {k: torch.from_numpy(np.array(v[:, :, rank * span:(rank + 1) * span]
                                          if k in ("c_kv", "k_rope") else v))
             for k, v in cache.items()}
    runtime.set_serve_mesh(mesh)
    try:
        logits = []
        for tok in tokens:
            out, local = decode.decode_step(cfg, params, local, torch.from_numpy(tok))
            logits.append(out.numpy())
    finally:
        runtime.set_serve_mesh(None)
    return np.stack(logits), {k: v.numpy() for k, v in local.items()}


def train_worker(rank, world, cases):
    """Each case ``(cfg, mesh shape, fsdp, state, batch, n_micro, lr)``: the
    reference's numpy TrainState and batch placed on a ("data", "model")
    mesh of that shape (`launch.sharding.state_specs`, `batch_specs`,
    `place`) and one `train_step` on the DTensors. Returns, per case, on
    rank 0 the whole new state and the metrics as numpy (None elsewhere),
    and on every rank the local and whole element counts of each parameter
    leaf."""
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import train_step as TS
    from repro_torch.training import tree as tr

    out = []
    for cfg, shape, fsdp, state, batch, n_micro, lr in cases:
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        st = TS.train_state_from_numpy(cfg, state, "cpu")
        placed = SH.place(st, SH.state_specs(cfg, st, mesh, fsdp), mesh)
        b = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        pb = SH.place(b, SH.batch_specs(cfg, b, mesh), mesh)
        new, m = TS.train_step(cfg, placed, pb, n_micro=n_micro, lr=lr)
        sizes = [(x.to_local().numel(), x.numel()) for x in tr.leaves(placed.params)]
        whole = tr.tree_map(lambda x: x.full_tensor(), new)
        res = None
        if rank == 0:
            res = (tr.tree_map(lambda t: t.numpy().copy(), whole),
                   {k: v.numpy().copy() for k, v in m.items()})
        out.append((res, sizes))
    return out
