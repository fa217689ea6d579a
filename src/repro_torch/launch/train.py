"""Training launcher: ``--arch <id> [--steps N] [--smoke]`` with
checkpoint/restart and deterministic data.

Port of `repro.launch.train`, with its CLI and printed lines, plus
``--device`` (CUDA unless told otherwise). Weights are drawn from
``--seed`` (`models.transformer.init_params`); a ``--ckpt`` directory
that holds a complete checkpoint is restored first and training goes on
from the step after it. Examples:

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b --smoke \
      --device cpu --steps 20 --batch 8 --seq 128 --ckpt /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
      --steps 4 --batch 2 --seq 8192 --n-micro 2 --ckpt ck
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.data import pipeline
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import train_step as TS


def init(cfg: ArchConfig, seed: int = 0, device=None) -> TS.TrainState:
    """The state at step 0: weights drawn from ``seed`` on ``device``."""
    dev = resolve_device(device)
    params = T.init_params(cfg, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed))
    return TS.init_state(cfg, params)


def resume(ckpt_dir, state: TS.TrainState, log=print) -> tuple[TS.TrainState, int]:
    """(the restored state, the step to run next) from ``ckpt_dir``'s
    newest complete slot, or (``state``, 0) when there is none."""
    got = ckpt.restore(ckpt_dir, state) if ckpt_dir else None
    if got is None:
        return state, 0
    state, step = got
    if log:
        log(f"restored checkpoint at step {step}")
    return state, step + 1


def train(cfg: ArchConfig, state: TS.TrainState, start: int, steps: int, *, batch: int,
          seq: int, n_micro: int = 1, lr: float = 3e-4, seed: int = 0, ckpt_dir=None,
          ckpt_every: int = 10, device=None, log=print):
    """Run steps ``start`` .. ``steps`` - 1, yielding (the state, the
    step's metrics) after each: each step's batch from the pipeline, one
    `train_step`, a line every 5 steps and at the last (the only reads
    back to the host), a checkpoint after every ``ckpt_every`` steps.

    A generator, so that the state handed in is owned by it: a call's
    arguments stay referenced by its caller until the call returns, and a
    loop inside one call would keep the first state (its moments and
    weights) alive through every step."""
    dev = resolve_device(device)
    t0 = time.time()
    for step in range(start, steps):
        b = pipeline.batch_for_step(cfg, step, batch, seq, seed, device=dev)
        state, metrics = TS.train_step(cfg, state, b, n_micro=n_micro, lr=lr)
        if log and (step % 5 == 0 or step == steps - 1):
            log(f"step {step:4d} loss={float(metrics['loss']):.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} "
                f"({(time.time() - t0):.1f}s)")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, state, step)
        yield state, metrics


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)

    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    dev = resolve_device(args.device)
    for _ in train(cfg, *resume(args.ckpt, init(cfg, args.seed, dev)), args.steps,
                   batch=args.batch, seq=args.seq, n_micro=args.n_micro, lr=args.lr,
                   seed=args.seed, ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
                   device=dev):
        pass
    print("done")


if __name__ == "__main__":
    main()
