"""Deterministic synthetic data pipeline.

Port of `repro.data.pipeline`: packed token batches from a seeded numpy
stream (zipf-ish unigrams with markov-ish repetition, so the loss curve
is not flat), plus the frontend stubs' embeddings for the [audio] / [vlm]
archs. The numpy stream is the reference's, so a batch is bit-identical
to its batch for the same (seed, step); a restarted job regenerates the
same batches (the data half of checkpoint/restart). The arrays are
copied to ``device`` (CUDA when None) as int32 tokens and targets and
fp32 embeddings.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.config import ArchConfig


def batch_for_step(cfg: ArchConfig, step: int, batch: int, seq: int, seed: int = 0,
                   device=None) -> dict:
    """The batch of global step ``step`` (stateless, so restartable):
    {"tokens", "targets"} [batch, seq] int32; "input_embeds" [batch, seq,
    d_model] in place of the tokens for a frontend arch; "enc_embeds"
    [batch, enc_seq, d_model] for an encoder-decoder."""
    dev = resolve_device(device)
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    base = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
    tokens = (base % (cfg.vocab - 2)) + 1
    rep = rng.random((batch, seq)) < 0.3
    shifted = np.roll(tokens, 1, axis=1)
    tokens = np.where(rep, shifted, tokens)
    tokens[:, 0] = 1  # BOS
    targets = np.roll(tokens, -1, axis=1)
    targets[:, -1] = 2  # EOS
    out = {"tokens": tokens.astype(np.int32), "targets": targets.astype(np.int32)}
    if cfg.frontend and not cfg.is_encdec:
        out["input_embeds"] = rng.standard_normal((batch, seq, cfg.d_model),
                                                  np.float32) * 0.02
        out["tokens"] = None
    if cfg.is_encdec:
        out["enc_embeds"] = rng.standard_normal((batch, cfg.enc_seq, cfg.d_model),
                                                np.float32) * 0.02
    return {k: torch.from_numpy(v).to(dev) for k, v in out.items() if v is not None}


def stream(cfg: ArchConfig, batch: int, seq: int, seed: int = 0, start_step: int = 0,
           device=None) -> Iterator[dict]:
    step = start_step
    while True:
        yield batch_for_step(cfg, step, batch, seq, seed, device=device)
        step += 1
