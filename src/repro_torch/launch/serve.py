"""Serving launcher: prefill + batched greedy decode for ``--arch <id>``,
and the XBOF harvesting runtime layer.

Port of `repro.launch.serve`. `run_model` drives the model zoo's serve
path (`models.transformer.init_params`, `models.decode.prefill`, then
`models.decode.decode_step` per token) for every architecture: the dense
family, the DeepSeek MoE/MLA pair, rwkv6, the RG-LRU hybrid
(recurrentgemma), qwen2-vl (prefill from the vision stub's patch
embeddings) and whisper (the audio stub's frame embeddings into the
encoder, a decoder prompt of tokens);
`run_runtime_layer` runs N data-parallel engine replicas under skewed
arrivals, redirecting overload through the unified `core.manager` round.
Both run on CUDA unless given ``--device``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
      --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --smoke \
      --device cpu --batch 2 --prompt-len 16 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b \
      --smoke --device cpu --batch 2 --prompt-len 16 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
      --batch 16 --prompt-len 4 --gen 128
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b --smoke \
      --device cpu --batch 2 --prompt-len 16 --gen 4 --replicas 4
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs, resolve_device
from repro_torch.models import decode as D
from repro_torch.models import transformer as T
from repro_torch.models.config import require_in_slice
from repro_torch.serving import engine as E


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def draw_inputs(cfg, batch: int, prompt_len: int, seed: int, device) -> dict:
    """The serve path's inputs for ``cfg`` on ``device``, as the
    reference's launcher draws them: a prompt of ``tokens`` [batch,
    prompt_len] from ``seed + 1``; for a frontend model (qwen2-vl) normal
    ``input_embeds`` [batch, prompt_len, D] from ``seed + 2`` in their
    place; for an encoder-decoder (whisper) also normal ``enc_embeds``
    [batch, enc_seq, D] from ``seed + 3``. Each from its own generator on
    ``device``."""
    dev = torch.device(device)
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)
    inputs = {}
    if cfg.frontend and not cfg.is_encdec:
        inputs["input_embeds"] = torch.randn((batch, prompt_len, cfg.d_model),
                                             device=dev, generator=gen(seed + 2))
    else:
        inputs["tokens"] = torch.randint(0, cfg.vocab, (batch, prompt_len), device=dev,
                                         generator=gen(seed + 1))
    if cfg.is_encdec:
        inputs["enc_embeds"] = torch.randn((batch, cfg.enc_seq, cfg.d_model),
                                           device=dev, generator=gen(seed + 3))
    return inputs


def run_model(arch: str, batch: int, prompt_len: int, gen: int, *,
              smoke: bool = False, seed: int = 0, device=None,
              cfg=None) -> dict:
    """Prefill a random prompt of ``batch`` x ``prompt_len`` tokens, then
    decode ``gen`` tokens greedily, on ``device`` (CUDA when None), with
    weights drawn by `init_params` from ``seed`` and inputs by
    `draw_inputs` (a frontend model prefills from embeddings in place of
    the tokens; an encoder-decoder also takes the encoder's). ``cfg`` (an
    `ArchConfig`), when given, replaces the named config: a harness runs a
    depth-cut config through it (``dataclasses.replace(configs.get(arch),
    n_layers=...)``) when the whole model does not fit one card. Prints the
    prefill time and the decode rate. Returns the greedy tokens [B, gen],
    the last logits [B, V], the times (prefill ms, decode ms per token,
    decoded tokens per second) and the parameter count summed over the
    tensors."""
    if cfg is None:
        cfg = configs.smoke(arch) if smoke else configs.get(arch)
    require_in_slice(cfg)
    dev = resolve_device(device)
    params = T.init_params(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    n_params = sum(t.numel() for t in T.leaves(params))
    inputs = draw_inputs(cfg, batch, prompt_len, seed, dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = D.prefill(cfg, params, max_len=prompt_len + gen, **inputs)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    print(f"prefill {batch}x{prompt_len}: {prefill_s:.3f}s")

    out = []
    tok = torch.argmax(logits, -1).to(torch.int32)
    t0 = time.perf_counter()
    for _ in range(gen):
        out.append(tok)
        logits, cache = D.decode_step(cfg, params, cache, tok)
        tok = torch.argmax(logits, -1).to(torch.int32)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    greedy = torch.stack(out, dim=1) if out else tok.new_zeros((batch, 0))
    tok_per_s = batch * gen / decode_s if gen else 0.0
    print(f"decoded {gen} tokens/seq in {decode_s:.3f}s ({tok_per_s:.1f} tok/s)")
    print("sample:", greedy[0][:12].tolist())
    return {"tokens": greedy, "logits": logits,
            "prefill_ms": 1e3 * prefill_s,
            "decode_ms_per_token": 1e3 * decode_s / gen if gen else 0.0,
            "tok_per_s": tok_per_s, "n_params": n_params}


def run_runtime_layer(n_replicas: int, steps: int = 12, device=None) -> dict:
    """Skewed-load demo of the batched harvesting engine on ``device``
    (CUDA when None). Prints the rate and the harvesting counters and
    returns them."""
    dev = resolve_device(device)
    cfg = E.EngineConfig(n_replicas=n_replicas)
    state = E.init(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    arrivals = torch.zeros(n_replicas, dtype=torch.int32, device=dev)
    arrivals[0] = 5
    arrivals[1] = 1
    # warmup step so the printed rate is steady-state, not first-call setup
    state, stats = E.step(cfg, state, arrivals, generator=gen)
    redirected = stats["redirected"].clone()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, stats = E.step(cfg, state, arrivals, generator=gen)
        redirected += stats["redirected"]
    _sync(dev)
    dt = time.perf_counter() - t0
    out = dict(redirected=int(redirected),
               offsite_pages=int(stats["offsite_pages"]),
               wal_commits=int(stats["log_commits"]),
               utils=[round(float(u), 2) for u in stats["util"]])
    print(f"runtime layer: {n_replicas} replicas x {steps} steps on "
          f"{dev.type} in {dt:.2f}s ({steps / dt:.1f} steps/s)")
    print(f"  redirected={out['redirected']} "
          f"offsite_pages={out['offsite_pages']} "
          f"wal_commits={out['wal_commits']} utils={out['utils']}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.ARCH_NAMES, default=None,
                    help="run the model's prefill + greedy decode")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=0,
                    help="also run the XBOF harvesting runtime layer")
    ap.add_argument("--steps", type=int, default=12,
                    help="runtime-layer steps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    if args.arch is None and args.replicas <= 0:
        ap.error("give --arch, --replicas N, or both")
    if args.arch is not None:
        run_model(args.arch, args.batch, args.prompt_len, args.gen,
                  smoke=args.smoke, seed=args.seed, device=args.device)
    if args.replicas > 0:
        run_runtime_layer(args.replicas, args.steps, device=args.device)


if __name__ == "__main__":
    main()
