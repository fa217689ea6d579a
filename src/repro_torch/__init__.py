"""repro_torch — the PyTorch/CUDA port of `repro` (XBOF), beside it.

The port mirrors `repro`'s module layout (``repro_torch.core.manager`` is
the port of ``repro.core.manager``) and imports neither JAX nor anything of
`repro`. State is NamedTuples of tensors threaded through plain functions;
every entry point takes an explicit ``device`` and runs on CUDA when it is
None. Each TPU kernel on a ported path is a hand-written CUDA kernel for
Hopper (`kernels/csrc/*.cu`) that CUDA tensors launch; CPU tensors take
its plain PyTorch version (`kernels/ref.py`).

Ported so far:

- the serving-engine step (`serving.engine.step`, fp32 and int8 KV
  pages), on one shard or as the hierarchical engine (``n_shards > 1``,
  flat or grouped into enclosures), with the paged-attention kernel
  (`kernels/csrc/paged_attention.cu`), with its telemetry plane
  (``trace_driven``: `core.shards_mrc`, `telemetry`, and the SHARDS
  window kernel `kernels/csrc/shards_window.cu`) and its observability
  plane (``obs``: `obs.metrics`, `obs.spans`, `obs.export`) and its
  failure plane (``track_failures``, ``migrate_pages_per_step``: the
  reclaim predictor `telemetry.reclaim`, `kv_pool.drain_offsite`,
  `engine.fail_replica`), and the scenarios (`serving.scenarios`: the link
  account, and `drive_events` under a `core.events` schedule);
- the engine's step across processes (`serving.engine.make_sharded_step`,
  one shard a rank of a `torch.distributed` serving mesh, the exchange's
  summaries and the stats gathered by all-reduces; `split_state`,
  `join_states`, `state_partition_specs`), the meshes and the serve
  mesh's context (`launch.mesh`, `launch.runtime`) and the sharding rules
  (`launch.sharding`: param, batch, cache and engine-state specs, their
  DTensor placements); weights stay replicated on the serve path;
- the dense model zoo's serve path (`models.transformer.init_params`,
  `models.decode.prefill` and `decode_step`, driven by
  `launch.serve.run_model`) for qwen3-14b, granite-8b, internlm2-20b and
  h2o-danube-1.8b, with the prefill flash-attention kernel
  (`kernels/csrc/flash_attention.cu`);
- the same serve path for the recurrent families, recurrentgemma-9b
  (RG-LRU blocks and local attention) and rwkv6-3b, with the RG-LRU and
  WKV scan kernels (`kernels/csrc/rglru_scan.cu`, `rwkv6_scan.cu`);
- the same serve path for the DeepSeek MoE/MLA family, deepseek-v2-236b
  and deepseek-v3-671b (`models/moe.py`, MLA in `models/attention.py`,
  the latent cache), with the MoE top-k router kernel
  (`kernels/csrc/moe_router.cu`); its decode also sequence-sharded under
  a serve mesh with a "model" axis (`attention.mla_decode_seq_sharded`:
  each rank a span of the latent cache, a flash combine by all-reduces);
- the same serve path for whisper-tiny (an encoder stack, then a decoder
  with cross-attention over the encoder's output; a self and a cross
  cache) and qwen2-vl-2b (M-RoPE, prefill from embeddings), both fed by
  their frontend stubs' embeddings (`launch.serve.run_model` draws them);
- the FTL's LPN -> PPN lookup (`kernels.ops.ftl_lookup`), with its kernel
  (`kernels/csrc/ftl_lookup.cu`);
- the JBOF simulator (`jbof.sim.simulate` with `jbof.platforms`,
  `workloads` and `bom`): static, trace-driven (the SHARDS window kernel),
  multi-enclosure, observed and event-scheduled runs;
- training (`launch.train`: `training.train_step`, microbatched AdamW
  from `training.optimizer`, `training.checkpoint`'s two-slot
  checkpoint/restart, the `data.pipeline` batches, `models.transformer.
  lm_loss` with remat; `training.compression` off the path). Prefill
  flash attention carries a gradient (`kernels.flash_attention.
  FlashAttention`, whose backward is `kernels/csrc/flash_attention_bwd.cu`),
  and so do the RG-LRU and WKV scans and the MoE router (`kernels.ops`'
  autograd Functions, each with a backward kernel): every architecture
  trains on the card; a raw CUDA wrapper raises
  ``NotImplementedError("later slice: no backward kernel ...")`` under
  grad.

Combinations of blocks that no config has (an encoder-decoder with MoE,
MLA or recurrent blocks; MoE without MLA) raise
``NotImplementedError("later slice")``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device a port entry point runs on: CUDA unless the caller names
    another one. Raises when CUDA is wanted and none is present — the port
    never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device unless told otherwise, and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path")
    return dev


__all__ = ["resolve_device"]
