"""Architecture registry: one module per architecture, each with its exact
published config (``CONFIG``) and a reduced same-family config
(``smoke()``), copied from `repro.configs`.

All ten architectures are named and the port runs all ten: the dense
family, rwkv6, the RG-LRU hybrid, the DeepSeek MoE/MLA pair, whisper's
encoder-decoder (a stub frontend over precomputed frame embeddings) and
qwen2-vl's M-RoPE stack (a stub frontend over patch embeddings).
"""
from __future__ import annotations

from importlib import import_module

_MODULES = {
    "whisper-tiny": "whisper_tiny",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "granite-8b": "granite_8b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "internlm2-20b": "internlm2_20b",
    "qwen3-14b": "qwen3_14b",
    "rwkv6-3b": "rwkv6_3b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}
# the architectures this port runs: every one the reference names
PORTED = ("granite-8b", "h2o-danube-1.8b", "internlm2-20b", "qwen3-14b",
          "rwkv6-3b", "recurrentgemma-9b", "deepseek-v2-236b",
          "deepseek-v3-671b", "whisper-tiny", "qwen2-vl-2b")

ARCH_NAMES = list(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCH_NAMES}")
    return import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str):
    """Full published config for ``--arch <name>``."""
    return _module(name).CONFIG


def smoke(name: str):
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).smoke()
