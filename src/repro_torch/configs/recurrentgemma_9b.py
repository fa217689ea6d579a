"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention, 1 attention : 2 recurrent.
[arXiv:2402.19427; unverified]"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_head=256,
    d_ff=12288,
    vocab=256000,
    recurrent="rglru",
    pattern_period=3,
    attn_in_period=(2,),   # (rec, rec, attn) repeating
    local_window=2048,     # sub-quadratic -> long_500k runs
    lru_width=4096,
    conv_width=4,
    act="geglu",
    tie_embeddings=True,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="recurrentgemma-smoke", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=1, d_head=16, d_ff=128, vocab=256,
        local_window=16, lru_width=64, dtype="float32",
    )
