"""rwkv6-3b [ssm] "Finch": 32L d_model=2560 (attention-free) d_ff=8960
vocab=65536 — data-dependent decay WKV. [arXiv:2404.05892; hf]"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # head_size 64
    n_kv_heads=40,
    d_head=64,
    d_ff=8960,
    vocab=65536,
    recurrent="rwkv6",
    pattern_period=1,
    attn_in_period=(),
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="rwkv6-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab=256, dtype="float32",
    )
