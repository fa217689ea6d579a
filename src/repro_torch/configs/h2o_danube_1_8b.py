"""h2o-danube-1.8b [dense]: 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama+mistral mix, sliding-window attention.
[arXiv:2401.16818; hf]"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=80,
    d_ff=6912,
    vocab=32000,
    sliding_window=4096,   # mistral-style SWA -> sub-quadratic, long_500k runs
    rope_theta=10000.0,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="h2o-danube-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=256, sliding_window=16,
        dtype="float32",
    )
