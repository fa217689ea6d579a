"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution. Vision frontend is a STUB:
input_specs() provides precomputed patch embeddings. [arXiv:2409.12191; hf]"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_head=128,
    d_ff=8960,
    vocab=151936,
    mrope_sections=(16, 24, 24),   # (t, h, w) frequency splits of Dh/2=64
    rope_theta=1000000.0,
    frontend="vision",
    tie_embeddings=True,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-vl-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=256, dtype="float32",
        mrope_sections=(2, 3, 3),
    )
