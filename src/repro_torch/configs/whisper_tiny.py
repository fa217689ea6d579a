"""whisper-tiny [audio]: 4L(enc)+4L(dec) d_model=384 6H d_ff=1536
vocab=51865 — encoder-decoder; conv/mel frontend is a STUB: input_specs()
provides precomputed frame embeddings [B, 1500, 384]. [arXiv:2212.04356]"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,            # decoder layers
    n_enc_layers=4,
    enc_seq=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    norm="layernorm",
    act="gelu",
    tie_embeddings=True,
    frontend="audio",
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="whisper-smoke", n_layers=2, n_enc_layers=2, enc_seq=32,
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
        dec_pos_len=256, dtype="float32",
    )
