"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400, MoE 160e top-6 — MLA kv_lora=512, 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf]"""
import dataclasses

from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,            # dense-FFN prefix layer
    vocab=102400,
    mla=MLAConfig(
        kv_lora_rank=512, q_lora_rank=1536,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    ),
    moe=MoEConfig(
        n_routed=160, n_shared=2, top_k=6, d_ff_expert=1536,
        first_k_dense=1, aux_free_bias=False,
    ),
    rope_theta=10000.0,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-v2-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, dtype="float32",
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(n_routed=8, n_shared=2, top_k=2, d_ff_expert=32,
                      first_k_dense=1, capacity_factor=4.0),
    )
