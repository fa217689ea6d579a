"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff(expert)=2048
vocab=129280, MoE 256e top-8 — MLA (kv_lora=512, q_lora=1536), 1 shared +
256 routed top-8, aux-free bias balancing, MTP. [arXiv:2412.19437; hf]"""
import dataclasses

from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,            # dense-FFN prefix layers
    vocab=129280,
    mla=MLAConfig(
        kv_lora_rank=512, q_lora_rank=1536,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    ),
    moe=MoEConfig(
        n_routed=256, n_shared=1, top_k=8, d_ff_expert=2048,
        first_k_dense=3, aux_free_bias=True,
    ),
    mtp_depth=1,
    rope_theta=10000.0,
)


def smoke() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-v3-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, dtype="float32",
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=24, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        # generous capacity: smoke tests compare forward/prefill/decode paths
        # whose capacity pools differ — no-drop keeps them bit-identical
        moe=MoEConfig(n_routed=8, n_shared=1, top_k=2, d_ff_expert=32,
                      first_k_dense=1, aux_free_bias=True,
                      capacity_factor=4.0),
        mtp_depth=1,
    )
