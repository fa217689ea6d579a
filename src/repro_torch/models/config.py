"""Architecture configuration for the model zoo.

Port of `repro.models.config`: one frozen `ArchConfig` per architecture
(see `repro_torch.configs`), with the same fields and derived properties.
`param_dtype` is a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0            # 0 = full-rank q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int = 64
    n_shared: int = 1
    top_k: int = 6
    d_ff_expert: int = 2048
    first_k_dense: int = 1          # leading dense-FFN layers (DeepSeek)
    capacity_factor: float = 1.25
    aux_free_bias: bool = False     # DeepSeek-v3 bias-based load balancing
    router_aux_coef: float = 0.001


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                 # 0 -> d_model // n_heads
    # attention options
    qk_norm: bool = False
    sliding_window: int = 0         # 0 = full attention
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) splits
    mla: Optional[MLAConfig] = None
    # MoE
    moe: Optional[MoEConfig] = None
    # recurrent blocks
    recurrent: str = ""             # "" | rwkv6 | rglru
    # hybrid pattern: period and which indices in the period are attention
    pattern_period: int = 1
    attn_in_period: Tuple[int, ...] = (0,)
    local_window: int = 0           # hybrid local-attn window
    lru_width: int = 0              # RG-LRU state width (0 -> d_model)
    conv_width: int = 4             # RG-LRU temporal conv
    # encoder-decoder
    n_enc_layers: int = 0
    enc_seq: int = 1500             # whisper audio frames after conv stub
    dec_pos_len: int = 65536        # learned decoder position table
    # modality frontend stub: input embeddings provided externally
    frontend: str = ""              # "" | audio | vision
    # multi-token prediction (DeepSeek-v3)
    mtp_depth: int = 0
    # norm / activation flavor
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "swiglu"             # swiglu | geglu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    remat: bool = True              # the reference's layer checkpointing
    scan_unroll: bool = False       # the reference's scan unrolling

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.recurrent != "" and not self.attn_layers_exist

    @property
    def attn_layers_exist(self) -> bool:
        if self.recurrent == "":
            return True
        # hybrid: attention appears in the period pattern
        return self.pattern_period > 1 and len(self.attn_in_period) > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM/hybrid/sliding-window attention."""
        return (self.recurrent != "") or (self.sliding_window > 0)

    def layer_kinds(self) -> list[str]:
        """Per-layer block kind: 'attn' | 'rec'."""
        if self.recurrent == "":
            return ["attn"] * self.n_layers
        if self.pattern_period <= 1:
            return ["rec"] * self.n_layers
        return ["attn" if (i % self.pattern_period) in self.attn_in_period
                else "rec" for i in range(self.n_layers)]

    def n_params(self) -> float:
        """Approximate parameter count (for 6ND roofline bookkeeping)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        dh, h, kv = self.head_dim, self.n_heads, self.n_kv_heads
        kinds = self.layer_kinds()
        total = v * d * (1 if self.tie_embeddings else 2)
        for i, kind in enumerate(kinds):
            if kind == "attn":
                if self.mla is not None:
                    m = self.mla
                    qdim = h * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    q = (d * m.q_lora_rank + m.q_lora_rank * qdim
                         if m.q_lora_rank else d * qdim)
                    kvp = d * (m.kv_lora_rank + m.qk_rope_head_dim) \
                        + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
                    o = h * m.v_head_dim * d
                    total += q + kvp + o
                else:
                    total += d * h * dh + 2 * d * kv * dh + h * dh * d
            else:  # recurrent block
                if self.recurrent == "rwkv6":
                    total += 4 * d * d + d * dh
                else:  # rglru
                    w = self.lru_width or d
                    total += 2 * d * w + w * d + 2 * w
            if self.moe is not None and i >= self.moe.first_k_dense:
                e = self.moe
                total += d * e.n_routed
                total += (e.n_routed + e.n_shared) * 3 * d * e.d_ff_expert
            else:
                mult = 3 if self.act in ("swiglu", "geglu") else 2
                total += mult * d * f
        if self.is_encdec:
            for _ in range(self.n_enc_layers):
                total += d * h * dh + 2 * d * kv * dh + h * dh * d
                total += (3 if self.act in ("swiglu", "geglu") else 2) * d * f
            total += self.n_layers * (d * h * dh + 2 * d * kv * dh + h * dh * d)
        return float(total)

    def n_active_params(self) -> float:
        """Active parameters per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        e = self.moe
        kinds = self.layer_kinds()
        n_moe_layers = sum(1 for i, _ in enumerate(kinds) if i >= e.first_k_dense)
        inactive = (e.n_routed - e.top_k) * 3 * d * e.d_ff_expert * n_moe_layers
        return self.n_params() - float(inactive)


def require_in_slice(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError("later slice")`` for a combination of
    blocks that no config has and the reference does not run coherently:
    MoE and MLA apart (the reference's decode reads a MoE model's
    ``moe_layers`` only on its MLA branch and an MLA model's only there
    too, so neither runs alone) or with recurrent blocks, and an
    encoder-decoder with MoE, MLA or recurrent blocks (the reference's
    `init_params` takes its enc-dec branch first and ignores the rest).
    The port runs the uniform attention stack (GQA, RoPE or M-RoPE,
    optional qk-norm and sliding window; or MLA with a dense-FFN prefix and
    MoE layers, as DeepSeek), the RWKV6 stack, the RG-LRU hybrid
    (recurrent blocks and local attention in a period pattern) and the
    encoder-decoder with cross-attention (whisper), from tokens or from a
    frontend stub's embeddings. As the two come together, the model code
    picks the DeepSeek family by ``cfg.mla`` alone."""
    moe, mla = cfg.moe is not None, cfg.mla is not None
    later = [name for name, on in (
        ("moe without mla", moe and not mla), ("mla without moe", mla and not moe),
        ("moe/mla with recurrent blocks", (moe or mla) and cfg.recurrent != ""),
        (f"recurrent={cfg.recurrent}",
         cfg.recurrent not in ("", "rglru", "rwkv6")),
        ("enc-dec with moe/mla/recurrent blocks",
         cfg.is_encdec and (moe or mla or cfg.recurrent != ""))) if on]
    if later:
        raise NotImplementedError(
            f"later slice: {cfg.name} needs {', '.join(later)}; the port "
            "runs the dense, M-RoPE and DeepSeek MoE/MLA attention stacks, "
            "RWKV6, the RG-LRU hybrid and the attention encoder-decoder")
