"""Unified model configuration covering all assigned architecture families."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    n_kv_heads: Optional[int] = None
    head_dim: Optional[int] = None

    # MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_capacity_factor: float = 1.25

    # SSM ---------------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64         # mamba2 head width
    ssm_dt_rank: Optional[int] = None
    ssm_variant: str = "mamba1"    # mamba1 | mamba2
    ssm_impl: str = "scan"         # scan (associative) | ssd (matmul dual)
    hybrid_attn_every: int = 0     # zamba2: shared attn block cadence

    # enc-dec -------------------------------------------------------------
    n_encoder_layers: int = 0

    # misc ----------------------------------------------------------------
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    qkv_bias: bool = False
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_inputs: bool = True      # False: stub frontend feeds embeddings
    kv_cache_dtype: str = "compute"   # compute dtype | "int8" (quantized)
    attn_chunk_q: int = 512        # flash-style chunk sizes (train/prefill)
    attn_chunk_kv: int = 1024
    ssm_chunk: int = 128
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True

    def __post_init__(self):
        if self.n_kv_heads is None:
            object.__setattr__(self, "n_kv_heads", self.n_heads)
        if self.head_dim is None and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.ssm_dt_rank is None and self.ssm_state:
            object.__setattr__(self, "ssm_dt_rank",
                               max(1, self.d_model // 16))

    # convenience ------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing (SSM/hybrid) -> long_500k runs."""
        return self.family in ("ssm", "hybrid")

    def reduced(self, **over) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 4 if self.hybrid_attn_every else 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(4, max(1, (self.n_kv_heads or 4) * 4
                                  // max(self.n_heads, 1))),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            n_experts_per_token=(min(self.n_experts_per_token, 2)
                                 if self.n_experts_per_token else 0),
            n_shared_experts=min(self.n_shared_experts, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_dt_rank=8 if self.ssm_state else None,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            mrope_sections=((4, 6, 6) if self.mrope_sections is not None
                            else None),
            dtype="float32",
            param_dtype="float32",
            name=self.name + "-reduced",
        )
        small.update(over)
        return dataclasses.replace(self, **small)
