"""zamba2-1.2b [hybrid]: Mamba2 + shared attention blocks.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf].  Shared attention block invoked every 6 mamba2
blocks on concat([x, x_embed]) (Zamba-style weight sharing).
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "zamba2-1.2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32000,
        ssm_state=64, ssm_variant="mamba2", ssm_head_dim=64,
        hybrid_attn_every=6,
        # d_state=64 makes the per-chunk state expansion (b, Q, H, P, n)
        # 64x the activation size; Q=64 bounds that transient
        ssm_chunk=64,
        # SSD matmul dual form: the intra-chunk work becomes two (Q x Q)
        # matmuls per head instead of an elementwise (b,Q,H,P,n) scan
        ssm_impl="ssd",
    )
