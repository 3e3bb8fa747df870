"""deepseek-moe-16b [moe]: fine-grained experts, 2 shared + 64 routed top-6.

28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400 [arXiv:2401.06066; hf].
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "deepseek-moe-16b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab_size=102400,
        n_experts=64, n_experts_per_token=6, n_shared_experts=2,
    )
