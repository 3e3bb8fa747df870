"""granite-moe-1b-a400m [moe]: 32 experts top-8.

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "granite-moe-1b-a400m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=512, vocab_size=49155,
        n_experts=32, n_experts_per_token=8,
    )
