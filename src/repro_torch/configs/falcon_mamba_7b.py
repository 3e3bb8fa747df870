"""falcon-mamba-7b [ssm]: attention-free mamba1 stack.

64L d_model=4096 d_ff=0 vocab=65024, ssm_state=16 [arXiv:2410.05355].
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "falcon-mamba-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, head_dim=0,
        d_ff=0, vocab_size=65024,
        ssm_state=16, ssm_variant="mamba1",
    )
