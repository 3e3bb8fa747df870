"""deepseek-67b [dense]: llama arch, deep GQA.

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400
[arXiv:2401.02954; hf].
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "deepseek-67b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22016, vocab_size=102400,
    )
