"""qwen1.5-0.5b [dense]: QKV bias, large vocab.

24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936
[hf:Qwen/Qwen1.5-0.5B; hf].
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen1.5-0.5b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=2816, vocab_size=151936, qkv_bias=True,
    )
