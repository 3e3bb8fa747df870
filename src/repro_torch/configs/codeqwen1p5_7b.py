"""codeqwen1.5-7b [dense]: qwen1.5 arch (QKV bias).

32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416
[hf:Qwen/CodeQwen1.5-7B; hf].
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "codeqwen1.5-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=13440, vocab_size=92416, qkv_bias=True,
    )
