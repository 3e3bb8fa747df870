"""seamless-m4t-large-v2 [audio]: enc-dec backbone, stub speech frontend.

24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206
[arXiv:2308.11596; hf].  24 encoder + 24 decoder layers; input_specs()
provides precomputed frame embeddings for the encoder.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "seamless-m4t-large-v2"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="encdec",
        n_layers=24, n_encoder_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=16, d_ff=8192, vocab_size=256206,
    )
