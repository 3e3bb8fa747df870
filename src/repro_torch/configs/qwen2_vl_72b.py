"""qwen2-vl-72b [vlm]: M-RoPE backbone, stub vision frontend.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064
[arXiv:2409.12191; hf].  input_specs() provides precomputed patch
embeddings + (t, h, w) position ids; mrope_sections=(16, 24, 24)
(sums to head_dim/2 = 64).
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen2-vl-72b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab_size=152064,
        mrope_sections=(16, 24, 24), embed_inputs=False, qkv_bias=True,
    )
