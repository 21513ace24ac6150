"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution (patch frontend is a stub:
input_specs provides precomputed patch embeddings and 3-axis positions).
[arXiv:2409.12191; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    mrope_sections=(16, 24, 24),
    vision_seq=256,
    rope_theta=1_000_000.0,
)
