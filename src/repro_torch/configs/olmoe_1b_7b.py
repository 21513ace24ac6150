"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (MHA kv=16) d_ff=1024/expert
vocab=50304, 64 experts top-8.  [arXiv:2409.02060; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50_304,
    num_experts=64,
    num_experts_per_tok=8,
    moe_d_ff=1024,
)
