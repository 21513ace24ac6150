"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048/expert
vocab=163840, MoE 384 experts top-8 — trillion-param MoE (paper-table
config; the real K2 uses MLA attention and one dense first layer, the
assigned table specifies GQA kv=8 and uniform MoE, which we follow).
[arXiv:2501.kimi2; unverified]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163_840,
    num_experts=384,
    num_experts_per_tok=8,
    moe_d_ff=2048,
    capacity_factor=1.25,
)
