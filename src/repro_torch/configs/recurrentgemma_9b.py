"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000 — RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427; unverified]"""

from ..models.config import ModelConfig

WINDOW = 2048
_UNIT = (
    ("rglru", 0, 10_000.0, False),
    ("rglru", 0, 10_000.0, False),
    ("attn", WINDOW, 10_000.0, False),
)

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    pattern=_UNIT * 12 + _UNIT[:2],  # 38 = 3*12 + 2 (trailing recurrents)
    scan_unit=3,
    rnn_width=4096,
    conv_width=4,
    subquadratic=True,
)
