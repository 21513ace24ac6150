"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 — local+global alternating, logit softcap.
[arXiv:2408.00118; hf]"""

from ..models.config import GLOBAL_WINDOW, ModelConfig

WINDOW = 4096
_UNIT = (
    ("attn", WINDOW, 10_000.0, False),
    ("attn", GLOBAL_WINDOW, 10_000.0, False),
)

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256_000,
    pattern=_UNIT * 21,
    scan_unit=2,
    attn_softcap=50.0,
    logit_softcap=30.0,
)
