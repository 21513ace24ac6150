"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144 — 5:1 local:global, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""

from ..models.config import GLOBAL_WINDOW, ModelConfig

WINDOW = 512
_UNIT = tuple(
    ("attn", WINDOW, 10_000.0, False) for _ in range(5)
) + (("attn", GLOBAL_WINDOW, 1_000_000.0, False),)

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    pattern=_UNIT * 4 + _UNIT[:2],   # 26 = 6*4 + 2 (trailing locals)
    scan_unit=6,
    rope_theta=1_000_000.0,
    subquadratic=True,  # 5:1 local; global layers are decode-KV-bounded
)
