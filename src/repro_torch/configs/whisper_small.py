"""whisper-small [audio]: 12L enc + 12L dec, d_model=768 12H (MHA kv=12)
d_ff=3072 vocab=51865 — enc-dec, conv frontend is a stub (input_specs
provides precomputed frame embeddings).  [arXiv:2212.04356; unverified]"""

from ..models.config import GLOBAL_WINDOW, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51_865,
    pattern=tuple((("xattn", GLOBAL_WINDOW, 10_000.0, False)
                   for _ in range(12))),
    encoder_layers=12,
    encoder_seq=1500,
)
