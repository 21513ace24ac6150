"""Model presets of the training driver.

Ported from ``repro.launch.train``: ``model_100m`` and ``pick_config``,
which the serving driver (``launch.serve``) uses.  The training loop itself
(``run``) comes with the port of the training path.

Presets:
  smoke  — the arch's reduced config (seconds/step on CPU)
  100m   — a ~100M-param dense config (the end-to-end example target)
  full   — the assigned config
"""

from __future__ import annotations

from ..configs import get_config, smoke_config
from ..models import ModelConfig

__all__ = ["model_100m", "pick_config"]


def model_100m() -> ModelConfig:
    """~100M params: 10L x d640 x ff2560, 50k vocab."""
    return ModelConfig(
        name="dense-100m", family="dense", num_layers=10, d_model=640,
        num_heads=10, num_kv_heads=5, head_dim=64, d_ff=2560,
        vocab_size=50_000, dtype="float32",
    )


def pick_config(arch: str, preset: str) -> ModelConfig:
    if preset == "smoke":
        return smoke_config(arch)
    if preset == "100m":
        return model_100m()
    return get_config(arch)
