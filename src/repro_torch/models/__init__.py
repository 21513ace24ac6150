"""LM model substrate: configs, blocks, assembly (the serving path).

Ported from ``repro.models``: ``init_params`` builds a ``Model``
(``nn.Module``) from a ``torch.Generator``; ``prefill``, ``decode_step`` and
``init_decode_state`` take that model.  The training path (``forward_train``,
``loss_fn``) is not ported yet.
"""

from .config import GLOBAL_WINDOW, ModelConfig, Segment, SubBlock, \
    build_segments, torch_dtype
from .model import (
    Model,
    decode_step,
    init_decode_state,
    init_params,
    prefill,
    sub_cache_len,
)

__all__ = [
    "GLOBAL_WINDOW", "ModelConfig", "Segment", "SubBlock", "build_segments",
    "torch_dtype", "Model", "decode_step", "init_decode_state",
    "init_params", "prefill", "sub_cache_len",
]
