"""LM model substrate: configs, blocks, assembly.

Ported from ``repro.models``: ``init_params`` builds a ``Model``
(``nn.Module``) from a ``torch.Generator``; ``forward_train`` and ``loss_fn``
(with autograd), ``prefill``, ``decode_step`` and ``init_decode_state`` take
that model.
"""

from .config import GLOBAL_WINDOW, ModelConfig, Segment, SubBlock, \
    build_segments, torch_dtype
from .model import (
    Model,
    decode_step,
    forward_train,
    init_decode_state,
    init_params,
    loss_fn,
    prefill,
    sub_cache_len,
)

__all__ = [
    "GLOBAL_WINDOW", "ModelConfig", "Segment", "SubBlock", "build_segments",
    "torch_dtype", "Model", "decode_step", "forward_train",
    "init_decode_state", "init_params", "loss_fn", "prefill",
    "sub_cache_len",
]
