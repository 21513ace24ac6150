"""Architecture registry: the 10 assigned configs, the shape grid, cell
eligibility, and reduced smoke-test variants.

Ported from ``repro.configs`` with the same registry, files and values."""

from __future__ import annotations

import dataclasses
import importlib

from ..models.config import GLOBAL_WINDOW, ModelConfig

__all__ = [
    "ARCHS", "SHAPES", "get_config", "smoke_config", "cells",
    "cell_eligible", "Shape",
]

# arch id -> module (one file per assigned architecture)
ARCHS = {
    "gemma3-1b": "gemma3_1b",
    "gemma2-9b": "gemma2_9b",
    "qwen2.5-3b": "qwen25_3b",
    "granite-34b": "granite_34b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "whisper-small": "whisper_small",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "rwkv6-7b": "rwkv6_7b",
}


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.CONFIG


def cell_eligible(cfg: ModelConfig, shape: Shape) -> tuple[bool, str]:
    """long_500k runs only for sub-quadratic archs (SSM / hybrid / mostly-
    local); pure full-attention archs skip it (DESIGN.md §5)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: long_500k skipped per spec"
    return True, ""


def cells(include_skipped: bool = False):
    """All (arch, shape) cells; 40 total, with eligibility annotations."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, why = cell_eligible(cfg, shape)
            if ok or include_skipped:
                out.append((arch, shape.name, ok, why))
    return out


def smoke_config(arch: str) -> ModelConfig:
    """A reduced same-family config: same pattern structure (one scan unit
    + remainder), tiny dims — runs a forward/train step on CPU in seconds."""
    cfg = get_config(arch)
    unit = max(cfg.scan_unit, 1)
    # keep 2 units + the same remainder structure, so segments mirror the
    # full config
    rem = cfg.num_layers % unit
    n_layers = 2 * unit + rem
    pattern = tuple(
        (k, (64 if w not in (0, GLOBAL_WINDOW) else w), t, m)
        for (k, w, t, m) in (cfg.pattern[:2 * unit] + cfg.pattern[
            cfg.num_layers - rem:] if rem else cfg.pattern[:n_layers])
    )
    heads = min(cfg.num_heads, 4)
    kv = min(cfg.num_kv_heads, heads)
    d_model = 64
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=n_layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab_size=128,
        pattern=pattern,
        num_experts=min(cfg.num_experts, 8) if cfg.num_experts else 0,
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2)
        if cfg.num_experts else 0,
        moe_d_ff=32 if cfg.num_experts else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=min(cfg.encoder_seq, 24),
        vision_seq=min(cfg.vision_seq, 8),
        mrope_sections=(4, 2, 2) if cfg.mrope_sections else None,
        rnn_width=d_model if cfg.rnn_width else 0,
        rwkv_head_dim=16,
        dtype="float32",
    )
