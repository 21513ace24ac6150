"""Model configuration for the assigned architectures.

A model is a sequence of *segments*.  Each segment repeats a fixed **unit**
of sub-blocks (e.g. gemma2's ``[local, global]``, recurrentgemma's
``[rec, rec, attn]``) under one ``lax.scan``: per-sub-block params are
stacked along a leading ``repeats`` axis, so stacked params *and* decode
caches stay rectangular even when layer kinds alternate.  Layers left over
after whole units form a trailing repeats=1 segment.

Block kinds:
  'attn'   — GQA attention (+ dense MLP or MoE), global or sliding-window
  'rglru'  — RecurrentGemma RG-LRU recurrent block (+ dense MLP)
  'rwkv'   — RWKV-6 time-mix + channel-mix block
  'xattn'  — decoder block with self-attn + cross-attn (enc-dec models)

Ported from ``repro.models.config`` verbatim; the port runs the layers of a
segment one after another (``Model.layers``, in layer order) and adds
``torch_dtype`` and ``segment_layers``, the map from the reference's stacked
layout to that order.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["ModelConfig", "SubBlock", "Segment", "build_segments",
           "segment_layers",
           "torch_dtype"]

GLOBAL_WINDOW = -1  # sentinel: full-context attention


@dataclasses.dataclass(frozen=True)
class SubBlock:
    kind: str                 # 'attn' | 'rglru' | 'rwkv' | 'xattn'
    window: int               # GLOBAL_WINDOW = full-context
    theta: float              # rope theta
    moe: bool = False         # MoE MLP instead of dense


@dataclasses.dataclass(frozen=True)
class Segment:
    unit: tuple[SubBlock, ...]
    repeats: int

    @property
    def layers(self) -> int:
        return len(self.unit) * self.repeats


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 -> d_model // num_heads
    # per-layer structure: sequence of (kind, window, theta, moe)
    pattern: tuple[tuple, ...] = ()
    # attention details
    qkv_bias: bool = False
    logit_softcap: float | None = None
    attn_softcap: float | None = None
    rope_theta: float = 10_000.0
    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0          # per-expert hidden dim (0 -> d_ff)
    capacity_factor: float = 1.25
    # encoder-decoder (audio): encoder is bidirectional full attention
    encoder_layers: int = 0
    encoder_seq: int = 1500    # precomputed frame embeddings (stub frontend)
    # vlm
    mrope_sections: tuple[int, int, int] | None = None
    vision_seq: int = 0        # precomputed patch embeddings (stub frontend)
    # ssm / hybrid
    rnn_width: int = 0         # RG-LRU state width (0 -> d_model)
    conv_width: int = 4
    rwkv_head_dim: int = 64
    # MLP style: SwiGLU (3 matrices) vs plain GELU (2 matrices)
    gated_mlp: bool = True
    # numerics
    dtype: str = "bfloat16"
    # sub-quadratic? (drives long_500k eligibility)
    subquadratic: bool = False
    # layers per lax.scan unit (the repeating pattern period)
    scan_unit: int = 1

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if not self.pattern:
            object.__setattr__(
                self,
                "pattern",
                tuple(("attn", GLOBAL_WINDOW, self.rope_theta,
                       self.num_experts > 0)
                      for _ in range(self.num_layers)),
            )
        if self.num_experts and not self.moe_d_ff:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def kv_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, ff, hd = self.d_model, self.d_ff, self.head_dim
        total = self.vocab_size * d  # embed (tied lm head)
        for kind, _w, _t, moe in self.pattern:
            if kind in ("attn", "xattn"):
                attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
                    + self.num_heads * hd * d
                if kind == "xattn":
                    attn *= 2
                nmat = 3 if self.gated_mlp else 2
                if moe:
                    mlp = self.num_experts * nmat * d * self.moe_d_ff \
                        + d * self.num_experts
                else:
                    mlp = nmat * d * ff
                total += attn + mlp + 2 * d
            elif kind == "rglru":
                w = self.rnn_width or d
                total += 2 * d * w + w * d + 3 * w + self.conv_width * w \
                    + 3 * d * ff + 2 * d
            elif kind == "rwkv":
                total += 6 * d * d + 2 * d * ff + 2 * d
        # encoder stack
        enc_attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
            + self.num_heads * hd * d + 3 * d * ff + 2 * d
        total += self.encoder_layers * enc_attn
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if not self.num_experts:
            return self.param_count()
        d = self.d_model
        nmat = 3 if self.gated_mlp else 2
        total = self.param_count()
        moe_layers = sum(1 for k, _w, _t, moe in self.pattern if moe)
        full = self.num_experts * nmat * d * self.moe_d_ff
        act = self.num_experts_per_tok * nmat * d * self.moe_d_ff
        return total - moe_layers * (full - act)


def build_segments(cfg: ModelConfig) -> tuple[Segment, ...]:
    """Group the per-layer pattern into repeated-unit scan segments.

    The pattern is split into ``scan_unit``-sized units; every full unit
    must be identical (asserted) and becomes one scanned segment; leftover
    layers form a trailing repeats=1 segment.
    """
    entries = tuple(SubBlock(kind=k, window=w, theta=t, moe=m)
                    for (k, w, t, m) in cfg.pattern)
    k = max(cfg.scan_unit, 1)
    full = len(entries) // k
    segs: list[Segment] = []
    if full:
        unit = entries[:k]
        for i in range(full):
            got = entries[i * k: (i + 1) * k]
            assert got == unit, (
                f"pattern not periodic with scan_unit={k} at unit {i}: "
                f"{got} != {unit}"
            )
        segs.append(Segment(unit=unit, repeats=full))
    rem = entries[full * k:]
    if rem:
        segs.append(Segment(unit=rem, repeats=1))
    return tuple(segs)


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    """The torch dtype of ``cfg.dtype`` ("bfloat16" or "float32")."""
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {cfg.dtype!r}; "
                         f"known: {sorted(_DTYPES)}")
    return _DTYPES[cfg.dtype]


def segment_layers(cfg: ModelConfig):
    """(layer, segment, repeat, sub-block) for every layer of ``cfg``, in
    the reference's stacking order: repeat r of sub-block j in the segment
    starting at layer o is layer o + r * len(unit) + j."""
    out, o = [], 0
    for si, seg in enumerate(build_segments(cfg)):
        for r in range(seg.repeats):
            for j in range(len(seg.unit)):
                out.append((o + r * len(seg.unit) + j, si, r, j))
        o += seg.layers
    return out
