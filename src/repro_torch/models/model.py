"""Model assembly: train forward (chunked xent loss), prefill, and
single-token decode.

Ported from ``repro.models.model``.  The reference stacks the sub-blocks of
each repeated-unit segment and scans them; the port holds one module per
layer in layer order (``Model.layers``) and runs them one after another,
which computes the same thing.  A decode state is
``{"caches": [one dict per layer], "pos": int}``.

``forward_train`` and ``loss_fn`` run with autograd.  The reference's
``jax.checkpoint`` of its scan body (one repeat of a segment's unit) is a
``torch.utils.checkpoint`` of each run of ``len(unit)`` consecutive layers
here, and each loss chunk is checkpointed as there, so a chunk's (B, C, V)
float32 logits live only while that chunk is computed.  The serving entry
points run under ``torch.no_grad()``; ``Model(cfg)`` and ``init_params``
place the parameters on the CUDA card unless given a device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..sharding.ctx import constrain
from . import blocks as blocks_mod
from .config import (GLOBAL_WINDOW, ModelConfig, SubBlock, segment_layers,
                     torch_dtype)
from .layers import init_dense, rms_norm, softcap

__all__ = [
    "Model",
    "init_params",
    "forward_train",
    "loss_fn",
    "prefill",
    "decode_step",
    "init_decode_state",
    "sub_cache_len",
]


def sub_cache_len(sub: SubBlock, max_len: int) -> int:
    """KV-cache length of one sub-block: full context for global attention,
    the window for sliding-window layers, 1 slot (unused) for stateful
    recurrent kinds."""
    if sub.kind in ("attn", "xattn"):
        return max_len if sub.window == GLOBAL_WINDOW \
            else min(sub.window, max_len)
    return 1


class Encoder(nn.Module):
    """Bidirectional encoder of an encoder-decoder model: ``blocks`` (global
    attention + MLP, one per encoder layer) and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        sub = SubBlock("attn", GLOBAL_WINDOW, cfg.rope_theta, False)
        self.blocks = nn.ModuleList(
            blocks_mod.init_block(cfg, sub, dtype, device)
            for _ in range(cfg.encoder_layers))
        self.final_norm = nn.Parameter(
            torch.empty((cfg.d_model,), dtype=dtype, device=device))


class Model(nn.Module):
    """The LM: token embedding (V, d), tied as the unembedding; the layers
    in layer order; the final norm; and, for encoder-decoder configs, the
    encoder.  Parameters are allocated uninitialized on ``device`` (None =
    the CUDA card); ``init_params`` initializes them from a generator."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        dtype = torch_dtype(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(
            (cfg.vocab_size, cfg.d_model), dtype=dtype, device=dev))
        self.final_norm = nn.Parameter(
            torch.empty((cfg.d_model,), dtype=dtype, device=dev))
        self.layers = nn.ModuleList(
            blocks_mod.init_block(cfg, SubBlock(*entry), dtype, dev)
            for entry in cfg.pattern)
        self.encoder = Encoder(cfg, dtype, dev) if cfg.encoder_layers \
            else None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def reset_parameters(self, generator):
        """The reference's ``init_params`` scales: the embedding N(0, 1/d)
        truncated at two standard deviations (re-scaled by sqrt(d) at
        lookup), norms at zero, dense weights at fan_in ** -0.5."""
        cfg = self.cfg
        self.embed.copy_(init_dense(generator, tuple(self.embed.shape),
                                    self.embed.dtype,
                                    scale=cfg.d_model ** -0.5))
        self.final_norm.zero_()
        for block in self.layers:
            block.reset_parameters(generator)
        if self.encoder is not None:
            for block in self.encoder.blocks:
                block.reset_parameters(generator)
            self.encoder.final_norm.zero_()


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device=None) -> Model:
    """A ``Model`` of ``cfg`` on ``device`` (None = the CUDA card),
    initialized from ``generator``, which must live on that device."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"parameters go to {dev}")
    model = Model(cfg, dev)
    model.reset_parameters(generator)
    return model


def _embed_tokens(model: Model, tokens):
    x = model.embed[tokens]  # (B, S, d) gather
    # the scale is rounded to the model dtype first, as the reference's
    # jnp.asarray(d ** 0.5, x.dtype); the product of two values of that
    # dtype is exact in float32 and rounded once, as there
    scale = float(torch.tensor(model.cfg.d_model ** 0.5, dtype=x.dtype))
    return x * scale


def _input_embeddings(model: Model, batch):
    x = _embed_tokens(model, batch["tokens"])
    if model.cfg.vision_seq and "vision" in batch:
        # stub multimodal frontend: precomputed patch embeddings replace
        # the first vision_seq positions
        v = batch["vision"].to(x.dtype)
        x = torch.cat([v, x[:, v.shape[1]:]], dim=1)
    return x


def _run_encoder(frames, model: Model):
    """Bidirectional encoder over precomputed frame embeddings (stub
    frontend): (B, Se, d) -> (B, Se, d).  With grad where the caller has it
    (``forward_train``), without under ``prefill``."""
    Se = frames.shape[1]
    positions = torch.arange(Se, dtype=torch.int32,
                             device=frames.device)[None, :]
    x = frames
    for block in model.encoder.blocks:
        x, _a, _st = block(x, positions=positions, causal=False)
    return rms_norm(x, model.encoder.final_norm)


def _logits(x, embed, cfg: ModelConfig):
    """(..., d) final hidden -> float32 soft-capped logits: the product in
    the model dtype, then cast, as the reference."""
    return softcap((x @ embed.T).float(), cfg.logit_softcap)


# --------------------------------------------------------------------------
# train forward + loss
# --------------------------------------------------------------------------

def _units(model: Model):
    """The layers in the reference's scan steps: each repeat of each
    segment's unit, a run of ``len(unit)`` consecutive layers."""
    units = {}
    for layer, si, r, _j in segment_layers(model.cfg):
        units.setdefault((si, r), []).append(model.layers[layer])
    return list(units.values())


def _run_unit(x, aux, unit, positions, enc_out, mrope_positions):
    """One scan step: the unit's layers in order, their aux losses added
    to ``aux`` one by one, as the reference's carry."""
    for block in unit:
        x, a, _state = block(x, positions=positions, causal=True,
                             enc_out=enc_out, mrope_positions=mrope_positions)
        aux = aux + a
    return x, aux


def forward_train(model: Model, batch, remat: bool = False):
    """Returns (final hidden states (B, S, d), aux losses).  ``batch``
    holds "tokens" (B, S) and, as the config needs, "frames", "vision" and
    "mrope_positions", on the model's device.  With ``remat`` each unit's
    activations are recomputed in backward."""
    cfg = model.cfg
    B, S = batch["tokens"].shape
    x = _input_embeddings(model, batch)
    enc_out = None
    if cfg.encoder_layers:
        enc_out = _run_encoder(batch["frames"].to(x.dtype), model)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None, :].expand(B, S)
    mrope_positions = batch.get("mrope_positions")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for unit in _units(model):
        args = (x, aux, unit, positions, enc_out, mrope_positions)
        if remat:
            # the forward draws no random numbers: no RNG state to keep
            x, aux = checkpoint(_run_unit, *args, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = _run_unit(*args)
    return rms_norm(x, model.final_norm), aux


def _xent_chunk(x, embed, labels, cfg: ModelConfig):
    """x: (B, C, d); labels: (B, C), -1 where none. Returns (sum_loss,
    count)."""
    # hints the reference does without.  XLA reduces a vocabulary-sharded
    # logsumexp in partial sums; DTensor has no such rule and, left alone,
    # gathers the chunk's whole logits, batch included, onto every device.
    # So: the batch stays sharded, the embedding is gathered over its model
    # dimension, and each device gathers only its own rows' logits
    x = constrain(x, "batch", None, None)
    embed = constrain(embed, "model", None)
    logits = constrain(_logits(x, embed, cfg), "batch", None, None)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      torch.clamp_min(labels, 0)[..., None].long())[..., 0]
    valid = labels >= 0
    loss = torch.where(valid, lse - ll, 0.0)
    return loss.sum(), valid.sum()


def loss_fn(model: Model, batch, remat: bool = False, loss_chunk: int = 512,
            aux_weight: float = 0.01):
    """Scalar LM loss with chunked cross-entropy (never materializes the
    full (B, S, V) logits): returns (loss, {"xent", "aux"}).  S is padded
    up to a multiple of the chunk with label -1."""
    x, aux = forward_train(model, batch, remat=remat)
    labels = batch["labels"]
    B, S, d = x.shape
    C = min(loss_chunk, S)
    n_chunks = -(-S // C)
    pad = n_chunks * C - S
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(n_chunks):
        s, c = checkpoint(_xent_chunk, x[:, i * C:(i + 1) * C], model.embed,
                          labels[:, i * C:(i + 1) * C], model.cfg,
                          use_reentrant=False, preserve_rng_state=False)
        tot, cnt = tot + s, cnt + c
    loss = tot / torch.clamp_min(cnt, 1)
    return loss + aux_weight * aux, {"xent": loss, "aux": aux}


def _cross_kv(block, enc_out):
    """One cross-attention layer's K/V from the encoder output."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, block.xattn.wk)
    v = torch.einsum("bsd,dhk->bshk", enc_out, block.xattn.wv)
    return k, v


@torch.no_grad()
def init_decode_state(model: Model, batch: int, max_len: int,
                      enc_out=None) -> dict:
    """Decode state: one cache per layer (+ cross K/V for enc-dec
    models), at position 0."""
    cfg = model.cfg
    dtype, dev = torch_dtype(cfg), model.device
    caches = []
    for block in model.layers:
        sub = block.sub
        cache = blocks_mod.init_block_cache(
            cfg, sub.kind, batch, sub_cache_len(sub, max_len), dtype, dev)
        if sub.kind == "xattn":
            if enc_out is not None:
                cache["xk"], cache["xv"] = _cross_kv(block, enc_out)
            else:
                shape = (batch, cfg.encoder_seq, cfg.num_kv_heads,
                         cfg.head_dim)
                cache["xk"] = torch.zeros(shape, dtype=dtype, device=dev)
                cache["xv"] = torch.zeros(shape, dtype=dtype, device=dev)
        caches.append(cache)
    return {"caches": caches, "pos": 0}


@torch.no_grad()
def decode_step(model: Model, state, tokens):
    """One token for the whole batch.  tokens: (B,) integers.
    Returns (logits (B, V) float32, new state).  The attention caches of
    ``state`` are written in place, so the state passed in is consumed."""
    pos = int(state["pos"])
    x = _embed_tokens(model, tokens[:, None])[:, 0]  # (B, d)
    caches = []
    for block, cache in zip(model.layers, state["caches"]):
        x, cache = block.decode(x, cache, pos)
        caches.append(cache)
    x = rms_norm(x, model.final_norm)
    return _logits(x, model.embed, model.cfg), {"caches": caches,
                                                "pos": pos + 1}


def _format_attn_cache(kv, sub: SubBlock, cfg: ModelConfig, S: int,
                       max_len: int, dtype):
    """Pack full-sequence K/V into ring-buffer cache layout: entry for
    position p lives at slot p % cache_len."""
    k_full, v_full = kv
    dev = k_full.device
    cl = sub_cache_len(sub, max_len)
    take = min(S, cl)
    pos_tail = torch.arange(S - take, S, dtype=torch.int32, device=dev)
    slots = torch.remainder(pos_tail, cl).long()

    def ring(x):
        # moves only: the last cl positions rotated to their slots, or the
        # S < cl positions in slots 0..S-1 followed by empty ones (a scatter
        # would do the same; DTensor has no sharding rule for it)
        x = x[:, S - take:].to(dtype)
        if take == cl:
            return torch.roll(x, shifts=S % cl, dims=1)
        return torch.cat([x, x.new_zeros((x.shape[0], cl - take)
                                          + x.shape[2:])], dim=1)

    sp = torch.full((cl,), -1, dtype=torch.int32, device=dev)
    sp[slots] = pos_tail
    return {"k": ring(k_full), "v": ring(v_full), "slot_pos": sp}


@torch.no_grad()
def prefill(model: Model, batch, max_len: int):
    """Full-sequence prefill: returns (last-token logits (B, V), state).

    Runs the full-sequence forward (streaming attention) while extracting
    per-layer decode state: ring-buffer K/V for attention layers, final
    recurrent state for rglru/rwkv layers.  ``batch`` holds "tokens" (B, S)
    and, as the config needs, "frames", "vision" and "mrope_positions".
    """
    cfg = model.cfg
    B, S = batch["tokens"].shape
    x = _input_embeddings(model, batch)
    enc_out = None
    if cfg.encoder_layers:
        enc_out = _run_encoder(batch["frames"].to(x.dtype), model)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None, :].expand(B, S)
    mrope_positions = batch.get("mrope_positions")
    dtype = torch_dtype(cfg)
    caches = []
    for block in model.layers:
        sub = block.sub
        x, _a, st = block(x, positions=positions, causal=True,
                          enc_out=enc_out, mrope_positions=mrope_positions)
        if sub.kind in ("attn", "xattn"):
            st = _format_attn_cache(st, sub, cfg, S, max_len, dtype)
            if sub.kind == "xattn":
                st["xk"], st["xv"] = _cross_kv(block, enc_out)
        caches.append(st)
    x = rms_norm(x, model.final_norm)
    return _logits(x[:, -1], model.embed, cfg), {"caches": caches, "pos": S}
