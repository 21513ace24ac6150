"""Transformer-family blocks: one ``nn.Module`` per kind, with a
full-sequence forward and a single-token decode.

Ported from ``repro.models.blocks``.  The reference's ``init_block`` is
``init_block`` here (it builds the kind's module), ``block_train`` is each
module's ``forward`` and ``block_decode`` its ``decode``; ``init_block_cache``
keeps its name.  Parameters keep the reference's names and layouts (``wq``
(d, H, hd), ``wo`` (H, hd, d), ...), so carrying weights across is a copy.
The reference's sharding hints (``sharding.ctx.constrain``) sit at its call
sites: the dry-run's DTensors are redistributed there; without a mesh
context (one card) they return their input.

Block layout conventions (pre-norm residual throughout):
  attn   : x += Attn(norm(x));  x += MLP_or_MoE(norm(x))
  xattn  : x += SelfAttn(norm(x)); x += CrossAttn(norm(x)); x += MLP(norm(x))
  rglru  : x += RGLRU_mixer(norm(x)); x += MLP(norm(x))
  rwkv   : x += TimeMix(norm(x));  x += ChannelMix(norm(x))

``decode`` writes an attention layer's ring-buffer cache in place (the
token's K/V at slot ``pos % cache_len``) and returns the layer's cache.
"""

from __future__ import annotations

import torch
from torch import nn

from . import attention as attn_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import rwkv as rwkv_mod
from ..sharding.ctx import constrain, shard_local
from .config import ModelConfig, SubBlock
from .layers import gated_mlp, gelu, init_dense, mrope, rms_norm, rope

__all__ = ["Attention", "MLP", "AttnBlock", "XAttnBlock", "RGLRUBlock",
           "RWKVBlock", "init_block", "init_block_cache"]


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class Attention(nn.Module):
    """Attention weights with explicit head axes: wq (d, H, hd), wk and wv
    (d, KV, hd), wo (H, hd, d), and with ``bias`` bq (H, hd), bk and bv
    (KV, hd)."""

    def __init__(self, cfg: ModelConfig, dtype, device, bias: bool = False):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        H, KV = cfg.num_heads, cfg.num_kv_heads
        self.wq = _param((d, H, hd), dtype, device)
        self.wk = _param((d, KV, hd), dtype, device)
        self.wv = _param((d, KV, hd), dtype, device)
        self.wo = _param((H, hd, d), dtype, device)
        if bias:
            self.bq = _param((H, hd), dtype, device)
            self.bk = _param((KV, hd), dtype, device)
            self.bv = _param((KV, hd), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        for name in ("wq", "wk", "wv"):
            w = getattr(self, name)
            d, h, k = w.shape
            w.copy_(init_dense(generator, (d, h * k), w.dtype).reshape(d, h, k))
        H, hd, d = self.wo.shape
        self.wo.copy_(init_dense(generator, (H * hd, d), self.wo.dtype)
                      .reshape(H, hd, d))
        for name in ("bq", "bk", "bv"):
            if hasattr(self, name):
                getattr(self, name).zero_()


class MLP(nn.Module):
    """w_up (d, ff), w_down (ff, d) and, for a gated MLP, w_gate (d, ff)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.w_up = _param((d, ff), dtype, device)
        self.w_down = _param((ff, d), dtype, device)
        if cfg.gated_mlp:
            self.w_gate = _param((d, ff), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        ff = self.w_down.shape[0]
        for name, w in self.named_parameters():
            scale = ff ** -0.5 if name == "w_down" else None
            w.copy_(init_dense(generator, tuple(w.shape), w.dtype, scale))

    def forward(self, x):
        return gated_mlp(x, dict(self.named_parameters()))


def _attention_tr(x, p: Attention, cfg: ModelConfig, window, theta,
                  positions, causal=True, mrope_positions=None):
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if cfg.mrope_sections is not None and mrope_positions is not None:
        q = mrope(q, mrope_positions, cfg.mrope_sections, cfg.rope_theta)
        k = mrope(k, mrope_positions, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    kv_cache = (k, v)
    # GQA -> MHA for the attention compute, as the reference does
    G = cfg.num_heads // cfg.num_kv_heads
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "heads", None)
    v = constrain(v, "batch", None, "heads", None)
    out = shard_local(attn_mod.streaming_attention, q, k, v, window=window,
                      causal=causal, attn_softcap=cfg.attn_softcap)
    out = constrain(out, "batch", None, "heads", None)
    return torch.einsum("bshk,hkd->bsd", out, p.wo), kv_cache


def _cross_attention_tr(x, p: Attention, cfg: ModelConfig, enc_out):
    """Cross-attention against the encoder output (B, Se, d); K/V are
    computed with this layer's projections."""
    k_enc = torch.einsum("bsd,dhk->bshk", enc_out, p.wk)
    v_enc = torch.einsum("bsd,dhk->bshk", enc_out, p.wv)
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    G = cfg.num_heads // cfg.num_kv_heads
    if G > 1:
        k_enc = torch.repeat_interleave(k_enc, G, dim=2)
        v_enc = torch.repeat_interleave(v_enc, G, dim=2)
    q = constrain(q, "batch", None, "heads", None)
    k_enc = constrain(k_enc, "batch", None, "heads", None)
    v_enc = constrain(v_enc, "batch", None, "heads", None)
    out = shard_local(attn_mod.streaming_attention, q, k_enc, v_enc,
                      window=-1, causal=False, attn_softcap=cfg.attn_softcap)
    out = constrain(out, "batch", None, "heads", None)
    return torch.einsum("bshk,hkd->bsd", out, p.wo)


class _Block(nn.Module):
    """Pre-norm residual block: ln1 and ln2 (d,) and the sub-block's
    kind, window and rope theta."""

    def __init__(self, cfg: ModelConfig, sub: SubBlock, dtype, device):
        super().__init__()
        self.cfg, self.sub = cfg, sub
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.ln2 = _param((cfg.d_model,), dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        for name, w in self.named_parameters(recurse=False):
            w.zero_()  # residual-from-1 norms
        for child in self.children():
            child.reset_parameters(generator)

    def _zero_aux(self, x):
        return torch.zeros((), dtype=torch.float32, device=x.device)


class AttnBlock(_Block):
    """GQA attention (global or sliding-window) + dense MLP or MoE."""

    def __init__(self, cfg: ModelConfig, sub: SubBlock, dtype, device):
        super().__init__(cfg, sub, dtype, device)
        self.attn = Attention(cfg, dtype, device, bias=cfg.qkv_bias)
        if sub.moe:
            self.moe = moe_mod.MoE(cfg.d_model, cfg.moe_d_ff,
                                   cfg.num_experts, dtype, device)
        else:
            self.mlp = MLP(cfg, dtype, device)

    def _cross(self, x, enc_out):
        return x

    def _cross_decode(self, x, cache):
        return x

    def _ffn(self, x):
        h_in = rms_norm(x, self.ln2)
        if self.sub.moe:
            return moe_mod.moe_mlp(
                h_in, self.moe, top_k=self.cfg.num_experts_per_tok,
                capacity_factor=self.cfg.capacity_factor)
        return self.mlp(h_in), self._zero_aux(x)

    def forward(self, x, *, positions, causal=True, enc_out=None,
                mrope_positions=None):
        """One layer, full-sequence.  Returns (x, aux_loss, (k, v)): the
        layer's full-sequence K/V after rope."""
        h, kv = _attention_tr(rms_norm(x, self.ln1), self.attn, self.cfg,
                              self.sub.window, self.sub.theta, positions,
                              causal, mrope_positions)
        x = self._cross(x + h, enc_out)
        h, aux = self._ffn(x)
        return x + h, aux, kv

    def decode(self, x, cache, pos: int):
        """One layer, one token.  x: (B, d).  Returns (x, cache)."""
        cfg, p = self.cfg, self.attn
        B = x.shape[0]
        xin = rms_norm(x, self.ln1)
        q = torch.einsum("bd,dhk->bhk", xin, p.wq)
        k = torch.einsum("bd,dhk->bhk", xin, p.wk)
        v = torch.einsum("bd,dhk->bhk", xin, p.wv)
        if cfg.qkv_bias:
            q, k, v = q + p.bq, k + p.bk, v + p.bv
        posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q = rope(q[:, None], posv, self.sub.theta)[:, 0]
        k = rope(k[:, None], posv, self.sub.theta)[:, 0]
        slot = pos % cache["k"].shape[1]
        cache["k"][:, slot] = k.to(cache["k"].dtype)
        cache["v"][:, slot] = v.to(cache["v"].dtype)
        cache["slot_pos"][slot] = pos
        out = attn_mod.decode_attention(
            q, cache["k"], cache["v"], cache["slot_pos"], pos,
            window=self.sub.window, attn_softcap=cfg.attn_softcap)
        x = x + torch.einsum("bhk,hkd->bd", out, p.wo)
        x = self._cross_decode(x, cache)
        h, _aux = self._ffn(x)
        return x + h, cache


class XAttnBlock(AttnBlock):
    """Decoder block of an encoder-decoder model: self-attention, then
    cross-attention to the encoder output (ln_x, xattn), then the MLP."""

    def __init__(self, cfg: ModelConfig, sub: SubBlock, dtype, device):
        super().__init__(cfg, sub, dtype, device)
        self.xattn = Attention(cfg, dtype, device)
        self.ln_x = _param((cfg.d_model,), dtype, device)

    def _cross(self, x, enc_out):
        return x + _cross_attention_tr(rms_norm(x, self.ln_x), self.xattn,
                                       self.cfg, enc_out)

    def _cross_decode(self, x, cache):
        """Attend to the encoder K/V held in the cache (``xk``, ``xv``)."""
        qx = torch.einsum("bd,dhk->bhk", rms_norm(x, self.ln_x),
                          self.xattn.wq)[:, None]
        out = attn_mod.streaming_attention(
            qx, cache["xk"], cache["xv"], window=-1, causal=False,
            attn_softcap=self.cfg.attn_softcap)
        return x + torch.einsum("bhk,hkd->bd", out[:, 0], self.xattn.wo)


class RGLRUBlock(_Block):
    """RG-LRU mixer (rec) + dense MLP."""

    def __init__(self, cfg: ModelConfig, sub: SubBlock, dtype, device):
        super().__init__(cfg, sub, dtype, device)
        self.rec = rglru_mod.RGLRU(cfg.d_model, cfg.rnn_width or cfg.d_model,
                                   cfg.conv_width, dtype, device)
        self.mlp = MLP(cfg, dtype, device)

    def forward(self, x, *, positions=None, causal=True, enc_out=None,
                mrope_positions=None):
        """Returns (x, aux_loss, {"h": final state, "conv": the last
        conv_width - 1 inputs of the conv})."""
        rec, K = self.rec, self.cfg.conv_width
        xin = rms_norm(x, self.ln1)
        gate = gelu(xin @ rec.w_gate)
        u_raw = xin @ rec.w_x
        u = rglru_mod.temporal_conv(u_raw, rec.conv_w)
        u, h_fin = rglru_mod.rglru_scan(u, rec)
        x = x + (gate * u) @ rec.w_out
        x = x + self.mlp(rms_norm(x, self.ln2))
        padded = torch.cat([u_raw.new_zeros((u_raw.shape[0], K - 1,
                                             u_raw.shape[2])), u_raw], 1)
        conv_tail = padded[:, padded.shape[1] - (K - 1):]
        return x, self._zero_aux(x), {"h": h_fin, "conv": conv_tail}

    def decode(self, x, cache, pos: int):
        rec = self.rec
        xin = rms_norm(x, self.ln1)
        gate = gelu(xin @ rec.w_gate)
        u = xin @ rec.w_x
        u, conv_state = rglru_mod.conv_step(u, cache["conv"], rec.conv_w)
        u, h_state = rglru_mod.rglru_step(u, cache["h"], rec)
        x = x + (gate * u) @ rec.w_out
        x = x + self.mlp(rms_norm(x, self.ln2))
        return x, {"h": h_state, "conv": conv_state}


class RWKVBlock(_Block):
    """RWKV-6 time-mix (tm) + channel-mix (cm)."""

    def __init__(self, cfg: ModelConfig, sub: SubBlock, dtype, device):
        super().__init__(cfg, sub, dtype, device)
        self.tm = rwkv_mod.TimeMix(cfg.d_model, cfg.rwkv_head_dim, dtype,
                                   device)
        self.cm = rwkv_mod.ChannelMix(cfg.d_model, cfg.d_ff, dtype, device)

    def forward(self, x, *, positions=None, causal=True, enc_out=None,
                mrope_positions=None):
        """Returns (x, aux_loss, {"S", "x_tm", "x_cm"})."""
        B, S, d = x.shape
        h, S_fin, x_tm = rwkv_mod.timemix_scan(
            rms_norm(x, self.ln1), x.new_zeros((B, d)), self.tm,
            self.cfg.rwkv_head_dim)
        x = x + h
        h, x_cm = rwkv_mod.channelmix(rms_norm(x, self.ln2),
                                      x.new_zeros((B, d)), self.cm)
        return (x + h, self._zero_aux(x),
                {"S": S_fin, "x_tm": x_tm, "x_cm": x_cm})

    def decode(self, x, cache, pos: int):
        h, (S_new, x_tm) = rwkv_mod.timemix_step(
            rms_norm(x, self.ln1), (cache["S"], cache["x_tm"]), self.tm,
            self.cfg.rwkv_head_dim)
        x = x + h
        h, x_cm = rwkv_mod.channelmix_step(rms_norm(x, self.ln2),
                                           cache["x_cm"], self.cm)
        return x + h, {"S": S_new, "x_tm": x_tm, "x_cm": x_cm}


_KINDS = {"attn": AttnBlock, "xattn": XAttnBlock, "rglru": RGLRUBlock,
          "rwkv": RWKVBlock}


def init_block(cfg: ModelConfig, sub: SubBlock, dtype, device) -> _Block:
    """The module of ``sub.kind`` with uninitialized parameters (call its
    ``reset_parameters(generator)`` or load weights)."""
    if sub.kind not in _KINDS:
        raise ValueError(sub.kind)
    return _KINDS[sub.kind](cfg, sub, dtype, device)


def init_block_cache(cfg: ModelConfig, kind: str, batch: int,
                     cache_len: int, dtype, device) -> dict:
    """One layer's empty decode state."""
    hd, kv = cfg.head_dim, cfg.num_kv_heads
    if kind in ("attn", "xattn"):
        return {
            "k": torch.zeros((batch, cache_len, kv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, cache_len, kv, hd), dtype=dtype,
                             device=device),
            "slot_pos": attn_mod.init_cache_positions(cache_len, device),
        }
    if kind == "rglru":
        w = cfg.rnn_width or cfg.d_model
        return {
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device),
        }
    if kind == "rwkv":
        d = cfg.d_model
        H = d // cfg.rwkv_head_dim
        N = cfg.rwkv_head_dim
        return {
            "S": torch.zeros((batch, H, N, N), dtype=torch.float32,
                             device=device),
            "x_tm": torch.zeros((batch, d), dtype=dtype, device=device),
            "x_cm": torch.zeros((batch, d), dtype=dtype, device=device),
        }
    raise ValueError(kind)
