"""Batched serving driver: prefill a batch of prompts, then decode.

    python -m repro_torch.launch.serve --arch gemma2-9b --preset smoke \\
        --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Ported from ``repro.launch.serve`` with the same flags, defaults and printed
lines, plus ``--device``: the model runs on the CUDA card unless given
``--device cpu``, and without a card the command raises.  Weights are a
random init from a seeded ``torch.Generator`` on the device, as the
reference serves from ``init_params(PRNGKey(0), cfg)``; the prompt and any
sampling draw from the same generator.  The path is eager PyTorch.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..device import resolve_device
from ..models import ModelConfig, decode_step, init_params, prefill
from .train import pick_config

__all__ = ["make_batch", "generate", "run"]


def make_batch(cfg: ModelConfig, batch: int, prompt_len: int,
               generator: torch.Generator) -> dict:
    """Random prompt tokens (batch, prompt_len) on the generator's device,
    with the stub frontends' inputs the config needs: frame embeddings
    (encoder-decoder), patch embeddings and 3-axis positions (VLM)."""
    dev = generator.device
    B, S = batch, prompt_len
    out = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                   generator=generator, device=dev)}
    if cfg.encoder_layers:
        out["frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                    generator=generator, device=dev)
    if cfg.vision_seq:
        out["vision"] = torch.randn((B, cfg.vision_seq, cfg.d_model),
                                    generator=generator, device=dev)
        out["mrope_positions"] = torch.arange(
            S, dtype=torch.int32, device=dev)[None, None, :].expand(3, B, S)
    return out


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(model, batch: dict, gen: int, temperature: float = 0.0,
             generator: torch.Generator | None = None):
    """Prefill ``batch`` then decode ``gen - 1`` more tokens (greedy, or
    sampled at ``temperature`` from ``generator``).

    Returns (ids (B, gen), info): info holds ``prefill_s`` and ``decode_s``
    (host seconds, each ending in a device synchronize), ``steps`` and
    ``finite``, whether every logit of every step was finite.
    """
    dev = model.device
    B, S = batch["tokens"].shape
    _sync(dev)
    t0 = time.perf_counter()
    logits, state = prefill(model, batch, max_len=S + gen)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    finite = torch.isfinite(logits).all()
    tokens = torch.argmax(logits, dim=-1)
    generated = [tokens]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, state = decode_step(model, state, tokens)
        finite &= torch.isfinite(logits).all()
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            tokens = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            tokens = torch.argmax(logits, dim=-1)
        generated.append(tokens)
    _sync(dev)
    t_dec = time.perf_counter() - t0
    return torch.stack(generated, dim=1), {
        "prefill_s": t_prefill, "decode_s": t_dec, "steps": gen - 1,
        "finite": bool(finite)}


def run(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--preset", choices=["smoke", "100m", "full"],
                    default="smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "on the host)")
    args = ap.parse_args(argv)

    cfg = pick_config(args.arch, args.preset)
    dev = resolve_device(args.device)
    generator = torch.Generator(device=dev).manual_seed(0)
    model = init_params(generator, cfg, dev)
    B, S = args.batch, args.prompt_len
    batch = make_batch(cfg, B, S, generator)

    out, info = generate(model, batch, args.gen, args.temperature, generator)
    t_prefill, t_dec, steps = info["prefill_s"], info["decode_s"], \
        info["steps"]
    print(f"prefill: batch={B} len={S}  {t_prefill:.2f}s "
          f"({B*S/t_prefill:.0f} tok/s)")
    print(f"decode: {steps} steps  {t_dec:.2f}s "
          f"({B*steps/max(t_dec,1e-9):.0f} tok/s, "
          f"{t_dec/max(steps,1)*1000:.0f} ms/step)")
    print("generated token ids (first row):", out[0].tolist())
    return out


if __name__ == "__main__":
    run()
