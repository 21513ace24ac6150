"""End-to-end training driver.

    python -m repro_torch.launch.train --arch qwen2.5-3b --preset smoke \\
        --steps 200 --ckpt-dir /tmp/ckpt [--device cpu]

Ported from ``repro.launch.train`` with the same flags, defaults and printed
lines, plus ``--device`` and ``--layers`` (keep the first N layers, widths
unchanged: a depth cut that fits a full-width model and its optimizer state
on one card): the model trains on the CUDA card unless given
``--device cpu``, and without a card the command raises.  Weights are a
random init from a seeded ``torch.Generator`` on the device, as the
reference trains from ``init_params(PRNGKey(0), cfg)``; batches are the
synthetic token streams of ``train.make_batch``.  The path is eager
PyTorch with autograd.

Presets:
  smoke  — the arch's reduced config (seconds/step on CPU)
  100m   — a ~100M-param dense config (the end-to-end example target)
  full   — the assigned config

The loop is the fault-tolerant one (checkpoint/restart, straggler
detection); run it twice with the same --ckpt-dir and it resumes.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs import get_config, smoke_config
from ..device import resolve_device
from ..models import ModelConfig, init_params
from ..train import (
    AdamWConfig,
    DataConfig,
    TrainConfig,
    init_train_state,
    make_batch,
    make_train_step,
)
from ..train.fault import FaultInjector, LoopConfig, train_loop

__all__ = ["model_100m", "pick_config", "cut_depth", "run"]


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


def cut_depth(cfg: ModelConfig, layers: int) -> ModelConfig:
    """``cfg`` with its first ``layers`` layers (whole scan units)."""
    unit = max(cfg.scan_unit, 1)
    if not 0 < layers <= cfg.num_layers or layers % unit:
        raise ValueError(f"--layers {layers}: need a multiple of the scan "
                         f"unit {unit} in [1, {cfg.num_layers}]")
    return dataclasses.replace(cfg, num_layers=layers,
                               pattern=cfg.pattern[:layers])


def run(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--preset", choices=["smoke", "100m", "full"],
                    default="smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--crash-at", type=int, default=None,
                    help="inject a fault at this step (restart demo)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "on the host)")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the first N layers of the config (a depth "
                         "cut; every width unchanged)")
    args = ap.parse_args(argv)

    cfg = pick_config(args.arch, args.preset)
    if args.layers is not None:
        cfg = cut_depth(cfg, args.layers)
    dev = resolve_device(args.device)
    print(f"config: {cfg.name}  params~{cfg.param_count()/1e6:.1f}M")
    tc = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=20),
        remat=True, microbatch=args.microbatch,
        loss_chunk=min(256, args.seq),
        compress_grads=args.compress_grads)
    dc = DataConfig(batch=args.batch, seq_len=args.seq)

    model = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    state = init_train_state(model, tc)
    step_fn = make_train_step(model, tc)

    lc = LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every)
    injector = FaultInjector((args.crash_at,) if args.crash_at else ())

    losses = []

    def on_metrics(step, metrics):
        losses.append(float(metrics["loss"]))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)

    t0 = time.perf_counter()
    model, state, hist = train_loop(
        step_fn, model, state, lambda s: make_batch(cfg, dc, s), lc,
        injector=injector, on_metrics=on_metrics)
    wall = time.perf_counter() - t0
    n = len(hist["loss"])
    print(f"done: {n} steps in {wall:.1f}s "
          f"({wall/max(n,1):.2f}s/step); "
          f"loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}; "
          f"stragglers={sum(hist['straggler'])} "
          f"resumed_from={hist['start_step']}")
    return model, state, hist


if __name__ == "__main__":
    run()
