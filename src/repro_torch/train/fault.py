"""Fault tolerance: the resilient training loop.

Ported from ``repro.train.fault``, with the same behaviour:

* **Checkpoint/restart**: every step is deterministic given (params, step)
  (the data pipeline regenerates batch ``k`` from the step index), so
  restoring the latest checkpoint resumes the exact trajectory.  The port's
  step updates the model and state in place, so a resume reads the
  checkpoint into them (``checkpoint.load``).
* **Straggler mitigation**: a watchdog times each step against a rolling
  deadline (median of the last 20 steps x ``straggler_factor``, once
  ``min_history`` steps are in); overruns are counted and surfaced so the
  cluster layer can re-dispatch.  On a real fleet the per-step barrier
  makes the slowest host the step time, which is exactly what the
  TL-Rightsizing planner's per-job demand margins absorb.
* **Restore elsewhere**: checkpoints are host bytes, so
  ``checkpoint.restore`` may place them on another device.
* **Crash injection**: ``FaultInjector`` raises at configured steps to
  exercise the restart path in tests.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable

from . import checkpoint as ckpt_mod

__all__ = ["LoopConfig", "FaultInjector", "train_loop", "run_with_restarts"]


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 10
    keep: int = 3
    straggler_factor: float = 3.0
    min_history: int = 5


class FaultInjector:
    """Deterministically crash at given global steps (once each)."""

    def __init__(self, crash_at: tuple[int, ...] = ()):
        self.crash_at = set(crash_at)

    def maybe_crash(self, step: int):
        if step in self.crash_at:
            self.crash_at.discard(step)
            raise RuntimeError(f"injected fault at step {step}")


def train_loop(
    step_fn: Callable,
    params,
    state,
    batch_at: Callable[[int], Any],
    lc: LoopConfig,
    injector: FaultInjector | None = None,
    on_metrics: Callable[[int, dict], None] | None = None,
):
    """Run (or resume) training to ``lc.total_steps``.  ``step_fn(state,
    batch) -> (state, metrics)`` updates ``params`` (the model it was made
    for) and ``state`` in place; a checkpoint holds both.

    Returns (params, state, history) where history records per-step wall
    time, loss, straggler flags and restart events, as the reference's, and
    beside them each step's grad norm and the checkpoints committed
    ("checkpoints": step, bytes, snapshot and commit seconds).
    """
    ckpt = ckpt_mod.Checkpointer(lc.ckpt_dir, keep=lc.keep)
    history: dict[str, list] = {"loss": [], "wall_s": [], "straggler": [],
                                "grad_norm": [], "restarts": 0,
                                "start_step": 0, "checkpoints": ckpt.records}

    try:
        # resume from the latest checkpoint if one exists
        start = ckpt_mod.latest_step(lc.ckpt_dir)
        step0 = 0
        if start is not None:
            ckpt_mod.load(lc.ckpt_dir, (params, state), step=start)
            step0 = start
            history["start_step"] = step0

        times: list[float] = []
        step = step0
        while step < lc.total_steps:
            t0 = time.perf_counter()  # includes data fetch: stalls straggle
            batch = batch_at(step)
            if injector is not None:
                injector.maybe_crash(step)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the device
            dt = time.perf_counter() - t0
            straggle = False
            if len(times) >= lc.min_history:
                deadline = statistics.median(times[-20:]) * lc.straggler_factor
                straggle = dt > deadline
            times.append(dt)
            history["loss"].append(loss)
            history["wall_s"].append(dt)
            history["straggler"].append(straggle)
            history["grad_norm"].append(float(metrics["grad_norm"]))
            if on_metrics:
                on_metrics(step, metrics)
            step += 1
            if step % lc.ckpt_every == 0 or step == lc.total_steps:
                ckpt.save_async((params, state), step)
    finally:
        ckpt.close()
    return params, state, history


def run_with_restarts(make_loop_args, lc: LoopConfig,
                      injector: FaultInjector, max_restarts: int = 5):
    """Driver that supervises train_loop across injected crashes: on
    failure, reconstructs fresh (step_fn, params, state, batch_at) and
    re-enters the loop, which resumes from the last checkpoint."""
    restarts = 0
    while True:
        step_fn, params, state, batch_at = make_loop_args()
        try:
            params, state, history = train_loop(
                step_fn, params, state, batch_at, lc, injector=injector)
            history["restarts"] = restarts
            return params, state, history
        except RuntimeError as e:
            if "injected fault" not in str(e) or restarts >= max_restarts:
                raise
            restarts += 1
