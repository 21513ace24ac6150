"""The port's checkpoints, fault-tolerant loop and training CLI on the CPU
(``repro_torch.train.checkpoint``, ``train.fault``, ``launch.train``), at
the reference test's setup (``tests/test_train.py``: qwen2.5-3b's smoke
config, lr 1e-3, warmup 5, B = 4, S = 32, loss chunk 64).

* Checkpoints: a round trip bit-equal, bfloat16 leaves and the step count
  included; keep-k GC; a stray ``.tmp`` file ignored by ``latest_step``; a
  restore onto another device than the tree it is shaped like; a mismatched
  tree refused.
* Restart exactness: ``run_with_restarts`` with faults at steps 7 and 13
  ends within rtol 1e-6 / atol 1e-7 of a clean 20-step run (the reference
  test's bound; read: bit-equal).  Straggler detection flags a step slowed
  by 1 s, and no other.
* ``python -m repro_torch.launch.train --preset smoke --device cpu`` prints
  the reference's lines (its config line, step lines every 10 steps and at
  the last, the done line) and, after ``--crash-at``, resumes from the last
  checkpoint.
"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro_torch.configs import smoke_config
from repro_torch.models import Model, init_params
from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                               checkpoint, init_train_state, make_batch,
                               make_train_step)
from repro_torch.train.fault import (FaultInjector, LoopConfig,
                                     run_with_restarts, train_loop)

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def setup_tiny(dtype="float32", compress=False):
    cfg = dataclasses.replace(smoke_config("qwen2.5-3b"), dtype=dtype)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=5),
                     remat=True, loss_chunk=64, compress_grads=compress)
    model = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    state = init_train_state(model, tc)
    return cfg, model, state, make_train_step(model, tc), \
        DataConfig(batch=4, seq_len=32)


def _pairs(a, b):
    la, lb = list(checkpoint._leaves(a)), list(checkpoint._leaves(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    return [(k, x, y) for (k, x), (_k, y) in zip(la, lb)]


def _bit_equal(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x.detach().cpu(),
                                                  y.detach().cpu())
               for _k, x, y in _pairs(a, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_restore_roundtrip(tmp_path, dtype):
    cfg, model, state, step, dc = setup_tiny(dtype, compress=True)
    for i in range(2):
        state, _m = step(state, make_batch(cfg, dc, i))
    checkpoint.save(str(tmp_path), (model, state), step=7)
    (m2, s2), got = checkpoint.restore(str(tmp_path), (model, state),
                                       device="cpu")
    assert got == 7 and isinstance(m2, Model) and m2 is not model
    assert _bit_equal((model, state), (m2, s2))
    assert int(s2["opt"]["step"]) == 2
    assert {p.dtype for p in m2.parameters()} == {getattr(torch, dtype)}


def test_load_in_place_and_refusals(tmp_path):
    cfg, model, state, step, dc = setup_tiny("bfloat16")
    state, _m = step(state, make_batch(cfg, dc, 0))
    checkpoint.save(str(tmp_path), (model, state), step=1)
    _c, fresh, fresh_state, _s, _d = setup_tiny("bfloat16")
    assert not _bit_equal(model, fresh)
    assert checkpoint.load(str(tmp_path), (fresh, fresh_state)) == 1
    assert _bit_equal((model, state), (fresh, fresh_state))
    with pytest.raises(ValueError, match="leaf 0/embed"):
        checkpoint.load(str(tmp_path), ({"embed": torch.zeros(3)},), 1)
    with pytest.raises(KeyError, match="missing leaf 2"):
        checkpoint.load(str(tmp_path), (model, state, torch.zeros(1)), 1)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), model, device="cpu")


def test_restore_onto_another_device(tmp_path):
    """The tree to restore into is shaped on the meta device (no memory);
    the restore places it on the CPU."""
    cfg, model, state, _step, _dc = setup_tiny("bfloat16")
    checkpoint.save(str(tmp_path), {"model": model, "state": state}, 3)
    with torch.device("meta"):
        like = {"model": Model(cfg, "meta"),
                "state": init_train_state(Model(cfg, "meta"), TrainConfig())}
    got, step = checkpoint.restore(str(tmp_path), like, device="cpu")
    assert step == 3 and got["model"].device.type == "cpu"
    assert _bit_equal({"model": model, "state": state}, got)


def test_keep_k_gc_and_stray_tmp(tmp_path):
    cfg, model, state, _step, _dc = setup_tiny()
    (tmp_path / "step_9.ckpt.tmp").write_bytes(b"partial")
    ck = checkpoint.Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save_async(model, s)
    ck.close()
    assert sorted(os.listdir(tmp_path)) == ["step_3.ckpt", "step_4.ckpt",
                                           "step_9.ckpt.tmp"]
    assert checkpoint.latest_step(str(tmp_path)) == 4
    assert [r["step"] for r in ck.records] == [1, 2, 3, 4]
    assert all(r["bytes"] == os.path.getsize(tmp_path / "step_4.ckpt")
               for r in ck.records)


def test_restart_resumes_exact_trajectory(tmp_path):
    """Crash mid-run; supervised restarts converge to the same final
    parameters as an uninterrupted run."""
    def make_args():
        cfg, model, state, step, dc = setup_tiny()
        return step, model, state, (lambda s: make_batch(cfg, dc, s))

    lc_a = LoopConfig(total_steps=20, ckpt_dir=str(tmp_path / "a"),
                      ckpt_every=5)
    m_clean, _s, hist_clean = run_with_restarts(make_args, lc_a,
                                                FaultInjector(()))
    lc_b = LoopConfig(total_steps=20, ckpt_dir=str(tmp_path / "b"),
                      ckpt_every=5)
    m_crashy, _s, hist = run_with_restarts(make_args, lc_b,
                                           FaultInjector((7, 13)))
    assert hist["restarts"] == 2 and hist["start_step"] == 10
    assert hist_clean["restarts"] == 0 and len(hist_clean["loss"]) == 20
    for (a, b) in zip(m_clean.parameters(), m_crashy.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
    assert _bit_equal(m_clean, m_crashy)
    assert hist["loss"] == hist_clean["loss"][10:]


def test_straggler_detection(tmp_path, monkeypatch):
    """Step 17's data takes 1 s more on a clock that moves 0.05 s between
    readings: only that step passes the deadline (3x the median).  A fake
    clock, since the host's own step times vary more than 3x under load."""
    from repro_torch.train import fault

    cfg, model, state, step, dc = setup_tiny()
    clock = [0.0]

    def tick():
        clock[0] += 0.05
        return clock[0]

    def batch_at(s):
        if s == 17:
            clock[0] += 1.0
        return make_batch(cfg, dc, s)

    monkeypatch.setattr(fault.time, "perf_counter", tick)
    lc = LoopConfig(total_steps=20, ckpt_dir=str(tmp_path), ckpt_every=50,
                    straggler_factor=3.0)
    _m, _s, hist = train_loop(step, model, state, batch_at, lc)
    assert hist["straggler"] == [s == 17 for s in range(20)]
    assert [r["step"] for r in hist["checkpoints"]] == [20]


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--preset",
         "smoke", "--device", "cpu", *args], capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": SRC})


def test_cli_prints_the_reference_lines_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    common = ["--steps", "22", "--ckpt-every", "5", "--ckpt-dir", ck]
    crashed = _cli(*common, "--crash-at", "12")
    assert crashed.returncode != 0
    assert "RuntimeError: injected fault at step 12" in crashed.stderr
    resumed = _cli(*common)
    assert resumed.returncode == 0, resumed.stderr
    cfg = ref_smoke_config("qwen2.5-3b")  # the reference's config line
    head = f"config: {cfg.name}  params~{cfg.param_count()/1e6:.1f}M"
    step_re = r"step +(\d+)  loss \d+\.\d{4}  gnorm \d+\.\d{3}"
    lines = crashed.stdout.splitlines()
    assert lines[0] == head
    assert [re.fullmatch(step_re, ln).group(1) for ln in lines[1:]] == \
        ["0", "10"]
    lines = resumed.stdout.splitlines()
    assert lines[0] == head
    assert [re.fullmatch(step_re, ln).group(1) for ln in lines[1:-1]] == \
        ["10", "20", "21"]
    assert re.fullmatch(
        r"done: 12 steps in \d+\.\ds \(\d+\.\d\ds/step\); loss \d+\.\d{3} "
        r"-> \d+\.\d{3}; stragglers=\d+ resumed_from=10", lines[-1]), lines
    # the crashed run's step 10 and the resumed run's step 10 agree
    assert crashed.stdout.splitlines()[2] == lines[1]


@pytest.mark.parametrize("arch,layers", [("rwkv6-7b", 8),
                                         ("recurrentgemma-9b", 6)])
def test_layers_cuts_depth_only(arch, layers):
    """``--layers`` keeps the config's first layers (whole scan units) and
    every width; a cut that splits a unit or exceeds the depth raises."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import cut_depth

    cfg = get_config(arch)
    cut = cut_depth(cfg, layers)
    assert cut.num_layers == layers and cut.pattern == cfg.pattern[:layers]
    assert dataclasses.replace(cut, num_layers=cfg.num_layers,
                               pattern=cfg.pattern) == cfg
    for bad in (0, cfg.num_layers + 3, 1 if cfg.scan_unit > 1 else -1):
        with pytest.raises(ValueError, match="--layers"):
            cut_depth(cfg, bad)


def test_cli_layers_trains_the_cut_model(tmp_path):
    out = _cli("--arch", "recurrentgemma-9b", "--layers", "3", "--steps",
               "2", "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].startswith("done: 2 steps")
