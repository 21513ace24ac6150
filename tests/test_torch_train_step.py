"""The port's train step (``repro_torch.train.make_train_step``) against the
JAX package's on the CPU, at the reference test's setup
(``tests/test_train.py``: qwen2.5-3b's smoke config, lr 1e-3, warmup 5,
B = 4, S = 32, loss chunk 64, remat on), in float32.

* Five steps from the same weights and batches: each step's loss, xent,
  aux, lr and grad norm within 1e-5 abs of the reference's (read: 1e-6);
  with int8 gradient compression the grad norm within rtol 1e-4 (read
  7e-6: gradients a last place apart can round a quantization tie the other
  way, which moves that entry by a whole quantum);
  parameters are not held elementwise across frameworks (Adam moves a
  near-zero gradient's parameter by up to 2 lr whichever way it rounds).
* Microbatch 4 against microbatch 1 (the parameters after one step within
  5e-5, the reference test's bound), and against the reference's microbatch
  4 step (loss within 1e-5, parameters within 5e-5).  The reference's
  microbatch path raises on a config with M-RoPE positions (a transpose of
  four axes on its (3, B, S) array; ROADMAP Queue 3 item 7), so on
  qwen2-vl-2b the port is held against the reference's accumulation
  written out: ``jax.value_and_grad`` of its ``loss_fn`` on each contiguous
  quarter, summed in float32, averaged, then its ``adamw_update``.
* Gradient dtypes: the parameters' with microbatch 1, float32 means with
  more; ``.grad`` is never written.
* Learning: 30 steps lower the loss by more than 0.2 (mean of the last 5
  against the first 5), plain and with int8 gradient compression.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import configs, max_diff, numpy_tree, reference_model, to_jax
import repro.train as R
import repro_torch.train as P
from repro.models import loss_fn as ref_loss_fn
from repro_torch.convert import named_from_reference, \
    train_state_from_reference
from repro_torch.configs import smoke_config
from repro_torch.models import init_params
from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig,
                               init_train_state, make_batch, make_serve_steps,
                               make_train_step)

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOSS_ATOL = 1e-5
GN_RTOL_COMPRESSED = 1e-4
MB_ATOL = 5e-5
DC = dict(batch=4, seq_len=32)


def _tc(pkg, microbatch=1, compress=False):
    return pkg.TrainConfig(
        optimizer=pkg.AdamWConfig(lr=1e-3, warmup_steps=5), remat=True,
        microbatch=microbatch, loss_chunk=64, compress_grads=compress)


def _params_diff(model, ref_params, cfg) -> float:
    ref = named_from_reference(numpy_tree(ref_params), cfg, "cpu")
    return max(max_diff(ref[n], p) for n, p in model.named_parameters())


@pytest.mark.parametrize("compress", [False, True])
def test_five_steps_match_the_reference_losses(compress):
    rcfg, tcfg = configs("qwen2.5-3b")
    params, model = reference_model(rcfg, tcfg)
    r_state = R.init_train_state(params, _tc(R, compress=compress))
    r_step = jax.jit(R.make_train_step(rcfg, _tc(R, compress=compress)))
    tc = _tc(P, compress=compress)
    state, step = init_train_state(model, tc), make_train_step(model, tc)
    assert ("err" in state) == compress
    for i in range(5):
        params, r_state, r_m = r_step(params, r_state,
                                      R.make_batch(rcfg, R.DataConfig(**DC),
                                                   i))
        state, m = step(state, make_batch(tcfg, DataConfig(**DC), i))
        assert r_m.keys() == m.keys() == {"loss", "xent", "aux",
                                          "grad_norm", "lr"}
        for key in r_m:
            tol = GN_RTOL_COMPRESSED * float(r_m[key]) if compress and \
                key == "grad_norm" else LOSS_ATOL
            assert abs(float(r_m[key]) - float(m[key])) < tol, (i, key)
        assert int(state["opt"]["step"]) == i + 1


def _mb_step(model, batch, microbatch):
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=5),
                     remat=True, microbatch=microbatch, loss_chunk=64)
    state, m = make_train_step(model, tc)(init_train_state(model, tc), batch)
    return m


def test_microbatch_matches_full_batch_and_the_reference():
    rcfg, tcfg = configs("qwen2.5-3b")
    params, m1 = reference_model(rcfg, tcfg)
    _p, m4 = reference_model(rcfg, tcfg)
    batch = make_batch(tcfg, DataConfig(**DC), 0)
    met1, met4 = _mb_step(m1, batch, 1), _mb_step(m4, batch, 4)
    assert set(met4) == {"loss", "xent", "grad_norm", "lr"}
    assert abs(float(met1["loss"]) - float(met4["loss"])) < LOSS_ATOL
    p1 = dict(m1.named_parameters())
    assert max(max_diff(p1[n], p) for n, p in m4.named_parameters()) \
        < MB_ATOL
    r_step = jax.jit(R.make_train_step(rcfg, _tc(R, microbatch=4)))
    r_params, _s, r_met = r_step(params, R.init_train_state(
        params, _tc(R, microbatch=4)), batch)
    assert abs(float(r_met["loss"]) - float(met4["loss"])) < LOSS_ATOL
    assert _params_diff(m4, r_params, tcfg) < MB_ATOL


def test_reference_microbatch_raises_on_mrope_positions():
    rcfg, _t = configs("qwen2-vl-2b")
    params, _m = reference_model(rcfg, _t)
    step = R.make_train_step(rcfg, _tc(R, microbatch=4))
    with pytest.raises(ValueError, match="ax(is|es)"):
        step(params, R.init_train_state(params, _tc(R, microbatch=4)),
             R.make_batch(rcfg, R.DataConfig(**DC), 0))


def test_microbatch_with_mrope_matches_the_references_accumulation():
    rcfg, tcfg = configs("qwen2-vl-2b")
    params, model = reference_model(rcfg, tcfg)
    batch = R.make_batch(rcfg, R.DataConfig(**DC), 0)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: ref_loss_fn(p, rcfg, b, remat=True, loss_chunk=64),
        has_aux=True))
    acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    loss_sum = jnp.zeros(())
    for i in range(4):
        part = {k: (v[:, i:i + 1] if k == "mrope_positions" else v[i:i + 1])
                for k, v in batch.items()}
        (loss, _aux), g = vg(params, to_jax(part))
        acc = jax.tree.map(jnp.add, acc, g)
        loss_sum = loss_sum + loss
    grads = jax.tree.map(lambda g: g * 0.25, acc)
    r_params, _s, _m = R.adamw_update(
        params, grads, R.adamw_init(params, _tc(R).optimizer),
        _tc(R).optimizer)
    met = _mb_step(model, make_batch(tcfg, DataConfig(**DC), 0), 4)
    assert abs(float(loss_sum * 0.25) - float(met["loss"])) < LOSS_ATOL
    assert _params_diff(model, r_params, tcfg) < MB_ATOL


@pytest.mark.parametrize("microbatch", [1, 2])
def test_gradient_dtypes_and_no_grad_attribute(monkeypatch, microbatch):
    from repro_torch.train import train_step as ts

    cfg = dataclasses.replace(smoke_config("qwen2.5-3b"), dtype="bfloat16")
    model = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    seen = {}
    orig = ts.adamw_update

    def spy(params, grads, state, ocfg):
        seen.update({n: g.dtype for n, g in grads.items()})
        return orig(params, grads, state, ocfg)

    monkeypatch.setattr(ts, "adamw_update", spy)
    tc = TrainConfig(microbatch=microbatch, loss_chunk=16)
    step = make_train_step(model, tc)
    step(init_train_state(model, tc), make_batch(cfg, DataConfig(4, 16), 0))
    want = torch.bfloat16 if microbatch == 1 else torch.float32
    assert set(seen.values()) == {want}
    assert all(p.grad is None and p.dtype == torch.bfloat16
               for p in model.parameters())


@pytest.mark.parametrize("compress", [False, True])
def test_loss_decreases(compress):
    cfg = smoke_config("qwen2.5-3b")
    model = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3, warmup_steps=5),
                     remat=True, loss_chunk=64, compress_grads=compress)
    state, step = init_train_state(model, tc), make_train_step(model, tc)
    losses = []
    for i in range(30):
        state, m = step(state, make_batch(cfg, DataConfig(**DC), i))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_train_state_from_reference_carries_every_leaf():
    rcfg, tcfg = configs("whisper-small")
    params, model = reference_model(rcfg, tcfg)
    r_state = R.init_train_state(params, _tc(R, compress=True))
    r_state = jax.tree.map(lambda x: x + 1, r_state)
    got = train_state_from_reference(numpy_tree(r_state), tcfg, "cpu")
    names = {n for n, _ in model.named_parameters()}
    assert set(got["opt"]["m"]) == set(got["opt"]["v"]) == set(got["err"]) \
        == names
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 1
    assert all(bool((t == 1).all()) for t in got["opt"]["m"].values())


def test_serve_steps_wrap_prefill_and_decode():
    cfg = smoke_config("gemma3-1b")
    model = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    prefill_fn, decode_fn = make_serve_steps(model, max_len=10)
    tokens = torch.randint(0, cfg.vocab_size, (2, 6),
                           generator=torch.Generator().manual_seed(1))
    logits, state = prefill_fn({"tokens": tokens})
    logits2, state = decode_fn(state, torch.argmax(logits, -1))
    assert logits2.shape == (2, cfg.vocab_size) and state["pos"] == 7
