"""Shared inputs and checks of the LM port's tests: the JAX package's
``repro.models`` against ``repro_torch.models`` on the CPU, in float32, on
the same weights (carried across by ``convert.params_from_reference``) and
the same numpy inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import decode_step as ref_decode_step
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro_torch.configs import smoke_config
from repro_torch.convert import (decode_state_from_reference,
                                 params_from_reference)
from repro_torch.models import decode_step, prefill

ATOL = 1e-4            # port against reference, float32
# port against the reference run op by op, bfloat16: logits and states read
# at most 3.125e-2 (gemma2-9b, olmoe-1b-7b), a step of bf16 at 4 to 8, where
# the two round the same sums differently (tanh-GELU in one float32 pass
# here, op by op in bf16 there; matmul sums in another order)
BF16_ATOL = 0.05
B, S, STEPS = 2, 12, 4
WINDOW = 8             # a local window below the prompt: the ring wraps


def with_window(cfg, window):
    """``cfg`` with every local (sliding) window set to ``window``."""
    if window is None:
        return cfg
    return dataclasses.replace(cfg, pattern=tuple(
        (k, window if w > 0 else w, t, m) for k, w, t, m in cfg.pattern))


def configs(arch, window=None):
    """(reference config, port config) of the arch's smoke variant."""
    return (with_window(ref_smoke_config(arch), window),
            with_window(smoke_config(arch), window))


def batch_np(cfg, seed=0, batch=B, seq=S) -> dict:
    """A prefill batch made with numpy from ``seed``: tokens and, as the
    config needs, frame and patch embeddings and M-RoPE positions."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq))
           .astype(np.int32)}
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.vision_seq:
        out["vision"] = rng.standard_normal(
            (batch, cfg.vision_seq, cfg.d_model)).astype(np.float32)
        # distinct t/h/w streams, so each M-RoPE section is exercised
        pos = np.arange(seq, dtype=np.int32)
        out["mrope_positions"] = np.stack(
            [np.broadcast_to(pos * (i + 1), (batch, seq)) for i in range(3)])
    return out


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def max_diff(a, b) -> float:
    a, b = (np.asarray(x.detach().cpu().float() if isinstance(x, torch.Tensor)
                       else x, np.float64) for x in (a, b))
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) if a.size else 0.0


def state_diff(ref_state, port_state, cfg) -> float:
    """Largest difference over every layer's decode state; integer leaves
    (the ring's slot positions) must be equal, and so must ``pos``."""
    conv = decode_state_from_reference(numpy_tree(ref_state), cfg, "cpu")
    assert conv["pos"] == port_state["pos"]
    assert len(conv["caches"]) == len(port_state["caches"]) == cfg.num_layers
    err = 0.0
    for layer, (a, b) in enumerate(zip(conv["caches"],
                                       port_state["caches"])):
        assert a.keys() == b.keys(), (layer, a.keys(), b.keys())
        for key in a:
            assert a[key].dtype == b[key].dtype, (layer, key)
            if a[key].dtype.is_floating_point:
                err = max(err, max_diff(a[key], b[key]))
            else:
                assert torch.equal(a[key], b[key]), (layer, key)
    return err


def reference_model(rcfg, tcfg, seed=0):
    """The reference's params from PRNGKey(seed) and the port's ``Model``
    holding them."""
    params = ref_init_params(jax.random.PRNGKey(seed), rcfg)
    return params, params_from_reference(numpy_tree(params), tcfg, "cpu")


def check_arch(arch, window=None):
    """Prefill logits and every decode state, then STEPS decode steps from
    the converted reference state, port against reference."""
    rcfg, tcfg = configs(arch, window)
    params, model = reference_model(rcfg, tcfg)
    batch = batch_np(rcfg)
    max_len = S + STEPS
    r_prefill = jax.jit(lambda p, b: ref_prefill(p, rcfg, b, max_len))
    r_decode = jax.jit(lambda p, s, t: ref_decode_step(p, rcfg, s, t))

    r_logits, r_state = r_prefill(params, to_jax(batch))
    p_logits, p_state = prefill(model, to_torch(batch), max_len)
    assert max_diff(r_logits, p_logits) < ATOL, arch
    assert state_diff(r_state, p_state, tcfg) < ATOL, arch

    state = decode_state_from_reference(numpy_tree(r_state), tcfg, "cpu")
    tokens = np.array(jnp.argmax(r_logits, -1), np.int32)
    for step in range(STEPS):
        r_logits, r_state = r_decode(params, r_state, jnp.asarray(tokens))
        p_logits, state = decode_step(model, state,
                                      torch.from_numpy(tokens))
        assert max_diff(r_logits, p_logits) < ATOL, (arch, step)
        tokens = np.array(jnp.argmax(r_logits, -1), np.int32)
    assert state_diff(r_state, state, tcfg) < ATOL, arch


def check_arch_bf16(arch, window=None):
    """``check_arch`` in bfloat16 against the reference run op by op
    (``jax.disable_jit``), where every bf16 rounding its source writes is
    made: compiled, XLA fuses some of them away, and its own logits move
    by up to 0.42 (olmoe-1b-7b, decode step 0)."""
    rcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in configs(arch, window))
    params, model = reference_model(rcfg, tcfg)
    batch = batch_np(rcfg)
    max_len = S + STEPS
    with jax.disable_jit():
        r_logits, r_state = ref_prefill(params, rcfg, to_jax(batch), max_len)
        p_logits, p_state = prefill(model, to_torch(batch), max_len)
        errs = [max_diff(r_logits, p_logits),
                state_diff(r_state, p_state, tcfg)]
        state = decode_state_from_reference(numpy_tree(r_state), tcfg, "cpu")
        tokens = np.array(jnp.argmax(r_logits, -1), np.int32)
        for _ in range(STEPS):
            r_logits, r_state = ref_decode_step(params, rcfg, r_state,
                                                jnp.asarray(tokens))
            p_logits, state = decode_step(model, state,
                                          torch.from_numpy(tokens))
            errs.append(max_diff(r_logits, p_logits))
            tokens = np.array(jnp.argmax(r_logits, -1), np.int32)
        errs.append(state_diff(r_state, state, tcfg))
    return errs
