"""Shared inputs and checks of the training port's tests: the JAX package's
``repro.models.loss_fn`` and ``repro.train`` against ``repro_torch``'s on the
CPU, in float32, on the same weights (carried across by
``convert.params_from_reference``) and the same batches (``make_batch``,
bit-equal in the two packages)."""

import jax
import numpy as np
import torch

from _torch_lm import configs, max_diff, numpy_tree, reference_model, to_jax
from repro.models import loss_fn as ref_loss_fn
from repro.train import DataConfig as RefDataConfig
from repro.train import make_batch as ref_make_batch
from repro_torch.convert import named_from_reference
from repro_torch.models import loss_fn
from repro_torch.models import moe as lm_moe
from repro_torch.train import data as port_data

# loss: abs; every gradient: abs, against its own max |value| (read at most
# 5.3e-6 over the ten smoke architectures, rwkv6-7b's time-mix)
ATOL = 1e-4
B, S = 2, 16
# (remat, loss_chunk): a chunk that divides S, and one that does not (S is
# padded with label -1 up to 18)
VARIANTS = [(False, 8), (True, 6)]


def batch(cfg, seed=3):
    """``make_batch``'s step-0 batch at (B, S) from ``seed``, as numpy."""
    return ref_make_batch(cfg, RefDataConfig(batch=B, seq_len=S, seed=seed), 0)


def port_grads(model, batch_np, remat, chunk):
    """(loss, metrics, {name: gradient}) of one port ``loss_fn`` call."""
    b = port_data.to_device(batch_np, "cpu")
    loss, metrics = loss_fn(model, b, remat=remat, loss_chunk=chunk)
    names, plist = zip(*model.named_parameters())
    return loss, metrics, dict(zip(names, torch.autograd.grad(loss, plist)))


def check_loss_and_grads(arch, remat, chunk):
    """The port's ``loss_fn`` value, metrics and every parameter's gradient
    against ``jax.value_and_grad`` of the reference's, within ATOL; the
    port's remat run bit-equal to its plain run.  Returns the port's
    gradients."""
    rcfg, tcfg = configs(arch)
    params, model = reference_model(rcfg, tcfg)
    b = batch(rcfg)
    (r_loss, r_m), r_g = jax.jit(jax.value_and_grad(
        lambda p, x: ref_loss_fn(p, rcfg, x, remat=remat, loss_chunk=chunk),
        has_aux=True))(params, to_jax(b))
    loss, metrics, grads = port_grads(model, b, remat, chunk)
    assert max_diff(r_loss, loss) < ATOL, arch
    for key in ("xent", "aux"):
        assert max_diff(r_m[key], metrics[key]) < ATOL, (arch, key)
    ref = named_from_reference(numpy_tree(r_g), tcfg, "cpu")
    assert ref.keys() == grads.keys()
    for name, g in grads.items():
        scale = max(float(ref[name].abs().max()), 1e-30)
        assert max_diff(ref[name], g) <= ATOL * scale, (arch, name)
    if remat:
        _l, _m, plain = port_grads(model, b, False, chunk)
        for name, g in grads.items():
            assert torch.equal(g, plain[name]), (arch, name)
    return grads


def dispatch_log():
    """A spy for ``moe._dispatch`` recording each call's (slot, keep), and
    a function that puts the original back."""
    orig, log = lm_moe._dispatch, []

    def spy(*args):
        buf, meta = orig(*args)
        log.append((meta[0].clone(), meta[1].clone()))
        return buf, meta

    lm_moe._dispatch = spy

    def undo():
        lm_moe._dispatch = orig

    return log, undo


def np_equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
