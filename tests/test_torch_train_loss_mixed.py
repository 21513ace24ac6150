"""The port's training loss against the JAX package's for the MoE,
recurrent and encoder-decoder architectures at smoke width, on the CPU in
float32, as ``test_torch_train_loss_dense.py`` (loss within 1e-4 abs, every
gradient within 1e-4 of its max |value|).  Beside it: whisper-small's
encoder gets its gradients (the training forward runs the encoder with
grad), and an MoE layer's routing recomputed under remat in backward is the
forward's, slot for slot."""

import pytest
import torch

from _torch_train import (VARIANTS, batch, check_loss_and_grads,
                          dispatch_log, port_grads)
from _torch_lm import configs, reference_model
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["kimi-k2-1t-a32b", "olmoe-1b-7b", "recurrentgemma-9b", "rwkv6-7b",
         "whisper-small"]


@pytest.mark.parametrize("remat,chunk", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch, remat, chunk):
    grads = check_loss_and_grads(arch, remat, chunk)
    if arch == "whisper-small":
        enc = [n for n in grads if n.startswith("encoder.")]
        assert len(enc) > 2
        for name in enc:
            assert float(grads[name].abs().max()) > 0, name


def test_moe_routing_recomputed_in_backward_is_the_forwards():
    rcfg, tcfg = configs("olmoe-1b-7b")
    _params, model = reference_model(rcfg, tcfg)
    log, undo = dispatch_log()
    try:
        port_grads(model, batch(rcfg), True, 6)
    finally:
        undo()
    moe_layers = sum(b.sub.moe for b in model.layers)
    # each MoE layer dispatched once in forward and once more in backward
    assert moe_layers > 0 and len(log) == 2 * moe_layers
    fwd, bwd = log[:moe_layers], log[moe_layers:]
    # backward recomputes the units in reverse order
    for (s0, k0), (s1, k1) in zip(fwd, reversed(bwd)):
        assert torch.equal(s0, s1) and torch.equal(k0, k1)
    assert sum(int((~k).sum()) for _s, k in fwd) > 0  # some tokens dropped
