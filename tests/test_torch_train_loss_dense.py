"""The port's training loss (``repro_torch.models.loss_fn``, chunked
cross-entropy with autograd) against the JAX package's for the dense and VLM
architectures at smoke width, on the CPU in float32: loss and metrics within
1e-4 abs, every parameter's gradient within 1e-4 of its max |value|
(``_torch_train.check_loss_and_grads``), with remat off and a loss chunk
that divides S, and with remat on and one that does not (label -1
padding); the port's remat gradients bit-equal to its plain ones."""

import pytest

from _torch_train import VARIANTS, check_loss_and_grads
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["gemma2-9b", "gemma3-1b", "granite-34b", "qwen2.5-3b",
         "qwen2-vl-2b"]


@pytest.mark.parametrize("remat,chunk", VARIANTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch, remat, chunk):
    check_loss_and_grads(arch, remat, chunk)
