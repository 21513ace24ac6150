"""The port's LM against the JAX package's for the dense and VLM
architectures at smoke width, on the CPU in float32: prefill logits and
every layer's decode state, then 4 decode steps from the converted
reference state, within 1e-4 abs (``_torch_lm.check_arch``).  The
``window8`` cases cut every local window to 8 tokens, below the 12-token
prompt, so the ring buffers wrap in prefill and in decode."""

import pytest

from _torch_lm import WINDOW, check_arch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["gemma2-9b", "gemma3-1b", "granite-34b", "qwen2.5-3b",
         "qwen2-vl-2b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    check_arch(arch)


@pytest.mark.parametrize("arch", ["gemma2-9b", "gemma3-1b"])
def test_prompt_longer_than_the_window(arch):
    check_arch(arch, window=WINDOW)
