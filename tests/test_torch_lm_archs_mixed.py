"""The port's LM against the JAX package's for the MoE, hybrid, SSM and
encoder-decoder architectures at smoke width, on the CPU in float32:
prefill logits and every layer's decode state, then 4 decode steps from
the converted reference state, within 1e-4 abs (``_torch_lm.check_arch``).
The MoE smoke configs (12 tokens a group, k = 2 of E = 8, capacity 4) drop
tokens.  The ``window8`` case wraps recurrentgemma's local attention ring
below its 12-token prompt."""

import pytest

from _torch_lm import WINDOW, check_arch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["kimi-k2-1t-a32b", "olmoe-1b-7b", "recurrentgemma-9b", "rwkv6-7b",
         "whisper-small"]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch):
    check_arch(arch)


def test_prompt_longer_than_the_window():
    check_arch("recurrentgemma-9b", window=WINDOW)
