"""The port's LM in bfloat16, the dtype it serves in, against the JAX
package's on the CPU.

- Model level, at smoke width: prefill logits and every decode state, then
  4 decode steps from the converted reference state, within ``BF16_ATOL``
  (0.05; read at most 3.125e-2) of the reference run op by op
  (``_torch_lm.check_arch_bf16``).  gemma2-9b with local windows of 8
  below the 12-token prompt (wrapped rings, soft caps, the bf16 embedding
  scale); olmoe-1b-7b, whose MoE drops tokens, so a routing decision that
  moves shows as a whole expert's output (without the rounding of the
  attention probabilities to bf16, its prefill state parts by 0.639).
- Attention: both paths round the probabilities to bf16 before the PV
  product, as the reference does, so their bf16 outputs are bit-equal to
  the reference's but for a few elements whose float32 sums round the
  other way (at most ``BF16_UNEQUAL`` of them).

``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm_bf16.py``
prints every reading these tests hold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import BF16_ATOL, WINDOW, check_arch_bf16
from repro.models import attention as r_attn
from repro_torch.models import attention as t_attn

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = [("gemma2-9b", WINDOW), ("olmoe-1b-7b", None)]
ATTN_SHAPES = [(1, 9, 2, 2), (2, 64, 4, 2)]   # B, S, H, KV
# the share of bf16 outputs allowed to differ from the reference's: read 0
# to 4.9e-4 (float32 sums in another order); without the rounding of the
# probabilities to bf16 before the PV product, 0.24 to 0.48
BF16_UNEQUAL = 1e-3


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _unequal(ref, got) -> tuple[float, float]:
    """(share of elements that are not bit-equal, largest difference) of a
    reference bf16 array against a port bf16 tensor."""
    assert got.dtype == torch.bfloat16
    d = np.abs(np.asarray(ref.astype(jnp.float32), np.float64)
               - got.float().numpy().astype(np.float64))
    return float((d != 0).mean()), float(d.max())


def streaming_reading(B, S, H, KV) -> tuple[float, float]:
    rng = np.random.default_rng(8)
    q, k, v = _randn(rng, B, S, H, 8), _randn(rng, B, S, KV, 8), \
        _randn(rng, B, S, KV, 8)
    k, v = np.repeat(k, H // KV, 2), np.repeat(v, H // KV, 2)
    kw = dict(window=32, attn_softcap=50.0, q_chunk=16, kv_chunk=16)
    ref = r_attn.streaming_attention(*(jnp.asarray(a, jnp.bfloat16)
                                       for a in (q, k, v)), **kw)
    got = t_attn.streaming_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), **kw)
    return _unequal(ref, got)


def decode_reading() -> tuple[float, float]:
    """A wrapped ring of 64 slots at position 69, window 48."""
    rng = np.random.default_rng(10)
    B, CL, H, KV, pos = 2, 64, 4, 2, 69
    q = _randn(rng, B, H, 16)
    kc, vc = _randn(rng, B, CL, KV, 16), _randn(rng, B, CL, KV, 16)
    slot_pos = np.array([max(p for p in range(pos + 1) if p % CL == i)
                         for i in range(CL)], np.int32)
    kw = dict(window=48, attn_softcap=50.0)
    ref = r_attn.decode_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, kc, vc)),
        jnp.asarray(slot_pos), pos, **kw)
    got = t_attn.decode_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, kc, vc)),
        torch.from_numpy(slot_pos), pos, **kw)
    return _unequal(ref, got)


@pytest.mark.parametrize("arch,window", ARCHS)
def test_bf16_prefill_and_decode_match_the_reference(arch, window):
    errs = check_arch_bf16(arch, window)
    assert max(errs) <= BF16_ATOL, (arch, errs)


@pytest.mark.parametrize("B,S,H,KV", ATTN_SHAPES)
def test_streaming_attention_bf16_rounds_probabilities(B, S, H, KV):
    share, err = streaming_reading(B, S, H, KV)
    assert share <= BF16_UNEQUAL and err <= 2 ** -9


def test_decode_attention_bf16_rounds_probabilities():
    share, err = decode_reading()
    assert share <= BF16_UNEQUAL and err <= 2 ** -9


if __name__ == "__main__":
    for shape in ATTN_SHAPES:
        print("streaming_attention", shape, "unequal share %.3e, "
              "max |diff| %.3e" % streaming_reading(*shape))
    print("decode_attention unequal share %.3e, max |diff| %.3e"
          % decode_reading())
    for arch, window in ARCHS:
        errs = check_arch_bf16(arch, window)
        print(arch, f"window {window}:", "prefill logits %.4g, state %.4g; "
              "decode logits %s; final state %.4g" % (
                  errs[0], errs[1], ", ".join("%.4g" % e for e in errs[2:-1]),
                  errs[-1]))
