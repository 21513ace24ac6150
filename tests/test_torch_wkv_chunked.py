"""The chunked form of the RWKV-6 recurrence that ``csrc/wkv.cu`` runs on the
card, mirrored step for step in plain PyTorch (``kernels.ref.wkv_chunked_ref``,
``wkv_chunked_backward_ref``): chunks of 64 steps, float64 prefix sums of the
log-decays clamped at -1000, the intra-chunk scores by sub-chunks of 16 with
no factor above 1, one serial pass over chunk states (forward) and over their
gradients (backward), and glw by the reverse cumulative sum identity.  The
kernel itself cannot run here, so this is where its maths is checked.

What is held, and how closely: the mirror's y, final state and all five
gradients against the plain loops ``ref.wkv_ref`` / ``wkv_backward_ref``
(which ``tests/test_torch_wkv.py`` holds against the reference's
``timemix_scan`` and ``jax.grad``), at lengths around the chunk and
sub-chunk edges, N in {16, 64}, with a tenth of the decays exactly 0 (half
of those lw = -inf, half below the clamp): within 1e-10 of each output's max
|value| in float64 (sums in another order) and 1e-5 in float32 (float32
products in another order, exp of a float32 argument).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL = {torch.float64: 1e-10, torch.float32: 1e-5}
LENGTHS = (1, 15, 16, 17, 63, 64, 65, 300)


def _rel(a, b) -> float:
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    a, b = a.double(), b.double()
    assert bool(torch.isfinite(a).all())
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _inputs(seed, B, S, H, N, dtype):
    """r, k, v, lw, u, gy, gs: lw = -exp(x), a tenth of it -inf or -2000
    (w = exp(lw) exactly 0)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, N)) * 0.5 for _ in range(3))
    lw = -np.exp(rng.standard_normal((B, S, H, N)) * 1.5 - 2.0)
    pick = rng.random(lw.shape)
    lw[pick < 0.05] = -np.inf
    lw[(pick >= 0.05) & (pick < 0.1)] = -2000.0
    u = rng.standard_normal((H, N)) * 0.5
    gy = rng.standard_normal((B, S, H, N))
    gs = rng.standard_normal((B, H, N, N)) * 0.1
    return [torch.tensor(a, dtype=dtype) for a in (r, k, v, lw, u, gy, gs)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("N", [16, 64])
@pytest.mark.parametrize("S", LENGTHS)
def test_chunked_forward_matches_the_plain_loop(S, N, dtype):
    ins = _inputs(S * 7 + N, 2, S, 2, N, dtype)[:5]
    assert int((torch.exp(ins[3]) == 0).sum()) > 0 or S == 1
    y, s = ref.wkv_chunked_ref(*ins)
    y0, s0 = ref.wkv_ref(*ins)
    assert _rel(y, y0) < RTOL[dtype]
    assert _rel(s, s0) < RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("N", [16, 64])
@pytest.mark.parametrize("S", LENGTHS)
def test_chunked_backward_matches_the_plain_reverse_loop(S, N, dtype):
    ins = _inputs(S * 11 + N, 2, S, 2, N, dtype)
    got = ref.wkv_chunked_backward_ref(*ins)
    want = ref.wkv_backward_ref(*ins)
    for name, a, b in zip(("gr", "gk", "gv", "glw", "gu"), got, want):
        assert _rel(a, b) < RTOL[dtype], name


def test_chunked_bfloat16_inputs_match_the_plain_loops():
    """bf16 r, k, v (the model's type), float32 lw and gradients: the
    outputs in the plain loops' types, within the float32 bound."""
    ins = _inputs(5, 1, 130, 2, 64, torch.float32)
    ins[:3] = [t.bfloat16() for t in ins[:3]]
    for a, b in zip(ref.wkv_chunked_ref(*ins[:5]), ref.wkv_ref(*ins[:5])):
        assert _rel(a, b) < RTOL[torch.float32]
    for a, b in zip(ref.wkv_chunked_backward_ref(*ins),
                    ref.wkv_backward_ref(*ins)):
        # gr, gk, gv come back in bf16 from both: one rounding apart
        tol = 2.0 ** -7 if a.dtype == torch.bfloat16 else RTOL[torch.float32]
        assert _rel(a, b) <= tol


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_chunked_glw_is_exactly_zero_where_the_decay_underflows(dtype):
    """Where w = exp(lw) is 0 in the working type, glw = gw * w is exactly 0
    in the plain loop, and so in the mirror (the identity's sums would
    leave their rounding there); elsewhere within the bounds above."""
    ins = _inputs(17, 2, 130, 2, 64, dtype)
    # a third of the decays past float32's underflow but finite
    pick = torch.rand(ins[3].shape, generator=torch.Generator().manual_seed(1))
    ins[3] = torch.where(pick < 0.3, -300.0 * (1.0 + pick), ins[3])
    zero = torch.exp(ins[3]) == 0
    assert int(zero.sum()) > 0
    glw = ref.wkv_chunked_backward_ref(*ins)[3]
    want = ref.wkv_backward_ref(*ins)[3]
    assert bool((want[zero] == 0).all()) and bool((glw[zero] == 0).all())
    assert _rel(glw, want) < RTOL[dtype]


def test_chunked_decay_gradients_through_the_model(monkeypatch):
    """The model's decay parameters (``w_decay``, ``decay_bias``, ``mu_w``)
    through ``timemix_scan`` with about half the decays underflowing and lw
    down to about -17000: the mirror's backward in the operator's place
    gives every parameter's gradient within 1e-4 of its max |value| of the
    plain reverse loop's (the kernel's check on the card is
    ``tests/test_torch_cuda.py``'s)."""
    from _torch_wkv_decay import RTOL as GRAD_RTOL
    from _torch_wkv_decay import timemix_grads, underflow_share, worst

    assert underflow_share() > 0.3
    want = timemix_grads("cpu")
    monkeypatch.setattr(ref, "wkv_backward_ref", ref.wkv_chunked_backward_ref)
    got = timemix_grads("cpu")
    errs = worst(got, want, want)
    assert max(errs.values()) < GRAD_RTOL, errs
