"""One RWKV-6 time-mix (``models.rwkv.timemix_scan``) at d = 128, two heads
of 64, B = 2, S = 130 (three chunks, the last ragged), with decay biases
drawn from [-4, 10] so that about half the log-decays lw = -exp(.) fall
below -104, where w = exp(lw) underflows to 0 in float32 (lw reaches about
-17000).  Its parameters' gradients, by autograd through the
``repro_torch::wkv`` operator, are what the model's chain rule makes of the
operator's glw: d lw / d(wx) = lw, so whatever glw carries where w is 0 is
scaled by |lw| into ``w_decay``, ``decay_bias`` and ``mu_w``.  Shared by
``tests/test_torch_wkv_chunked.py`` (the chunked CPU mirror) and
``tests/test_torch_cuda.py`` (the kernel).  It imports torch and the port
only: no JAX."""

import torch

from repro_torch.models import rwkv

D, HEAD, B, S = 128, 64, 2, 130
DECAY_BIAS = (-4.0, 10.0)
RTOL = 1e-4   # each gradient within this much of its own max |value|


def _case():
    """The time-mix and its inputs on the CPU, from one seed."""
    g = torch.Generator().manual_seed(3)
    p = rwkv.TimeMix(D, HEAD, torch.float32, "cpu")
    p.reset_parameters(g)
    lo, hi = DECAY_BIAS
    with torch.no_grad():
        p.decay_bias.copy_(torch.rand(D, generator=g) * (hi - lo) + lo)
        p.u_bonus.copy_(torch.randn(p.u_bonus.shape, generator=g) * 0.5)
    x = torch.randn(B, S, D, generator=g)
    x_prev = torch.randn(B, D, generator=g)
    g_out = torch.randn(B, S, D, generator=g)
    g_state = torch.randn(B, D // HEAD, HEAD, HEAD, generator=g)
    return p, x, x_prev, g_out, g_state


def timemix_grads(device) -> dict:
    """The time-mix's parameter gradients (CPU copies) for a random loss
    on its output and final state."""
    p, *ts = _case()
    p = p.to(device)
    x, x_prev, g_out, g_state = (t.to(device) for t in ts)
    out, state, _ = rwkv.timemix_scan(x, x_prev, p, HEAD)
    ((out * g_out).sum() + (state * g_state).sum()).backward()
    return {n: q.grad.detach().cpu() for n, q in p.named_parameters()}


def underflow_share() -> float:
    """The share of the case's log-decays whose exp is 0 in float32."""
    p, x, x_prev, _, _ = _case()
    with torch.no_grad():
        lw = rwkv._projections(x, rwkv._shift(x, x_prev), p, HEAD)[-1]
    return float((torch.exp(lw) == 0).float().mean())


def worst(got: dict, want: dict, names) -> dict:
    """Each named gradient's max |difference| over its own max |value|."""
    return {n: float((got[n] - want[n]).abs().max()
                     / want[n].abs().max().clamp_min(1e-30)) for n in names}
