"""The RG-LRU linear scan operator (``repro_torch.kernels.scan``,
``repro_torch::linear_scan`` and ``repro_torch::linear_scan_backward``) on
the CPU, where it runs its plain versions (``kernels.ref.linear_scan_ref``,
``linear_scan_backward_ref``).

What is held, and how closely:
  * against the reference (float32): ``rglru_scan``'s output and last state,
    and ``jax.grad`` of a random linear function of both for x and every
    parameter, within 1e-4 of each array's max |value|: the port scans
    sequentially, the reference's ``associative_scan`` in log depth, and the
    two round the same products in another order (the reference's scan is
    reached only through ``rglru_scan``; its parameters carry a and b);
  * the plain reverse scan against autograd through the plain forward scan,
    both in float64: 1e-12 of each gradient's max |value|;
  * the operator on the CPU against the plain loops: bit-equal (it runs
    them); its fake implementation's shapes on ``meta``; its FLOP formula (0)
    against ``launch.hlo_cost.OpCounter``'s count of the plain loop; one
    operator a layer in a ``meta`` trace; wrappers that refuse what the
    kernel does not take.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import rglru as r_rglru
from repro_torch.kernels import ref
from repro_torch.kernels import scan as kscan
from repro_torch.launch.hlo_cost import OpCounter
from repro_torch.models import rglru as t_rglru

RTOL_REF = 1e-4
RTOL_F64 = 1e-12


def _rel(a, b) -> float:
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b.detach() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _ab(seed, shape, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, shape)
    b = rng.standard_normal(shape)
    gh = rng.standard_normal(shape)
    return [torch.from_numpy(x.astype(dtype)) for x in (a, b, gh)]


@pytest.mark.parametrize("B,S,d,W", [(2, 40, 16, 16), (1, 9, 8, 24),
                                     (3, 17, 16, 8)])
def test_rglru_scan_against_reference_forward_and_grad(B, S, d, W):
    rng = np.random.default_rng(B * 100 + S)
    ref_p = r_rglru.init_rglru(jax.random.PRNGKey(S), d, W, 4, jnp.float32)
    port = t_rglru.RGLRU(d, W, 4, torch.float32, "cpu")
    port.load_state_dict({k: torch.tensor(np.asarray(v))
                          for k, v in ref_p.items()}, strict=True)
    x = rng.standard_normal((B, S, W)).astype(np.float32)
    c_out = rng.standard_normal((B, S, W)).astype(np.float32)
    c_last = rng.standard_normal((B, W)).astype(np.float32)

    def ref_loss(x, p):
        out, h = r_rglru.rglru_scan(x, p)
        return (out * c_out).sum() + (h * c_last).sum(), (out, h)

    (_, (r_out, r_h)), r_g = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), ref_p)
    tx = torch.from_numpy(x).requires_grad_()
    t_out, t_h = t_rglru.rglru_scan(tx, port)
    loss = (t_out * torch.from_numpy(c_out)).sum() \
        + (t_h * torch.from_numpy(c_last)).sum()
    names, params = zip(*port.named_parameters())
    grads = torch.autograd.grad(loss, (tx,) + params, allow_unused=True)
    assert _rel(t_out, r_out) < RTOL_REF and _rel(t_h, r_h) < RTOL_REF
    assert _rel(grads[0], r_g[0]) < RTOL_REF
    for name, g in zip(names, grads[1:]):
        if g is None:  # a weight rglru_scan does not read
            assert not np.asarray(r_g[1][name]).any(), name
            continue
        assert _rel(g, r_g[1][name]) < RTOL_REF, name


@pytest.mark.parametrize("shape", [(2, 9, 5), (1, 64, 3), (3, 1, 7)])
def test_plain_backward_is_the_gradient_of_the_plain_scan(shape):
    a, b, gh = _ab(sum(shape), shape)
    a.requires_grad_()
    b.requires_grad_()
    h = ref.linear_scan_ref(a, b)
    ga, gb = torch.autograd.grad((h * gh).sum(), (a, b))
    pa, pb = ref.linear_scan_backward_ref(a.detach(), h.detach(), gh)
    assert _rel(pa, ga) < RTOL_F64 and _rel(pb, gb) < RTOL_F64


def test_operator_on_the_cpu_is_the_plain_loops():
    a, b, gh = _ab(3, (2, 13, 6), np.float32)
    a.requires_grad_()
    b.requires_grad_()
    h = kscan.linear_scan(a, b)
    h0 = ref.linear_scan_ref(a.detach(), b.detach())
    assert torch.equal(h, h0)
    ga, gb = torch.autograd.grad((h * gh).sum(), (a, b))
    pa, pb = ref.linear_scan_backward_ref(a.detach(), h0, gh)
    assert torch.equal(ga, pa) and torch.equal(gb, pb)


def test_fake_implementation_on_meta():
    a, b = (torch.empty((3, 7, 8), device="meta", requires_grad=True)
            for _ in range(2))
    h = kscan.linear_scan(a, b)
    assert (h.shape, h.dtype, h.device.type) == ((3, 7, 8), torch.float32,
                                                 "meta")
    ga, gb = torch.autograd.grad(h, (a, b), torch.ones_like(h))
    assert ga.shape == gb.shape == (3, 7, 8) and ga.device.type == "meta"


@pytest.mark.parametrize("shape", [(2, 5, 8), (4, 3, 16)])
def test_flop_formula_equals_the_count_of_the_plain_loop(shape):
    """No matrix product in the scan: 0 FLOPs by both, forward and backward
    (as ``OpCounter`` counts the reference's ``associative_scan``)."""
    def count(fn):
        a, b = (torch.empty(shape, device="meta", requires_grad=True)
                for _ in range(2))
        with OpCounter(device="meta") as fwd:
            h = fn(a, b)
        with OpCounter(device="meta") as bwd:
            torch.autograd.grad(h, (a, b), torch.ones_like(h))
        return fwd.flops, bwd.flops

    assert count(ref.linear_scan_ref) == count(kscan.linear_scan) == (0, 0)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names[str(func._overloadpacket.__name__)] += 1
        return func(*args, **(kwargs or {}))


def test_one_operator_per_layer_in_a_meta_trace():
    d, W, B, S = 16, 16, 2, 128
    port = t_rglru.RGLRU(d, W, 4, torch.float32, "meta")
    x = torch.empty((B, S, W), device="meta", requires_grad=True)
    with _Ops() as ops:
        out, h = t_rglru.rglru_scan(x, port)
        torch.autograd.grad(out.sum() + h.sum(), x)
    assert ops.names["linear_scan"] == 1
    assert ops.names["linear_scan_backward"] == 1
    assert ops.names["select"] < S  # no step of the loop ran


def test_wrappers_refuse_what_the_kernel_does_not_take():
    a, b, gh = _ab(5, (1, 4, 3), np.float32)
    with pytest.raises(ValueError, match="unsupported device"):
        kscan.scan_forward(a.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        kscan.scan_backward(a.to("meta"), b.to("meta"), gh.to("meta"))
    with pytest.raises(TypeError, match="float32"):
        kscan.scan_forward(a.double(), b.double())
    with pytest.raises(ValueError, match="shapes differ"):
        kscan.scan_forward(a, b[:, :2])
    with pytest.raises(ValueError, match=r"\(B, S, W\)"):
        kscan.scan_forward(a[0], b[0])
