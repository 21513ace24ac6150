"""The RWKV-6 recurrence operator (``repro_torch.kernels.wkv``,
``repro_torch::wkv`` and ``repro_torch::wkv_backward``) on the CPU, where it
runs its plain versions (``kernels.ref.wkv_ref``, ``wkv_backward_ref``).

What is held, and how closely:
  * against the reference (float32): ``timemix_scan``'s output and final
    state, and ``jax.grad`` of a random linear function of both for the
    inputs x, x_prev and every parameter, within 1e-4 of each array's max
    |value| (float32 sums over time in another order).  The reference's
    recurrence is the body of its ``lax.scan`` inside ``timemix_scan`` and is
    reached only through it; its parameters carry r, k, v (w_r, w_k, w_v),
    the log-decay lw (w_decay, decay_bias) and u (u_bonus);
  * the plain reverse loop against autograd through the plain forward loop,
    both in float64, with decays that are exactly 0 (lw = -inf): 1e-12 of
    each gradient's max |value| (the same sums in another order);
  * the operator on the CPU against the plain loops: bit-equal (it runs
    them); its fake implementation's shapes and types on ``meta``; its FLOP
    formula against ``launch.hlo_cost.OpCounter``'s count of the plain loop;
    one operator a layer in a ``meta`` trace; wrappers that refuse what the
    kernel does not take.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import rwkv as r_rwkv
from repro_torch.kernels import ref
from repro_torch.kernels import wkv as kwkv
from repro_torch.launch.hlo_cost import OpCounter
from repro_torch.models import rwkv as t_rwkv

RTOL_REF = 1e-4    # float32 against the reference, of each max |value|
RTOL_F64 = 1e-12   # float64 against float64


def _rel(a, b) -> float:
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b.detach() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _inputs(seed, B, S, H, N, dtype=np.float32, zeros=0.1):
    """r, k, v, lw, u, gy, gs as numpy arrays: the log-decays lw = -exp(x),
    a share ``zeros`` of them -inf (decays exactly 0)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, N)) * 0.5 for _ in range(3))
    x = rng.standard_normal((B, S, H, N)) * 1.5 - 2.0
    lw = -np.exp(x)
    lw[rng.random(lw.shape) < zeros] = -np.inf
    u = rng.standard_normal((H, N)) * 0.5
    gy = rng.standard_normal((B, S, H, N))
    gs = rng.standard_normal((B, H, N, N)) * 0.1
    return [a.astype(dtype) for a in (r, k, v, lw, u, gy, gs)]


def _torch(arrays, requires_grad=False):
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(
        requires_grad) for a in arrays]


def _timemix_params(seed, d, N):
    rng = np.random.default_rng(seed)
    tm = r_rwkv.init_rwkv_timemix(jax.random.PRNGKey(seed), d, N,
                                  jnp.float32)
    for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "ln_x"):
        tm[name] = jnp.asarray(rng.uniform(0.1, 0.9, d).astype(np.float32))
    tm["u_bonus"] = jnp.asarray(
        (rng.standard_normal((d // N, N)) * 0.5).astype(np.float32))
    # decays spread over (0, 1) rather than all near exp(-exp(-4))
    tm["decay_bias"] = jnp.asarray(
        rng.uniform(-4.0, 1.0, d).astype(np.float32))
    tm["w_decay"] = jnp.asarray(
        (rng.standard_normal((d, d)) * d ** -0.5).astype(np.float32))
    port = t_rwkv.TimeMix(d, N, torch.float32, "cpu")
    port.load_state_dict({k: torch.tensor(np.asarray(v))
                          for k, v in tm.items()}, strict=True)
    return tm, port


@pytest.mark.parametrize("B,S,d,N", [(2, 10, 32, 8), (1, 7, 16, 4),
                                     (3, 5, 32, 16)])
def test_timemix_scan_against_reference_forward_and_grad(B, S, d, N):
    tm, port = _timemix_params(B * 100 + S, d, N)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    x_prev = rng.standard_normal((B, d)).astype(np.float32)
    c_out = rng.standard_normal((B, S, d)).astype(np.float32)
    c_state = rng.standard_normal((B, d // N, N, N)).astype(np.float32)

    def ref_loss(x, x_prev, p):
        out, s, _ = r_rwkv.timemix_scan(x, x_prev, p, N)
        return (out * c_out).sum() + (s * c_state).sum(), (out, s)

    (_, (r_out, r_s)), r_g = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(x), jnp.asarray(x_prev), tm)
    tx, tp = _torch([x, x_prev], requires_grad=True)
    t_out, t_s, _ = t_rwkv.timemix_scan(tx, tp, port, N)
    loss = (t_out * torch.from_numpy(c_out)).sum() \
        + (t_s * torch.from_numpy(c_state)).sum()
    names, params = zip(*port.named_parameters())
    grads = torch.autograd.grad(loss, (tx, tp) + params)
    assert _rel(t_out, r_out) < RTOL_REF
    assert _rel(t_s, r_s) < RTOL_REF
    assert _rel(grads[0], r_g[0]) < RTOL_REF
    assert _rel(grads[1], r_g[1]) < RTOL_REF
    for name, g in zip(names, grads[2:]):
        assert _rel(g, r_g[2][name]) < RTOL_REF, name


@pytest.mark.parametrize("shape", [(2, 9, 3, 4), (1, 40, 2, 8),
                                   (2, 33, 1, 16)])
def test_plain_backward_is_the_gradient_of_the_plain_loop(shape):
    """Every input's gradient, u's included, where a tenth of the decays
    are exactly 0 (the reverse loop never divides by w; glw = gw * w)."""
    arrays = _inputs(sum(shape), *shape, dtype=np.float64)
    ins = _torch(arrays[:5], requires_grad=True)
    gy, gs = _torch(arrays[5:])
    assert int((torch.exp(ins[3]) == 0).sum()) > 0
    y, s = ref.wkv_ref(*ins)
    auto = torch.autograd.grad((y * gy).sum() + (s * gs).sum(), ins)
    plain = ref.wkv_backward_ref(*[t.detach() for t in ins], gy, gs)
    for name, a, b in zip(("r", "k", "v", "lw", "u"), plain, auto):
        assert a.dtype == torch.float64
        assert _rel(a, b) < RTOL_F64, name


def test_operator_on_the_cpu_is_the_plain_loops():
    arrays = _inputs(3, 2, 11, 3, 8)
    ins = _torch(arrays[:5], requires_grad=True)
    gy, gs = _torch(arrays[5:])
    y, s = kwkv.wkv(*ins)
    y0, s0 = ref.wkv_ref(*[t.detach() for t in ins])
    assert torch.equal(y, y0) and torch.equal(s, s0)
    grads = torch.autograd.grad((y * gy).sum() + (s * gs).sum(), ins)
    plain = ref.wkv_backward_ref(*[t.detach() for t in ins], gy, gs)
    for a, b in zip(grads, plain):
        assert torch.equal(a, b)
    # a final state that the loss does not read gets a zero gradient
    (g_u,) = torch.autograd.grad(kwkv.wkv(*ins)[0].sum(), ins[4])
    ones = torch.ones_like(gy)
    assert torch.equal(g_u, ref.wkv_backward_ref(
        *[t.detach() for t in ins], ones, torch.zeros_like(gs))[4])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_implementation_on_meta(dtype):
    B, S, H, N = 3, 5, 4, 16
    r, k, v = (torch.empty((B, S, H, N), dtype=dtype, device="meta",
                           requires_grad=True) for _ in range(3))
    lw = torch.empty((B, S, H, N), device="meta", requires_grad=True)
    u = torch.empty((H, N), device="meta", requires_grad=True)
    y, s = kwkv.wkv(r, k, v, lw, u)
    assert (y.shape, y.dtype, y.device.type) == ((B, S, H, N),
                                                 torch.float32, "meta")
    assert (s.shape, s.dtype) == ((B, H, N, N), torch.float32)
    grads = torch.autograd.grad((y, s), (r, k, v, lw, u),
                                (torch.ones_like(y), torch.ones_like(s)))
    for g, x in zip(grads, (r, k, v, lw, u)):
        assert (g.shape, g.dtype, g.device.type) == (x.shape, x.dtype,
                                                     "meta")


@pytest.mark.parametrize("shape", [(2, 3, 4, 16), (1, 5, 2, 8),
                                   (4, 2, 3, 64)])
def test_flop_formula_equals_the_count_of_the_plain_loop(shape):
    """``OpCounter`` counts the plain loop's products (its einsums' bmm):
    the operators' formulas give the same, forward and backward."""
    B, S, H, N = shape

    def count(fn):
        ins = [torch.empty(s, device="meta", requires_grad=True)
               for s in ((B, S, H, N),) * 4 + ((H, N),)]
        with OpCounter(device="meta") as fwd:
            y, s = fn(*ins)
        with OpCounter(device="meta") as bwd:
            torch.autograd.grad((y, s), ins, (torch.ones_like(y),
                                              torch.ones_like(s)))
        return fwd.flops, bwd.flops

    plain = count(ref.wkv_ref)
    assert plain == (2.0 * B * S * H * N * N, 4.0 * B * S * H * N * N)
    assert count(kwkv.wkv) == plain


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names[str(func._overloadpacket.__name__)] += 1
        return func(*args, **(kwargs or {}))


def test_one_operator_per_layer_in_a_meta_trace():
    d, N, B, S = 32, 8, 2, 64
    port = t_rwkv.TimeMix(d, N, torch.float32, "meta")
    x = torch.empty((B, S, d), device="meta", requires_grad=True)
    x_prev = torch.empty((B, d), device="meta")
    with _Ops() as ops:
        out, s, _ = t_rwkv.timemix_scan(x, x_prev, port, N)
        torch.autograd.grad(out.sum() + s.sum(), x)
    assert ops.names["wkv"] == 1 and ops.names["wkv_backward"] == 1
    assert ops.names["bmm"] == 0  # no step of the loop ran


def test_wrappers_refuse_what_the_kernel_does_not_take():
    arrays = _inputs(5, 1, 3, 2, 8)
    r, k, v, lw, u = _torch(arrays[:5])
    gy, gs = _torch(arrays[5:])
    meta = [t.to("meta") for t in (r, k, v, lw, u)]
    with pytest.raises(ValueError, match="unsupported device"):
        kwkv.wkv_forward(*meta)
    with pytest.raises(ValueError, match="unsupported device"):
        kwkv.wkv_backward_launch(*meta, gy.to("meta"), gs.to("meta"))
    with pytest.raises(TypeError, match="lw must be"):
        kwkv.wkv_forward(r, k, v, lw.double(), u)
    with pytest.raises(TypeError, match="k must be"):
        kwkv.wkv_forward(r, k.bfloat16(), v, lw, u)
    with pytest.raises(ValueError, match="u must be"):
        kwkv.wkv_forward(r, k, v, lw, u[:1])
    with pytest.raises(ValueError, match="gs must be"):
        kwkv.wkv_backward_launch(r, k, v, lw, u, gy, gs[:, :1])
