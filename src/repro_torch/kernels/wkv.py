"""The RWKV-6 recurrence (``csrc/wkv.cu``) as PyTorch operators.

``wkv(r, k, v, lw, u) -> (y, s)`` runs the time-mix recurrence of
``models.rwkv`` over a whole sequence from a zero state:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t,    w_t = exp(lw_t)
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

r, k, v: (B, S, H, N) float32 or bfloat16; lw: (B, S, H, N) float32, the
log-decays (<= 0, may be -inf); u: (H, N) float32; y (B, S, H, N) and the
final state s (B, H, N, N) come back in float32.  Its backward,
``wkv_backward_launch(r, k, v, lw, u, gy, gs)``, returns (gr, gk, gv, glw,
gu), gr, gk and gv in the inputs' type.  The operator takes log-decays
because its backward produces their gradient glw = w * gw directly: getting
gw back would divide by w, which underflows to exactly 0.  Where w is 0 in
float32, glw is exactly 0 on either device.

On the card both run the chunked form (``ref.wkv_chunked_ref`` and
``wkv_chunked_backward_ref`` mirror it step for step): chunks of
``ref.WKV_CHUNK`` = L steps worked on in parallel with tensor-core products,
and one serial pass over the chunk states (``csrc/wkv.cu`` says how).
Scratch, allocated here, with nc = ceil(S / L): the forward hands the states
from chunk to chunk through a ring of 2 B H N^2 float32 and keeps 1 + B H nc
int32 flags (8.4 MB and 67 kB at B = 4, S = 4100, H = N = 64); the backward
keeps the states entering every chunk and the final one, B H (nc + 1) N^2
float32, their gradients, B H nc N^2 float32, the chunk decays, B H nc N
float32, and float64 bonus partials, B H nc N (279 MB at S = 2048;
``backward_scratch``).  No per-step state reaches device memory.  The
fake implementation returns the outputs only; the dry-run counts the
backward's scratch through ``backward_scratch_bytes`` (in
``launch.hlo_cost.workspace_registry``), the sum the wrapper allocates by.

Both are ``torch.library`` operators (``repro_torch::wkv``,
``repro_torch::wkv_backward``): the CPU implementation is the plain version
(``ref.wkv_ref``, ``ref.wkv_backward_ref``), the CUDA one the kernels, and
the fake one gives shapes only, so a ``meta`` trace (the dry-run) sees one
operator a layer, and the backward's scratch is counted beside it.  ``wkv``
carries an autograd rule whose backward is ``wkv_backward``.  Each operator
has a FLOP formula equal to what ``launch.hlo_cost.OpCounter`` counts for
the plain loop's products on the same shapes (2 B S H N^2 forward, 4 B S H
N^2 backward), so the dry-run's counts do not move.

The launch wrappers ``wkv_forward`` and ``wkv_backward_launch`` add one to
their ``launches`` count per call that launches the kernels (the forward's
memset and kernel, and the backward's four launches, count as one).  On a
tensor that is neither on the CPU nor on a CUDA card they raise; a CUDA build or launch
that fails raises.  Replaces no Pallas kernel: the reference compiles this
loop as a ``lax.scan`` (``repro.models.rwkv.timemix_scan``).
"""

from __future__ import annotations

import math

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from . import ref

__all__ = ["wkv", "wkv_forward", "wkv_backward_launch"]

SUPPORTED_N = (8, 16, 32, 64)  # the head sizes wkv.cu is instantiated for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(r, k, v, lw, u):
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, N), got {tuple(r.shape)}")
    B, S, H, N = r.shape
    for name, t, dtype, shape in (("r", r, r.dtype, (B, S, H, N)),
                                  ("k", k, r.dtype, (B, S, H, N)),
                                  ("v", v, r.dtype, (B, S, H, N)),
                                  ("lw", lw, torch.float32, (B, S, H, N)),
                                  ("u", u, torch.float32, (H, N))):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != r.device:
            raise ValueError("all inputs must share one device")


def _cuda_args(*tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the wkv kernel takes contiguous tensors")
    N = tensors[0].shape[-1]
    if N not in SUPPORTED_N:
        raise ValueError(f"the wkv kernel takes N in {SUPPORTED_N}, got {N}")
    if tensors[0].dtype not in _DTYPES:
        raise TypeError(f"the wkv kernel takes r, k, v in "
                        f"{list(_DTYPES)}, got {tensors[0].dtype}")
    from . import build

    lib = build.load("wkv")
    if lib.wkv_chunk() != ref.WKV_CHUNK:
        raise RuntimeError(f"wkv.cu's chunk {lib.wkv_chunk()} is not "
                           f"ref.WKV_CHUNK = {ref.WKV_CHUNK}")
    return lib, torch.cuda.current_stream(dev).cuda_stream


def _aligned(*tensors):
    """The kernels copy rows 16 bytes at a time: a tensor whose data does
    not start on 16 bytes (a view at an offset) is copied first."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in tensors)


def wkv_forward(r, k, v, lw, u):
    """(y, s) by the kernel on CUDA tensors, by ``ref.wkv_ref`` on CPU
    tensors."""
    _check(r, k, v, lw, u)
    if r.device.type == "cpu":
        return ref.wkv_ref(r, k, v, lw, u)
    lib, stream = _cuda_args(r, k, v, lw, u)
    r, k, v, lw, u = _aligned(r, k, v, lw, u)
    B, S, H, N = r.shape
    dev = r.device
    y = torch.empty((B, S, H, N), dtype=torch.float32, device=dev)
    s = torch.empty((B, H, N, N), dtype=torch.float32, device=dev)
    # the states handed from chunk to chunk, and the chunks' ready flags
    ring = torch.empty((B * H, 2, N, N), dtype=torch.float32, device=dev)
    sync = torch.empty(1 + B * H * -(-S // ref.WKV_CHUNK), dtype=torch.int32,
                       device=dev)
    err = lib.wkv_forward_launch(
        *(t.data_ptr() for t in (r, k, v, lw, u, y, s, ring, sync)),
        B, S, H, N, _DTYPES[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"wkv forward launch failed: CUDA error {err}")
    wkv_forward.launches += 1
    return y, s


wkv_forward.launches = 0


def backward_scratch(B: int, S: int, H: int, N: int) -> dict:
    """The backward kernels' scratch, ``{name: (shape, dtype)}``, with
    nc = ceil(S / L) chunks: the states entering every chunk and the final
    one, their gradients, the chunk decays and the float64 bonus partials;
    B H (2 nc + 1) N^2 * 4 + 12 B H nc N bytes in all."""
    nc = -(-S // ref.WKV_CHUNK)
    return {"states": ((B * H, nc + 1, N, N), torch.float32),
            "dstates": ((B * H, nc, N, N), torch.float32),
            "dec": ((B * H, nc, N), torch.float32),
            "gu_part": ((B, H, nc, N), torch.float64)}


def backward_scratch_bytes(B: int, S: int, H: int, N: int) -> int:
    return sum(math.prod(shape) * dtype.itemsize
               for shape, dtype in backward_scratch(B, S, H, N).values())


def wkv_backward_launch(r, k, v, lw, u, gy, gs):
    """(gr, gk, gv, glw, gu) by the kernels on CUDA tensors, by
    ``ref.wkv_backward_ref`` on CPU tensors."""
    _check(r, k, v, lw, u)
    B, S, H, N = r.shape
    for name, t, shape in (("gy", gy, (B, S, H, N)), ("gs", gs, (B, H, N, N))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or t.device != r.device:
            raise ValueError(f"{name} must be float32 {shape} on {r.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if r.device.type == "cpu":
        return ref.wkv_backward_ref(r, k, v, lw, u, gy, gs)
    lib, stream = _cuda_args(r, k, v, lw, u, gy, gs)
    r, k, v, lw, u, gy, gs = _aligned(r, k, v, lw, u, gy, gs)
    dev = r.device
    states, dstates, dec, gu_part = (
        torch.empty(shape, dtype=dtype, device=dev)
        for shape, dtype in backward_scratch(B, S, H, N).values())
    gr, gk, gv = (torch.empty((B, S, H, N), dtype=r.dtype, device=dev)
                  for _ in range(3))
    glw = torch.empty((B, S, H, N), dtype=torch.float32, device=dev)
    gu = torch.empty((H, N), dtype=torch.float32, device=dev)
    err = lib.wkv_backward_launch(
        *(t.data_ptr() for t in (r, k, v, lw, u, gy, gs, states, dstates, dec,
                                 gu_part, gr, gk, gv, glw, gu)),
        B, S, H, N, _DTYPES[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"wkv backward launch failed: CUDA error {err}")
    wkv_backward_launch.launches += 1
    return gr, gk, gv, glw, gu


wkv_backward_launch.launches = 0


# --- the operators -----------------------------------------------------------

@torch.library.custom_op("repro_torch::wkv", mutates_args=())
def _wkv_op(r: Tensor, k: Tensor, v: Tensor, lw: Tensor,
            u: Tensor) -> tuple[Tensor, Tensor]:
    return wkv_forward(r, k, v, lw, u)


@_wkv_op.register_fake
def _(r, k, v, lw, u):
    B, S, H, N = r.shape
    return (r.new_empty((B, S, H, N), dtype=torch.float32),
            r.new_empty((B, H, N, N), dtype=torch.float32))


@torch.library.custom_op("repro_torch::wkv_backward", mutates_args=())
def _wkv_backward_op(r: Tensor, k: Tensor, v: Tensor, lw: Tensor, u: Tensor,
                     gy: Tensor, gs: Tensor
                     ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    return wkv_backward_launch(r, k, v, lw, u, gy, gs)


@_wkv_backward_op.register_fake
def _(r, k, v, lw, u, gy, gs):
    return (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v),
            torch.empty_like(lw), torch.empty_like(u))


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, gy, gs):
    r, k, v, lw, u = ctx.saved_tensors
    return torch.ops.repro_torch.wkv_backward(
        r, k, v, lw, u, gy.contiguous(), gs.contiguous())


_wkv_op.register_autograd(_backward, setup_context=_setup)


@register_flop_formula(torch.ops.repro_torch.wkv)
def _wkv_flops(r_shape, *args, **kwargs) -> int:
    B, S, H, N = r_shape
    return 2 * B * S * H * N * N


@register_flop_formula(torch.ops.repro_torch.wkv_backward)
def _wkv_backward_flops(r_shape, *args, **kwargs) -> int:
    B, S, H, N = r_shape
    return 4 * B * S * H * N * N


def wkv(r: Tensor, k: Tensor, v: Tensor, lw: Tensor,
        u: Tensor) -> tuple[Tensor, Tensor]:
    """The recurrence over a sequence: (y (B, S, H, N), s (B, H, N, N)),
    both float32, differentiable in every input."""
    return torch.ops.repro_torch.wkv(r, k, v, lw, u)
