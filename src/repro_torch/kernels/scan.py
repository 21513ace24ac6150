"""The RG-LRU linear scan (``csrc/scan.cu``) as PyTorch operators.

``linear_scan(a, b) -> h`` runs ``h_t = a_t * h_{t-1} + b_t`` over time from
``h_{-1} = 0`` on (B, S, W) float32 tensors, as ``models.rglru`` needs it;
its backward, ``scan_backward(a, h, gh) -> (ga, gb)``, is the reverse scan.

Both are ``torch.library`` operators (``repro_torch::linear_scan``,
``repro_torch::linear_scan_backward``): the CPU implementation is the plain
version (``ref.linear_scan_ref``, ``ref.linear_scan_backward_ref``), the
CUDA one the kernel, and the fake one gives shapes only, so a ``meta`` trace
(the dry-run) sees one operator a layer.  ``linear_scan`` carries an autograd
rule whose backward is ``linear_scan_backward``.  Their FLOP formula is 0, as
``launch.hlo_cost.OpCounter`` counts matrix products only and the scan has
none (nor does the reference's ``associative_scan``).

The launch wrappers ``scan_forward`` and ``scan_backward`` add one to their
``launches`` count per launch.  The kernel rounds the multiply and the add
apart, as the plain loop does, so the two agree bit for bit on the card.
Each block of the kernel owns a few consecutive channels of one batch row
and streams time tiles through a ring in shared memory (``csrc/scan.cu``
says how); ``launch_plan`` reports the launch shape it picks.
Replaces no Pallas kernel: the reference compiles this scan as a
``lax.associative_scan`` (``repro.models.rglru.rglru_scan``).
"""

from __future__ import annotations

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from . import ref

__all__ = ["linear_scan", "scan_forward", "scan_backward", "launch_plan"]


def _check(*tensors):
    first = tensors[0]
    if first.dim() != 3:
        raise ValueError(f"need (B, S, W) tensors, got {tuple(first.shape)}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the linear scan takes float32, got {t.dtype}")
        if t.shape != first.shape:
            raise ValueError(f"shapes differ: {tuple(t.shape)} and "
                             f"{tuple(first.shape)}")
        if t.device != first.device:
            raise ValueError("all inputs must share one device")


def _cuda_args(*tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the linear scan takes contiguous tensors")
    from . import build

    return build.load("scan"), torch.cuda.current_stream(dev).cuda_stream


def scan_forward(a, b):
    """h by the kernel on CUDA tensors, by ``ref.linear_scan_ref`` on CPU
    tensors."""
    _check(a, b)
    if a.device.type == "cpu":
        return ref.linear_scan_ref(a, b)
    lib, stream = _cuda_args(a, b)
    h = torch.empty_like(b)
    err = lib.linear_scan_launch(a.data_ptr(), b.data_ptr(), h.data_ptr(),
                                 *a.shape, stream)
    if err != 0:
        raise RuntimeError(f"linear scan launch failed: CUDA error {err}")
    scan_forward.launches += 1
    return h


scan_forward.launches = 0


def scan_backward(a, h, gh):
    """(ga, gb) by the kernel on CUDA tensors, by
    ``ref.linear_scan_backward_ref`` on CPU tensors."""
    _check(a, h, gh)
    if a.device.type == "cpu":
        return ref.linear_scan_backward_ref(a, h, gh)
    lib, stream = _cuda_args(a, h, gh)
    ga, gb = torch.empty_like(gh), torch.empty_like(gh)
    err = lib.linear_scan_backward_launch(
        a.data_ptr(), h.data_ptr(), gh.data_ptr(), ga.data_ptr(),
        gb.data_ptr(), *a.shape, stream)
    if err != 0:
        raise RuntimeError(
            f"linear scan backward launch failed: CUDA error {err}")
    scan_backward.launches += 1
    return ga, gb


scan_backward.launches = 0


def launch_plan(B: int, W: int, backward: bool = False) -> dict:
    """The launch shape the kernel picks for B batch rows of W channels on
    this card, with 16-byte-aligned tensors (the sequence length does not
    change it: rows past the end are masked): blocks, channels a block,
    steps a tile, ring stages, shared bytes a block, threads a block,
    floats a copy (4, or 1 where W is not a multiple of 4) and the blocks
    an SM holds at once by the occupancy calculator.  Needs the built
    kernel and a card."""
    import ctypes

    from . import build

    info = (ctypes.c_int * 8)()
    err = build.load("scan").linear_scan_plan(B, W, int(backward), info)
    if err != 0:
        raise ValueError(f"no launch shape for B={B} W={W}")
    keys = ("blocks", "channels", "steps", "stages", "smem_bytes", "threads",
            "vec", "resident")
    return dict(zip(keys, info))


# --- the operators -----------------------------------------------------------

@torch.library.custom_op("repro_torch::linear_scan", mutates_args=())
def _scan_op(a: Tensor, b: Tensor) -> Tensor:
    return scan_forward(a, b)


@_scan_op.register_fake
def _(a, b):
    return torch.empty_like(b)


@torch.library.custom_op("repro_torch::linear_scan_backward", mutates_args=())
def _scan_backward_op(a: Tensor, h: Tensor,
                      gh: Tensor) -> tuple[Tensor, Tensor]:
    return scan_backward(a, h, gh)


@_scan_backward_op.register_fake
def _(a, h, gh):
    return torch.empty_like(gh), torch.empty_like(gh)


def _setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0], output)


def _backward(ctx, gh):
    a, h = ctx.saved_tensors
    return torch.ops.repro_torch.linear_scan_backward(a, h, gh.contiguous())


_scan_op.register_autograd(_backward, setup_context=_setup)


@register_flop_formula([torch.ops.repro_torch.linear_scan,
                        torch.ops.repro_torch.linear_scan_backward])
def _scan_flops(*args, **kwargs) -> int:
    return 0


def linear_scan(a: Tensor, b: Tensor) -> Tensor:
    """h (B, S, W) float32 of ``h_t = a_t h_{t-1} + b_t``, differentiable
    in a and b."""
    return torch.ops.repro_torch.linear_scan(a, b)
