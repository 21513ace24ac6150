"""Per-device cost accounting of one eager call, from its op trace.

Ported from ``repro.launch.hlo_cost`` and named after it so that a reader
finds the counterpart, but the port reads no HLO text: ``OpCounter`` is a
``TorchDispatchMode`` that sees every ATen op one call dispatches and adds
up the reference's roofline inputs:

  * FLOPs of the matrix products (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
    convolutions and attention kernels, by ``torch.utils.flop_counter``'s
    formulas), as the reference counts dot and convolution FLOPs only;
  * memory traffic: operand + result bytes of every dispatched op that is
    not a view.  That is the eager analogue of the reference's count at
    fusion boundaries: eager PyTorch fuses nothing, so every op's boundary
    is one;
  * collective bytes by the reference's five kinds, each collective's
    result bytes (``dryrun.py``'s convention): ``all_gather_into_tensor``
    -> all-gather, ``all_reduce`` -> all-reduce, ``reduce_scatter_tensor``
    -> reduce-scatter, ``all_to_all_single`` -> all-to-all, point-to-point
    sends and receives -> collective-permute;
  * the bytes of the storages alive at each op and their peak, when the
    caller registers the call's arguments (``track``); an operator whose
    kernels allocate scratch of their own inside the call (which its fake
    implementation cannot show) has a formula for those bytes in
    ``workspace_registry``, and the peak then holds them beside what is
    live while the op runs.

**Per device.**  On a ``DTensor`` op the mode steps aside (it returns
``NotImplemented``), so DTensor runs its sharding propagation and issues
the collectives and the ops on the *local shards*, which the mode then
sees: every count is one device's, not the global tensor's (entering
``torch.utils.flop_counter.FlopCounterMode`` around DTensor code counts the
global shapes).

**Loops.**  An eager loop runs its body on every trip and the mode sees
every op, so the reference's problem — ``cost_analysis`` counting a while
body once, which ``known_trip_count`` repairs there — does not arise.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import wkv

__all__ = ["analyze", "HloCost", "OpCounter", "workspace_registry"]

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "c10d",
                  "_c10d_functional_autograd")
# ops that return their input (or a view of it) and move no bytes
_NO_TRAFFIC = {"wait_tensor", "detach", "alias", "lift_fresh",
               "_local_scalar_dense"}


# scratch bytes an operator's kernels allocate inside one call, beyond its
# outputs, as a function of the call's arguments; by op overload packet.  The
# formula is the one the operator's wrapper allocates by.
workspace_registry: dict = {
    torch.ops.repro_torch.wkv_backward:
        lambda r, *args, **kwargs: wkv.backward_scratch_bytes(*r.shape),
}


def _collective_kind(name: str) -> str | None:
    if name.startswith("all_gather"):
        return "all-gather"
    if name.startswith("all_reduce"):
        return "all-reduce"
    if name.startswith("reduce_scatter"):
        return "reduce-scatter"
    if name.startswith("all_to_all"):
        return "all-to-all"
    if name.lstrip("_i") in ("send", "recv") or "permute" in name:
        return "collective-permute"
    return None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class HloCost:
    flops: float
    traffic_bytes: float
    collective_bytes: dict
    collective_count: int

    def to_dict(self):
        return {
            "flops": self.flops,
            "traffic_bytes": self.traffic_bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_count": self.collective_count,
        }


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is entered (see the module
    docstring).  ``device``: count only ops whose tensors lie on this
    device type (the dry-run's local shards are ``meta`` tensors; the
    small host tensors DTensor's sharding propagation makes are then not
    counted).  ``live_bytes`` and ``peak_bytes`` follow the storages the
    counted ops create and the ones ``track`` registers; at an op with a
    registered workspace, ``peak_bytes`` also holds the live bytes with its
    outputs plus that scratch; ``workspace_bytes`` is the largest such
    scratch seen and ``workspace_peak_bytes`` the largest such sum."""

    def __init__(self, device: str | None = None):
        super().__init__()
        self.device = device
        self.flops = 0.0
        self.traffic = 0.0
        self.coll = collections.defaultdict(float)
        self.coll_count = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.workspace_bytes = 0
        self.workspace_peak_bytes = 0
        self._seen: dict[int, weakref.ref] = {}

    # -- memory ------------------------------------------------------------
    def _free(self, key: int, nbytes: int, _ref=None):
        self._seen.pop(key, None)
        self.live_bytes -= nbytes

    def _add(self, t: torch.Tensor):
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(st)
        ref = self._seen.get(key)
        if ref is not None and ref() is st:
            return
        nbytes = st.nbytes()
        self._seen[key] = weakref.ref(
            st, lambda r, k=key, n=nbytes: self._free(k, n, r))
        self.live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def track(self, tree):
        """Register the storages of the tensors in ``tree`` (a call's
        arguments, made before the counter was entered) as live; a
        ``DTensor`` counts its local shard."""
        for t in tree_leaves(tree):
            if isinstance(t, DTensor):
                t = t._local_tensor
            if isinstance(t, torch.Tensor):
                self._add(t)

    def cost(self) -> HloCost:
        return HloCost(
            flops=self.flops, traffic_bytes=self.traffic,
            collective_bytes={k: self.coll.get(k, 0.0) for k in _COLLECTIVES},
            collective_count=self.coll_count)

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor desugars into local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs or (self.device is not None
                        and outs[0].device.type != self.device):
            return out
        if any(issubclass(t, FakeTensor) for t in types) or any(
                isinstance(t, FakeTensor) for t in outs):
            # DTensor's sharding propagation runs an op on fake tensors of
            # the global shapes to learn its output: no device runs that
            return out
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace in _COLLECTIVE_NS:
            kind = _collective_kind(name)
            if kind is not None:
                self.coll[kind] += sum(_nbytes(t) for t in outs)
                self.coll_count += 1
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
        if not func.is_view and name not in _NO_TRAFFIC:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.traffic += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._add(t)
        if packet in workspace_registry:
            scratch = int(workspace_registry[packet](*args, **kwargs))
            self.workspace_bytes = max(self.workspace_bytes, scratch)
            self.workspace_peak_bytes = max(self.workspace_peak_bytes,
                                            self.live_bytes + scratch)
            self.peak_bytes = max(self.peak_bytes, self.workspace_peak_bytes)
        return out


def analyze(fn, *args, **kwargs) -> HloCost:
    """Trace one call ``fn(*args, **kwargs)`` and return its per-device
    FLOPs, traffic and collective bytes."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.cost()
