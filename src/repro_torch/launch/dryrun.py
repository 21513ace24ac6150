"""Multi-pod dry-run: trace one step of every (architecture x input-shape
x mesh) cell on the production mesh with NO real allocation, and extract
the roofline inputs per device.

Ported from ``repro.launch.dryrun`` with its record, file names and CLI.
The reference lowers and compiles against 512 fake host devices; the port
runs its own step eagerly in one process:

  * a ``"fake"`` process group of 256 (16x16) or 512 (2x16x16) ranks, this
    process rank 0 (``launch.mesh.fake_world``), whose collectives move no
    data, and the production ``DeviceMesh`` over it;
  * the parameters, the training or decode state and the batch as
    ``DTensor``s on the ported specs (``repro_torch.sharding``), whose local
    shards are ``meta`` tensors: shapes, dtypes and strides without storage
    (DTensor dispatches over them several times faster than over
    ``FakeTensorMode``'s fake tensors);
  * the port's own step on them: ``train.make_train_step``, or the prefill
    or decode of ``train.make_serve_steps``, under ``implicit_replication``
    (the model's position tables and masks are plain tensors, which meet
    the sharded activations as replicated ones) and, with hints, under
    ``sharding.ctx.use_mesh``;
  * ``ReshardOnFailure`` where DTensor cannot run an op as laid out (no
    sharding rule, a rule that fails, a view its shards do not allow): it
    gathers the op's inputs to replicas, as GSPMD inserts reshards in the
    reference's compile, and the CLI's OK line counts such ops;
  * ``launch.hlo_cost.OpCounter`` around the step: FLOPs, traffic and
    collective bytes of rank 0's local ops, and the bytes of the storages
    alive at each op.

The record keeps the reference's keys.  Its sizes are rank 0's:
``argument_size_in_bytes`` and ``output_size_in_bytes`` are the local shard
bytes of the step's inputs and outputs, ``alias_size_in_bytes`` the donated
ones (parameters and state for train, the cache for decode, as the
reference's ``donate_argnums``), and ``temp_size_in_bytes`` the peak of the
live bytes during the step less the arguments.  The keys that describe
XLA's own compilation and analysis (``compile_s``, ``xla_flops``,
``xla_bytes_accessed``, ``xla_collective_bytes_once``,
``generated_code_size_in_bytes``) are ``null``: the port compiles nothing.
These records count the port's own program under a fake process group;
none of their numbers is a measurement of any device.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k \\
        --mesh pod --out results/dryrun [--device cpu]
    python -m repro_torch.launch.dryrun --all   # every eligible cell, both meshes

``--device`` names the device the records stand for (default: the CUDA
card, which must be visible; ``cpu`` on a host without one).  Each mesh of
a cell runs under its own process group, destroyed before the next.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
import traceback

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta
from torch.distributed.tensor._redistribute import redistribute_local_tensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map_only

from ..configs import SHAPES, cell_eligible, cells, get_config
from ..device import resolve_device
from ..models import Model, ModelConfig, init_decode_state
from ..sharding import batch_specs, decode_state_specs, named, param_specs
from ..sharding.ctx import use_mesh
from ..train import TrainConfig, init_train_state, make_train_step
from ..train.train_step import make_serve_steps
from .hlo_cost import OpCounter
from .mesh import fake_world, make_production_mesh

__all__ = ["batch_shapes", "input_specs", "collective_bytes", "run_cell",
           "run_step", "main"]

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


# --------------------------------------------------------------------------
# input specs (meta-tensor stand-ins; never allocated)
# --------------------------------------------------------------------------


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_shapes(cfg: ModelConfig, seq: int, batch: int, mode: str) -> dict:
    """The batch of one step as meta tensors."""
    if mode == "decode":
        return {"tokens": _meta((batch,), torch.int32)}
    b = {
        "tokens": _meta((batch, seq), torch.int32),
        "labels": _meta((batch, seq), torch.int32),
    }
    if mode == "prefill":
        del b["labels"]
    if cfg.encoder_layers:
        b["frames"] = _meta((batch, cfg.encoder_seq, cfg.d_model),
                            torch.float32)
    if cfg.vision_seq:
        b["vision"] = _meta((batch, cfg.vision_seq, cfg.d_model),
                            torch.float32)
        b["mrope_positions"] = _meta((3, batch, seq), torch.int32)
    return b


def input_specs(arch: str, shape_name: str, mode: str | None = None,
                train_cfg: TrainConfig | None = None):
    """(cfg, model, state, batch) for one cell: a ``Model`` whose
    parameters are meta tensors, the training or decode state (None for
    prefill) and the batch as meta tensors; nothing is allocated."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    return _inputs(cfg, mode or shape.mode, shape.seq_len,
                   shape.global_batch, train_cfg)


def _inputs(cfg, mode, seq, batch, train_cfg):
    model = Model(cfg, device="meta")
    b = batch_shapes(cfg, seq, batch, mode)
    if mode == "train":
        state = init_train_state(model, train_cfg or TrainConfig())
    elif mode == "decode":
        state = init_decode_state(model, batch, seq)
    else:
        state = None
    return cfg, model, state, b


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------


def collective_bytes(cost) -> dict:
    """Result bytes of every collective, by kind, and their count, from an
    ``HloCost``: the reference's ``collective_bytes`` of the HLO text."""
    out = {k: cost.collective_bytes.get(k, 0.0) for k in _COLLECTIVES}
    out["count"] = cost.collective_count
    return out


# --------------------------------------------------------------------------
# one cell
# --------------------------------------------------------------------------


def _local_bytes(t) -> int:
    """Rank 0's bytes of a step input or output.  A decode state's
    position is a Python int in the port and an int32 scalar in the
    reference's state: it counts as that scalar."""
    if isinstance(t, int):
        return 4
    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return _local_bytes(tree)


def _distribute(t, mesh, spec):
    """``t``'s stand-in as a DTensor on ``spec``: a meta local shard of rank
    0's shape, the global shape and strides of ``t``."""
    placements = named(mesh, spec)
    local = list(t.shape)
    for p, size in zip(placements, mesh.shape):
        if p.is_shard():
            local[p.dim] //= size
    return DTensor.from_local(_meta(tuple(local), t.dtype), mesh, placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _distribute_tree(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: _distribute_tree(v, specs[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_distribute_tree(v, s, mesh) for v, s in zip(tree, specs)]
    if isinstance(tree, torch.Tensor):
        return _distribute(tree, mesh, specs)
    return tree


def _distribute_model(model: Model, mesh) -> dict:
    """Replace every parameter of ``model`` by a DTensor on its spec;
    returns the specs by parameter name."""
    specs = param_specs(model, model.cfg, mesh)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, nn.Parameter(_distribute(p, mesh, specs[name]),
                                        requires_grad=p.requires_grad))
    return specs


def _state_specs(state, pspecs) -> dict:
    """The training state's specs: the optimizer moments (and compression
    residuals) share the parameter specs; the step count replicates."""
    out = {"opt": {"m": pspecs, "v": pspecs, "step": ()}}
    if "err" in state:
        out["err"] = pspecs
    return out


def _redistribute_tree(tree, specs, mesh):
    """Redistribute the DTensors of ``tree`` to ``specs`` (the reference's
    ``out_shardings``)."""
    if isinstance(tree, dict):
        return {k: _redistribute_tree(v, specs[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_redistribute_tree(v, s, mesh) for v, s in zip(tree, specs)]
    if isinstance(tree, DTensor):
        return tree.redistribute(mesh, named(mesh, specs))
    return tree


class CellFailure(RuntimeError):
    """A DTensor op of the step that failed, named in the message."""


class ReshardOnFailure(TorchDispatchMode):
    """Where DTensor cannot propagate an op's sharding (a view that would
    split a sharded dimension unevenly, an op without a sharding rule), do
    what GSPMD does in the reference's compile: gather the op's sharded
    inputs to replicas and run it there.  Each such op is counted by name
    in ``reshards``; the gathers run under the ``OpCounter`` below this
    mode and are counted as collectives."""

    def __init__(self):
        super().__init__()
        self.reshards = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        try:
            return self._dispatch(func, args, kwargs)
        except CellFailure:
            raise
        except Exception as e:
            # name the op that failed, for the FAIL line
            raise CellFailure(f"{func}: {type(e).__name__}: {e}") from e

    def _dispatch(self, func, args, kwargs):
        if func in _NEW_FACTORIES and isinstance(args[0], DTensor):
            return _new_like(func, args, kwargs)
        if func in _SCATTERS and _scatter_here(args[0], args[1]):
            rest = args[2:4]
            if not _aligned(args[0], args[1], rest):
                # lay the index and source out as the destination first
                self.reshards[str(func)] += 1
                rest = [_redistribute(t, args[0].placements) for t in rest]
            if _aligned(args[0], args[1], rest):
                return _local_scatter(func, (*args[:2], *rest, *args[4:]),
                                      kwargs)
        if func is torch.ops.aten.gather.default and _sharded_on(*args[:2]):
            # DTensor gathers along a sharded dim into a masked partial sum
            # whose reduction fails for ranks above 2: gather the source
            self.reshards[str(func)] += 1
            return func(_replicate(args[0]), *args[1:], **kwargs)
        if func._schema.is_mutable and _replicated(args[0]) and any(
                isinstance(a, DTensor) and not _replicated(a)
                for a in args[1:]):
            # an in-place op on a replica: DTensor may pick a sharded
            # strategy and relabel the replica without moving it, so the
            # other operands are gathered to replicas first
            self.reshards[str(func)] += 1
            args = (args[0], *tree_map_only(DTensor, _replicate, args[1:]))
        try:
            out = func(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as e:
            if _strided_view(func, e):
                return func(_dense_shard(args[0]), *args[1:], **kwargs)
            if not _propagation_failure(e) or func._schema.is_mutable:
                raise
        else:
            if func._schema.is_mutable:
                _check_shards(func, out)
            return out
        self.reshards[str(func)] += 1
        args, kwargs = tree_map_only(DTensor, _replicate, (args, kwargs))
        try:
            return func(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as e:
            if _strided_view(func, e):
                return func(_dense_shard(args[0]), *args[1:], **kwargs)
            if not _propagation_failure(e):
                raise
        # no usable sharding rule: every rank computes the op on its replica
        mesh = next(a.device_mesh for a in tree_leaves((args, kwargs))
                    if isinstance(a, DTensor))
        rep = (Replicate(),) * mesh.ndim
        out = func(*tree_map_only(DTensor, _local, args),
                   **tree_map_only(DTensor, _local, kwargs))
        return tree_map_only(
            torch.Tensor, lambda t: _wrap(t, mesh, rep, t.shape, t.stride()),
            out)


_SCATTERS = (torch.ops.aten.scatter_.src, torch.ops.aten.scatter.src,
             torch.ops.aten.scatter_add_.default,
             torch.ops.aten.scatter_add.default)


def _scatter_here(x, dim: int) -> bool:
    """Whether a scatter into the DTensor ``x`` along ``dim`` can be each
    device's own: ``dim`` unsharded and ``x``'s shard as its layout says."""
    return (isinstance(x, DTensor) and _consistent(x) and not any(
        p.is_shard(dim % x.ndim) for p in x.placements))


def _aligned(x, dim: int, rest) -> bool:
    """Whether a scatter into ``x`` along ``dim`` from the DTensors
    ``rest`` (index, source) is each device's own: every operand laid out
    alike, ``dim`` unsharded, and every sharded dimension of one size in
    all of them."""
    ops = [x, *rest]
    if not all(isinstance(t, DTensor) and t.placements == x.placements
               and t.ndim == x.ndim and _consistent(t) for t in ops):
        return False
    dims = {p.dim for p in x.placements if p.is_shard()}
    return dim % x.ndim not in dims and all(
        t.shape[d] == x.shape[d] for t in ops for d in dims)


def _local_scatter(func, args, kwargs):
    """A scatter along an unsharded dimension of operands sharded alike
    (the MoE dispatch's, per batch row): each device scatters its own
    shards, which is exact.  DTensor 2.11 has no in-place rule for it."""
    x = args[0]
    out = func(*tree_map_only(DTensor, _local, args),
               **tree_map_only(DTensor, _local, kwargs))
    if func._schema.is_mutable:
        return x
    return _wrap(out, x.device_mesh, x.placements, x.shape, _contiguous(
        x.shape))


_NEW_FACTORIES = (torch.ops.aten.new_zeros.default,
                  torch.ops.aten.new_empty.default,
                  torch.ops.aten.new_ones.default,
                  torch.ops.aten.new_full.default)


def _new_like(func, args, kwargs):
    """``x.new_zeros(shape)`` (and its kin) of a DTensor ``x``: DTensor
    replicates a new tensor of another shape, so a gather's backward (the
    zeros it scatters the gradient into) would hold the whole global tensor
    on every device.  Any placement is right for a constant: keep ``x``'s
    shards of a leading (batch) dimension the new shape shares with it,
    replicate the rest (shards of other dimensions could disagree with an
    in-place op that fills the new tensor)."""
    x, shape = args[0], tuple(args[1])
    mesh = x.device_mesh
    placements, local = [], list(shape)
    for p, size in zip(x.placements, mesh.shape):
        if (p.is_shard(0) and len(shape) == x.ndim and shape[0] == x.shape[0]
                and local[0] % size == 0):
            placements.append(p)
            local[p.dim] //= size
        else:
            placements.append(Replicate())
    out = func(x._local_tensor, local, *args[2:], **kwargs)
    return _wrap(out, mesh, tuple(placements), shape, _contiguous(shape))


def _contiguous(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (computed, not
    read off a tensor: a meta tensor made under the counter would count)."""
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(stride))


def _sharded_on(src, dim: int) -> bool:
    return isinstance(src, DTensor) and any(
        p.is_shard(dim % src.ndim) for p in src.placements)


# Inside the dispatch mode, below autograd, DTensors are taken apart and
# built with DTensor's own internals: its autograd-level entry points
# (redistribute, from_local, to_local) are autograd Functions, which some
# versions of PyTorch cannot run there.


def _local(x):
    return x._local_tensor


def _wrap(local, mesh, placements, shape, stride):
    spec = DTensorSpec(mesh, tuple(placements),
                       tensor_meta=TensorMeta(torch.Size(shape), tuple(stride),
                                              local.dtype))
    return DTensor(local, spec, requires_grad=False)


def _redistribute(x, placements):
    """``x`` laid out on ``placements`` (a consistent DTensor; anything
    else as it is)."""
    if not isinstance(x, DTensor) or not _consistent(x):
        return x
    spec = DTensorSpec(x.device_mesh, tuple(placements),
                       tensor_meta=x._spec.tensor_meta)
    local = redistribute_local_tensor(x._local_tensor, x._spec, spec)
    return DTensor(local, spec, requires_grad=False)


def _replicate(x):
    """``x`` gathered to a replica on every device."""
    return _redistribute(x, (Replicate(),) * x.device_mesh.ndim)


def _replicated(x) -> bool:
    return isinstance(x, DTensor) and all(p.is_replicate()
                                          for p in x.placements)


def _consistent(t) -> bool:
    """Whether a DTensor's local shard has the shape its placements give
    (an expanded DTensor's need not)."""
    want, _ = compute_local_shape_and_global_offset(t.shape, t.device_mesh,
                                                    t.placements)
    return tuple(want) == tuple(t._local_tensor.shape)


def _check_shards(func, out):
    """Raise where an in-place op left a local shard whose shape its
    placements do not give (DTensor would carry on with it)."""
    for t in tree_leaves(out):
        if isinstance(t, DTensor):
            if not _consistent(t):
                raise RuntimeError(
                    f"{func} left a local shard of {tuple(t._local_tensor.shape)}"
                    f" for {tuple(t.shape)} on {t.placements}")


def _dense_shard(x):
    """``x`` with its local shard copied contiguous (DTensor's own
    ``contiguous`` looks at the global strides only)."""
    return _wrap(x._local_tensor.contiguous(), x.device_mesh, x.placements,
                 x.shape, x.stride())


def _strided_view(func, e: Exception) -> bool:
    """A view DTensor allows on the global tensor that its local shard's
    strides do not (a shard gathered out of order): the shard is copied
    contiguous first, as a reshape would."""
    return (func in (torch.ops.aten.view.default,
                     torch.ops.aten._unsafe_view.default)
            and "view size is not compatible" in str(e))


def _propagation_failure(e: Exception) -> bool:
    text = str(e)
    return ("Sharding propagation failed" in text
            or "sharding strategy" in text
            or ("redistribute from" in text and "not supported" in text))


def run_step(cfg: ModelConfig, mode: str, seq: int, batch: int, mesh,
             train_cfg: TrainConfig | None = None,
             hints: bool = True) -> dict:
    """Trace one step of ``mode`` ("train", "prefill" or "decode") of
    ``cfg`` at ``batch`` x ``seq`` on ``mesh`` and return rank 0's
    accounting: the record's size, FLOP, traffic and collective keys and
    ``lower_s``; ``reshards`` (the ops ``ReshardOnFailure`` gathered, by
    name), ``logits_bytes`` (rank 0's bytes of a serving step's
    logits), ``workspace_bytes`` (the largest scratch of one registered
    op, ``hlo_cost.workspace_registry``) and ``workspace_temp_bytes`` (the
    temp that the busiest such op alone would give: what is live there with
    its scratch, less the arguments; the record's temp holds it).  With
    ``mesh`` None the step runs on plain meta tensors: one
    device holding everything, without DTensor."""
    tc = train_cfg or TrainConfig()
    _cfg, model, state, b = _inputs(cfg, mode, seq, batch, tc)
    sspecs = None
    if mesh is not None:
        pspecs = _distribute_model(model, mesh)
        b = _distribute_tree(b, batch_specs(b, cfg, mesh), mesh)
        if mode == "train":
            sspecs = _state_specs(state, pspecs)
        elif mode == "decode":
            sspecs = decode_state_specs(state, cfg, mesh)
        if state is not None:
            state = _distribute_tree(state, sspecs, mesh)
    params = dict(model.named_parameters())
    args = (params, state, b)
    arg_bytes = _tree_bytes(args)

    t0 = time.perf_counter()
    with implicit_replication(), use_mesh(mesh if hints else None), \
            OpCounter(device="meta") as counter, \
            ReshardOnFailure() as fallback:
        counter.track(args)
        if mode == "train":
            step = make_train_step(model, tc)
            state, metrics = step(state, b)
            out = (dict(model.named_parameters()), state, metrics)
            alias = _tree_bytes((params, state))
        elif mode == "decode":
            _pre, decode_fn = make_serve_steps(model, seq)
            logits, new_state = decode_fn(state, b["tokens"])
            if mesh is not None:
                new_state = _redistribute_tree(new_state, sspecs, mesh)
            out = (logits, new_state)
            alias = _tree_bytes(state)
        else:
            prefill_fn, _dec = make_serve_steps(model, seq)
            logits, new_state = prefill_fn(b)
            if mesh is not None:
                new_state = _redistribute_tree(
                    new_state, decode_state_specs(new_state, cfg, mesh), mesh)
            out = (logits, new_state)
            alias = 0
    lower_s = time.perf_counter() - t0
    acc = counter.cost()
    return {
        "lower_s": round(lower_s, 2),
        "flops": acc.flops,
        "traffic_bytes": acc.traffic_bytes,
        "collective_bytes": acc.collective_bytes,
        "collective_count": acc.collective_count,
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": _tree_bytes(out),
        "temp_size_in_bytes": counter.peak_bytes - arg_bytes,
        "alias_size_in_bytes": alias,
        "reshards": dict(fallback.reshards),
        "logits_bytes": _local_bytes(out[0]) if mode != "train" else 0,
        "workspace_bytes": counter.workspace_bytes,
        "workspace_temp_bytes": max(
            counter.workspace_peak_bytes - arg_bytes, 0),
    }


def _cell(arch, shape_name, multi_pod, train_cfg, hints, device):
    """(record, ``run_step``'s accounting) of one cell."""
    resolve_device(device)
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    n_dev = 512 if multi_pod else 256
    with fake_world(n_dev):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        acc = run_step(cfg, shape.mode, shape.seq_len, shape.global_batch,
                       mesh, train_cfg, hints)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "devices": n_dev,
        "mode": shape.mode,
        "sharding_hints": hints,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "lower_s": acc["lower_s"],
        "compile_s": None,
        # per-device totals
        "flops": acc["flops"],
        "traffic_bytes": acc["traffic_bytes"],
        "collective_bytes": acc["collective_bytes"],
        "collective_count": acc["collective_count"],
        # XLA's own analysis: nothing is compiled
        "xla_flops": None,
        "xla_bytes_accessed": None,
        "xla_collective_bytes_once": None,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "argument_size_in_bytes": acc["argument_size_in_bytes"],
        "output_size_in_bytes": acc["output_size_in_bytes"],
        "temp_size_in_bytes": acc["temp_size_in_bytes"],
        "generated_code_size_in_bytes": None,
        "alias_size_in_bytes": acc["alias_size_in_bytes"],
    }, acc


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             train_cfg: TrainConfig | None = None,
             hints: bool = True, device=None) -> dict:
    """One cell's record (the reference's keys).  Runs under its own fake
    process group of 256 (512 with ``multi_pod``) ranks, which it destroys
    on return."""
    return _cell(arch, shape_name, multi_pod, train_cfg, hints, device)[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--no-hints", action="store_true",
                    help="disable sharding hints (paper-faithful baseline)")
    ap.add_argument("--device", default=None,
                    help="the device the records stand for (default: the "
                         "CUDA card; 'cpu' on a host without one)")
    args = ap.parse_args(argv)

    resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    todo = []
    if args.all:
        for arch, shape_name, ok, _why in cells(include_skipped=False):
            todo.append((arch, shape_name))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        ok, why = cell_eligible(get_config(args.arch), SHAPES[args.shape])
        if not ok:
            print(f"SKIP {args.arch} x {args.shape}: {why}")
            return 0
        todo.append((args.arch, args.shape))

    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    for arch, shape_name in todo:
        for multi_pod in meshes:
            tag = f"{arch}__{shape_name}__{'2x16x16' if multi_pod else '16x16'}"
            try:
                res, acc = _cell(arch, shape_name, multi_pod, None,
                                 not args.no_hints, args.device)
                path = os.path.join(args.out, tag + ".json")
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                print(f"OK   {tag}: trace={res['lower_s']}s "
                      f"flops/dev={res['flops']:.3e} "
                      f"coll/dev={sum(res['collective_bytes'].values()):.3e}B "
                      f"reshards={sum(acc['reshards'].values())} "
                      f"workspace={acc['workspace_bytes']}B "
                      f"workspace_temp={acc['workspace_temp_bytes']}B",
                      flush=True)
            except Exception as e:
                failures += 1
                print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
