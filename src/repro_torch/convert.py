"""Carry instances and solver state into the port.

``problem_from_arrays`` builds the port's ``Problem`` from plain arrays, or
from any object that has them as attributes (``dem``, ``start``, ``end``,
``T``, ``node_types.cap``/``node_types.cost`` and optional ``constraints``,
such as a reference ``repro.core.Problem``), without importing the reference
package; constraints come across as the port's own ``TaskConstraints``.
``state_from_numpy`` builds a ``PDHGState`` from numpy iterates, and
``forecast_from_reference`` a ``DemandForecast`` from another package's
forecast.  The tests use them to feed identical instances, iterates and
forecasts to the reference and to the port.

A live serving loop needs no helper here: ``serve.snapshot`` reads and
writes the reference's snapshot format (the same manifest, arrays, version
and checksum), so a reference ``RightsizingService.snapshot(path)`` restores
in the port with ``repro_torch.serve.RightsizingService.restore(path)``,
warm states bit for bit, and the other way round.

``params_from_reference`` builds the port's LM ``Model`` from the
reference's ``init_params`` pytree, ``named_from_reference`` the port's
``{parameter name: tensor}`` dict from any pytree of that layout (gradients,
AdamW moments, error-feedback residuals), ``train_state_from_reference`` the
port's training state from the reference's ``init_train_state`` layout, and
``decode_state_from_reference`` the port's decode state from the reference's
``prefill``/``init_decode_state`` state, all given as numpy arrays
(``jax.tree.map(np.asarray, tree)``).  The reference stacks each sub-block
of a segment along a leading ``repeats`` axis; repeat r of sub-block j in
the segment starting at layer o is the port's layer o + r * len(unit) + j
(``segment_layers``).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.constraints import TaskConstraints
from .core.lp_pdhg import PDHGState
from .core.problem import NodeTypes, Problem
from .device import resolve_device
from .models.config import ModelConfig, segment_layers
from .models.model import Model
from .stochastic.forecast import DemandForecast

__all__ = ["problem_from_arrays", "constraints_from", "state_from_numpy",
           "forecast_from_reference", "segment_layers",
           "named_from_reference", "params_from_reference",
           "train_state_from_reference", "decode_state_from_reference"]


def problem_from_arrays(dem, start=None, end=None, cap=None, cost=None,
                        T=None) -> Problem:
    """The port's ``Problem`` for (n, D) ``dem``, (n,) ``start``/``end``,
    (m, D) ``cap``, (m,) ``cost`` and ``T`` slots.

    When ``dem`` is an object with those attributes (a problem of another
    package), the other arguments are read from it, and its constraints,
    when present, are carried across by ``constraints_from``.
    """
    if hasattr(dem, "node_types"):
        src = dem
        names = tuple(getattr(src.node_types, "names", ()))
        return Problem(
            dem=np.array(src.dem, np.float64),
            start=np.array(src.start, np.int64),
            end=np.array(src.end, np.int64),
            node_types=NodeTypes(cap=np.array(src.node_types.cap, np.float64),
                                 cost=np.array(src.node_types.cost,
                                               np.float64),
                                 names=names),
            T=int(src.T),
            constraints=constraints_from(getattr(src, "constraints", None)))
    return Problem(dem=np.array(dem, np.float64),
                   start=np.array(start, np.int64),
                   end=np.array(end, np.int64),
                   node_types=NodeTypes(cap=np.array(cap, np.float64),
                                        cost=np.array(cost, np.float64)),
                   T=int(T))


def constraints_from(c) -> TaskConstraints | None:
    """The port's ``TaskConstraints`` holding the six per-task arrays and
    the two group-name tuples of ``c`` (any object with those attributes,
    such as a reference ``repro.core.TaskConstraints``); None for None."""
    if c is None:
        return None
    return TaskConstraints(
        deadline=np.array(c.deadline, np.int64),
        affinity=np.array(c.affinity, np.int64),
        anti_affinity=np.array(c.anti_affinity, np.int64),
        exclusive=np.array(c.exclusive, bool),
        max_width=np.array(c.max_width, np.int64),
        serial_frac=np.array(c.serial_frac, np.float64),
        affinity_names=tuple(c.affinity_names),
        anti_names=tuple(c.anti_names))


def state_from_numpy(x, y, eta=None, omega=None) -> PDHGState:
    """``PDHGState`` from (B, n, m) primal and (B, T', m, D) dual iterates
    (stored as float32, the solver's iterate type)."""
    return PDHGState(
        x=np.asarray(x, np.float32), y=np.asarray(y, np.float32),
        eta=None if eta is None else np.asarray(eta, np.float32),
        omega=None if omega is None else np.asarray(omega, np.float32))


def forecast_from_reference(fc) -> DemandForecast:
    """The port's ``DemandForecast`` for ``fc`` (any object with a ``base``
    problem and the five channel attributes, such as a reference
    ``repro.stochastic.DemandForecast``): the base comes across through
    ``problem_from_arrays``, constraints included, and the channels as
    they are."""
    return DemandForecast(
        base=problem_from_arrays(fc.base),
        load_sigma=fc.load_sigma, diurnal_amp=fc.diurnal_amp,
        burst_prob=fc.burst_prob, burst_alpha=fc.burst_alpha,
        burst_cap=fc.burst_cap)


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 ones included) as a tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.tensor(a, device=device)  # a copy: decode writes it


def _flat(tree: dict, prefix: str = ""):
    """(dotted name, leaf) of a nested dict, the port's parameter names."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{key}.")
        else:
            yield prefix + key, val


def named_from_reference(tree: dict, cfg: ModelConfig,
                         device=None) -> dict:
    """``{port parameter name: tensor}`` on ``device`` (None = the CUDA
    card) from a pytree in the layout of the reference's ``init_params``
    (its parameters, their gradients, AdamW's ``m`` or ``v``, or the
    error-feedback residuals) as numpy arrays; each leaf keeps its dtype."""
    dev = resolve_device(device)
    sd = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    for layer, si, r, j in segment_layers(cfg):
        for name, leaf in _flat(tree["segments"][si][j]):
            sd[f"layers.{layer}.{name}"] = np.asarray(leaf)[r]
    if cfg.encoder_layers:
        enc = tree["encoder"]
        sd["encoder.final_norm"] = enc["final_norm"]
        for i in range(cfg.encoder_layers):
            for name, leaf in _flat(enc["blocks"]):
                sd[f"encoder.blocks.{i}.{name}"] = np.asarray(leaf)[i]
    return {k: _tensor(v, dev) for k, v in sd.items()}


def params_from_reference(params: dict, cfg: ModelConfig,
                          device=None) -> Model:
    """The port's ``Model`` holding the reference's parameters ``params``
    (its ``init_params`` pytree as numpy arrays) on ``device`` (None = the
    CUDA card).  Every parameter of the model is set, and every leaf used
    (``load_state_dict(strict=True)``)."""
    dev = resolve_device(device)
    model = Model(cfg, dev)
    model.load_state_dict(named_from_reference(params, cfg, dev),
                          strict=True)
    return model


def train_state_from_reference(state: dict, cfg: ModelConfig,
                               device=None) -> dict:
    """The port's training state (``train.init_train_state``'s layout) from
    the reference's, as numpy arrays, on ``device`` (None = the CUDA card):
    AdamW's ``m`` and ``v`` and, with gradient compression, ``err`` by
    parameter name, and ``step`` as an int32 tensor."""
    dev = resolve_device(device)
    opt = state["opt"]
    out = {"opt": {"m": named_from_reference(opt["m"], cfg, dev),
                   "v": named_from_reference(opt["v"], cfg, dev),
                   "step": torch.tensor(int(np.asarray(opt["step"])),
                                        dtype=torch.int32, device=dev)}}
    if "err" in state:
        out["err"] = named_from_reference(state["err"], cfg, dev)
    return out


def decode_state_from_reference(state: dict, cfg: ModelConfig,
                                device=None) -> dict:
    """The port's decode state (one cache dict per layer, ``pos`` an int)
    from the reference's (per-segment, per-sub-block caches stacked along
    ``repeats``), as numpy arrays, on ``device`` (None = the CUDA card)."""
    dev = resolve_device(device)
    caches = [None] * cfg.num_layers
    for layer, si, r, j in segment_layers(cfg):
        caches[layer] = {k: _tensor(np.asarray(v)[r], dev)
                         for k, v in state["caches"][si][j].items()}
    return {"caches": caches, "pos": int(np.asarray(state["pos"]))}
