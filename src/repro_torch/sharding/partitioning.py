"""Sharding rules: parameter, batch, and decode-state specs.

Ported from ``repro.sharding.partitioning`` with DESIGN.md §6's policy as
the reference codes it.  A *spec* is a tuple with one entry per tensor
dimension: a mesh-axis name, a tuple of names (major to minor) or None for
unsharded; ``tuple(PartitionSpec)`` of the reference's.  Specs are keyed by
the port's parameter names (``layers.{i}.attn.wq``, ...), and a per-layer
leaf has no leading ``repeats`` entry, which the reference's stacked leaves
carry.  ``named(mesh, spec)`` turns a spec into ``DTensor`` placements.

Mesh axes: ('data', 'model') single-pod; ('pod', 'data', 'model') multi-pod.

Policy (DESIGN.md §6):
  * Params: TP along 'model' (heads / ffn hidden / expert axis) + FSDP
    along 'data' (d_model or the complementary axis).  Params are
    *replicated* across 'pod' — the only cross-pod collective is the
    gradient all-reduce (the cheapest thing to put on DCN).
  * Activations: batch over ('pod', 'data') when divisible.
  * Decode caches: batch over 'data' when divisible; for global_batch=1
    long-context cells the cache length axis shards over 'data'
    (sequence-parallel KV) instead.
  * Head axes shard over 'model' only when divisible; otherwise head_dim
    takes the shard (KV-head counts of 1/2/8 vs model=16).
"""

from __future__ import annotations

from torch.distributed.tensor import Replicate, Shard

from ..models.config import ModelConfig
from .ctx import axis_sizes

__all__ = ["param_specs", "batch_specs", "decode_state_specs",
           "named", "tree_named"]


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _maybe(mesh, dim_size, axis):
    """Axis name if it divides the dim, else None."""
    return axis if _div(dim_size, _axis_size(mesh, axis)) else None


def _param_spec(name: str, shape, mesh) -> tuple:
    """The spec of one per-layer (or top-level) parameter ``name`` (its
    last dotted component) of ``shape``."""
    model = "model"
    data = "data"
    msz = _axis_size(mesh, model)

    if name == "embed":
        return (_maybe(mesh, shape[0], model), _maybe(mesh, shape[1], data))
    if name in ("wq", "wk", "wv"):       # (d, H, hd)
        d, H, hd = shape
        if _div(H, msz):
            return (_maybe(mesh, d, data), model, None)
        return (_maybe(mesh, d, data), None, _maybe(mesh, hd, model))
    if name == "wo":                      # (H, hd, d)
        H, hd, d = shape
        if _div(H, msz):
            return (model, None, _maybe(mesh, d, data))
        return (None, _maybe(mesh, hd, model), _maybe(mesh, d, data))
    if name in ("bq", "bk", "bv"):        # (H, hd)
        H, hd = shape
        if _div(H, msz):
            return (model, None)
        return (None, _maybe(mesh, hd, model))
    if name in ("w_gate", "w_up"):
        if len(shape) == 3:               # moe (E, d, ff): EP + FSDP(d)
            E, d, ff = shape
            return (_maybe(mesh, E, model), _maybe(mesh, d, data), None)
        d, ff = shape                     # dense (d, ff)
        return (_maybe(mesh, d, data), _maybe(mesh, ff, model))
    if name == "w_down":
        if len(shape) == 3:               # moe (E, ff, d)
            E, ff, d = shape
            return (_maybe(mesh, E, model), None, _maybe(mesh, d, data))
        ff, d = shape
        return (_maybe(mesh, ff, model), _maybe(mesh, d, data))
    if name == "router":                  # (d, E)
        d, E = shape
        return (_maybe(mesh, d, data), _maybe(mesh, E, model))
    if name in ("w_x",):                  # rglru (d, W)
        d, W = shape
        return (_maybe(mesh, d, data), _maybe(mesh, W, model))
    if name in ("w_input_gate", "w_rec_gate"):  # (W, W)
        W1, W2 = shape
        return (_maybe(mesh, W1, data), _maybe(mesh, W2, model))
    if name == "w_out":                   # (W|d, d)
        a, d = shape
        return (_maybe(mesh, a, model), _maybe(mesh, d, data))
    if name == "conv_w":                  # (K, W)
        return (None, _maybe(mesh, shape[1], model))
    if name == "lam":                     # (W,)
        return (_maybe(mesh, shape[0], model),)
    if name in ("w_r", "w_k", "w_v", "w_g", "w_decay"):  # rwkv (d, *)
        a, b = shape
        return (_maybe(mesh, a, data), _maybe(mesh, b, model))
    # everything small: norms, mu_*, biases, u_bonus, ln_x, decay_bias
    return (None,) * len(shape)


def param_specs(params, cfg: ModelConfig, mesh) -> dict:
    """``{parameter name: spec}`` for a ``Model`` or a ``{name: tensor}``
    dict of its parameters (or of anything shaped like them)."""
    if hasattr(params, "named_parameters"):
        params = dict(params.named_parameters())
    return {k: _param_spec(k.rsplit(".", 1)[-1], tuple(v.shape), mesh)
            for k, v in params.items()}


def _batch_axes(mesh, B: int):
    """Largest prefix of ('pod','data') whose product divides B."""
    sizes = axis_sizes(mesh)
    axes = [a for a in ("pod", "data") if a in sizes]
    prod = 1
    chosen = []
    for a in axes:
        if _div(B, prod * sizes[a]):
            chosen.append(a)
            prod *= sizes[a]
    if not chosen:
        return None
    return tuple(chosen) if len(chosen) > 1 else chosen[0]


def batch_specs(batch, cfg: ModelConfig, mesh) -> dict:
    """Specs for a train/prefill batch dict keyed by field name."""
    specs = {}
    for k, v in batch.items():
        if k == "mrope_positions":            # (3, B, S)
            specs[k] = (None, _batch_axes(mesh, v.shape[1]), None)
        elif v.ndim == 1:                     # (B,) decode tokens
            specs[k] = (_batch_axes(mesh, v.shape[0]),)
        elif v.ndim == 2:                     # (B, S)
            specs[k] = (_batch_axes(mesh, v.shape[0]), None)
        else:                                 # (B, S, d) frames/vision
            specs[k] = (_batch_axes(mesh, v.shape[0]), None, None)
    return specs


def _cache_spec(name: str, shape, mesh) -> tuple:
    """The spec of one layer's decode-state leaf ``name`` of ``shape``."""
    msz = _axis_size(mesh, "model")
    if name == "slot_pos":                # (CL,)
        return (None,)
    bax = _batch_axes(mesh, shape[0])
    if name in ("k", "v"):                # (B, CL, KV, hd)
        _b, CL, KV, hd = shape
        kv_ax = "model" if _div(KV, msz) else None
        hd_ax = None if kv_ax else _maybe(mesh, hd, "model")
        if bax is None:
            # long-context, batch=1: sequence-parallel cache
            return (None, _maybe(mesh, CL, "data"), kv_ax, hd_ax)
        return (bax, None, kv_ax, hd_ax)
    if name in ("xk", "xv"):              # (B, Se, KV, hd)
        _b, Se, KV, hd = shape
        kv_ax = "model" if _div(KV, msz) else None
        hd_ax = None if kv_ax else _maybe(mesh, hd, "model")
        return (bax, None, kv_ax, hd_ax)
    if name == "h":                       # (B, W)
        return (bax, _maybe(mesh, shape[1], "model"))
    if name == "conv":                    # (B, K-1, W)
        return (bax, None, _maybe(mesh, shape[2], "model"))
    if name == "S":                       # (B, H, N, N)
        return (bax, _maybe(mesh, shape[1], "model"), None, None)
    if name in ("x_tm", "x_cm"):          # (B, d)
        return (bax, _maybe(mesh, shape[1], "model"))
    return (None,) * len(shape)


def decode_state_specs(state, cfg: ModelConfig, mesh) -> dict:
    """Specs for a decode state ``{"caches": [one dict per layer], "pos"}``:
    the same structure, a spec per cache leaf and ``()`` for ``pos``."""
    return {"caches": [{k: _cache_spec(k, tuple(v.shape), mesh)
                        for k, v in cache.items()}
                       for cache in state["caches"]],
            "pos": ()}


def named(mesh, spec) -> tuple:
    """DTensor placements on ``mesh`` for ``spec``: ``Shard(d)`` on each
    mesh axis that tensor dimension d names (in the spec's major-to-minor
    order, which is the mesh's axis order), ``Replicate()`` elsewhere."""
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            out[mesh.mesh_dim_names.index(axis)] = Shard(d)
    return tuple(out)


def tree_named(mesh, specs):
    """``named`` over a tree of specs (dicts and lists of specs)."""
    if isinstance(specs, dict):
        return {k: tree_named(mesh, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [tree_named(mesh, v) for v in specs]
    return named(mesh, specs)
