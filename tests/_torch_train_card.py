"""One smoke-width training loss and backward of the port on the CPU and
again on the card, on the same weights (one ``Model`` copied with
``copy.deepcopy`` and moved with ``.to()``) and the same batch
(``train.make_batch``).  Shared by ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 14b.  It imports torch and the port only: no JAX."""

import copy

import torch

from repro_torch.configs import smoke_config
from repro_torch.models import init_params, loss_fn
from repro_torch.models import moe as lm_moe
from repro_torch.train import DataConfig, make_batch
from repro_torch.train.data import to_device

B, S = 2, 16
REMAT, CHUNK = True, 6     # the training default, and a chunk that pads S


def _loss_and_grads(model, batch):
    loss, metrics = loss_fn(model, batch, remat=REMAT, loss_chunk=CHUNK)
    names, plist = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, plist)
    return (loss.detach().cpu(), {k: v.detach().cpu()
                                  for k, v in metrics.items()},
            {n: g.cpu() for n, g in zip(names, grads)})


def train_card_vs_cpu(arch: str, device) -> dict:
    """Run ``arch``'s smoke config in float32 on the CPU, then a copy on
    ``device``: one ``loss_fn`` (remat, a padded loss chunk) and backward.
    Returns the loss difference, the largest gradient difference against
    that gradient's own max |value| (and the parameter it belongs to), and
    the MoE dispatches of each side: their count (forward and recompute)
    and whether every (slot, keep) pair is equal."""
    cfg = smoke_config(arch)
    model = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = make_batch(cfg, DataConfig(batch=B, seq_len=S, seed=7), 0)
    orig = lm_moe._dispatch
    logs = {"cpu": [], "card": []}
    runs = {}
    for side in ("cpu", "card"):
        def spy(*args, _log=logs[side]):
            buf, meta = orig(*args)
            _log.append((meta[0].cpu(), meta[1].cpu()))
            return buf, meta

        lm_moe._dispatch = spy
        try:
            m = model if side == "cpu" else copy.deepcopy(model).to(device)
            runs[side] = _loss_and_grads(
                m, to_device(batch, "cpu" if side == "cpu" else device))
        finally:
            lm_moe._dispatch = orig
    (lc, mc, gc), (lg, mg, gg) = runs["cpu"], runs["card"]
    worst, where = 0.0, None
    for name, g in gc.items():
        rel = float((g - gg[name]).abs().max()) / max(
            float(g.abs().max()), 1e-30)
        if rel >= worst:
            worst, where = rel, name
    moe_equal = len(logs["cpu"]) == len(logs["card"]) and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        for a, b in zip(logs["cpu"], logs["card"]))
    return {"loss": float((lc - lg).abs()),
            "aux": float((mc["aux"] - mg["aux"]).abs()),
            "grad_rel": worst, "grad_worst": where,
            "moe_dispatches": len(logs["cpu"]), "moe_equal": moe_equal}
