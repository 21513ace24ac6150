"""One smoke-width run of the LM port on the CPU and again on the card, on
the same weights (one ``Model`` moved with ``.to()``), the same prompt and
the same decode tokens: prefill, then ``STEPS`` decode steps.  Shared by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 13c.  It imports
torch and the port only: no JAX."""

import dataclasses

import torch

from repro_torch.configs import smoke_config
from repro_torch.launch import serve as lm_serve
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models import moe as lm_moe

B, S, STEPS = 2, 12, 4
WINDOW = 8        # local windows below the prompt: the rings wrap


def _snapshot(state) -> list:
    """A CPU copy of a decode state's caches, layer by layer."""
    return [{k: v.detach().cpu().clone() for k, v in c.items()}
            for c in state["caches"]]


def _run(model, batch, tokens):
    """(logits of each call, the states after prefill and after the last
    decode step), on CPU copies."""
    logits, state = prefill(model, batch, S + STEPS)
    out, states = [logits.cpu()], [_snapshot(state)]
    for j in range(STEPS):
        logits, state = decode_step(model, state, tokens[:, j])
        out.append(logits.cpu())
    states.append(_snapshot(state))
    return out, states


def card_vs_cpu(arch: str, device) -> dict:
    """Run ``arch``'s smoke config in float32 (local windows cut to WINDOW)
    on the CPU, then on ``device``.  Returns the largest difference of the
    logits and of the floating state leaves, whether the integer leaves
    (slot positions) are equal, and the MoE dispatches of each side: their
    count, whether every (slot, keep) pair is equal, and the tokens the CPU
    run dropped."""
    cfg = smoke_config(arch)
    cfg = dataclasses.replace(cfg, pattern=tuple(
        (k, WINDOW if w > 0 else w, t, m) for k, w, t, m in cfg.pattern))
    gen = torch.Generator().manual_seed(0)
    model = init_params(gen, cfg, "cpu")
    batch = lm_serve.make_batch(cfg, B, S, gen)
    tokens = torch.randint(0, cfg.vocab_size, (B, STEPS), generator=gen)
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
            if side == "card":
                model.to(device)
                batch = {k: v.to(device) for k, v in batch.items()}
                tokens = tokens.to(device)
            runs[side] = _run(model, batch, tokens)
        finally:
            lm_moe._dispatch = orig
    (lc, sc), (lg, sg) = runs["cpu"], runs["card"]
    e_logits = max(float((a - b).abs().max()) for a, b in zip(lc, lg))
    e_state, ints_equal = 0.0, True
    for a_st, b_st in zip(sc, sg):
        for a, b in zip(a_st, b_st):
            for k in a:
                if a[k].dtype.is_floating_point:
                    e_state = max(e_state, float((a[k] - b[k]).abs().max()))
                else:
                    ints_equal &= torch.equal(a[k], b[k])
    moe_equal = len(logs["cpu"]) == len(logs["card"]) and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        for a, b in zip(logs["cpu"], logs["card"]))
    return {"logits": e_logits, "states": e_state, "ints_equal": ints_equal,
            "moe_dispatches": len(logs["cpu"]), "moe_equal": moe_equal,
            "dropped": sum(int((~keep).sum()) for _, keep in logs["cpu"])}
