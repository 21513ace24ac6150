"""Where rwkv6-7b's ``u_bonus`` gradient parts between the card and the CPU
(``chip_smoke.py`` phase 14b), measured against float64.

    python3 scripts/diagnose_rwkv_bonus_grad.py [--out FILE]

Phase 14b's setup (``tests/_torch_train_card.py``: the smoke config in
float32, B = 2, S = 16, the same weights and batch) runs one loss and
backward on the CPU and on the card, once with the time loop as the plain
loop under autograd (path "loop", the port before ``repro_torch::wkv``)
and once through the operator (path "op": the kernel on the card, the plain
reverse loop on the CPU).  Every layer's loop inputs (r, k, v, the
log-decays lw, u)
and the gradient reaching its output (gy) are recorded on each side.  The
bonus gradient is the loop's alone (u enters nowhere else), so each side's
reading splits into:

  * the loop's own error: the side's float32 gradient against the plain loop
    run in float64 (under autograd, on the CPU) on that side's inputs;
  * the inputs' share: the float64 loop on the card's inputs against the
    float64 loop on the CPU's inputs.

Every number is max |difference| / max |float64 gradient| of the layer, the
measure phase 14b uses.  It also prints phase 14b's own reading per path
(remat and a padded loss chunk: the worst gradient of all parameters and
whose it is).  Needs a CUDA card; torch and the port only.
"""

import argparse
import copy
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("diagnose_rwkv_bonus_grad: no CUDA card is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import _torch_train_card as card14b

    from repro_torch.configs import smoke_config
    from repro_torch.kernels import ref
    from repro_torch.models import init_params, loss_fn
    from repro_torch.models import rwkv
    from repro_torch.train import DataConfig, make_batch
    from repro_torch.train.data import to_device

    dev = torch.device("cuda")
    cfg = smoke_config("rwkv6-7b")
    model = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = make_batch(cfg, DataConfig(batch=card14b.B, seq_len=card14b.S,
                                       seed=7), 0)
    op = rwkv.wkv

    def loop(r, k, v, lw, u):
        return ref.wkv_ref(r, k, v, lw, u)

    def rel(a, b) -> float:
        return float((a.double() - b.double()).abs().max()) / max(
            float(b.double().abs().max()), 1e-300)

    def captured(side, path):
        """(loss, [(inputs, gy, gu)] per layer) of one side and path."""
        recs = []

        def spy(r, k, v, lw, u):
            y, s = (op if path == "op" else loop)(r, k, v, lw, u)
            rec = {"in": [t.detach().cpu() for t in (r, k, v, lw, u)]}
            y.register_hook(lambda g, rec=rec: rec.__setitem__(
                "gy", g.detach().cpu()))
            recs.append(rec)
            return y, s

        m = model if side == "cpu" else copy.deepcopy(model).to(dev)
        rwkv.wkv = spy
        try:
            loss, _ = loss_fn(m, to_device(batch, "cpu" if side == "cpu"
                                           else dev), remat=False,
                              loss_chunk=card14b.CHUNK)
            names, plist = zip(*m.named_parameters())
            grads = dict(zip(names, torch.autograd.grad(loss, plist)))
        finally:
            rwkv.wkv = op
        bonus = [g.cpu() for n, g in grads.items() if n.endswith("u_bonus")]
        return [(rec["in"], rec["gy"], gu) for rec, gu in zip(recs, bonus)]

    def f64_bonus(inputs, gy):
        x = [t.double().requires_grad_() for t in inputs]
        y, _s = ref.wkv_ref(*x)
        return torch.autograd.grad((y * gy.double()).sum(), x[4])[0]

    out = {"paths": {}}
    for path in ("loop", "op"):
        sides = {side: captured(side, path) for side in ("cpu", "card")}
        layers = []
        for j, ((in_c, gy_c, gu_c), (in_g, gy_g, gu_g)) in enumerate(
                zip(sides["cpu"], sides["card"])):
            ref_c, ref_g = f64_bonus(in_c, gy_c), f64_bonus(in_g, gy_g)
            row = {"layer": j,
                   "card_vs_cpu": rel(gu_g, gu_c),
                   "cpu_loop_error": rel(gu_c, ref_c),
                   "card_loop_error": rel(gu_g, ref_g),
                   "inputs_share": rel(ref_g, ref_c),
                   "max_abs_f64": float(ref_c.abs().max())}
            # the same CPU inputs through each float32 route
            xs = [t.to(dev) for t in in_c]
            gs = torch.zeros((xs[0].shape[0],) + tuple(xs[4].shape)
                             + (xs[4].shape[-1],), device=dev)
            row["kernel_on_cpu_inputs"] = rel(
                _kernel_bonus(xs, gy_c.to(dev), gs), ref_c)
            row["plain_reverse_on_cpu_inputs"] = rel(ref.wkv_backward_ref(
                *in_c, gy_c, gs.cpu())[4], ref_c)
            layers.append(row)
            print(f"path {path} layer {j}: " + ", ".join(
                f"{k} {v:.4g}" for k, v in row.items() if k != "layer"),
                flush=True)
        # phase 14b's own reading of u_bonus (remat, padded chunk)
        if path == "loop":
            rwkv.wkv = loop
        try:
            r14 = card14b.train_card_vs_cpu("rwkv6-7b", dev)
        finally:
            rwkv.wkv = op
        print(f"path {path}: phase 14b's reading, worst gradient "
              f"{r14['grad_rel']:.4g} at {r14['grad_worst']}", flush=True)
        out["paths"][path] = {"layers": layers, "phase14b": r14}
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


def _kernel_bonus(xs, gy, gs):
    """The kernel's bonus gradient on card tensors (the plain reverse loop
    on CPU tensors), back on the CPU."""
    from repro_torch.kernels.wkv import wkv_backward_launch

    return wkv_backward_launch(*xs, gy, gs)[4].cpu()


if __name__ == "__main__":
    sys.exit(main())
