"""Two layouts of the LM port's attention, interleaved in one process on one
CUDA card: gemma2-9b at full width in bf16 served as ``chip_smoke.py``
phase 13a serves it (``launch.serve.generate``: B = 4, a 4100-token prompt,
16 greedy tokens), alternating the layout call by call.

- ``head-major``: ``repro_torch.models.attention`` as it stands (K and V
  cast to float32 and laid out head-major in one copy, batched matmuls).
- ``einsum``: the reference's einsums on float32 copies of the bf16 caches
  and chunks, the layout the port began with; defined here.

Both compute the same function (the probabilities rounded to bf16 before
the PV product).  Prints, per call, prefill s and decode ms/step; per
layout, the median of each, the generated ids, and for one profiled decode
step its kernels, busy ms and idle share; then one JSON line.  Run from the
repository root on a machine with a card:

    python3 scripts/lm_attention_ab.py [--rounds 5] [--gen 16] [--out FILE]
"""

import argparse
import json
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

ARCH, BATCH, PROMPT, GEN = "gemma2-9b", 4, 4100, 16


def einsum_streaming(q, k, v, *, window=-1, causal=True, attn_softcap=None,
                     q_offset=0, kv_offset=0, q_chunk=1024, kv_chunk=1024):
    """``attention.streaming_attention`` with the reference's einsums on
    float32 copies of each chunk."""
    import torch

    from repro_torch.models.attention import NEG_INF, _block_mask, _pad_seq
    from repro_torch.models.layers import softcap

    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = hd ** -0.5
    dev = q.device
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Skv)
    nq, nk = -(-Sq // qc), -(-Skv // kc)
    q = _pad_seq(q, nq * qc - Sq)
    k, v = _pad_seq(k, nk * kc - Skv), _pad_seq(v, nk * kc - Skv)
    qr = q.reshape(B, nq, qc, KV, G, hd)
    kr, vr = k.reshape(B, nk, kc, KV, hd), v.reshape(B, nk, kc, KV, hd)
    q_positions = q_offset + torch.arange(nq * qc, dtype=torch.int32,
                                          device=dev)
    k_positions = kv_offset + torch.arange(nk * kc, dtype=torch.int32,
                                           device=dev)
    k_valid = torch.arange(nk * kc, device=dev) < Skv
    out = []
    for i in range(nq):
        qb = qr[:, i].float()
        qpos = q_positions[i * qc:(i + 1) * qc]
        acc = torch.zeros((B, qc, KV, G, hd), dtype=torch.float32, device=dev)
        m = torch.full((B, qc, G, KV), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, qc, G, KV), dtype=torch.float32, device=dev)
        for j in range(nk):
            kb, vb = kr[:, j].float(), vr[:, j]
            kpos = k_positions[j * kc:(j + 1) * kc]
            kval = k_valid[j * kc:(j + 1) * kc]
            s = torch.einsum("bqkgd,bckd->bqgkc", qb, kb) * scale
            s = softcap(s, attn_softcap)
            mask = _block_mask(qpos, kpos, window, causal) & kval[None, :]
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bqgkc,bckd->bqkgd", p.to(v.dtype).float(),
                              vb.float())
            acc = acc * corr.transpose(2, 3)[..., None] + pv
            m = m_new
        norm = torch.clamp_min(l, 1e-37).transpose(2, 3)[..., None]
        out.append((acc / norm).to(q.dtype))
    out = torch.stack(out, dim=1).reshape(B, nq * qc, H, hd)
    return out[:, :Sq]


def einsum_decode(q, k_cache, v_cache, slot_pos, pos, *, window=-1,
                  attn_softcap=None):
    """``attention.decode_attention`` with the reference's einsums on
    float32 copies of the caches."""
    import torch

    from repro_torch.models.attention import NEG_INF
    from repro_torch.models.layers import softcap

    B, H, hd = q.shape
    _, CL, KV, _ = k_cache.shape
    qr = q.reshape(B, KV, H // KV, hd).float()
    s = torch.einsum("bkgd,bckd->bgkc", qr, k_cache.float()) * hd ** -0.5
    s = softcap(s, attn_softcap)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window > 0:
        valid &= pos - slot_pos < window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgkc,bckd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, H, hd).to(q.dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5,
                    help="calls per layout, alternating (ABBA order)")
    ap.add_argument("--gen", type=int, default=GEN,
                    help="tokens generated per call (gen - 1 decode steps)")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write the readings to this JSON file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("lm_attention_ab: no CUDA card is visible", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import attention, decode_step, init_params
    from repro_torch.models import prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    layouts = {
        "head-major": (attention.streaming_attention,
                       attention.decode_attention),
        "einsum": (einsum_streaming, einsum_decode),
    }

    def use(name):
        attention.streaming_attention, attention.decode_attention = \
            layouts[name]

    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = init_params(gen, cfg, dev)
    batch = lm_serve.make_batch(cfg, BATCH, PROMPT, gen)
    names = list(layouts)
    calls = {n: [] for n in names}
    ids = {}
    for name in names:   # a cold call each, not counted
        use(name)
        out, _ = lm_serve.generate(model, batch, args.gen)
        ids[name] = out[0].tolist()
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            use(name)
            out, info = lm_serve.generate(model, batch, args.gen)
            if not info["finite"] or out[0].tolist() != ids[name]:
                raise AssertionError(f"{name}: non-finite logits or other "
                                     f"ids than its cold call")
            ms = info["decode_s"] / info["steps"] * 1e3
            calls[name].append({"prefill_s": info["prefill_s"],
                                "decode_ms_step": ms})
            cs.log(f"round {r} {name}: prefill {info['prefill_s']:.3f} s, "
                   f"decode {ms:.3f} ms/step")
    # one decode step's logits under each layout, from the same state
    _logits, state = prefill(model, batch, max_len=PROMPT + 4)
    tokens = batch["tokens"][:, -1]
    snap = [{k: v.clone() for k, v in c.items()} for c in state["caches"]]
    step_logits, profiled = {}, {}
    for name in names:
        use(name)
        fresh = dict(state, caches=[{k: v.clone() for k, v in c.items()}
                                    for c in snap])
        step_logits[name] = decode_step(model, fresh, tokens)[0].float()
        steps = [fresh]

        def step():
            steps[0] = decode_step(model, steps[0], tokens)[1]

        ev = cs.fn_events(torch, step, reps=3, warmup=0)
        busy = sum(d for _, d in ev) * 1e3 / 3
        wall = statistics.median(c["decode_ms_step"] for c in calls[name])
        profiled[name] = {"kernels": len(ev) / 3, "busy_ms": busy,
                          "idle_share": 1.0 - busy / wall}
        del fresh, steps
    use("head-major")
    diff = float((step_logits[names[0]] - step_logits[names[1]]).abs().max())
    summary = {}
    for name in names:
        summary[name] = {
            "decode_ms_step_median": statistics.median(
                c["decode_ms_step"] for c in calls[name]),
            "prefill_s_median": statistics.median(
                c["prefill_s"] for c in calls[name]),
            "calls": calls[name], "ids_row0": ids[name], **profiled[name]}
        s = summary[name]
        cs.log(f"{name}: decode median {s['decode_ms_step_median']:.3f} "
               f"ms/step, prefill median {s['prefill_s_median']:.3f} s; a "
               f"decode step puts {s['kernels']:.1f} kernels on the card, "
               f"{s['busy_ms']:.3f} ms busy (idle share "
               f"{s['idle_share']:.4f})")
    cs.log(f"decode logits, head-major against einsum: max |diff| {diff:.3e}; "
           f"ids equal: {ids[names[0]] == ids[names[1]]}")
    wins = {n: 0 for n in names}   # rounds in which each decoded faster
    for a, b in zip(calls[names[0]], calls[names[1]]):
        wins[names[0] if a["decode_ms_step"] < b["decode_ms_step"]
             else names[1]] += 1
    cs.log(f"rounds won on decode ms/step: {wins}")
    faster = min(names, key=lambda n: summary[n]["decode_ms_step_median"])
    result = {"card": card, "arch": ARCH, "batch": BATCH, "prompt": PROMPT,
              "gen": args.gen, "rounds": args.rounds, "layouts": summary,
              "decode_rounds_won": wins,
              "logits_max_abs_diff": diff, "lower_decode_wall": faster}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps({k: v for k, v in result.items() if k != "layouts"}
                     | {"medians": {n: (summary[n]["decode_ms_step_median"],
                                        summary[n]["prefill_s_median"])
                                    for n in names}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
