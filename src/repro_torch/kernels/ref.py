"""Plain PyTorch versions of the kernels.

Each function computes what its CUDA kernel computes, with the reference
package's formulas (``repro.kernels.ref``), on tensors of any device.  The
recurrences (``wkv_*``, ``linear_scan_*``) have no counterpart there: the
reference compiles its time loops (``repro.models.rwkv`` ``lax.scan``,
``repro.models.rglru`` ``associative_scan``) and takes their gradients with
``jax.grad``; these are the port's own loops over time and their reverse.  The
kernel wrappers take these for CPU tensors; the tests and ``chip_smoke.py``
hold the kernels against them.  Like the kernels, they are generic over the
trailing feature dimension (D or K).  ``lane_sum_ref`` is torch's own sum;
``lane_sum_ordered`` adds in the lane-sum kernel's order, which torch's sum
on a card does not keep.
"""

from __future__ import annotations

import torch

__all__ = ["congestion_ref", "congestion_many_ref", "congestion_lp_ref",
           "fit_scores_ref", "fit_scores_many_ref", "span_mask",
           "sub_phase_ref", "two_phase_ref", "wkv_step_ref", "wkv_ref",
           "wkv_backward_ref", "wkv_chunked_ref", "wkv_chunked_backward_ref",
           "linear_scan_ref", "linear_scan_backward_ref", "lane_view",
           "lane_sum_ref", "lane_sum_ordered"]

_EPS = 1e-7  # the placement engines' feasibility slack


def congestion_ref(start, end, w, T: int):
    """out[t, k] = sum_u [start_u <= t <= end_u] * w[u, k].

    start, end: (n,) integer inclusive slots; w: (n, K) float; out: (T, K).
    """
    return congestion_many_ref(start[None], end[None], w[None], T)[0]


def congestion_many_ref(start, end, w, T: int):
    """out[g, t, k] = sum_u [start_gu <= t <= end_gu] * w[g, u, k].

    start, end: (G, n) integer; w: (G, n, K); out: (G, T, K).
    """
    t = torch.arange(T, device=w.device, dtype=start.dtype)
    mask = ((start[:, None, :] <= t[None, :, None])
            & (t[None, :, None] <= end[:, None, :]))  # (G, T, n)
    return torch.bmm(mask.to(w.dtype), w)


def congestion_lp_ref(start, end, w_all, x, T: int):
    """out[b, t, j, k] = sum_u [start_bu <= t <= end_bu] * x[b,u,j] *
    w_all[b,u,j,k]: the LP's forward apply, as B*m groups of D columns.

    start, end: (B, n) integer; w_all: (B, n, m, D); x: (B, n, m); out:
    (B, T, m, D), a permuted view (the reference's operator="pallas"
    expression, step for step).
    """
    B, n, m, D = w_all.shape
    start_g = start.repeat_interleave(m, dim=0)
    end_g = end.repeat_interleave(m, dim=0)
    w_g = w_all.permute(0, 2, 1, 3).reshape(B * m, n, D)
    x_g = x.permute(0, 2, 1).reshape(B * m, n)
    cong = congestion_many_ref(start_g, end_g, w_g * x_g[:, :, None], T)
    return cong.reshape(B, m, T, D).permute(0, 2, 1, 3)


def span_mask(s, e, T: int, dtype=torch.float32):
    """(B, T) mask, 1 inside each row's inclusive span [s_b, e_b]."""
    t = torch.arange(T, device=s.device)
    return ((s[:, None] <= t[None, :]) & (t[None, :] <= e[:, None])).to(dtype)


def fit_scores_ref(rem, dem, mask, inv_cap):
    """Fit scoring of one task against N open nodes.

    rem: (N, T, D); dem: (D,); mask: (T,) 1 inside the span; inv_cap: (D,).
    Returns (feas_margin, dot, rem_norm2), each (N,):
      feas_margin = min over span, d of rem - dem   (feasible iff >= -eps)
      dot         = sum over span, d of (rem/cap) * (dem/cap)
      rem_norm2   = sum over span, d of (rem/cap)^2
    """
    out = fit_scores_many_ref(rem[None], dem[None], mask[None], inv_cap[None])
    return tuple(o[0] for o in out)


def fit_scores_many_ref(rem, dem, mask, inv_cap):
    """Batched fit scoring: one task per instance against its N nodes.

    rem: (B, N, T, D); dem: (B, D); mask: (B, T); inv_cap: (B, D), 0 on
    padded dims.  Returns (feas_margin, dot, rem_norm2), each (B, N).
    """
    big = torch.finfo(rem.dtype).max
    margin = rem - dem[:, None, None, :]
    inside = (mask > 0)[:, None, :, None]
    feas_margin = torch.where(inside, margin, big).amin(dim=(2, 3))
    rem_n = rem * inv_cap[:, None, None, :]
    dem_n = dem * inv_cap
    dot = torch.einsum("bntd,bd,bt->bn", rem_n, dem_n, mask)
    rem_norm2 = torch.einsum("bntd,bntd,bt->bn", rem_n, rem_n, mask)
    return feas_margin, dot, rem_norm2


def sub_phase_ref(pool, w, lens, dem_seq, s_seq, e_seq, dn_seq, capx,
                  cap_rows, quantum: float, purchase: bool,
                  similarity: bool):
    """One placement sub-phase, step by step: the compiled stepper's scan
    body (``repro.core.place_step``) as a Python loop over attempt steps,
    every lane at once, in float64.

    pool: (A, n_cap, K) remaining capacity of each lane's nodes, slot
    k = t * D + d, every row cap-initialized; updated in place.  w, lens:
    (A,) int32 open-node counts and attempt-list lengths.  dem_seq (L, A, D)
    float64, s_seq / e_seq (L, A) int32 inclusive spans, dn_seq (L, A)
    float64 demand norms.  capx (A, D) capacity, +inf on padded dims;
    cap_rows (A, D) capacity with 1.0 on padded dims.

    Returns one int32 tensor ``[w (A) | bad (A) | j_rec (L * A)]``: the
    final open-node counts, each lane's first step whose task cannot fit
    the node-type (-1 = none), and the (L, A) pool-local node each step
    placed into (-1 = no placement).
    """
    A, n_cap, K = pool.shape
    L, _, D = dem_seq.shape
    T = K // D
    dev = pool.device
    out = torch.full((2 * A + L * A,), -1, dtype=torch.int32, device=dev)
    j_rec = out[2 * A:].view(L, A)
    w = w.to(torch.int64)
    bad = torch.full((A,), -1, dtype=torch.int64, device=dev)
    lanes = torch.arange(A, device=dev)
    node_ids = torch.arange(n_cap, device=dev)
    t_ids = torch.arange(T, device=dev)
    capx_k = capx.repeat(1, T)
    for step in range(L):
        active = step < lens
        dem = dem_seq[step]
        dem_k = dem.repeat(1, T)
        span = ((s_seq[step][:, None] <= t_ids)
                & (t_ids <= e_seq[step][:, None]))
        span_k = span.repeat_interleave(D, dim=1)
        thr = dem_k - _EPS
        viol = ((pool < thr[:, None, :]) & span_k[:, None, :]).any(dim=2)
        feas = ~viol & (node_ids < w[:, None]) & active[:, None]
        has = feas.any(dim=1)
        if similarity:
            span_f = span_k.to(pool.dtype)
            rem_n = pool / capx_k[:, None, :]
            q = (dem_k / capx_k) * span_f
            dot = (rem_n * q[:, None, :]).sum(dim=2)
            rm = rem_n * span_f[:, None, :]
            norm2 = (rm * rm).sum(dim=2)
            score = dot / (dn_seq[step][:, None] * torch.sqrt(norm2) + 1e-30)
            score = torch.round(score * quantum) / quantum
            choice = torch.where(feas, score, -torch.inf).argmax(dim=1)
        else:
            choice = feas.to(torch.int8).argmax(dim=1)
        if purchase:
            buy = ~has & active
            bad_now = buy & (dem > cap_rows + _EPS).any(dim=1)
            bad = torch.where(bad_now & (bad < 0), step, bad)
            j = torch.where(has, choice, w)
            placed = active
            w = w + buy.to(torch.int64)
        else:
            j = choice
            placed = has
        rows, cols = lanes[placed], j[placed]
        pool[rows, cols] -= (dem_k * span_k.to(pool.dtype))[placed]
        j_rec[step] = torch.where(placed, j, -1).to(torch.int32)
    out[:A] = w.to(torch.int32)
    out[A: 2 * A] = bad.to(torch.int32)
    return out


def two_phase_ref(walk, bounds, cap, dem, start, end, dn, T: int,
                  quantum: float, similarity: bool, sequential: bool,
                  rows: int, work: dict | None = None):
    """One instance's whole ``two_phase`` placement, attempt by attempt: the
    ``two_phase`` entry of ``csrc/place_step.cu`` as a Python loop, in
    float64, on the inputs' device.

    walk: (E,) int32 task ids; bounds: (P, 3) int32, per phase p (a
    node-type, in two_phase's type order) the walk's entries [lo, own) are
    the type's own tasks in start order and [own, hi) its cross-fill
    candidates in increasing h_avg order (ignored unless ``sequential``,
    which also makes the phases share one placed set).  cap (P, D) float64
    per phase; dem (n, D) float64; start / end (n,) int32 inclusive slots
    below T; dn (n,) float64 demand norms (read by similarity steps only).
    ``rows`` bounds the nodes one phase may buy.

    An entry whose task is placed is skipped.  An own entry is placed by the
    policy fit (similarity when ``similarity``, else first), buying a node
    on a miss; a demand above cap + EPS stops the walk instead, naming the
    task in ``bad``, and so does a purchase past ``rows`` nodes, with
    ``bad`` = -2.  A cross-fill entry is placed first fit, never buying;
    with no node open the cross-fill is skipped.

    Returns one int32 tensor ``[w (P) | bad (P) | steps (P) | phase (n) |
    node (n)]``: per phase the nodes bought, the task that could not fit
    (-1 = none, -2 = ``rows`` too small) and the attempts made; per task the
    phase and phase-local node it was placed in (-1 = not placed).
    ``work``, when a dict, gets what the attempts needed, scanning each
    node's span slot by slot and dimension by dimension: the comparisons
    (``scored``: up to a node's first violation, and a first-fit attempt
    stops at its first feasible node), the elements of the feasible nodes a
    similarity attempt scored (``similar``) and the elements debited
    (``debited``).
    """
    dev = dem.device
    P, D = cap.shape
    n = dem.shape[0]
    out = torch.full((3 * P + 2 * n,), -1, dtype=torch.int32, device=dev)
    w_out, bad_out, steps_out = out[:P], out[P: 2 * P], out[2 * P: 3 * P]
    phase_out, node_out = out[3 * P: 3 * P + n], out[3 * P + n:]
    w_out.zero_()
    steps_out.zero_()
    walk_l, bounds_l = walk.tolist(), bounds.tolist()
    s_l, e_l = start.tolist(), end.tolist()
    tally = dict.fromkeys(("scored", "similar", "debited"), 0)
    placed = [False] * n
    pool = torch.empty((rows, T, D), dtype=torch.float64, device=dev)
    for p in range(P):
        lo, own_hi, hi = bounds_l[p]
        if not sequential:
            hi = own_hi
        c = cap[p]
        w = steps = 0
        stop = False
        for i in range(lo, hi):
            u = walk_l[i]
            if placed[u]:
                continue
            own = i < own_hi
            if not own and w == 0:
                break
            s, e = s_l[u], e_l[u]
            d = dem[u]
            steps += 1
            j = -1
            if w:
                rs = pool[:w, s: e + 1]
                viol = (rs < d - _EPS).flatten(1)
                feas = ~viol.any(dim=1)
                size = viol.shape[1]
                # comparisons a scan of each node needs: up to its first
                # violation, all of its span's elements when it fits
                need = torch.where(feas, size, viol.to(torch.int8).argmax(
                    dim=1) + 1)
                sim = similarity and own
                if not sim and bool(feas.any()):
                    need = need[: int(feas.to(torch.int8).argmax()) + 1]
                tally["scored"] += int(need.sum())
                if bool(feas.any()):
                    if sim:
                        tally["similar"] += int(feas.sum()) * size
                        rn = rs / c
                        dot = (rn * (d / c)).sum(dim=(1, 2))
                        norm2 = (rn * rn).sum(dim=(1, 2))
                        score = dot / (dn[u] * torch.sqrt(norm2) + 1e-30)
                        key = torch.round(score * quantum) / quantum
                        j = int(torch.where(feas, key, -torch.inf).argmax())
                    else:
                        j = int(feas.to(torch.int8).argmax())
            if j < 0 and own:
                if bool((d > c + _EPS).any()):
                    bad_out[p] = u
                    stop = True
                    break
                if w == rows:
                    bad_out[p] = -2
                    stop = True
                    break
                j, w = w, w + 1
                pool[j] = c
            if j >= 0:
                pool[j, s: e + 1] -= d
                tally["debited"] += (e - s + 1) * D
                phase_out[u], node_out[u] = p, j
                placed[u] = True
        w_out[p], steps_out[p] = w, steps
        if stop and sequential:
            break
    if work is not None:
        work.update(tally)
    return out


# --- recurrences (no counterpart in repro.kernels.ref) -----------------------


def _wide(x):
    """x in float32, or as it is when wider (float64 runs of the loops)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def wkv_step_ref(state, r_t, k_t, v_t, w_t, u):
    """One RWKV-6 step on (B, H, N) inputs and the (B, H, N, N) float32
    state; u (H, N).  Returns (y (B, H, N), the new state), both float32
    (float64 for float64 inputs)."""
    kv = torch.einsum("bhk,bhv->bhkv", _wide(k_t), _wide(v_t))
    y = torch.einsum("bhk,bhkv->bhv", _wide(r_t),
                     state + u[None, :, :, None] * kv)
    new = _wide(w_t)[..., None] * state + kv
    return y, new


def wkv_ref(r, k, v, lw, u):
    """The RWKV-6 recurrence over time from a zero state, one step at a
    time.  r, k, v, lw: (B, S, H, N), lw the log-decays (w = exp(lw), lw
    may be -inf); u: (H, N).  Returns (y (B, S, H, N), the final state
    (B, H, N, N)), both float32."""
    B, S, H, N = r.shape
    w = torch.exp(lw)
    state = torch.zeros((B, H, N, N), dtype=_wide(w).dtype, device=r.device)
    ys = []
    for t in range(S):
        y_t, state = wkv_step_ref(state, r[:, t], k[:, t], v[:, t], w[:, t],
                                  u)
        ys.append(y_t)
    return torch.stack(ys, dim=1), state


def wkv_backward_ref(r, k, v, lw, u, gy, gs):
    """The gradients of ``wkv_ref`` by the reverse recurrence, given gy
    (B, S, H, N) and gs (B, H, N, N): dS_T = gs, dS_{t-1} = w_t dS_t +
    r_t^T gy_t.  The states S_{t-1} come from a forward pass kept in full
    (never from dividing by w_t, which may be 0).  Returns (gr, gk, gv in
    the inputs' types, glw = gw * w and gu (H, N) float32, or float64 for
    float64 inputs)."""
    B, S, H, N = r.shape
    w = torch.exp(lw)
    f32 = dict(dtype=_wide(w).dtype, device=r.device)
    state = torch.zeros((B, H, N, N), **f32)
    states = []
    for t in range(S):
        states.append(state)
        _, state = wkv_step_ref(state, r[:, t], k[:, t], v[:, t], w[:, t],
                                u)
    gr, gk, gv, gw = (torch.empty((B, S, H, N), **f32) for _ in range(4))
    gu = torch.zeros((H, N), **f32)
    ds = _wide(gs).clone()
    for t in reversed(range(S)):
        r_t, k_t, v_t, w_t = (_wide(x[:, t]) for x in (r, k, v, w))
        g_t = _wide(gy[:, t])
        gyv = (g_t * v_t).sum(-1, keepdim=True)  # (B, H, 1)
        gr[:, t] = torch.einsum("bhj,bhij->bhi", g_t, states[t]) \
            + u * k_t * gyv
        gk[:, t] = torch.einsum("bhij,bhj->bhi", ds, v_t) + u * r_t * gyv
        gv[:, t] = torch.einsum("bhij,bhi->bhj", ds, k_t) \
            + g_t * (r_t * u * k_t).sum(-1, keepdim=True)
        gw[:, t] = (ds * states[t]).sum(-1)
        gu += (r_t * k_t * gyv).sum(0)
        ds = w_t[..., None] * ds + r_t[..., None] * g_t[..., None, :]
    return gr.to(r.dtype), gk.to(k.dtype), gv.to(v.dtype), gw * w, gu


# --- the chunked form of csrc/wkv.cu, step for step --------------------------

WKV_CHUNK = 64         # L: time steps a chunk
WKV_SUB = 16           # sub-chunks of the intra-chunk decayed scores
WKV_LEAF = 8          # blocks of the scores computed elementwise
WKV_LW_FLOOR = -1000.0  # log-decays are clamped here (exp underflows anyway)


def _wkv_chunks(x, S_pad: int):
    """(B, S, H, N) -> (B, H, nc, L, N), zero past S."""
    B, S, H, N = x.shape
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, S_pad - S))
    return x.reshape(B, S_pad // WKV_CHUNK, WKV_CHUNK, H, N).permute(
        0, 3, 1, 2, 4)


def _wkv_unchunk(x, S: int):
    B, H, nc, L, N = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(B, nc * L, H, N)[:, :S]


def _wkv_chunk_inputs(r, k, v, lw, *more):
    """The chunked operands in the working type (float64 for float64
    inputs, else float32) and the log-decay prefix sums in float64: C[t]
    the sum of the clamped lw over the chunk's steps 0..t, Cm[t] = C[t-1]
    (Cm[0] = 0).  Padding steps carry lw = 0 and zero operands."""
    S = r.shape[1]
    S_pad = -(-S // WKV_CHUNK) * WKV_CHUNK
    wd = torch.promote_types(lw.dtype, torch.float32)
    R, K, V, *M = (_wkv_chunks(x.to(wd), S_pad) for x in (r, k, v) + more)
    C = torch.cumsum(_wkv_chunks(lw.double().clamp(min=WKV_LW_FLOOR),
                                 S_pad), dim=-2)
    Cm = torch.nn.functional.pad(C, (0, 0, 1, 0))[..., :-1, :]
    return wd, R, K, V, M, C, Cm


def _e(x, wd):
    """exp of a float64 log-decay difference (<= 0), in the working type."""
    return torch.exp(x.to(wd))


def _wkv_scores(R, K, Cm, C, u, wd):
    """A[t, s] = sum_i r_t k_s exp(C[t-1] - C[s]) for s < t and the bonus
    r_t . (u k_t) on the diagonal, (..., L, L).  Sub-chunk a's rows against
    earlier sub-chunks: r scaled to the sub-chunk's anchor f = 16a - 1 and k
    from it, both factors <= 1.  Inside a sub-chunk, its second half
    against its first the same way, anchored at the first half's end;
    inside each half of WKV_LEAF steps, elementwise."""
    L, SUB = WKV_CHUNK, WKV_SUB
    A = torch.zeros(R.shape[:-1] + (L,), dtype=wd, device=R.device)

    def anchored(rows, cols, anchor):
        Ca = C[..., anchor:anchor + 1, :]
        return (R[..., rows, :] * _e(Cm[..., rows, :] - Ca, wd)) \
            @ (K[..., cols, :] * _e(Ca - C[..., cols, :], wd)).transpose(-1, -2)

    def block(o, w):
        if w > WKV_LEAF:
            h = w // 2
            A[..., o + h:o + w, o:o + h] = anchored(
                slice(o + h, o + w), slice(o, o + h), o + h - 1)
            block(o, h)
            block(o + h, h)
            return
        rows = slice(o, o + w)
        low = torch.ones(w, w, dtype=torch.bool, device=R.device).tril(-1)
        d = Cm[..., rows, None, :] - C[..., None, rows, :]  # (.., t, s, N)
        E = _e(torch.where(low[:, :, None], d, float("-inf")), wd)
        A[..., rows, rows] = (R[..., rows, None, :] * K[..., None, rows, :]
                              * E).sum(-1)

    for a in range(L // SUB):
        o = a * SUB
        if a:
            A[..., o:o + SUB, :o] = anchored(slice(o, o + SUB), slice(0, o),
                                             o - 1)
        block(o, SUB)
    diag = (R * u.to(wd)[:, None, None, :] * K).sum(-1)
    return A + torch.diag_embed(diag)


def _wkv_states(K, V, C, wd):
    """Per chunk the state increment (k exp(C_end - C))^T v and the decay
    exp(C_end), then the serial pass: the state entering each chunk and,
    last, the final state (..., nc + 1, N, N)."""
    Cend = C[..., -1:, :]
    dS = (K * _e(Cend - C, wd)).transpose(-1, -2) @ V
    dec = _e(Cend, wd).transpose(-1, -2)  # (..., nc, N, 1)
    B, H, nc, N, _ = dS.shape
    S_in = torch.zeros((B, H, nc + 1, N, N), dtype=wd, device=K.device)
    for c in range(nc):
        S_in[:, :, c + 1] = dec[:, :, c] * S_in[:, :, c] + dS[:, :, c]
    return S_in, dec


def wkv_chunked_ref(r, k, v, lw, u):
    """``wkv_ref`` by the chunked form that ``csrc/wkv.cu`` runs: chunks of
    WKV_CHUNK steps, float64 prefix sums of the clamped log-decays, the
    intra-chunk scores by sub-chunks of WKV_SUB, halved down to blocks of
    WKV_LEAF (no factor above 1), one
    serial pass over chunk states, then y = A v + (r exp(C[t-1])) S_in.
    Used by the tests only."""
    B, S, H, N = r.shape
    wd, R, K, V, _, C, Cm = _wkv_chunk_inputs(r, k, v, lw)
    S_in, _ = _wkv_states(K, V, C, wd)
    A = _wkv_scores(R, K, Cm, C, u, wd)
    y = A @ V + (R * _e(Cm, wd)) @ S_in[:, :, :-1]
    return _wkv_unchunk(y, S), S_in[:, :, -1]


def wkv_chunked_backward_ref(r, k, v, lw, u, gy, gs):
    """``wkv_backward_ref`` by the chunked form of ``csrc/wkv.cu``: the
    chunk states S_in, the reverse pass over chunks dS_out[c-1] =
    exp(C_end) dS_out[c] + (r exp(C[t-1]))^T gy, then per chunk gr, gk, gv
    as products against S_in, dS_out, A and dA = gy v^T, and glw by the
    reverse cumulative sum identity, with no division:

        glw_s = rowsum(dS_out * S_out) + sum_{t > s} r_t gr'_t
                - sum_{t >= s} k_t gk'_t

    (gr', gk' without the bonus terms), glw_0 = 0 and glw = 0 wherever
    the step's decay is 0.  gu summed in
    float64.  Returns
    (gr, gk, gv in the inputs' types, glw and gu in the working type)."""
    B, S, H, N = r.shape
    L, SUB = WKV_CHUNK, WKV_SUB
    wd, R, K, V, (G,), C, Cm = _wkv_chunk_inputs(r, k, v, lw, gy)
    S_in, dec = _wkv_states(K, V, C, wd)
    nc = S_in.shape[2] - 1
    ddS = (R * _e(Cm, wd)).transpose(-1, -2) @ G
    dS_out = torch.empty_like(S_in[:, :, :-1])
    d = gs.to(wd)
    for c in reversed(range(nc)):
        dS_out[:, :, c] = d
        d = dec[:, :, c] * d + ddS[:, :, c]
    A = _wkv_scores(R, K, Cm, C, u, wd)
    low = torch.ones(L, L, dtype=torch.bool, device=r.device).tril()
    dA = torch.where(low, G @ V.transpose(-1, -2), 0.0)
    bonus = torch.diagonal(dA, dim1=-2, dim2=-1)[..., None]  # gy_t . v_t
    Sn = S_in[:, :, :-1]
    Cend = C[..., -1:, :]
    gv = A.transpose(-1, -2) @ G + (K * _e(Cend - C, wd)) @ dS_out
    gr = torch.empty_like(R)
    gk = torch.empty_like(K)
    tri = torch.ones(SUB, SUB, dtype=torch.bool,
                     device=r.device).tril(-1)[:, :, None]
    zero = torch.zeros((), dtype=wd, device=r.device)
    for a in range(L // SUB):
        rows = slice(a * SUB, (a + 1) * SUB)
        # gr: dA's earlier columns anchored at f = 16a - 1, and S_in
        Cf = Cm[..., a * SUB:a * SUB + 1, :]
        acc = zero
        if a:
            Kf = K[..., :a * SUB, :] * _e(Cf - C[..., :a * SUB, :], wd)
            acc = dA[..., rows, :a * SUB] @ Kf
        gr[..., rows, :] = _e(Cm[..., rows, :] - Cf, wd) * acc \
            + _e(Cm[..., rows, :], wd) * (G[..., rows, :]
                                          @ Sn.transpose(-1, -2))
        # gk: dA's later rows anchored at e = 16a + 15, and dS_out
        Ce = C[..., (a + 1) * SUB - 1:(a + 1) * SUB, :]
        acc = zero
        if a < L // SUB - 1:
            Rf = R[..., (a + 1) * SUB:, :] \
                * _e(Cm[..., (a + 1) * SUB:, :] - Ce, wd)
            acc = dA[..., (a + 1) * SUB:, rows].transpose(-1, -2) @ Rf
        gk[..., rows, :] = _e(Ce - C[..., rows, :], wd) * acc \
            + _e(Cend - C[..., rows, :], wd) * (V[..., rows, :]
                                                @ dS_out.transpose(-1, -2))
        # inside the sub-chunk, elementwise
        dd = Cm[..., rows, None, :] - C[..., None, rows, :]  # (.., t, s, N)
        E = _e(torch.where(tri, dd, float("-inf")), wd)
        P = dA[..., rows, rows, None] * E
        gr[..., rows, :] += (P * K[..., None, rows, :]).sum(-2)
        gk[..., rows, :] += (P * R[..., rows, None, :]).sum(-3)
    S_out = S_in[:, :, 1:]
    Kc = (dS_out * S_out).double().sum(-1)[..., None, :]  # (.., 1, N)
    P = (R * gr).double()
    Q = (K * gk).double()
    rev = lambda x: torch.flip(torch.cumsum(torch.flip(x, [-2]), -2), [-2])
    glw = (Kc + rev(P) - P - rev(Q)).to(wd)
    # w_0 multiplies the zero initial state: glw_0 is exactly 0; so is glw
    # wherever the step's decay exp(C[t] - C[t-1]) = w is 0 in the working
    # type, as gw * w is (the sums above would leave their rounding there,
    # which the model's chain rule scales by |lw|)
    glw[:, :, 0, 0] = 0.0
    glw = torch.where(_e(C - Cm, wd) == 0, 0.0, glw)
    uw = u.to(wd)[:, None, None, :]
    gr = gr + uw * K * bonus
    gk = gk + uw * R * bonus
    gu = (R * K * bonus).double().sum((0, 2, 3)).to(wd)
    return (_wkv_unchunk(gr, S).to(r.dtype), _wkv_unchunk(gk, S).to(k.dtype),
            _wkv_unchunk(gv, S).to(v.dtype), _wkv_unchunk(glw, S), gu)


def linear_scan_ref(a, b):
    """h_t = a_t * h_{t-1} + b_t over time from h_{-1} = 0, on (B, S, W)
    float32: one step at a time, the multiply and the add rounded apart."""
    h = torch.empty_like(b)
    h_t = torch.zeros_like(b[:, 0])
    for t in range(b.shape[1]):
        h_t = a[:, t] * h_t + b[:, t]
        h[:, t] = h_t
    return h


def linear_scan_backward_ref(a, h, gh):
    """The gradients of ``linear_scan_ref`` given gh: dh_t = gh_t +
    a_{t+1} dh_{t+1}, ga_t = dh_t h_{t-1}, gb_t = dh_t.  Returns (ga, gb)."""
    ga, gb = torch.empty_like(gh), torch.empty_like(gh)
    carry = torch.zeros_like(gh[:, 0])
    for t in reversed(range(gh.shape[1])):
        dh = gh[:, t] + carry
        gb[:, t] = dh
        ga[:, t] = dh * h[:, t - 1] if t > 0 else dh * 0.0
        carry = a[:, t] * dh
    return ga, gb


def lane_view(shape, dims) -> tuple[int, int, int, int]:
    """(B, R1, M, R2) such that summing ``dims`` of a contiguous tensor of
    ``shape`` is summing axes 1 and 3 of its (B, R1, M, R2) view: ``dims``
    is every axis but the first, or (1, 3) of a 4-axis shape (the two sums
    the LP makes over a lane's elements).  Raises ValueError otherwise."""
    dims = tuple(sorted(int(d) % len(shape) for d in dims))
    if len(shape) >= 2 and dims == tuple(range(1, len(shape))):
        rest = 1
        for s in shape[1:]:
            rest *= int(s)
        return int(shape[0]), rest, 1, 1
    if len(shape) == 4 and dims == (1, 3):
        return tuple(int(s) for s in shape)
    raise ValueError(
        f"lane sums take every axis but the first, or axes (1, 3) of a "
        f"4-axis tensor; got dims {dims} of shape {tuple(shape)}")


def lane_sum_ref(x, dims):
    """``x.sum(dim=dims, keepdim=True)`` over one of ``lane_view``'s axis
    sets: the plain version of the lane-sum kernel."""
    lane_view(x.shape, dims)
    return x.sum(dim=tuple(dims), keepdim=True)


def _ordered_rows(v, chunk: int, threads: int = 256):
    """(P,) sums of the (P, R) rows of v in the kernel's order: chunks of
    ``chunk``; in each, thread t adds elements t, t + threads, ... from +0;
    a butterfly over each warp's 32 sums, then over the warps' sums padded
    with zeros to 32; the chunk sums of a row summed again the same way."""
    P, R = v.shape
    chunks = max(1, -(-R // chunk))
    v = torch.nn.functional.pad(v, (0, chunks * chunk - R))
    v = v.reshape(P, chunks, chunk // threads, threads)
    acc = torch.zeros((P, chunks, threads), dtype=v.dtype, device=v.device)
    for i in range(chunk // threads):
        acc = acc + v[:, :, i]

    def butterfly(a):  # lane 0's value of a shuffle-xor tree over 32
        for s in (16, 8, 4, 2, 1):
            a = a[..., :s] + a[..., s:2 * s]
        return a[..., 0]

    warps = butterfly(acc.reshape(P, chunks, threads // 32, 32))
    part = butterfly(torch.nn.functional.pad(warps, (0, 32 - threads // 32)))
    return part[:, 0] if chunks == 1 else _ordered_rows(part, chunk, threads)


def lane_sum_ordered(x, dims, chunk: int):
    """``lane_sum_ref`` with the lane-sum kernel's order of adds (chunks of
    ``chunk`` elements an output): bit-equal to the kernel, and for a given
    lane the same in a batch of any size."""
    B, R1, M, R2 = lane_view(x.shape, dims)
    rows = x.reshape(B, R1, M, R2).permute(0, 2, 1, 3).reshape(B * M,
                                                                R1 * R2)
    keep = [1 if a in {int(d) % x.dim() for d in dims} else s
            for a, s in enumerate(x.shape)]
    return _ordered_rows(rows, chunk).reshape(keep)
