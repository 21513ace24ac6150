"""Random inputs of the placement steppers' kernels, shared by the card
tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py`` phase 3.  Torch
and numpy only, no JAX."""

import numpy as np
import torch


def sub_phase_inputs(g, A, L, T, D, dem_scale, w0_max, purchase):
    """A random sub-phase: A lanes of up to L start-sorted attempts over T
    slots, the last dimension padded (+inf capacity, zero demand)."""
    f64 = torch.float64
    cap = 0.5 + torch.rand((A, D), generator=g, dtype=f64)
    cap[:, -1] = 1.0
    capx = cap.clone()
    capx[:, -1] = torch.inf
    dem = torch.rand((L, A, D), generator=g, dtype=f64) * dem_scale
    dem[..., -1] = 0.0
    s = torch.sort(torch.randint(0, T, (L, A), generator=g), dim=0).values
    e = torch.clamp(s + torch.randint(0, T // 2 + 1, (L, A), generator=g),
                    max=T - 1)
    dn = 0.5 + torch.rand((L, A), generator=g, dtype=f64)
    lens = torch.randint(0, L + 1, (A,), generator=g).to(torch.int32)
    w = torch.randint(0, w0_max + 1, (A,), generator=g).to(torch.int32)
    n_cap = w0_max + (L if purchase else 0)
    pool = cap.repeat(1, T)[:, None, :].expand(A, n_cap, T * D).clone()
    if not purchase:  # open rows already partly used
        pool -= torch.rand(pool.shape, generator=g, dtype=f64) * 0.3
    rows = n_cap if purchase else w0_max
    return [pool, w, lens, dem, s.to(torch.int32), e.to(torch.int32), dn,
            capx, cap], rows


def walk_inputs(rng, n, P, D, T, dem_scale, filling, unfit):
    """A random single-instance walk (the ``two_phase`` kernel's inputs):
    tasks mapped to P phases, own parts in start order, cross-fill parts of
    the later phases' tasks (filling only).  With ``unfit`` one task's
    demand exceeds its phase's capacity.  Returns (args, rank of each task's
    phase, rows)."""
    cap = 0.5 + rng.random((P, D))
    dem = rng.random((n, D)) * dem_scale * cap.min()
    start = rng.integers(0, T, n)
    end = np.minimum(start + rng.integers(0, T // 2 + 1, n), T - 1)
    phase = rng.integers(0, P, n)
    if unfit:
        u = int(rng.integers(0, n))
        dem[u] = cap[phase[u]] * 1.5
    parts = []
    for p in range(P):
        mine = np.flatnonzero(phase == p)
        parts.append(mine[np.lexsort((mine, start[mine]))])
        later = np.flatnonzero(phase > p) if filling else np.zeros(0, int)
        parts.append(rng.permutation(later))
    ends = np.cumsum([0] + [len(x) for x in parts])
    bounds = np.stack([ends[0:-1:2], ends[1::2], ends[2::2]], axis=1)
    i32, f64 = torch.int32, torch.float64
    args = [torch.as_tensor(np.concatenate(parts), dtype=i32),
            torch.as_tensor(bounds, dtype=i32), torch.as_tensor(cap, dtype=f64),
            torch.as_tensor(dem, dtype=f64), torch.as_tensor(start, dtype=i32),
            torch.as_tensor(end, dtype=i32),
            torch.as_tensor(0.5 + rng.random(n), dtype=f64)]
    rows = max(int((phase == p).sum()) for p in range(P))
    return args, phase, rows
