"""The congestion kernel's launch plan where every column fits one tile.

``one_tile_plan`` transcribes ``make_plan`` of ``csrc/congestion.cu`` as it
was before the column axis was tiled: at every shape whose m * D fits one
CTA's partial sums, the tiled kernel must still pick exactly this plan.
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold
``kernels.congestion.launch_plan`` to it on the card.  Torch only, no JAX.
"""

from __future__ import annotations

MAX_THREADS = 256
MAX_CLUSTER = 8
TILE_T = 32
PART_FLOATS = 8192
STAGE_FLOATS = 8192
MIN_TASKS = 8
WARPS_PER_SM = 16


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def one_tile_plan(B: int, n: int, m: int, D: int, T: int, lp: bool,
                  sms: int) -> dict:
    """``launch_plan``'s keys but the column tiles, for one column tile on
    a card of ``sms`` SMs."""
    C = m * D
    x_cols = m if lp else 0
    t_tile = min(TILE_T, T, PART_FLOATS // C)
    rows = B * _ceil(T, t_tile)
    best, pick = -1.0, 1
    for R in (8, 4, 2, 1):
        units = C * _ceil(t_tile, R)
        pad = min(_ceil(units, 32) * 32, MAX_THREADS)
        eff = C * t_tile / (_ceil(units, pad) * pad * R)
        if eff > best:
            best, pick = eff, R
        if eff >= 0.7:
            pick = R
            break
    P = _ceil(t_tile, pick)
    unit_pad = min(_ceil(C * P, 32) * 32, MAX_THREADS)
    target = sms * WARPS_PER_SM
    warps = rows * (unit_pad // 32)
    tc = t_tile * C
    W = 1
    while (2 * W * unit_pad <= MAX_THREADS and 2 * W * tc <= PART_FLOATS
           and warps * W < target and n >= 2 * W * MIN_TASKS):
        W *= 2
    S = 1
    while (S < MAX_CLUSTER and warps * W * S < target
           and n >= 2 * S * W * MIN_TASKS):
        S *= 2
    per_task = 2 + C + x_cols
    chunk = max(1, min(_ceil(n, S), STAGE_FLOATS // per_task))
    smem = (W * tc + S * _ceil(tc, S) + chunk * per_task) * 4
    return {"t_tile": t_tile, "R": pick, "P": P, "S": S, "W": W,
            "threads": W * unit_pad, "chunk": chunk, "smem_bytes": smem}
