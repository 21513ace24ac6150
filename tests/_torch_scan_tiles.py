"""The linear-scan kernels' tile walk (``csrc/scan.cu``), transcribed to
PyTorch on the CPU.

``plan`` transcribes ``make_plan``: channels a block, steps a tile, ring
stages and shared bytes for (B, W) on a card of ``sms`` SMs.  ``forward``
and ``backward`` walk the tiles as the kernels do: every block (one batch
row, C consecutive channels) runs its tiles in order (the backward in
reverse time), copies rows into a ring of ``stages`` slots ``stages - 1``
tiles ahead of the chain, in chunks of ``vec`` floats with the channels
past W skipped and the backward's h tile shifted by one step (zero at
t = -1), runs the chain one lane a channel over the rows below S, stages the
results in one of two tiles, and stores the other tile's rows to the
output.  The walk checks the pipeline's order as it goes: a slot is filled
only after the chain has left it, the chain reads only the tile it expects,
and a staging tile is stored only once it is full.  The arithmetic is the
kernels': the multiply and the add rounded apart in float32.
``tests/test_torch_scan_tiles.py`` holds the walk bit-equal to the plain
loops, and ``tests/test_torch_cuda.py`` holds ``kernels.scan.launch_plan``
to ``plan`` on the card.  Torch only, no JAX.
"""

from __future__ import annotations

import torch

THREADS = 256
MAX_CHANNELS = 64
SMEM_PER_SM = 233472      # 228 KB an SM ...
RESERVE_PER_BLOCK = 1024  # ... less 1 KB a resident block
MAX_SMEM_PER_BLOCK = 232448  # 227 KB
MAX_RESIDENT = 2048 // THREADS
SHAPES = ((64, 4), (32, 4), (32, 3), (16, 4), (16, 3), (16, 2), (8, 2))


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(T: int, C: int, stages: int, backward: bool) -> int:
    ins, outs = (3, 2) if backward else (2, 1)
    return (ins * stages + 2 * outs) * T * C * 4


def plan(B: int, W: int, backward: bool, sms: int) -> dict:
    """``launch_plan``'s keys but ``resident`` (the occupancy calculator's),
    for 16-byte-aligned tensors on a card of ``sms`` SMs."""
    C = MAX_CHANNELS
    while C > 8 and B * _ceil(W, C) < sms:
        C //= 2
    blocks = B * _ceil(W, C)
    resident = min(max(_ceil(blocks, sms), 1), MAX_RESIDENT)
    budget = min(SMEM_PER_SM // resident - RESERVE_PER_BLOCK,
                 MAX_SMEM_PER_BLOCK)
    T, stages = next(((t, s) for t, s in SHAPES
                      if smem_bytes(t, C, s, backward) <= budget), SHAPES[-1])
    return {"blocks": blocks, "channels": C, "steps": T, "stages": stages,
            "smem_bytes": smem_bytes(T, C, stages, backward),
            "threads": THREADS, "vec": 4 if W % 4 == 0 else 1}


class _Ring:
    """The ring's slots: which tile each holds, and whether the chain has
    read it (every block walks the same tiles in the same order, so one
    record serves them all)."""

    def __init__(self, blocks: int, stages: int, arrays: int, T: int,
                 C: int):
        self.data = torch.full((stages, arrays, blocks, T, C), float("nan"))
        self.tile = [None] * stages
        self.read = [True] * stages

    def fill(self, slot: int, k: int):
        assert self.read[slot], f"slot {slot} refilled before it was read"
        self.tile[slot], self.read[slot] = k, False

    def take(self, slot: int, k: int):
        assert self.tile[slot] == k and not self.read[slot], (slot, k)
        self.read[slot] = True
        return self.data[slot]


def _lanes(p: dict, B: int, W: int):
    """Per block and lane: the batch row, the channel and whether the lane's
    copy chunk (``vec`` channels from a multiple of ``vec``) lies below W."""
    C, vec = p["channels"], p["vec"]
    blk = torch.arange(p["blocks"])
    bi, c0 = blk // _ceil(W, C), blk % _ceil(W, C) * C
    q = torch.arange(C)
    cols = c0[:, None] + q[None, :]
    keep = c0[:, None] + (q // vec * vec)[None, :] < W
    return bi, cols, keep


def _copy(dst, src, lanes, t0, rows, shift):
    """Rows [0, rows) of every block's tile, row r from step t0 + r +
    shift: the chunks below W are copied, negative steps zero-filled, the
    rest left as they were."""
    bi, cols, keep = lanes
    t = t0 + shift + torch.arange(rows)
    got = src[bi[:, None, None], t.clamp(min=0)[None, :, None],
              cols.clamp(max=src.shape[2] - 1)[:, None, :]]
    got = torch.where((t >= 0)[None, :, None], got, torch.zeros_like(got))
    dst[:, :rows] = torch.where(keep[:, None, :], got, dst[:, :rows])


def _store(dst, count, stage, lanes, t0, rows):
    """Rows [0, rows) of every block's staging tile out to dst, the chunks
    below W only; ``count`` counts the stores of each element."""
    bi, cols, keep = lanes
    nb, C = cols.shape
    m = keep[:, None, :].expand(nb, rows, C)
    idx = (bi[:, None, None].expand(nb, rows, C)[m],
           (t0 + torch.arange(rows))[None, :, None].expand(nb, rows, C)[m],
           cols[:, None, :].expand(nb, rows, C)[m])
    dst.index_put_(idx, stage[:, :rows][m])
    count.index_put_(idx, torch.ones(len(idx[0]), dtype=count.dtype),
                     accumulate=True)


def _walk(ins, outs, p, order, chain, shifts):
    """The walk of every block at once.  ``order(nt)`` lists the tiles in
    the order they are run; ``chain(x, staging, rows, carry)`` runs the
    lanes over one tile and returns the new carry.  Returns how often each
    element of each output was stored, (outputs, B, S, W) int8."""
    B, S, W = ins[0].shape
    C, T, stages = p["channels"], p["steps"], p["stages"]
    nt = _ceil(S, T)
    tiles = order(nt)
    lanes = _lanes(p, B, W)
    nb = p["blocks"]
    ring = _Ring(nb, stages, len(ins), T, C)
    staging = torch.full((2, len(outs), nb, T, C), float("nan"))
    full = [None, None]
    count = torch.zeros((len(outs), B, S, W), dtype=torch.int8)

    def fetch(k):
        if k >= nt:
            return
        slot, t0 = k % stages, tiles[k] * T
        ring.fill(slot, k)
        for x, src, shift in zip(ring.data[slot], ins, shifts):
            _copy(x, src, lanes, t0, min(T, S - t0), shift)

    def store(k):
        assert full[k & 1] == k, (k, full)
        t0 = tiles[k] * T
        for y, dst, n in zip(staging[k & 1], outs, count):
            _store(dst, n, y, lanes, t0, min(T, S - t0))
        full[k & 1] = None

    for k in range(stages - 1):
        fetch(k)
    carry = torch.zeros((nb, C))
    for k in range(nt):
        # the barrier: the chain has left tile k - 1, whose slot the next
        # copies fill, and the stores of tile k - 2 have gone
        fetch(k + stages - 1)
        x = ring.take(k % stages, k)
        assert full[k & 1] is None, (k, full)
        carry = chain(x, staging[k & 1], min(T, S - tiles[k] * T), carry)
        full[k & 1] = k
        if k > 0:
            store(k - 1)
    if nt:
        store(nt - 1)
    return count


def forward(a, b, sms: int = 132, p: dict | None = None):
    """(h, stores per element) of ``ref.linear_scan_ref`` by the kernel's
    tile walk."""
    B, S, W = a.shape
    p = p or plan(B, W, False, sms)
    h = torch.full_like(b, float("nan"))

    def chain(x, stage, rows, acc):
        for r in range(rows):
            acc = x[0, :, r] * acc + x[1, :, r]
            stage[0, :, r] = acc
        return acc

    count = _walk((a, b), (h,), p, lambda nt: list(range(nt)), chain, (0, 0))
    return h, count


def backward(a, h, gh, sms: int = 132, p: dict | None = None):
    """(ga, gb, stores per element) of ``ref.linear_scan_backward_ref`` by
    the kernel's tile walk, in reverse time."""
    B, S, W = a.shape
    p = p or plan(B, W, True, sms)
    ga = torch.full_like(gh, float("nan"))
    gb = torch.full_like(gh, float("nan"))

    def chain(x, stage, rows, carry):
        for r in reversed(range(rows)):
            dh = x[1, :, r] + carry
            stage[1, :, r] = dh
            stage[0, :, r] = dh * x[2, :, r]
            carry = x[0, :, r] * dh
        return carry

    count = _walk((a, gh, h), (ga, gb), p,
                  lambda nt: list(reversed(range(nt))), chain, (0, 0, -1))
    return ga, gb, count
