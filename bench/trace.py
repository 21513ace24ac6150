"""Reading a ``torch.profiler`` trace of the measured window: the device's
merged busy intervals, device seconds and launches by kernel name, the
operations that took most device time, and the longest idle gaps labelled
by what the host was doing during them."""

from __future__ import annotations

import collections
import contextlib
import functools
import importlib

import numpy as np

WINDOW_SPAN = "bench.window"
TOP = 10
NAME_CHARS = 160   # a breakdown's names are cut to this length


# the program's functions whose calls a traced run marks as host spans, by
# module: the layers' entries as the timed paths call them
SPANS = {
    "repro_torch.core.engine": ("solve_lp_many", "place_many", "verify",
                                "penalty_map", "pack_problems",
                                "trim_timeline"),
    "repro_torch.stochastic.select": ("fan_out", "trim_timeline",
                                      "pack_problems", "candidate_fleets",
                                      "overload_costs", "_select"),
}


@contextlib.contextmanager
def spans():
    """Wraps each function of ``SPANS`` that exists in a
    ``record_function`` span named ``<module>.<function>`` for the
    duration, and puts the originals back."""
    import torch

    def wrap(fn, label):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return spanned

    saved = []
    try:
        for mod_name, names in SPANS.items():
            mod = importlib.import_module(mod_name)
            for name in names:
                fn = getattr(mod, name, None)
                if callable(fn):
                    saved.append((mod, name, fn))
                    setattr(mod, name, wrap(fn, f"{mod_name}.{name}"))
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def profiler():
    """A profiler of host operations and CUDA activity (not started)."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def merge(spans: np.ndarray) -> np.ndarray:
    """(k, 2) merged, sorted busy intervals of (start, end) rows."""
    if len(spans) == 0:
        return np.zeros((0, 2), np.int64)
    iv = spans[np.argsort(spans[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.concatenate([[True], iv[1:, 0] > ends[:-1]])
    starts = iv[new, 0]
    stops = np.append(ends[np.flatnonzero(new)[1:] - 1], ends[-1])
    return np.stack([starts, stops], axis=1)


def summarize(prof) -> dict:
    """Device busy seconds, seconds and launches per device operation, the
    top device operations and the longest idle gaps of a finished
    profile.  The window is the host span named ``WINDOW_SPAN``."""
    from torch.autograd import DeviceType

    dev, host, host_names = [], [], []
    dev_s = collections.defaultdict(float)
    dev_n = collections.Counter()
    lo = hi = None
    labels = {WINDOW_SPAN} | {f"{m}.{n}" for m, ns in SPANS.items()
                              for n in ns}
    for ev in prof.profiler.kineto_results.events():
        a, b, name = ev.start_ns(), ev.end_ns(), ev.name()
        if ev.device_type() == DeviceType.CUDA and name in labels:
            continue   # a host span's annotation, mirrored on the device
        if ev.device_type() == DeviceType.CUDA:
            dev.append((a, b))
            dev_s[name] += (b - a) / 1e9
            dev_n[name] += 1
        elif name == WINDOW_SPAN:
            lo, hi = a, b
        else:
            host.append((a, b))
            host_names.append(name)
    busy = merge(np.asarray(dev, np.int64).reshape(-1, 2))
    if lo is None:
        lo = int(busy[0, 0]) if len(busy) else 0
        hi = int(busy[-1, 1]) if len(busy) else 0
    busy = np.clip(busy, lo, hi)
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e9
    edges = np.concatenate([[lo], busy.reshape(-1), [hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    longest = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")[:TOP]]
    host_iv = np.asarray(host, np.int64).reshape(-1, 2)
    idle = [[gap_label(host_iv, host_names, g0, g1), (g1 - g0) / 1e9]
            for g0, g1 in longest]
    top = [[k[:NAME_CHARS], v]
           for k, v in sorted(dev_s.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": busy_s, "device_s": dict(dev_s),
            "launches": dict(dev_n),
            "breakdown": {"device_ops": top, "idle_gaps": idle}}


def gap_label(host_iv: np.ndarray, names: list, g0: int, g1: int) -> str:
    """The innermost host operation running at the gap's middle, else the
    host operation that ended last before the gap began."""
    mid = (g0 + g1) // 2
    cover = np.flatnonzero((host_iv[:, 0] <= mid) & (host_iv[:, 1] >= mid))
    if len(cover):
        k = cover[np.argmin(host_iv[cover, 1] - host_iv[cover, 0])]
        return names[k][:NAME_CHARS]
    before = np.flatnonzero(host_iv[:, 1] <= g0)
    if len(before):
        k = before[np.argmax(host_iv[before, 1])]
        return "host work after " + names[k][:NAME_CHARS]
    return "host work before any profiled operation"


def kernel_seconds(summary: dict, kernel: str) -> tuple[float, int]:
    """(device seconds, launches) of the device operations whose name
    holds ``kernel``."""
    secs = sum(v for k, v in summary["device_s"].items() if kernel in k)
    runs = sum(v for k, v in summary["launches"].items() if kernel in k)
    return secs, runs
