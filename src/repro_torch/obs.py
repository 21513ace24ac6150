"""The program's own spans and counters, recorded while a ``torch.profiler``
session records.

The recorder has one switch, and it is the profiler's: ``span`` and ``add``
record exactly while ``torch.autograd._profiler_enabled()`` is true, so the
spans always come with the device trace they label.  Off, ``span`` returns
one shared no-op context and ``add`` returns at once: one flag check a site.

    from torch.profiler import profile
    from repro_torch import obs

    with profile():
        engine.evaluate(problems)
    step = obs.steps()[-1]
    step["name"], step["spans"]["evaluate/place/place.verify"]
    # 'evaluate', (count, total_s, self_s, host)

A span opened on an empty stack (this thread's) is a *step*: ``evaluate``,
``plan``.  Every span under it records into that step's table, keyed by its
path (``evaluate/place/place.gather``), with its count, its total seconds
and its self seconds (the total less what its child spans cover), on the
host's ``time.perf_counter_ns`` clock.  ``add`` adds to a counter of the
innermost open step; outside a step it records nothing.  The last
``MAX_STEPS`` finished steps are kept.

``host=True`` marks a span that enqueues no device work (numpy and Python
only).  Only these also enter ``torch.profiler.record_function`` as
``repro_torch.<name>``, so that the trace's own clock shows what the host
was doing while the card idled.  A span around a launch, a copy or a
read-back stays in memory: the profiler would mirror it on the device
timeline, where it would read as device time.

``timed`` is a span whose seconds also go into a result's ``timings``,
recorder on or off: a phase that both report is timed once, on one clock.

No span may stay open across a ``yield``: the LP's solve is a generator, and
several of them run interleaved on one thread.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

__all__ = ["span", "timed", "add", "steps", "MAX_STEPS"]

MAX_STEPS = 256

_local = threading.local()
_finished: collections.deque = collections.deque(maxlen=MAX_STEPS)
_ids = itertools.count()


class _Off:
    """The one no-op span handed out while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Step:
    """One step's table: path -> [count, total ns, self ns, host], and its
    counters."""

    __slots__ = ("id", "name", "spans", "counters")

    def __init__(self, name: str):
        self.id = next(_ids)
        self.name = name
        self.spans: dict = {}
        self.counters: collections.Counter = collections.Counter()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Clock:
    """``timed`` while the recorder is off: the host-clock seconds of the
    block, added to ``into[key]``."""

    __slots__ = ("into", "key", "t0")

    def __init__(self, into: dict, key: str):
        self.into, self.key = into, key

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        self.into[self.key] = self.into.get(self.key, 0.0) + dt / 1e9
        return False


class _Span:
    __slots__ = ("name", "host", "path", "step", "child_ns", "t0", "rf",
                 "into", "key")

    def __init__(self, name: str, host: bool, into=None, key=None):
        self.name, self.host = name, host
        self.into, self.key = into, key

    def __enter__(self):
        stack = _stack()
        if stack:
            parent = stack[-1]
            self.step = parent.step
            self.path = parent.path + "/" + self.name
        else:
            self.step, self.path = _Step(self.name), self.name
        self.rf = None
        if self.host:
            self.rf = torch.profiler.record_function(
                "repro_torch." + self.name)
            self.rf.__enter__()
        self.child_ns = 0
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        stack = _local.stack
        stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        row = self.step.spans.get(self.path)
        if row is None:
            row = self.step.spans[self.path] = [0, 0, 0, self.host]
        row[0] += 1
        row[1] += dt
        row[2] += dt - self.child_ns
        if self.into is not None:
            self.into[self.key] = self.into.get(self.key, 0.0) + dt / 1e9
        if stack:
            stack[-1].child_ns += dt
        else:
            _finished.append(self.step)
        return False


def span(name: str, host: bool = False):
    """A context that records the phase ``name`` while the recorder is on
    (``host=True``: the phase enqueues no device work, and the profiler's
    trace shows it as ``repro_torch.<name>``)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, host)


def timed(name: str, into: dict, key: str, host: bool = False):
    """``span(name, host)`` that also adds its seconds to ``into[key]``
    (starting from 0), whether or not the recorder is on: the one clock of
    a phase that a result's ``timings`` and the recorder both report."""
    if not torch.autograd._profiler_enabled():
        return _Clock(into, key)
    return _Span(name, host, into, key)


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the open step, if the recorder
    is on and a step is open on this thread."""
    if not torch.autograd._profiler_enabled():
        return
    stack = getattr(_local, "stack", None)
    if stack:
        stack[-1].step.counters[name] += n


def steps() -> list[dict]:
    """The finished steps, oldest first (at most ``MAX_STEPS``): each
    ``{"id", "name", "spans": {path: (count, total_s, self_s, host)},
    "counters": {name: n}}``."""
    return [{"id": s.id, "name": s.name,
             "spans": {p: (r[0], r[1] / 1e9, r[2] / 1e9, r[3])
                       for p, r in s.spans.items()},
             "counters": dict(s.counters)}
            for s in list(_finished)]
