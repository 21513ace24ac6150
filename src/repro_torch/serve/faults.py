"""Fault injection for the serving loop — break it on purpose, in CI.

A crash-safe daemon is only believable if its failure paths run under
test.  This module is the injection harness the hardening tests and the
crash-and-recover benchmark drive:

  * ``FaultSpec``/``FaultInjector`` — declarative "fire fault X at
    fleet Y on tick Z, N times" triggers the service consults at its
    three failure points: request application (a raising request),
    the solve (solver non-convergence), and placement verification;
  * ``InjectedFault`` — the exception injected faults raise, so tests
    can tell a deliberate failure from a real one;
  * ``corrupt_snapshot`` — flips bytes inside a written checkpoint so
    recovery tests exercise the ``SnapshotError`` path.

The injector is deliberately dumb: it matches, decrements a budget, and
logs.  All retry/quarantine POLICY lives in ``serve.service`` — the
same code paths real failures take, which is the point.

Ported from ``repro.serve.faults`` unchanged.
"""

from __future__ import annotations

import dataclasses
import os

__all__ = ["FAULT_KINDS", "FaultSpec", "FaultInjector", "InjectedFault",
           "corrupt_snapshot"]

FAULT_KINDS = ("apply-raise", "nonconverge", "verify-fail")


class InjectedFault(RuntimeError):
    """Raised (or recorded) by a matching ``FaultSpec`` — distinct from
    real failures so tests can assert provenance."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection trigger.

    kind: 'apply-raise' (the request application raises mid-fold),
        'nonconverge' (treat the fleet's solve lane as failed), or
        'verify-fail' (placement verification raises).
    fleet: only fire for this fleet (None = any fleet).
    tick: only fire at this service tick (None = any tick).
    times: total firing budget (None = unlimited).  A budget of 1
        models a transient blip the first retry clears; a generous
        budget outlasts ``max_request_retries`` and forces quarantine.

    >>> FaultSpec(kind="segfault")
    Traceback (most recent call last):
        ...
    ValueError: fault kind must be one of ('apply-raise', 'nonconverge', 'verify-fail'), got 'segfault'
    """

    kind: str
    fleet: str | None = None
    tick: int | None = None
    times: int | None = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind must be one of {FAULT_KINDS}, got "
                f"{self.kind!r}")
        if self.times is not None and self.times < 1:
            raise ValueError(
                f"times must be >= 1 (or None for unlimited), got "
                f"{self.times!r}")


class FaultInjector:
    """Matches service failure points against a list of ``FaultSpec``s.

    ``fire(kind, fleet=..., tick=...)`` returns True (and decrements
    the matching spec's budget, logging to ``fired``) when a spec
    matches; the service turns that True into the corresponding
    failure.  One call consumes at most one spec.

    >>> inj = FaultInjector([FaultSpec(kind="nonconverge", fleet="a")])
    >>> inj.fire("nonconverge", fleet="a", tick=3)
    True
    >>> inj.fire("nonconverge", fleet="a", tick=4)   # budget spent
    False
    >>> inj.fired[0]["tick"]
    3
    """

    def __init__(self, specs: list[FaultSpec] | tuple[FaultSpec, ...]):
        self.specs = tuple(specs)
        self._remaining = [s.times for s in self.specs]
        self.fired: list[dict] = []

    def fire(self, kind: str, *, fleet: str, tick: int) -> bool:
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind must be one of {FAULT_KINDS}, got {kind!r}")
        for i, spec in enumerate(self.specs):
            if spec.kind != kind:
                continue
            if spec.fleet is not None and spec.fleet != fleet:
                continue
            if spec.tick is not None and spec.tick != tick:
                continue
            if self._remaining[i] is not None:
                if self._remaining[i] <= 0:
                    continue
                self._remaining[i] -= 1
            self.fired.append(
                {"kind": kind, "fleet": fleet, "tick": tick, "spec": i})
            return True
        return False


def corrupt_snapshot(path: str, nbytes: int = 16, seed: int = 0) -> str:
    """Flip ``nbytes`` bytes in the middle of a snapshot's array blob
    (falling back to the manifest if there is no blob), so restore hits
    the checksum/parse error path.  Returns the corrupted file's path.
    """
    target = os.path.join(path, "arrays.npz")
    if not os.path.exists(target):
        target = os.path.join(path, "manifest.json")
    with open(target, "rb") as f:
        blob = bytearray(f.read())
    if not blob:
        raise ValueError(f"snapshot file {target} is empty")
    # deterministic positions, clustered mid-file where npz payload
    # (not just zip framing) lives
    start = len(blob) // 2
    for k in range(nbytes):
        pos = (start + seed + k * 7919) % len(blob)
        blob[pos] ^= 0xFF
    with open(target, "wb") as f:
        f.write(bytes(blob))
    return target
