"""Online rightsizing service: a serving loop over ``FleetEngine``.

``RightsizingService`` keeps many live fleets rightsized under a
stream of arrivals/departures/bursts: an admission queue coalesces
requests into shape-bucketed micro-batches (one LP dispatch per tick),
perturbed fleets re-enter PDHG warm from their previous state, and a
flag-gated decision loop adopts or holds the proposed scale changes.
The loop is hardened for unattended operation: versioned
checkpoint/recovery (``serve.snapshot``), SLO-aware overload shedding
(``AdmissionQueue.shed``), and bounded retry-with-quarantine driven
under test by fault injection (``serve.faults``).  See docs/service.md
for the tick lifecycle, telemetry, and recovery semantics.

Ported from ``repro.serve`` with the same modules and public names; the
service runs over the port's ``FleetEngine`` (see ``serve.service``).
"""

from .config import ServiceConfig
from .faults import (FaultInjector, FaultSpec, InjectedFault,
                     corrupt_snapshot)
from .queue import (AdmissionQueue, PendingRequest, Request, ShedEvent,
                    NEVER_SHED_KINDS)
from .scale import ScaleCheck, ScaleDecision, ScaleEvent, evaluate_scale
from .service import (FleetView, QuarantineRecord, RightsizingService,
                      TickRecord)
from .snapshot import SNAPSHOT_VERSION, SnapshotError
from .trace import (TraceSpec, gct_trace, jobs_trace, replay,
                    replay_with_crash)

__all__ = [
    "ServiceConfig", "AdmissionQueue", "PendingRequest", "Request",
    "ShedEvent", "NEVER_SHED_KINDS",
    "ScaleCheck", "ScaleDecision", "ScaleEvent", "evaluate_scale",
    "FleetView", "QuarantineRecord", "RightsizingService", "TickRecord",
    "FaultInjector", "FaultSpec", "InjectedFault", "corrupt_snapshot",
    "SNAPSHOT_VERSION", "SnapshotError",
    "TraceSpec", "gct_trace", "jobs_trace", "replay",
    "replay_with_crash",
]
