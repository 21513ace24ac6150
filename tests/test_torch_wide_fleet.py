"""The D = 274 constrained fleet through ``FleetEngine(device="cpu")``
against the reference's ``FleetEngine()`` (legacy LP, batched placement).

Two ``tests/_torch_wide.py`` ``d274_fleet`` instances (n = 600, m = 3, 270
anti-affinity pairs and 4 exclusive tasks each, lowered to D = 274): lower
bounds within rel 1e-4, costs within rel 1e-5 (float32 LP trajectories in
another summation order; placements given a mapping are exact).
"""

import pytest

import repro.core as J
from repro_torch import core as P

from _torch_wide import d274_fleet
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

LB_RTOL = 1e-4
COST_RTOL = 1e-5


@pytest.fixture(scope="module")
def d274():
    refs, ports = d274_fleet()
    want = J.FleetEngine().evaluate(refs)
    got = P.FleetEngine(device="cpu").evaluate(ports)
    return refs, ports, want, got


def test_fleet_at_274_dimensions(d274):
    _, _, want, got = d274
    for g, w in zip(got.entries, want.entries):
        assert abs(g["lb"] / w["lb"] - 1) <= LB_RTOL
        assert list(g["costs"]) == list(w["costs"])
        for algo, c in w["costs"].items():
            assert abs(g["costs"][algo] / c - 1) <= COST_RTOL, algo
