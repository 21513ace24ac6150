"""The compiled placement route's plain version (``ref.sub_phase_ref`` on
the CPU) at D = 274 with ``fit="first"``, given the reference's own legacy
LP mappings, placing exactly as the reference's numpy lockstep engine.

The instances are ``tests/_torch_wide.py`` ``d274_lowered``: the D = 274
fleet lowered and trimmed in both packages.  The other fit policy has a file
of its own, so that the two run on separate workers.
"""

import numpy as np
import pytest

import repro.core as J
from repro_torch import core as P

from _torch_wide import d274_lowered as lowered_fleet
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def d274_lowered():
    return lowered_fleet()


@pytest.mark.parametrize("filling", [False, True])
@pytest.mark.parametrize("fit", ["first"])
def test_compiled_plain_version_places_as_the_reference(d274_lowered, fit,
                                                        filling):
    lowered_ref, lowered, maps = d274_lowered
    expect = J.place_many(lowered_ref, maps, fit=fit, filling=filling)
    tel: dict = {}
    placed = P.place_many(lowered, maps, fit=fit, filling=filling,
                          placement="compiled", telemetry=tel, device="cpu")
    assert tel["engine"] == "compiled" and "fallback" not in tel, tel
    for a, b in zip(placed, expect):
        assert np.array_equal(a.assign, b.assign)
        assert np.array_equal(a.node_type, b.node_type)
