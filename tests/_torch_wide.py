"""Wide constrained instances shared by the ``tests/test_torch_wide_*.py``
files: the reference's Table-I-style instances with anti-affinity pairs and
exclusive tasks (``wide_instance``, as ``chip_smoke.py`` phase 10c draws
them), and the D = 274 fleet both as instances and lowered and trimmed.

Each pair lowers to one unit-capacity dimension and the exclusive set to one
more, so ``d44_instance`` lowers to D = 3 + 1 + 40 = 44 and ``d274_fleet``
to D = 3 + 1 + 270 = 274.
"""

import dataclasses

import numpy as np

import repro.core as J
from repro.workload import SyntheticSpec, synthetic_instance
from repro_torch import core as P
from repro_torch.convert import problem_from_arrays


def wide_instance(n, m, D, T, seed, pairs, exclusive):
    """The reference's Table-I-style instance with ``pairs`` anti-affinity
    pairs and ``exclusive`` exclusive tasks over disjoint tasks drawn by
    ``np.random.default_rng(2000 + seed)``."""
    p = synthetic_instance(SyntheticSpec(n=n, m=m, D=D, T=T, seed=seed))
    rng = np.random.default_rng(2000 + seed)
    pool = list(rng.permutation(p.n))

    def pop(k):
        return [int(pool.pop()) for _ in range(k)]

    anti = {f"anti{g}": pop(2) for g in range(pairs)}
    c = J.TaskConstraints.from_groups(p.n, anti_affinity=anti,
                                      exclusive=pop(exclusive))
    return dataclasses.replace(p, constraints=c)


def d44_instance():
    """(reference instance, port instance) lowering to D = 44."""
    ref = wide_instance(120, 4, 3, 12, 0, pairs=40, exclusive=4)
    assert J.lower_constraints(ref).lowered.D == 44
    return ref, problem_from_arrays(ref)


def d274_fleet():
    """(reference instances, port instances): two instances lowering to
    D = 274."""
    refs = [wide_instance(600, 3, 3, 8, s, pairs=270, exclusive=4)
            for s in range(2)]
    assert {J.lower_constraints(p).lowered.D for p in refs} == {274}
    return refs, [problem_from_arrays(p) for p in refs]


def d274_lowered():
    """The D = 274 fleet lowered and trimmed in both packages, and the
    reference's own legacy LP mappings of it: (lowered reference, lowered
    port, mappings)."""
    refs, ports = d274_fleet()
    lowered_ref = [J.trim_timeline(J.lower_constraints(p).lowered)[0]
                   for p in refs]
    lowered = [P.trim_timeline(P.lower_constraints(p).lowered)[0]
               for p in ports]
    maps = [np.asarray(r.mapping) for r in J.solve_lp_many(lowered_ref)]
    return lowered_ref, lowered, maps
