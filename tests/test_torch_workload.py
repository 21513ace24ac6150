"""The port's workload generators on the CPU, against the reference
(``repro.workload.gct`` and ``repro.workload.jobs``): the same seed, ``rng``
or file gives the same arrays, bit for bit, and a schedule's constraints
lower the same way."""

import dataclasses
import json

import numpy as np
import pytest

import repro.core as J
from repro.workload import gct as jgct
from repro.workload import jobs as jjobs
import repro_torch.core as T
from repro_torch.workload import gct as tgct
from repro_torch.workload import jobs as tjobs

from test_torch_constraints import (_same_constraints, _same_lowering,
                                    _same_problem)


def _same(a, b):
    _same_problem(a, b)
    if a.constraints is None:
        assert b.constraints is None
    else:
        _same_constraints(a.constraints, b.constraints)


def test_gct_pool():
    want, got = jgct.gct_pool(), tgct.gct_pool()
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(value).dtype


@pytest.mark.parametrize("cost_model", ["homogeneous", "gce"])
@pytest.mark.parametrize("seed", range(4))
def test_gct_like_instance(seed, cost_model):
    kw = dict(n=300, m=8, seed=seed, cost_model=cost_model, e=0.8)
    want = jgct.gct_like_instance(**kw)
    got = tgct.gct_like_instance(**kw)
    _same(want, got)
    # the trimmed timeline too (T' is what the kernels see)
    (jt, jk), (tt, tk) = J.trim_timeline(want), T.trim_timeline(got)
    _same_problem(jt, tt)
    np.testing.assert_array_equal(tk, jk)


def test_gct_like_instance_full_size_and_shared_rng():
    _same(jgct.gct_like_instance(), tgct.gct_like_instance())
    ja, ta = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):  # one stream, several distinct instances
        _same(jgct.gct_like_instance(n=50, m=4, rng=ja),
              tgct.gct_like_instance(n=50, m=4, rng=ta))
    with pytest.raises(ValueError, match="unknown cost model"):
        tgct.gct_like_instance(n=5, m=2, cost_model="flat")


def test_load_trace_csv(tmp_path):
    path = tmp_path / "trace.csv"
    rows = ["start,end,cpu,mem", "100,400,0.02,0.01", "130,130,0.04,0.08",
            "90,,0.01,0.02",            # missing field: purged
            "200,150,0.08,0.04",        # end < start: purged
            "95,2000,0.16,0.5", "300,360,nan,0.1"]
    path.write_text("\n".join(rows) + "\n")
    cap = np.array([[1.0, 1.0], [0.5, 0.25]])
    for cost_model in ("homogeneous", "gce"):
        want = jgct.load_trace_csv(str(path), cap, cost_model=cost_model)
        got = tgct.load_trace_csv(str(path), cap, cost_model=cost_model)
        _same(want, got)
        assert got.n == 3 and int(got.start.min()) == 0


def test_skus_and_builtin_tables():
    for attr in ("cap", "cost"):
        np.testing.assert_array_equal(getattr(tjobs.TPU_SKUS, attr),
                                      getattr(jjobs.TPU_SKUS, attr))
    assert tjobs.TPU_SKUS.names == jjobs.TPU_SKUS.names
    assert tjobs.BUILTIN_DEMANDS == jjobs.BUILTIN_DEMANDS
    assert [dataclasses.astuple(j) for j in tjobs.DEFAULT_SCHEDULE] == \
        [dataclasses.astuple(j) for j in jjobs.DEFAULT_SCHEDULE]
    for name in ("HBM_PER_CHIP_GB", "HOST_PER_CHIP_GB", "CHIP_HOUR_USD"):
        assert getattr(tjobs, name) == getattr(jjobs, name)


def _same_tasks(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key, value in w.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(g[key], value)
            else:
                assert g[key] == value, key


def test_fleet_problem_default_schedule(tmp_path):
    absent = str(tmp_path / "none")
    (jp, jt), (tp, tt) = (jjobs.fleet_problem(dryrun_dir=absent),
                          tjobs.fleet_problem(dryrun_dir=absent))
    _same(jp, tp)
    _same_tasks(tt, jt)
    assert tp.constraints is None
    assert all(t["source"] == "builtin" for t in tt)
    # the default path: results/dryrun is absent from the repo
    _same(jjobs.fleet_problem()[0], tjobs.fleet_problem()[0])


def _schedule(Job):
    return (
        Job("train-a", "gemma2-9b", "train_4k", 0, 9, deadline_h=6,
            max_width=3, serial_frac=0.2),
        Job("train-b", "olmoe-1b-7b", "train_4k", 1, 5, deadline_h=5),
        Job("serve-x", "qwen2.5-3b", "decode_32k", 8, 17, exclusive=True),
        Job("tower-1", "gemma3-1b", "decode_32k", 8, 15, affinity="tower"),
        Job("tower-2", "whisper-small", "prefill_32k", 10, 17,
            affinity="tower"),
        Job("rep-1", "qwen2-vl-2b", "decode_32k", 9, 18,
            anti_affinity="spread"),
        Job("rep-2", "qwen2-vl-2b", "decode_32k", 9, 18,
            anti_affinity="spread"),
        Job("big", "kimi-k2-1t-a32b", "decode_32k", 10, 15,
            anti_affinity="big-spread"),
        Job("unknown", "custom-arch", "train_4k", 18, 23),
    )


def test_custom_schedule_with_every_constraint_kind(tmp_path):
    absent = str(tmp_path / "none")
    jp, jt = jjobs.fleet_problem(_schedule(jjobs.Job), dryrun_dir=absent)
    tp, tt = tjobs.fleet_problem(_schedule(tjobs.Job), dryrun_dir=absent)
    _same(jp, tp)
    _same_tasks(tt, jt)
    c = tp.constraints
    assert c is not None and c.exclusive.any() and (c.max_width > 1).any()
    assert (c.affinity >= 0).sum() == 2 and (c.deadline >= 0).sum() == 2
    assert c.anti_names == ("spread", "big-spread")
    _same_lowering(J.lower_constraints(jp), T.lower_constraints(tp))
    sol = T.rightsize(tp, "penalty-map-f", device="cpu")
    assert T.check_plan(tp, sol) == [] and J.check_plan(jp, sol) == []


def test_jobs_from_dryrun_records(tmp_path):
    rec = {"arch": "gemma2-9b", "shape": "train_4k", "devices": 256,
           "argument_size_in_bytes": 3.0e9, "temp_size_in_bytes": 1.5e9,
           "output_size_in_bytes": 0.5e9}
    (tmp_path / "gemma2-9b__train_4k__16x16.json").write_text(json.dumps(rec))
    (tmp_path / "ignored__8x8.json").write_text(json.dumps(rec))
    want = jjobs.jobs_from_dryrun(dryrun_dir=str(tmp_path), util=0.7)
    got = tjobs.jobs_from_dryrun(dryrun_dir=str(tmp_path), util=0.7)
    _same_tasks(got, want)
    assert sum(t["source"] == "dryrun" for t in got) >= 1
