"""The benchmark's definition, its result line, finding pieces by name, and
``correct``: false for the float32 control and for a broken program."""

import dataclasses
import json
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import _tiny
from bench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device",
             "checks"]


def test_benchmark_json_keys_and_names():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + \
        [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [w["traffic"] for w in BENCH["workloads"]]
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_every_piece_is_found_by_name():
    bench_dir = ROOT / BENCH["paths"][0]
    for c in BENCH["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
    for w in BENCH["workloads"]:
        spec = harness.cell_spec(ROOT, w["name"])
        assert (bench_dir / "drivers" / f"{spec['mix']['driver']}.py") \
            .is_file()
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert callable(harness.reader(bench_dir, m["name"]))


def test_every_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells)
    for cell in cells:
        spec = harness.cell_spec(ROOT, cell)
        assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]


def test_run_seconds_fit_a_full_check():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _tiny.tiny_root(tmp_path_factory.mktemp("bench"))


def quiet(*args, **kwargs):
    pass


@pytest.mark.parametrize("cell", ["tiny.fleet", "tinygct.forecast"])
def test_result_line_and_correct_on_the_cpu(tiny, cell):
    line = harness.run(tiny, cell, 2**31 + 11, 0.2, False, device="cpu",
                       log=quiet)
    assert list(line) == LINE_KEYS
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", ["tiny.fleet", "tinygct.fleet",
                                  "tinygct.forecast"])
def test_the_controls_are_not_correct(tiny, cell):
    line = harness.run(tiny, cell, 5, 0.2, False, device="cpu",
                       controls=("float32", "primal_bound"), log=quiet)
    assert line["correct"] is True
    f32 = line["control"]["float32"]
    assert f32["correct"] is False
    assert max(f32["checks"][k]["value"] for k in ("cost_err", "plan_err")
               if k in f32["checks"]) > 0
    primal = line["control"]["primal_bound"]
    assert primal["correct"] is False
    assert primal["checks"]["lp_cert"]["value"] > 1.0


@pytest.mark.parametrize("cell", ["tiny.fleet", "tinygct.forecast"])
def test_a_loosened_lp_is_not_correct(tiny, cell):
    """The program run with ten times the stated tolerance: lp_gap reads
    past its limit."""
    line = harness.run(tiny, cell, 6, 0.1, False, device="cpu",
                       solver={"tol": 0.05}, log=quiet)
    assert line["checks"]["lp_gap"]["value"] > \
        line["checks"]["lp_gap"]["limit"]
    assert line["correct"] is False


def test_jax_loaded_after_the_window_gives_no_line(tiny, tmp_path):
    """A metric reader that loads a module named ``repro`` (as the JAX
    package is named) ends the run without a result."""
    root = tmp_path / "copy"
    shutil.copytree(tiny, root)
    (root / "bench" / "metrics" / "lp_s.py").write_text(
        "import sys\nimport types\n\n\n"
        "def read(ctx):\n"
        "    sys.modules['repro'] = types.ModuleType('repro')\n"
        "    return 1.0\n")
    saved = sys.modules.pop("repro", None)
    try:
        with pytest.raises(RuntimeError, match="repro"):
            harness.run(root, "tiny.fleet", 7, 0.1, True, device="cpu",
                        log=quiet)
    finally:
        sys.modules.pop("repro", None)
        if saved is not None:
            sys.modules["repro"] = saved


def test_a_traced_run_reads_the_layers(tiny):
    line = harness.run(tiny, "tiny.fleet", 8, 0.2, True, device="cpu",
                       log=quiet)
    assert list(line) == LINE_KEYS[:5] + ["breakdown", "checks"]
    assert {"lp_s.fleet", "place_s.fleet", "lp_roofline.fleet"} <= \
        set(line["metrics"])
    assert "window_s" in line["device"] and "busy_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_new_pieces_are_found_by_name(tiny, tmp_path):
    """A configuration (with an instance generator of its own), a mix and a
    per-layer metric added as new files and entries, no file edited."""
    root = tmp_path / "copy"
    shutil.copytree(tiny, root)
    bench_dir = root / "bench"
    (bench_dir / "generators").mkdir()
    (bench_dir / "generators" / "flat.py").write_text(
        "from bench.gen import synthetic_instance\n\n\n"
        "def instance(rng, **sizes):\n"
        "    return synthetic_instance(rng, demand=(0.05, 0.05), **sizes)\n")
    (bench_dir / "configs" / "flat.json").write_text(json.dumps(
        {"name": "flat", "generator": "flat", "reduced": [],
         "instance": {"n": 30, "m": 3, "D": 2, "T": 10}}))
    mix = json.loads((bench_dir / "mixes" / "fleet_tiny.json").read_text())
    (bench_dir / "mixes" / "fleet_other.json").write_text(
        json.dumps(dict(mix, fleet=2, max_steps=2)))
    (bench_dir / "metrics" / "steps_done.py").write_text(
        "def read(ctx):\n    return float(ctx['steps'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "flat", "source": "test",
                             "file": "bench/configs/flat.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "flat.other", "config": "flat",
                               "traffic": "fleet_other", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if "tiny.fleet" in m.get("workloads", ()):
            m["workloads"].append("flat.other")
    bench["per_layer"].append({"name": "steps_done", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "session",
                               "moves": "instances_per_s",
                               "workloads": ["flat.other"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = harness.run(root, "flat.other", 1, 0.1, False, device="cpu",
                       log=quiet)
    assert line["attempted"] == 2 * 2 and line["correct"] is True
    traced = harness.run(root, "flat.other", 1, 0.1, True, device="cpu",
                         log=quiet)
    assert traced["metrics"]["steps_done"]["value"] == 2.0


def test_lanes_follow_the_buckets(tiny, monkeypatch):
    """A fleet packed into two buckets, the second half first: every
    sampled instance is checked against its own lane."""
    from repro_torch.core import FleetEngine, pack_problems
    from repro_torch.core.engine import Bucket, PackPlan

    def pack(self, problems):
        trimmed = self._trimmed(problems)
        h = len(trimmed) // 2
        parts = (tuple(range(h, len(trimmed))), tuple(range(h)))
        buckets = tuple(Bucket(indices=idx, batch=pack_problems(
            [trimmed[i] for i in idx], assume_trimmed=True))
            for idx in parts)
        return PackPlan(buckets=buckets, n_instances=len(trimmed),
                        cells_single=sum(b.cells for b in buckets))

    monkeypatch.setattr(FleetEngine, "pack", pack)
    line = harness.run(tiny, "tinygct.fleet", 9, 0.1, False, device="cpu",
                       log=quiet)
    assert line["correct"] is True, line["checks"]


# --- a broken program: correct comes out false ---------------------------

def lp_unchanged(monkeypatch):
    """The LP step returns (nearly) the state it started from."""
    from repro_torch.core import engine

    real = engine.solve_lp_many
    monkeypatch.setattr(engine, "solve_lp_many",
                        lambda *a, **k: real(*a, **dict(k, iters=1)))


def half_batch(monkeypatch):
    """Half of each batch solved; the other half gets the first half's
    answers."""
    from repro_torch.core import FleetEngine

    real = FleetEngine._solve_bucket

    def solve(self, bucket, init=None):
        from repro_torch.core.engine import Bucket

        h = max(1, bucket.batch.B // 2)
        sub = Bucket(indices=bucket.indices[:h], batch=_head(bucket.batch,
                                                             h))
        res, stats = real(self, sub, init=init)
        reps = -(-bucket.batch.B // h)
        res = (res * reps)[: bucket.batch.B]
        st = stats[0]
        state = dataclasses.replace(
            st.state, x=np.concatenate([st.state.x] * reps)[: len(res)],
            y=np.concatenate([st.state.y] * reps)[: len(res)])
        stats = [dataclasses.replace(
            st, state=state,
            iterations=np.resize(st.iterations, len(res)),
            converged=np.resize(st.converged, len(res)))]
        return res, stats

    monkeypatch.setattr(FleetEngine, "_solve_bucket", solve)


def _head(batch, h):
    from repro_torch.core import pack_problems

    return pack_problems(batch.problems[:h], pad_to=batch.shape,
                         assume_trimmed=True)


def answer_altered(monkeypatch):
    """Each placement pass buys one node more than it places on."""
    from repro_torch.core import engine

    real = engine.place_many

    def place(*a, **k):
        sols = real(*a, **k)
        sols[-1].node_type = np.append(sols[-1].node_type,
                                       sols[-1].node_type[:1])
        return sols

    monkeypatch.setattr(engine, "place_many", place)


def _last_lane(monkeypatch, change):
    from repro_torch.core import engine

    real = engine.place_many

    def place(*a, **k):
        sols = real(*a, **k)
        change(sols[-1])
        return sols

    monkeypatch.setattr(engine, "place_many", place)


def task_moved(monkeypatch):
    """Each placement pass moves one task of its last lane onto a node it
    buys for it, of the type the task's node has: still feasible."""
    def change(s):
        s.node_type = np.append(s.node_type, s.node_type[s.assign[0]])
        s.assign = s.assign.copy()
        s.assign[0] = len(s.node_type) - 1

    _last_lane(monkeypatch, change)


def node_overloaded(monkeypatch):
    """Each placement pass puts every task of its last lane on its first
    node."""
    def change(s):
        s.assign = np.zeros_like(s.assign)

    _last_lane(monkeypatch, change)


FAULTS = {"state_unchanged": lp_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered, "task_moved": task_moved,
          "node_overloaded": node_overloaded}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["tiny.fleet", "tinygct.forecast"])
def test_a_broken_program_is_not_correct(tiny, monkeypatch, fault, cell):
    """Not correct, or no result at all: a program whose broken answers
    make a later stage raise (its own ``verify`` among them) ends the run
    without a line."""
    FAULTS[fault](monkeypatch)
    try:
        line = harness.run(tiny, cell, 2**32 + 3, 0.1, False, device="cpu",
                           log=quiet)
    except (RuntimeError, AssertionError):
        return
    assert line["correct"] is False
    if fault == "node_overloaded":
        assert line["checks"]["overload"]["value"] > \
            line["checks"]["overload"]["limit"]


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "table1.fleet",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "table1.fleet",
         "--seed", "2", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == LINE_KEYS and line["correct"] is True
    assert line["device"]["platform"] == "gpu"
