"""``lp_graph_hit``: the window's replayed tol-LP chunks over all its chunks,
read from the program's counters; nothing where the program counts no
chunks (a program without chunk graphs), and no error."""

import pytest

import _tiny
from bench import harness

NAMES = {"tiny.fleet": "lp_graph_hit.fleet",
         "tinygct.forecast": "lp_graph_hit.forecast"}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _tiny.tiny_root(tmp_path_factory.mktemp("bench"))


def quiet(*args, **kwargs):
    pass


def _ctx(counters):
    return {"mix": {"driver": "evaluate"}, "steps": len(counters)}


@pytest.mark.parametrize("counters, want", [
    ([{"lp.graph_replays": 7, "lp.chunks_eager": 1},
      {"lp.graph_replays": 8}], 15 / 16),
    ([{"lp.chunks_eager": 3}, {"lp.chunks_eager": 2}], 0.0),
    ([{"lp.attempts": 50}, {"lp.attempts": 25}], None),
])
def test_reads_replays_over_chunks(tiny, monkeypatch, counters, want):
    from repro_torch import obs

    steps = [{"id": i, "name": "evaluate", "spans": {}, "counters": c}
             for i, c in enumerate(counters)]
    monkeypatch.setattr(obs, "steps", lambda: steps)
    read = harness.reader(tiny / "bench", "lp_graph_hit.fleet")
    assert read(_ctx(counters)) == want


@pytest.mark.parametrize("cell", list(NAMES))
@pytest.mark.parametrize("program", ["eager", "without the counters"])
def test_traced_tiny_runs_report_the_share(tiny, monkeypatch, cell, program):
    """On the CPU every chunk runs eagerly: the share reads 0.  A program
    that counts no chunks (one without chunk graphs) gives nothing to read:
    the line leaves the metric out, and the run stays correct."""
    from repro_torch import obs

    if program == "without the counters":
        add = obs.add
        monkeypatch.setattr(obs, "add", lambda name, n=1: None if name in (
            "lp.chunks_eager", "lp.graph_captures", "lp.graph_replays")
            else add(name, n))
    line = harness.run(tiny, cell, 2**31 + 41, 0.2, True, device="cpu",
                       log=quiet)
    if program == "eager":
        assert line["metrics"][NAMES[cell]]["value"] == 0
    else:
        assert NAMES[cell] not in line["metrics"]
    assert line["correct"] is True
