"""The per-layer metrics read from the program's own spans and counters
(``repro_torch.obs``): every one reported, and positive, by a traced run of
the tiny cells; none by an untraced run; nothing, and no error, where the
program records no steps."""

import pytest

import _tiny
from bench import harness, spans

FLEET = ["place_host_s.fleet", "place_wait_s.fleet", "lp_enqueue_s.fleet",
         "lp_wait_s.fleet", "lp_attempt_us.fleet"]
FORECAST = [m.replace(".fleet", ".forecast") for m in FLEET] + \
    ["fanout_s.forecast", "select_s.forecast"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _tiny.tiny_root(tmp_path_factory.mktemp("bench"))


def quiet(*args, **kwargs):
    pass


@pytest.mark.parametrize("cell, names", [("tiny.fleet", FLEET),
                                         ("tinygct.forecast", FORECAST)])
def test_traced_runs_report_every_span_metric(tiny, cell, names):
    line = harness.run(tiny, cell, 2**31 + 29, 0.2, True, device="cpu",
                       log=quiet)
    for name in names:
        assert line["metrics"][name]["value"] > 0, name
    assert line["correct"] is True


@pytest.mark.parametrize("cell, names", [("tiny.fleet", FLEET),
                                         ("tinygct.forecast", FORECAST)])
def test_untraced_runs_report_none(tiny, cell, names):
    line = harness.run(tiny, cell, 3, 0.1, False, device="cpu", log=quiet)
    assert not set(names) & set(line["metrics"])


@pytest.mark.parametrize("program", ["no steps", "no recorder"])
def test_no_recorded_steps_read_as_nothing(monkeypatch, program):
    """A program that recorded no step, or one without ``repro_torch.obs``
    (as the parent of the change that added it): no value, no error."""
    import sys

    import repro_torch
    from repro_torch import obs

    if program == "no steps":
        monkeypatch.setattr(obs, "steps", lambda: [])
    else:
        monkeypatch.delattr(repro_torch, "obs")
        monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    ctx = {"mix": {"driver": "evaluate"}, "steps": 2}
    assert spans.window(ctx) is None
    assert spans.seconds(ctx, ("lp.enqueue",)) is None
    assert spans.host_seconds(ctx, "place") is None
    assert spans.per_count(ctx, "lp.enqueue", "lp.attempts") is None
