"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``) at smoke size: five cells
(``qwen2.5-3b``, ``olmoe-1b-7b`` and ``rwkv6-7b`` train, ``qwen2.5-3b``
prefill and decode) of ``smoke_config`` at batch 32 x 64 tokens on the 16x16
mesh, with hints on and off; and the rightsizer's problem built by both
packages from the same records.

The reference runs in one subprocess with 512 fake host devices.  Its
hinted dry-run fails on jax 0.9.0: ``jax.make_mesh`` gives Explicit axes,
which ``with_sharding_constraint`` rejects (ROADMAP Queue 3 item 10), so the
subprocess patches ``make_production_mesh`` to Auto axes, test-side.

Held:
  * the record's keys equal the reference's;
  * ``argument_size_in_bytes`` equal, exactly: both sum the shards the
    specs give;
  * ``output_size_in_bytes`` equal once two leaf-level differences are
    added: XLA counts a tuple-shaped output's index table, 8 bytes per
    output leaf, and its serving steps' logits, left unconstrained by
    ``out_shardings``, take a sharding of XLA's choosing (replicated, over
    one axis or over both), where DTensor's come out as they do;
  * per-device FLOPs x 256 at least the port's own count of the same step
    on one device (plain meta tensors), which the 1x1 mesh's DTensor step
    matches.
"""

import json
import os
import pathlib
import subprocess
import sys
import warnings

import pytest

from repro_torch.configs import Shape, smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (fake_world, make_host_mesh,
                                     make_production_mesh)

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = pathlib.Path(__file__).resolve().parent.parent
SEQ, BATCH = 64, 32
CELLS = [("qwen2.5-3b", "train"), ("olmoe-1b-7b", "train"),
         ("rwkv6-7b", "train"), ("qwen2.5-3b", "prefill"),
         ("qwen2.5-3b", "decode")]
# the cells whose records stand in for schedule jobs, under these shapes
RECORDS = {("qwen2.5-3b", "decode"): "decode_32k",
           ("olmoe-1b-7b", "train"): "train_4k",
           ("rwkv6-7b", "train"): "train_4k"}

REF_SCRIPT = r"""
import json, sys
import jax
from jax.sharding import AxisType
from repro.configs import Shape, smoke_config
from repro.launch import dryrun
from repro.train import TrainConfig, make_train_step
from repro.train.train_step import make_serve_steps

def auto_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes,
                         axis_types=(AxisType.Auto,) * len(shape))

dryrun.make_production_mesh = auto_mesh
dryrun.get_config = smoke_config
seq, batch, cells = json.loads(sys.argv[1])
out = {}
for arch, mode in cells:
    dryrun.SHAPES["t_" + mode] = Shape("t_" + mode, seq, batch, mode)
    cfg, params, state, b = dryrun.input_specs(arch, "t_" + mode)
    if mode == "train":
        shapes = jax.eval_shape(make_train_step(cfg, TrainConfig()),
                                params, state, b)
    elif mode == "decode":
        shapes = jax.eval_shape(make_serve_steps(cfg, seq)[1], params,
                                state, b["tokens"])
    else:
        shapes = jax.eval_shape(make_serve_steps(cfg, seq)[0], params, b)
    for hints in (True, False):
        rec = dryrun.run_cell(arch, "t_" + mode, False, hints=hints)
        rec["n_out"] = len(jax.tree.leaves(shapes))
        out[f"{arch}|{mode}|{hints}"] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    """The reference's records, from one subprocess started first, so that
    it runs while the port's cells do."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=str(REPO / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, json.dumps([SEQ, BATCH, CELLS])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    records = {}

    def get():
        if not records:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            records.update(json.loads(out.splitlines()[-1]))
        return records

    yield get
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def port(reference, monkeypatch_module):
    """The port's accounting of each cell (``run_step``) with hints on and
    off, and its records (``run_cell``) of the hinted cells."""
    monkeypatch_module.setattr(dryrun, "get_config", smoke_config)
    shapes = dict(dryrun.SHAPES)
    for mode in ("train", "prefill", "decode"):
        shapes["t_" + mode] = Shape("t_" + mode, SEQ, BATCH, mode)
    monkeypatch_module.setattr(dryrun, "SHAPES", shapes)
    acc, records, one = {}, {}, {}
    with warnings.catch_warnings():  # see _quiet
        warnings.simplefilter("ignore")
        for arch, mode in CELLS:
            cfg = smoke_config(arch)
            for hints in (True, False):
                with fake_world(256):
                    mesh = make_production_mesh(device="cpu")
                    acc[arch, mode, hints] = dryrun.run_step(
                        cfg, mode, SEQ, BATCH, mesh, hints=hints)
            if (arch, mode) in RECORDS:
                records[arch, mode] = dryrun.run_cell(
                    arch, "t_" + mode, False, device="cpu")
            one[arch, mode] = dryrun.run_step(cfg, mode, SEQ, BATCH, None)
    return acc, records, one


@pytest.fixture(autouse=True)
def _quiet():
    """DTensor warns from its dispatch; recording every warning, as pytest
    does, makes a cell several times slower."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("hints", [True, False], ids=["hints", "no-hints"])
@pytest.mark.parametrize("arch,mode", CELLS, ids=lambda x: x)
def test_sizes_against_reference(arch, mode, hints, port, reference):
    acc = port[0][arch, mode, hints]
    ref = reference()[f"{arch}|{mode}|{hints}"]
    assert acc["argument_size_in_bytes"] == ref["argument_size_in_bytes"]
    # XLA's output buffer holds a tuple's index table: 8 bytes per leaf
    residual = (ref["output_size_in_bytes"] - 8 * ref["n_out"]
                - acc["output_size_in_bytes"])
    if mode == "train":
        # parameters, state (the donated ones) and the five metrics
        assert residual == 0
        assert acc["alias_size_in_bytes"] == ref["alias_size_in_bytes"]
    else:
        # only the logits differ: XLA shards them its own way
        logits = 4 * BATCH * smoke_config(arch).vocab_size
        assert acc["logits_bytes"] + residual in (
            logits, logits // 16, logits // 256), (acc["logits_bytes"],
                                                   residual)
    if mode == "decode":
        assert acc["alias_size_in_bytes"] == ref["alias_size_in_bytes"]
    assert acc["temp_size_in_bytes"] > 0 and acc["flops"] > 0


@pytest.mark.parametrize("arch,mode", CELLS, ids=lambda x: x)
def test_flops_cover_one_device(arch, mode, port):
    acc, _records, one = port
    for hints in (True, False):
        assert acc[arch, mode, hints]["flops"] * 256 >= one[arch, mode][
            "flops"] > 0
    # one device moves nothing between devices and holds everything
    assert one[arch, mode]["collective_count"] == 0
    assert one[arch, mode]["argument_size_in_bytes"] > acc[
        arch, mode, True]["argument_size_in_bytes"]


def test_host_mesh_counts_one_device(port):
    """The step on the 1x1 mesh (DTensors, every hint a no-op
    redistribution) counts what the plain one-device step does."""
    _acc, _records, one = port
    cfg = smoke_config("qwen2.5-3b")
    with fake_world(1):
        got = dryrun.run_step(cfg, "decode", SEQ, BATCH,
                              make_host_mesh("cpu"))
    want = one["qwen2.5-3b", "decode"]
    for key in ("flops", "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "collective_count"):
        assert got[key] == want[key], key


def test_record_keys_equal_reference(port, reference):
    _acc, records, _one = port
    ref = reference()
    for (arch, mode), rec in records.items():
        want = dict(ref[f"{arch}|{mode}|True"])
        del want["n_out"]
        assert set(rec) == set(want), (arch, mode)
        assert set(rec["collective_bytes"]) == set(want["collective_bytes"])
        for key in ("compile_s", "xla_flops", "xla_bytes_accessed",
                    "xla_collective_bytes_once",
                    "generated_code_size_in_bytes"):
            assert rec[key] is None, key
        for key in ("arch", "mesh", "devices", "mode", "sharding_hints",
                    "seq_len", "global_batch", "param_count",
                    "active_param_count", "argument_size_in_bytes"):
            assert rec[key] == want[key], key


def test_fleet_problem_from_the_same_records(port, tmp_path):
    """The port's records of three schedule jobs' archs, filed under those
    jobs' shapes: both packages build the same problem, bit for bit, and
    those jobs take their demands from the records."""
    from repro.workload import jobs as jjobs
    from repro_torch.workload import jobs as tjobs
    from test_torch_workload import _same, _same_tasks

    _acc, records, _one = port
    for (arch, mode), shape in RECORDS.items():
        rec = dict(records[arch, mode], shape=shape)
        (tmp_path / f"{arch}__{shape}__16x16.json").write_text(
            json.dumps(rec))
    (jp, jt), (tp, tt) = (jjobs.fleet_problem(dryrun_dir=str(tmp_path)),
                          tjobs.fleet_problem(dryrun_dir=str(tmp_path)))
    _same(jp, tp)
    _same_tasks(tt, jt)
    src = {t["name"]: t["source"] for t in tt}
    assert src["day-serve-qwen"] == src["nightly-train-olmoe"] == \
        src["nightly-train-rwkv"] == "dryrun"
    assert sum(s == "builtin" for s in src.values()) == len(src) - 3


def test_main_writes_records_and_fails_loudly(tmp_path, monkeypatch, capsys):
    """The CLI on the CPU: a cell's record under the reference's file name;
    a cell that cannot run prints FAIL with the error and exits 1; no card,
    no run."""
    import torch

    monkeypatch.setattr(dryrun, "get_config", smoke_config)
    monkeypatch.setattr(dryrun, "cell_eligible", lambda cfg, shape: (True, ""))
    shapes = dict(dryrun.SHAPES, t_decode=Shape("t_decode", SEQ, BATCH,
                                                "decode"))
    monkeypatch.setattr(dryrun, "SHAPES", shapes)
    out = str(tmp_path / "rec")
    # the 16x16 mesh only: torch 2.13's DTensor plans each op on the 2x16x16
    # mesh for minutes (torch 2.11's lowers the same cell in seconds)
    assert dryrun.main(["--arch", "qwen2.5-3b", "--shape", "t_decode",
                        "--mesh", "pod", "--out", out,
                        "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == ["qwen2.5-3b__t_decode__16x16.json"]
    rec = json.loads((tmp_path / "rec" /
                      "qwen2.5-3b__t_decode__16x16.json").read_text())
    assert rec["devices"] == 256 and rec["mesh"] == "16x16"
    assert "OK   qwen2.5-3b__t_decode__16x16" in capsys.readouterr().out

    def boom(*args, **kwargs):
        raise RuntimeError("Sharding propagation failed for aten.bmm")

    monkeypatch.setattr(dryrun, "run_step", boom)
    assert dryrun.main(["--arch", "qwen2.5-3b", "--shape", "t_decode",
                        "--mesh", "pod", "--out", out,
                        "--device", "cpu"]) == 1
    assert ("FAIL qwen2.5-3b__t_decode__16x16: RuntimeError: Sharding "
            "propagation failed for aten.bmm") in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main(["--arch", "qwen2.5-3b", "--shape", "t_decode"])


def test_new_tensors_keep_values_on_one_device():
    """``x.new_zeros`` of a DTensor under ``ReshardOnFailure``'s rule (the
    batch shards kept, the rest replicated) holds the plain op's values: on
    a 1x1 mesh over real CPU tensors."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate

    with fake_world(1):
        mesh = make_host_mesh("cpu")
        x = DTensor.from_local(torch.ones((4, 2, 3)), mesh,
                               (Replicate(), Replicate()))
        z = dryrun._new_like(torch.ops.aten.new_zeros.default,
                             (x, [4, 6]), {})
        assert z.shape == (4, 6) and torch.equal(z.to_local(),
                                                 torch.zeros(4, 6))


def test_temp_holds_the_wkv_backward_scratch(port):
    """The WKV backward's kernels allocate scratch inside the call that its
    fake implementation cannot show; the count holds it
    (``hlo_cost.workspace_registry``).  rwkv6-7b's train record holds the
    scratch of one layer's call on its local shard (with hints the batch
    split 16 ways, without them whole; the smoke config's 4 heads too few
    for the 16-way model axis); no other cell runs a registered op, so
    their counts are as before."""
    from repro_torch.kernels import wkv

    acc, records, _one = port
    cfg = smoke_config("rwkv6-7b")
    H, N = cfg.num_heads, cfg.head_dim
    scratch = wkv.backward_scratch_bytes(BATCH // 16, SEQ, H, N)
    assert acc["rwkv6-7b", "train", True]["workspace_bytes"] == scratch
    assert acc["rwkv6-7b", "train", False]["workspace_bytes"] == \
        wkv.backward_scratch_bytes(BATCH, SEQ, H, N)
    assert records["rwkv6-7b", "train"]["temp_size_in_bytes"] >= scratch > 0
    for hints in (True, False):
        got = acc["rwkv6-7b", "train", hints]
        assert got["workspace_bytes"] <= got["workspace_temp_bytes"] <= \
            got["temp_size_in_bytes"]
    for (arch, mode, hints), got in acc.items():
        if (arch, mode) != ("rwkv6-7b", "train"):
            assert got["workspace_bytes"] == 0, (arch, mode, hints)
