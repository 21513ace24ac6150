"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``,
the card-side test helpers it shares and the card scripts) imports JAX, the
JAX package or the reference's checkpoint serializers (msgpack, zstandard),
and its entry points run on the CUDA card unless the caller asks for the
CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack", "zstandard")

MODULES = sorted(PKG.rglob("*.py"))
CARD_SIDE = [REPO / "chip_smoke.py", REPO / "tests" / "_torch_lm_card.py",
             REPO / "tests" / "_torch_train_card.py",
             REPO / "tests" / "_torch_congestion_plan.py",
             REPO / "tests" / "_torch_scan_tiles.py",
             REPO / "tests" / "_torch_stepper_inputs.py",
             *sorted((REPO / "scripts").glob("*.py"))]


def _imported(path: pathlib.Path) -> set[str]:
    """Top-level package names a file imports (absolute imports only)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_package_has_the_slice_modules():
    rel = {str(p.relative_to(PKG)) for p in MODULES}
    for name in ("device.py", "convert.py", "core/batch.py",
                 "core/engine.py", "core/place_batch.py",
                 "kernels/congestion.py", "kernels/fit.py",
                 "kernels/ops.py", "kernels/ref.py", "kernels/build.py",
                 "workload/synthetic.py", "core/place_step.py",
                 "kernels/place_step.py", "core/rounding.py",
                 "core/lowerbound.py", "core/constraints.py",
                 "core/checker.py", "workload/gct.py", "workload/jobs.py",
                 "serve/__init__.py", "serve/config.py", "serve/queue.py",
                 "serve/scale.py", "serve/faults.py", "serve/service.py",
                 "serve/snapshot.py", "serve/trace.py",
                 "stochastic/__init__.py", "stochastic/forecast.py",
                 "stochastic/scenarios.py", "stochastic/select.py",
                 "launch/__init__.py", "launch/rightsize.py",
                 "models/__init__.py", "models/config.py",
                 "models/layers.py", "models/attention.py",
                 "models/moe.py", "models/rglru.py", "models/rwkv.py",
                 "models/blocks.py", "models/model.py",
                 "configs/__init__.py", "configs/gemma2_9b.py",
                 "configs/gemma3_1b.py", "configs/granite_34b.py",
                 "configs/kimi_k2_1t.py", "configs/olmoe_1b_7b.py",
                 "configs/qwen25_3b.py", "configs/qwen2_vl_2b.py",
                 "configs/recurrentgemma_9b.py", "configs/rwkv6_7b.py",
                 "configs/whisper_small.py", "launch/serve.py",
                 "launch/train.py", "train/__init__.py",
                 "train/optimizer.py", "train/compression.py",
                 "train/data.py", "train/train_step.py",
                 "train/checkpoint.py", "train/fault.py",
                 "launch/dryrun.py", "launch/hlo_cost.py", "launch/mesh.py",
                 "sharding/__init__.py", "sharding/ctx.py",
                 "sharding/partitioning.py"):
        assert name in rel, name
    for src in ("congestion.cu", "fit.cu", "place_step.cu"):
        assert (PKG / "kernels" / "csrc" / src).is_file(), src
    from repro_torch import convert

    assert callable(convert.forecast_from_reference)
    assert callable(convert.params_from_reference)
    assert callable(convert.decode_state_from_reference)
    assert callable(convert.named_from_reference)
    assert callable(convert.train_state_from_reference)
    from repro_torch.launch import train
    from repro_torch.models import forward_train, loss_fn

    assert callable(train.run) and callable(forward_train)
    assert callable(loss_fn)
    from repro_torch.launch import dryrun, hlo_cost, mesh
    from repro_torch import sharding

    assert callable(dryrun.run_cell) and callable(dryrun.main)
    assert callable(hlo_cost.analyze) and callable(mesh.make_production_mesh)
    assert callable(sharding.param_specs) and callable(sharding.tree_named)


@pytest.mark.parametrize("path", MODULES + CARD_SIDE,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = _imported(path) & set(FORBIDDEN)
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_checker_imports_only_numpy_and_math():
    """The feasibility oracle shares no code with the port: no relative
    import, and no absolute one beyond numpy and math."""
    tree = ast.parse((PKG / "core" / "checker.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "checker.py has a relative import"
            names.add(node.module.split(".")[0])
    assert names - {"__future__"} == {"numpy", "math"}


def test_imports_with_jax_and_reference_blocked():
    """Import every module of the port in a fresh interpreter in which
    importing jax or repro raises."""
    mods = [".".join(p.relative_to(PKG.parent).with_suffix("").parts)
            for p in MODULES]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = f"""
import importlib, importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {FORBIDDEN!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(REPO / "src")!r})
for m in {mods!r}:
    importlib.import_module(m)
print("ok", len({mods!r}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    from repro_torch.core import (FleetEngine, evaluate_many, place_many,
                                  rightsize, solve_lp_many, two_phase)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.launch import rightsize as cli
    from repro_torch.launch import serve as lm_serve
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as lm_train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model, init_params
    from repro_torch.train import checkpoint
    from repro_torch.serve import RightsizingService
    from repro_torch.stochastic import (StochasticConfig, gct_forecast,
                                        plan_stochastic)
    from repro_torch.workload import SyntheticSpec, synthetic_instance

    RightsizingService(device="cpu").snapshot(str(tmp_path))
    cfg = smoke_config("qwen2.5-3b")
    ckpt_dir = str(tmp_path / "ckpt")
    checkpoint.save(ckpt_dir, Model(cfg, "cpu"), 1)
    train_args = ["--steps", "1", "--ckpt-dir", str(tmp_path / "run")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = synthetic_instance(SyntheticSpec(n=8, m=2, D=2, T=5))
    mapping = [0] * p.n
    calls = [
        lambda: FleetEngine(),
        lambda: evaluate_many([p]),
        lambda: solve_lp_many([p], iters=2),
        lambda: place_many([p], [mapping]),
        lambda: two_phase(p, mapping),
        lambda: rightsize(p, "penalty-map"),
        lambda: ops.congestion([0], [0], [[1.0]], 1),
        lambda: resolve_device("cuda"),
        lambda: RightsizingService(),
        lambda: RightsizingService.restore(str(tmp_path)),
        lambda: plan_stochastic(gct_forecast(n=12, m=3),
                                StochasticConfig(scenarios=2)),
        lambda: cli.run(["plan", "--scenarios", "2"]),
        lambda: cli.run(["compare"]),
        lambda: lm_serve.run(["--gen", "2"]),
        lambda: Model(smoke_config("gemma2-9b")),
        lambda: init_params(torch.Generator(), smoke_config("gemma2-9b")),
        lambda: convert.params_from_reference({}, smoke_config("rwkv6-7b")),
        lambda: convert.decode_state_from_reference(
            {}, smoke_config("rwkv6-7b")),
        lambda: convert.named_from_reference({}, smoke_config("rwkv6-7b")),
        lambda: convert.train_state_from_reference(
            {}, smoke_config("rwkv6-7b")),
        lambda: lm_train.run(train_args),
        lambda: checkpoint.restore(ckpt_dir, Model(cfg, "cpu")),
        lambda: dryrun.main(["--arch", "qwen2.5-3b", "--shape",
                             "decode_32k", "--out", str(tmp_path / "dr")]),
        lambda: dryrun.run_cell("qwen2.5-3b", "decode_32k", False),
        lambda: make_host_mesh(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu").type == "cpu"
    assert len(FleetEngine(device="cpu").evaluate([p]).entries) == 1
    assert RightsizingService.restore(str(tmp_path),
                                      device="cpu").fleets == ()
    assert plan_stochastic(gct_forecast(n=12, m=3),
                           StochasticConfig(scenarios=2),
                           device="cpu").lp_dispatches == 1
    assert not (tmp_path / "run").exists()  # the run raised before training
    assert not (tmp_path / "dr").exists()  # the dry-run raised before a cell
    assert checkpoint.restore(ckpt_dir, Model(cfg, "cpu"),
                              device="cpu")[1] == 1
    model, _state, hist = lm_train.run(train_args + ["--device", "cpu"])
    assert model.device.type == "cpu" and len(hist["loss"]) == 1


def test_kernel_build_failure_propagates_out_of_plan_stochastic(monkeypatch):
    """No fallback: a congestion kernel that fails to build stops
    ``plan_stochastic``, and its plain version never runs in its place."""
    from repro_torch.core import FleetEngine, SolverConfig
    from repro_torch.kernels import build, congestion, ref
    from repro_torch.stochastic import (StochasticConfig, gct_forecast,
                                        plan_stochastic)

    plain = []
    orig = ref.congestion_lp_ref

    def spy(*args, **kwargs):
        plain.append("congestion_lp_ref")
        return orig(*args, **kwargs)

    def no_build(name):
        raise RuntimeError(f"nvcc failed building {name}")

    engine = FleetEngine(solver=SolverConfig(tol=5e-3, iters=4000,
                                             operator="pallas"),
                         algos=("lp-map-f",), device="cpu")
    monkeypatch.setattr(ref, "congestion_lp_ref", spy)
    monkeypatch.setattr(congestion, "_on_card", lambda *t: True)
    monkeypatch.setattr(build, "load", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed building congestion"):
        plan_stochastic(gct_forecast(n=12, m=3),
                        StochasticConfig(scenarios=2), engine=engine)
    assert plain == []
