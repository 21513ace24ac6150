"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``)
imports JAX or the JAX package, and its entry points run on the CUDA card
unless the caller asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")

MODULES = sorted(PKG.rglob("*.py"))


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
                 "serve/snapshot.py", "serve/trace.py"):
        assert name in rel, name
    for src in ("congestion.cu", "fit.cu", "place_step.cu"):
        assert (PKG / "kernels" / "csrc" / src).is_file(), src


@pytest.mark.parametrize("path", MODULES + [REPO / "chip_smoke.py"],
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
    from repro_torch.core import (FleetEngine, place_many, rightsize,
                                  solve_lp_many, two_phase)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.serve import RightsizingService
    from repro_torch.workload import SyntheticSpec, synthetic_instance

    RightsizingService(device="cpu").snapshot(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = synthetic_instance(SyntheticSpec(n=8, m=2, D=2, T=5))
    mapping = [0] * p.n
    calls = [
        lambda: FleetEngine(),
        lambda: solve_lp_many([p], iters=2),
        lambda: place_many([p], [mapping]),
        lambda: two_phase(p, mapping),
        lambda: rightsize(p, "penalty-map"),
        lambda: ops.congestion([0], [0], [[1.0]], 1),
        lambda: resolve_device("cuda"),
        lambda: RightsizingService(),
        lambda: RightsizingService.restore(str(tmp_path)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu").type == "cpu"
    assert len(FleetEngine(device="cpu").evaluate([p]).entries) == 1
    assert RightsizingService.restore(str(tmp_path),
                                      device="cpu").fleets == ()
