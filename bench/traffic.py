"""The benchmark's one traffic generator.

A configuration file names an instance generator and its sizes; a mix
file holds the traffic's parameters.  Every draw comes from its own
``np.random.default_rng([tag, seed, ...])`` stream, so the same ``--seed``
gives the same inputs, a step's inputs do not depend on how many steps a
run reaches, and the warm-up, the timed steps and the check's sample never
share a stream.
"""

from __future__ import annotations

import importlib.util
import pathlib

import numpy as np

from . import gen

STEP, WARM, SAMPLE, PICK = 0xB01, 0xB02, 0xB03, 0xB04

# instance generators by the name a configuration file gives
GENERATORS = {"synthetic": gen.synthetic_instance,
              "gct": gen.gct_like_instance}


def entropy(seed: int) -> int:
    """A non-negative seed word for any whole-number ``--seed``."""
    return int(seed) % (1 << 64)


def rng(seed: int, tag: int, *key: int) -> np.random.Generator:
    return np.random.default_rng([tag, entropy(seed), *key])


def generator(config: dict, bench_dir: pathlib.Path):
    """The configuration's instance generator: one of ``GENERATORS``, or
    the ``instance`` function of ``generators/<name>.py`` under the
    benchmark's folder."""
    name = config["generator"]
    if name in GENERATORS:
        return GENERATORS[name]
    path = bench_dir / "generators" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_gen_{name}", path)
    if spec is None or not path.is_file():
        raise ValueError(f"no instance generator named {name!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.instance


def instances(config: dict, bench_dir: pathlib.Path, seed: int, tag: int,
              step: int, count: int) -> list[gen.Instance]:
    """``count`` instances of step ``step``, instance j from its own
    stream."""
    make = generator(config, bench_dir)
    return [make(rng(seed, tag, step, j), **config["instance"])
            for j in range(count)]


def step_seed(seed: int, tag: int, step: int) -> int:
    """A whole-number seed for what the program draws itself in a step
    (a forecast's scenario fan-out)."""
    return int(np.random.SeedSequence([tag, entropy(seed), step])
               .generate_state(1, np.uint64)[0])


def picks(seed: int, steps: int, among: int, count: int) -> np.ndarray:
    """(steps, count) indices drawn without replacement from ``among`` per
    step: the answers of a step that the check may sample."""
    count = min(count, among)
    return np.stack([rng(seed, PICK, i).choice(among, count, replace=False)
                     for i in range(steps)])


def sample(seed: int, done: int, per_step: int, count: int) -> list:
    """``count`` distinct (step, pick) pairs among ``done`` completed steps
    of ``per_step`` picks each, drawn after the window."""
    pairs = [(i, j) for i in range(done) for j in range(per_step)]
    r = rng(seed, SAMPLE)
    idx = r.choice(len(pairs), min(count, len(pairs)), replace=False)
    return [pairs[k] for k in sorted(idx)]
