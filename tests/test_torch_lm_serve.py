"""The LM serving path of the port on the CPU: the config registry against
the JAX package's, the converter's layer order, the port's own
prefill/decode consistency (the bound of ``tests/test_archs.py``
``test_prefill_decode_parity``, 5e-3), and ``launch.serve`` against the
reference's greedy ids on the same weights and prompt."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from _torch_lm import WINDOW, batch_np, configs, max_diff, numpy_tree, \
    reference_model, to_torch
from repro.launch import serve as ref_serve
from repro.launch.train import model_100m as ref_model_100m
from repro.models import init_params as ref_init_params
from repro.models import build_segments as ref_build_segments
from repro_torch import configs as port_configs
from repro_torch.convert import params_from_reference, segment_layers
from repro_torch.launch import serve as port_serve
from repro_torch.launch.train import model_100m, pick_config
from repro_torch.models import (build_segments, decode_step,
                                init_decode_state, init_params, prefill,
                                torch_dtype)
from repro_torch.models.model import _run_encoder

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

PARITY_ATOL = 5e-3


# --- configs -----------------------------------------------------------------

def test_registry_and_cells_match_the_reference():
    assert port_configs.ARCHS == ref_configs.ARCHS
    assert {k: dataclasses.asdict(v)
            for k, v in port_configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    assert port_configs.cells(include_skipped=True) == \
        ref_configs.cells(include_skipped=True)
    assert dataclasses.asdict(model_100m()) == \
        dataclasses.asdict(ref_model_100m())
    assert dataclasses.asdict(pick_config("gemma2-9b", "100m")) == \
        dataclasses.asdict(model_100m())


@pytest.mark.parametrize("arch", sorted(ref_configs.ARCHS))
def test_configs_match_the_reference(arch):
    for get in ("get_config", "smoke_config"):
        ref = getattr(ref_configs, get)(arch)
        port = getattr(port_configs, get)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), get
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert [dataclasses.asdict(s) for s in build_segments(port)] == \
            [dataclasses.asdict(s) for s in ref_build_segments(ref)]
    assert dataclasses.asdict(pick_config(arch, "full")) == \
        dataclasses.asdict(ref_configs.get_config(arch))


def test_torch_dtype():
    cfg = port_configs.smoke_config("gemma2-9b")
    assert torch_dtype(cfg) == torch.float32
    assert torch_dtype(port_configs.get_config("gemma2-9b")) == \
        torch.bfloat16
    with pytest.raises(ValueError, match="float16"):
        torch_dtype(dataclasses.replace(cfg, dtype="float16"))


# --- the converter's layer order ----------------------------------------------

@pytest.mark.parametrize("arch,expect", [
    # [local, global] x 2: repeat r of sub-block j is layer 2r + j
    ("gemma2-9b", [(0, 0, 0, 0), (1, 0, 0, 1), (2, 0, 1, 0), (3, 0, 1, 1)]),
    # [rec, rec, attn] x 2, then a trailing [rec, rec] segment
    ("recurrentgemma-9b", [(0, 0, 0, 0), (1, 0, 0, 1), (2, 0, 0, 2),
                           (3, 0, 1, 0), (4, 0, 1, 1), (5, 0, 1, 2),
                           (6, 1, 0, 0), (7, 1, 0, 1)]),
])
def test_converter_layer_order(arch, expect):
    """Repeat r of sub-block j in the segment starting at layer o is layer
    o + r * len(unit) + j: each port layer holds that slice of the
    reference's stacked parameters, and its kind and window are the
    config's for that layer (a wrong index swaps local and global)."""
    rcfg, tcfg = configs(arch)
    assert segment_layers(tcfg) == expect
    params, model = reference_model(rcfg, tcfg)
    for layer, si, r, j in expect:
        block = model.layers[layer]
        kind, window, theta, moe = tcfg.pattern[layer]
        assert (block.sub.kind, block.sub.window) == (kind, window)
        ref_p = params["segments"][si][j]
        name = "attn" if kind == "attn" else "rec"
        ref_w = np.asarray(ref_p[name]["w_out" if name == "rec" else "wq"])
        port_w = (block.rec.w_out if name == "rec" else block.attn.wq)
        assert np.array_equal(ref_w[r], port_w.detach().numpy()), layer
    windows = [b.sub.window for b in model.layers]
    assert windows == [w for _k, w, _t, _m in tcfg.pattern]


def test_converter_carries_every_parameter():
    rcfg, tcfg = configs("whisper-small")
    params = numpy_tree(ref_init_params(jax.random.PRNGKey(1), rcfg))
    model = params_from_reference(params, tcfg, "cpu")
    n_ref = sum(np.asarray(a).size for a in jax.tree.leaves(params))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    assert np.array_equal(params["encoder"]["blocks"]["attn"]["wo"][1],
                          model.encoder.blocks[1].attn.wo.detach().numpy())


# --- the port's own prefill/decode consistency ---------------------------------

@pytest.mark.parametrize("arch,window", [
    ("gemma3-1b", None), ("gemma2-9b", None), ("recurrentgemma-9b", None),
    ("rwkv6-7b", None), ("whisper-small", None), ("gemma2-9b", WINDOW),
    ("recurrentgemma-9b", WINDOW)])
def test_prefill_decode_parity(arch, window):
    """Prefill against decoding the same tokens from an empty state
    (``tests/test_archs.py``'s check, on the port alone): exercises the
    ring-buffer caches, recurrent state extraction and cross-attention K/V
    precompute; with ``window`` 8 the ring wraps below the prompt."""
    _rcfg, cfg = configs(arch, window)
    model = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = to_torch(batch_np(cfg, seed=3))
    B, S = batch["tokens"].shape
    logits_p, _state = prefill(model, batch, max_len=16)
    enc_out = (_run_encoder(batch["frames"], model)
               if cfg.encoder_layers else None)
    state = init_decode_state(model, B, 16, enc_out=enc_out)
    for t in range(S):
        lg, state = decode_step(model, state, batch["tokens"][:, t])
    assert state["pos"] == S
    assert max_diff(lg, logits_p) < PARITY_ATOL, arch


# --- launch.serve ----------------------------------------------------------------

def _reference_inputs(cfg, B, S):
    """The reference serve driver's weights and prompt (PRNGKey(0))."""
    key = jax.random.PRNGKey(0)
    params = ref_init_params(key, cfg)
    batch = {"tokens": jax.random.randint(key, (B, S), 0, cfg.vocab_size)}
    if cfg.encoder_layers:
        batch["frames"] = jax.random.normal(
            key, (B, cfg.encoder_seq, cfg.d_model))
    if cfg.vision_seq:
        batch["vision"] = jax.random.normal(
            key, (B, cfg.vision_seq, cfg.d_model))
        batch["mrope_positions"] = jnp.broadcast_to(
            jnp.arange(S, dtype=jnp.int32)[None, None, :], (3, B, S))
    return params, batch


@pytest.mark.parametrize("arch", ["gemma2-9b", "whisper-small"])
def test_serve_greedy_ids_match_the_reference(arch):
    """The reference's ``run`` (its weights and prompt from PRNGKey(0)) and
    the port's ``generate`` on the same weights and prompt produce the same
    greedy ids."""
    argv = ["--arch", arch, "--preset", "smoke", "--batch", "2",
            "--prompt-len", "12", "--gen", "6"]
    ref_ids = np.asarray(ref_serve.run(argv))
    rcfg, tcfg = configs(arch)
    params, batch = _reference_inputs(rcfg, 2, 12)
    model = params_from_reference(numpy_tree(params), tcfg, "cpu")
    ids, info = port_serve.generate(
        model, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
        6)
    assert info["finite"] and info["steps"] == 5
    assert np.array_equal(ids.numpy(), ref_ids), (ids, ref_ids)


def test_serve_cli_on_the_cpu(capsys):
    out = port_serve.run(["--preset", "smoke", "--device", "cpu", "--batch",
                          "2", "--prompt-len", "10", "--gen", "4"])
    assert tuple(out.shape) == (2, 4) and out.dtype == torch.int64
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("prefill: batch=2 len=10")
    assert lines[1].startswith("decode: 3 steps")
    assert lines[2] == f"generated token ids (first row): {out[0].tolist()}"
    # the same seed serves the same ids; sampling draws from the generator
    again = port_serve.run(["--preset", "smoke", "--device", "cpu",
                            "--batch", "2", "--prompt-len", "10", "--gen",
                            "4"])
    assert torch.equal(out, again)
    sampled = port_serve.run(["--arch", "qwen2-vl-2b", "--preset", "smoke",
                              "--device", "cpu", "--batch", "2",
                              "--prompt-len", "10", "--gen", "4",
                              "--temperature", "1.0"])
    assert tuple(sampled.shape) == (2, 4)


def test_init_params_generator_on_another_device():
    cfg = port_configs.smoke_config("gemma2-9b")
    with pytest.raises(ValueError, match="generator"):
        init_params(torch.Generator(), cfg, "meta")
