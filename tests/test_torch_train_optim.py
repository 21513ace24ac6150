"""The port's optimizer, gradient compression and data pipeline against the
JAX package's, on the CPU.

* ``adamw_update``: three steps on random parameters and gradients of
  qwen2.5-3b's smoke config (its QKV biases and per-layer norms are rank 1 in
  the port, rank 2 in the reference's stacked layout), with ``state_dtype``
  float32 and bfloat16, parameters float32 and bfloat16, with clipping and
  without.  Each step starts from the reference's carried parameters and
  state (moments, step count): float32 leaves within rtol 1e-6 / atol 1e-7
  (read: about one float32 step, where XLA contracts the update into fused
  multiply-adds), bfloat16 leaves within one bfloat16 step (rtol 2**-7: the
  float32 values they round from differ in the last place), the grad norm
  within rtol 1e-5 (float32 sums of some 10^5 squares in another order).  In
  float32 each side also carries its own state through the three steps,
  within the same tolerance.  Decay by the port's own rank fails the check.
* compression: quantize, dequantize and the error-feedback round trip
  bit-equal, on inputs with exact .5 ties; the reference's convergence case.
* ``make_batch``: bit-equal for every architecture, several steps, seeds and
  host splits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import configs, numpy_tree, reference_model
from _torch_train import np_equal
from repro.configs import smoke_config as ref_smoke_config
from repro.train import compression as ref_comp
from repro.train import data as ref_data
from repro.train import optimizer as ref_opt
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.convert import named_from_reference, params_from_reference
from repro_torch.train import compression, data, optimizer

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32_RTOL, F32_ATOL = 1e-6, 1e-7
BF16_RTOL = 2.0 ** -7


NORM_RTOL = 1e-5


def _close(ref, got, what):
    assert ref.dtype == got.dtype, what
    rtol = BF16_RTOL if got.dtype == torch.bfloat16 else F32_RTOL
    np.testing.assert_allclose(got.detach().float().numpy(),
                               ref.float().numpy(), rtol=rtol, atol=F32_ATOL,
                               err_msg=what)


def _adamw_three_steps(param_dtype, state_dtype, clip_norm, resync=True):
    """Three ``adamw_update`` steps of each package; with ``resync`` each
    port step starts from the reference's parameters and state."""
    rcfg, tcfg = (dataclasses.replace(c, dtype=param_dtype)
                  for c in configs("qwen2.5-3b"))
    params, _ = reference_model(rcfg, tcfg)
    rng = np.random.default_rng(5)

    def rand(p, s=1.0):
        return jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)
                           * s, p.dtype)

    def named(tree):
        return named_from_reference(numpy_tree(tree), tcfg, "cpu")

    params = jax.tree.map(rand, params)  # norms and biases away from zero
    model = params_from_reference(numpy_tree(params), tcfg, "cpu")
    kw = dict(lr=1e-2, warmup_steps=2, state_dtype=state_dtype,
              clip_norm=clip_norm)
    r_cfg, p_cfg = ref_opt.AdamWConfig(**kw), optimizer.AdamWConfig(**kw)
    r_state = ref_opt.adamw_init(params, r_cfg)
    p_params = dict(model.named_parameters())
    p_state = optimizer.adamw_init(p_params, p_cfg)
    update = jax.jit(lambda p, g, s: ref_opt.adamw_update(p, g, s, r_cfg))
    for k in range(3):
        if resync and k:
            with torch.no_grad():
                for name, t in named(params).items():
                    p_params[name].copy_(t)
            p_state = {"m": named(r_state["m"]), "v": named(r_state["v"]),
                       "step": torch.tensor(int(r_state["step"]),
                                            dtype=torch.int32)}
        g = jax.tree.map(lambda p: rand(p, 0.1), params)
        params, r_state, r_m = update(params, g, r_state)
        _p, p_state, p_m = optimizer.adamw_update(p_params, named(g),
                                                  p_state, p_cfg)
        assert int(p_state["step"]) == int(r_state["step"]) == k + 1
        np.testing.assert_allclose(float(p_m["grad_norm"]),
                                   float(r_m["grad_norm"]), rtol=NORM_RTOL)
        assert float(p_m["lr"]) == float(r_m["lr"])
        for what, ref_tree, got in (("params", params, p_params),
                                    ("m", r_state["m"], p_state["m"]),
                                    ("v", r_state["v"], p_state["v"])):
            ref = named(ref_tree)
            for name, t in got.items():
                _close(ref[name], t, f"step {k} {what} {name}")


@pytest.mark.parametrize("clip_norm", [1.0, 1e9])
@pytest.mark.parametrize("param_dtype,state_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
def test_adamw_update_matches_the_reference(param_dtype, state_dtype,
                                            clip_norm):
    _adamw_three_steps(param_dtype, state_dtype, clip_norm)


@pytest.mark.parametrize("clip_norm", [1.0, 1e9])
def test_adamw_carries_its_own_state_like_the_reference(clip_norm):
    _adamw_three_steps("float32", "float32", clip_norm, resync=False)


def test_decay_by_the_ports_own_rank_fails(monkeypatch):
    monkeypatch.setattr(optimizer, "decays", lambda name, p: p.ndim >= 2)
    with pytest.raises(AssertionError,
                       match=r"params layers\.\d+\.(ln|attn\.b)"):
        _adamw_three_steps("float32", "float32", 1e9)


def test_decay_set_is_the_references_stacked_rank():
    model = params_from_reference(
        numpy_tree(reference_model(*configs("whisper-small"))[0]),
        smoke_config("whisper-small"), "cpu")
    got = {n for n, p in model.named_parameters()
           if optimizer.decays(n, p)}
    assert got == {n for n, _ in model.named_parameters()} - {
        "final_norm", "encoder.final_norm"}
    assert "layers.0.ln1" in got and "encoder.blocks.0.ln1" in got


def test_adamw_init_layout():
    p = {"a": torch.ones(3, 2), "b": torch.ones(4, dtype=torch.bfloat16)}
    st = optimizer.adamw_init(p, optimizer.AdamWConfig(state_dtype="bfloat16"))
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    for key in ("m", "v"):
        assert {k: (t.shape, t.dtype) for k, t in st[key].items()} == {
            "a": ((3, 2), torch.bfloat16), "b": ((4,), torch.bfloat16)}


def _with_ties(n, seed):
    """Gradients whose blocks hit exact .5 ties: each block's max is 127
    and the rest are halves of odd integers, so blocks / scale lands on
    k + 0.5 and rounds half to even."""
    rng = np.random.default_rng(seed)
    g = (rng.integers(-126, 127, n) + 0.5).astype(np.float32)
    g[::256] = 127.0
    return g * np.float32(2.0 ** -7)


@pytest.mark.parametrize("shape", [(1000,), (3, 256), (7, 5, 11), (256,)])
def test_quantize_and_round_trip_bit_equal(shape):
    n = int(np.prod(shape))
    for g in (_with_ties(n, 0).reshape(shape),
              np.random.default_rng(1).standard_normal(shape)
              .astype(np.float32) * 0.01):
        q, s, nn = ref_comp.quantize_int8(jnp.asarray(g))
        pq, ps, pn = compression.quantize_int8(torch.from_numpy(g))
        assert nn == pn == n
        assert np_equal(np.asarray(q), pq.numpy())
        assert np_equal(np.asarray(s), ps.numpy())
        assert np_equal(np.asarray(ref_comp.dequantize_int8(q, s, n, shape)),
                        compression.dequantize_int8(pq, ps, pn, shape).numpy())
        err = np.random.default_rng(2).standard_normal(shape).astype(
            np.float32) * 1e-3
        r_hat, r_err = ref_comp.compress_decompress(jnp.asarray(g),
                                                    jnp.asarray(err))
        p_hat, p_err = compression.compress_decompress(
            torch.from_numpy(g), torch.from_numpy(err))
        assert np_equal(np.asarray(r_hat), p_hat.numpy())
        assert np_equal(np.asarray(r_err), p_err.numpy())


def test_ties_round_half_to_even():
    g = _with_ties(512, 3)
    q, _s, _n = compression.quantize_int8(torch.from_numpy(g))
    halves = np.abs(g / np.float32(2.0 ** -7)) % 1 == 0.5
    assert halves.sum() > 400
    exact = np.round(g / np.float32(2.0 ** -7))[halves]   # half to even
    assert np.array_equal(q.numpy().reshape(-1)[halves], exact)


def test_bfloat16_gradient_round_trip_bit_equal():
    g = np.random.default_rng(4).standard_normal((5, 300)).astype(np.float32)
    r_hat, r_err = ref_comp.compress_decompress(
        jnp.asarray(g, jnp.bfloat16), jnp.zeros((5, 300)))
    p_hat, p_err = compression.compress_decompress(
        torch.from_numpy(g).bfloat16(), torch.zeros(5, 300))
    assert p_hat.dtype == torch.bfloat16 and p_err.dtype == torch.float32
    assert np.array_equal(np.asarray(r_hat).astype(np.float32),
                          p_hat.float().numpy())
    assert np_equal(np.asarray(r_err), p_err.numpy())


def test_error_feedback_converges():
    """The reference's case: one round trip loses precision, but the sum
    of 50 round trips with error feedback is within 1% of 50 g."""
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32) * 0.01)
    g1, _ = compression.compress_decompress(g, torch.zeros(1000))
    assert float((g1 - g).abs().max()) > 0
    total, e = torch.zeros(1000), torch.zeros(1000)
    for _ in range(50):
        gh, e = compression.compress_decompress(g, e)
        total += gh
    assert float(torch.linalg.norm(total - 50 * g)
                 / torch.linalg.norm(50 * g)) < 1e-2


def test_compressed_psum_needs_more_than_one_card():
    """The collective runs over a dimension of the ambient mesh
    (``tests/test_torch_multicard_train.py``); without a mesh there is no
    group to reduce over, and it raises instead of returning the local
    value."""
    with pytest.raises(ValueError, match="needs a mesh"):
        compression.compressed_psum(torch.zeros(4), torch.zeros(4), "pod")
    err = compression.init_error_state({"w": torch.ones(2, 3,
                                                        dtype=torch.bfloat16)})
    assert err["w"].dtype == torch.float32 and not err["w"].any()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_make_batch_bit_equal(arch):
    rcfg, tcfg = ref_smoke_config(arch), smoke_config(arch)
    for dc_kw, step, host, hosts in (({}, 0, 0, 1),
                                     (dict(batch=4, seq_len=37), 3, 0, 1),
                                     (dict(batch=6, seed=9), 11, 2, 3)):
        ref = ref_data.make_batch(rcfg, ref_data.DataConfig(**dc_kw), step,
                                  host, hosts)
        got = data.make_batch(tcfg, data.DataConfig(**dc_kw), step, host,
                              hosts)
        assert ref.keys() == got.keys()
        for key in ref:
            assert np_equal(ref[key], got[key]), (arch, key)
    keys = set(got)
    assert ("frames" in keys) == bool(tcfg.encoder_layers)
    assert ("vision" in keys) == ("mrope_positions" in keys) == bool(
        tcfg.vision_seq)


def test_synthetic_stream_and_device_batches():
    cfg = smoke_config("qwen2-vl-2b")
    dc = data.DataConfig(batch=4, seq_len=20)
    src = data.SyntheticLMData(cfg, dc, host_id=1, num_hosts=2)
    it = iter(src)
    for step in range(3):
        b = next(it)
        assert src.local_batch == 2 and b["tokens"].shape == (2, 20)
        assert all(np_equal(b[k], v) for k, v in
                   data.make_batch(cfg, dc, step, 1, 2).items())
    t = data.to_device(b, "cpu")
    assert t["mrope_positions"].shape == (3, 2, 20)
    assert t["tokens"].dtype == torch.int32
    with pytest.raises(ValueError, match="split"):
        data.SyntheticLMData(cfg, dc, num_hosts=3)
