"""The LM port's modules against the JAX package's, one by one, on the CPU:
the same numpy inputs (from a seed) and weights through ``repro.models.*``
and ``repro_torch.models.*``.  Tolerance 1e-4 abs in float32 (the two sum in
another order; the port's RG-LRU scans time sequentially where the
reference uses an associative scan); MoE routing is held equal, drops
included.  The bfloat16 cases hold the points where the reference rounds
(the attention paths in bfloat16: ``tests/test_torch_lm_bf16.py``)."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import ATOL, configs, max_diff, numpy_tree
from repro.models import attention as r_attn
from repro.models import init_params as ref_init_params
from repro.models import layers as r_layers
from repro.models import moe as r_moe
from repro.models import rglru as r_rglru
from repro.models import rwkv as r_rwkv
from repro.models.model import _embed_tokens as r_embed_tokens
from repro_torch.convert import params_from_reference
from repro_torch.models import attention as t_attn
from repro_torch.models import init_params
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import rglru as t_rglru
from repro_torch.models import rwkv as t_rwkv
from repro_torch.models.model import _embed_tokens as t_embed_tokens

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _load(module, tree: dict):
    """Load a reference parameter dict (flat) into a port module."""
    module.load_state_dict({k: torch.tensor(np.asarray(v))
                            for k, v in tree.items()}, strict=True)
    return module


# --- layers ------------------------------------------------------------------

def test_rms_norm():
    rng = _rng(1)
    x, scale = _f32(rng, 2, 5, 16), _f32(rng, 16, scale=0.3)
    got = t_layers.rms_norm(_t(x), _t(scale))
    assert max_diff(r_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale)),
                    got) < ATOL


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_half_split(theta):
    """Half-split layout, float32 angles up to position 5000."""
    rng = _rng(2)
    x = _f32(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    ref = r_layers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    assert max_diff(ref, t_layers.rope(_t(x), _t(pos), theta)) < ATOL
    # the interleaved layout gives other numbers
    x1, x2 = x[..., 0::2], x[..., 1::2]
    inter = np.concatenate([x1, x2], -1)
    assert max_diff(ref, t_layers.rope(_t(inter), _t(pos), theta)) > 1e-2


def test_mrope_sections():
    rng = _rng(3)
    x = _f32(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 300, (3, 2, 7)).astype(np.int32)
    ref = r_layers.mrope(jnp.asarray(x), jnp.asarray(pos), (4, 2, 2), 1e6)
    assert max_diff(ref, t_layers.mrope(_t(x), _t(pos), (4, 2, 2),
                                        1e6)) < ATOL
    with pytest.raises(ValueError, match="sections"):
        t_layers.mrope(_t(x), _t(pos), (4, 2, 3))


def test_softcap():
    x = _f32(_rng(4), 50, scale=40.0)
    assert max_diff(r_layers.softcap(jnp.asarray(x), 30.0),
                    t_layers.softcap(_t(x), 30.0)) < ATOL
    assert t_layers.softcap(_t(x), None) is not None


@pytest.mark.parametrize("gated", [True, False])
def test_gated_mlp_uses_tanh_gelu(gated):
    rng = _rng(5)
    x = _f32(rng, 3, 8)
    p = {"w_up": _f32(rng, 8, 12), "w_down": _f32(rng, 12, 8)}
    if gated:
        p["w_gate"] = _f32(rng, 8, 12)
    ref = r_layers.gated_mlp(jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in p.items()})
    got = t_layers.gated_mlp(_t(x), {k: _t(v) for k, v in p.items()})
    assert max_diff(ref, got) < ATOL
    # jax.nn.gelu defaults to the tanh approximation, not the erf form
    z = _f32(rng, 100, scale=3.0)
    assert max_diff(jax.nn.gelu(jnp.asarray(z)), t_layers.gelu(_t(z))) < 1e-6
    assert max_diff(jax.nn.gelu(jnp.asarray(z)),
                    torch.nn.functional.gelu(_t(z))) > 1e-4


def test_bf16_rounding_points():
    """In bfloat16: the embedding scale is rounded to bf16 before the
    product, rms_norm and rope compute in f32 and round once at the end."""
    rng = _rng(6)
    d = 3584  # gemma2-9b: sqrt(d) = 59.866..., 59.75 in bf16
    rcfg, tcfg = configs("gemma2-9b")
    rcfg = dataclasses.replace(rcfg, d_model=d, dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, d_model=d, dtype="bfloat16")
    embed = _f32(rng, 16, d, scale=d ** -0.5)
    tokens = rng.integers(0, 16, (2, 3)).astype(np.int32)
    ref = r_embed_tokens({"embed": jnp.asarray(embed, jnp.bfloat16)}, rcfg,
                         jnp.asarray(tokens))

    model = types.SimpleNamespace(cfg=tcfg, embed=_t(embed).bfloat16())
    got = t_embed_tokens(model, _t(tokens))
    assert got.dtype == torch.bfloat16
    assert max_diff(ref.astype(jnp.float32), got.float()) == 0.0

    x, scale = _f32(rng, 2, 5, 64), _f32(rng, 64, scale=0.3)
    ref = r_layers.rms_norm(jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(scale, jnp.bfloat16))
    got = t_layers.rms_norm(_t(x).bfloat16(), _t(scale).bfloat16())
    assert got.dtype == torch.bfloat16
    # one bf16 rounding step at most (rsqrt may round differently)
    assert max_diff(ref.astype(jnp.float32), got.float()) <= 2 ** -7 * 4

    xr = _f32(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    ref = r_layers.rope(jnp.asarray(xr, jnp.bfloat16), jnp.asarray(pos))
    got = t_layers.rope(_t(xr).bfloat16(), _t(pos))
    assert got.dtype == torch.bfloat16
    assert max_diff(ref.astype(jnp.float32), got.float()) <= 2 ** -7 * 4


def test_init_dense_truncated_and_scaled():
    g = torch.Generator().manual_seed(0)
    w = t_layers.init_dense(g, (256, 512), torch.float32)
    assert w.abs().max() <= 2 * 256 ** -0.5 + 1e-7
    # a standard normal truncated at +-2 has std 0.8796
    assert abs(float(w.std()) / 256 ** -0.5 - 0.8796) < 0.02
    w2 = t_layers.init_dense(torch.Generator().manual_seed(0), (256, 512),
                             torch.bfloat16, scale=0.5)
    assert w2.dtype == torch.bfloat16
    assert torch.equal(w2, (w / 256 ** -0.5 * 0.5).bfloat16())


# --- attention ---------------------------------------------------------------

ATTN_CASES = {
    # name: (Sq, Skv, H, KV, causal, window, softcap, q_chunk, kv_chunk,
    #        q_offset, kv_offset)
    "causal-padded-chunks": (13, 13, 4, 2, True, -1, None, 4, 5, 0, 0),
    "windowed-softcapped": (16, 16, 4, 4, True, 6, 50.0, 4, 4, 0, 0),
    # q block 3 sees kv block 0 fully masked before its first valid one
    "masked-first-block": (16, 16, 2, 1, True, 3, None, 4, 4, 0, 0),
    "cross-noncausal": (5, 11, 4, 2, False, -1, 30.0, 1024, 4, 0, 0),
    "offsets-one-chunk": (6, 9, 2, 2, True, 5, None, 1024, 1024, 3, 0),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_streaming_attention(case):
    Sq, Skv, H, KV, causal, window, cap, qc, kc, qo, ko = ATTN_CASES[case]
    rng = _rng(7)
    q, k, v = (_f32(rng, 2, Sq, H, 8), _f32(rng, 2, Skv, KV, 8),
               _f32(rng, 2, Skv, KV, 8))
    kw = dict(window=window, causal=causal, attn_softcap=cap, q_offset=qo,
              kv_offset=ko, q_chunk=qc, kv_chunk=kc)
    ref = r_attn.streaming_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **kw)
    got = t_attn.streaming_attention(_t(q), _t(k), _t(v), **kw)
    assert max_diff(ref, got) < ATOL


def test_block_mask():
    qp = np.arange(3, 9, dtype=np.int32)
    kp = np.arange(0, 10, dtype=np.int32)
    for window, causal in ((-1, True), (4, True), (3, False)):
        ref = r_attn._block_mask(jnp.asarray(qp), jnp.asarray(kp), window,
                                 causal)
        got = t_attn._block_mask(_t(qp), _t(kp), window, causal)
        assert np.array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("window", [8, -1])
def test_decode_attention_wrapped_ring(window):
    """A cache of 8 slots holding positions 12..19 at slot p % 8 (the ring
    has wrapped), plus a partly filled cache with empty (-1) slots."""
    rng = _rng(9)
    CL, pos = 8, 19
    q = _f32(rng, 2, 4, 8)
    kc, vc = _f32(rng, 2, CL, 2, 8), _f32(rng, 2, CL, 2, 8)
    slot_pos = np.empty(CL, np.int32)
    for p in range(12, 20):
        slot_pos[p % CL] = p
    partly = np.array([0, 1, 2, -1, -1, -1, -1, -1], np.int32)
    for sp, at in ((slot_pos, pos), (partly, 2)):
        ref = r_attn.decode_attention(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(sp), at, window=window, attn_softcap=50.0)
        got = t_attn.decode_attention(_t(q), _t(kc), _t(vc), _t(sp), at,
                                      window=window, attn_softcap=50.0)
        assert max_diff(ref, got) < ATOL
    assert np.array_equal(t_attn.init_cache_positions(5).numpy(),
                          np.asarray(r_attn.init_cache_positions(5)))


# --- MoE ---------------------------------------------------------------------

def _moe_params(seed, d=16, ff=8, E=8):
    ref = r_moe.init_moe(jax.random.PRNGKey(seed), d, ff, E, jnp.float32)
    # a router that favours experts 0 and 1, so groups overflow capacity
    router = np.asarray(ref["router"]).copy()
    router[:, :2] += 0.5
    ref = dict(ref, router=jnp.asarray(router))
    port = _load(t_moe.MoE(d, ff, E, torch.float32, "cpu"), ref)
    return ref, port


def _meta_equal(ref_meta, port_meta):
    names = ("slot", "keep", "order", "flat_tok", "flat_p", "flat_e")
    for name, a, b in zip(names, ref_meta, port_meta):
        if name == "flat_p":
            assert max_diff(a, b) < 1e-6, name
        else:
            assert np.array_equal(np.asarray(a), b.numpy()), name


@pytest.mark.parametrize("shape", [(2, 12, 16), (3, 16)],
                         ids=["prefill-groups", "decode-one-group"])
def test_moe_mlp_routing_equal_with_drops(shape):
    ref_p, port_p = _moe_params(10)
    x = _f32(_rng(11), *shape)
    top_k = 2
    out_r, aux_r = r_moe.moe_mlp(jnp.asarray(x), ref_p, top_k=top_k)
    out_t, aux_t = t_moe.moe_mlp(_t(x), port_p, top_k=top_k)
    assert max_diff(out_r, out_t) < ATOL
    assert abs(float(aux_r) - float(aux_t.detach())) < 1e-5

    xg = x.reshape(1 if len(shape) == 2 else shape[0], -1, shape[-1])
    N, E = xg.shape[1], 8
    C = r_moe.router_capacity(N, E, top_k, 1.25)
    assert C == t_moe.router_capacity(N, E, top_k, 1.25)
    probs = jax.nn.softmax(jnp.asarray(xg) @ ref_p["router"], axis=-1)
    _, ref_meta = jax.vmap(
        lambda xt, pr: r_moe._dispatch_group(xt, pr, top_k, C, jnp.float32)
    )(jnp.asarray(xg), probs)
    _, port_meta = t_moe._dispatch(_t(xg), torch.softmax(
        _t(xg) @ port_p.router, dim=-1), top_k, C)
    _meta_equal(ref_meta, port_meta)
    if len(shape) == 3:
        assert not bool(port_meta[1].all()), "no token was dropped"


def test_moe_ties_go_to_the_lower_expert():
    """Equal router probabilities: top-k takes the lowest indices, the
    stable sort keeps token order, and the overflow goes to the dump row."""
    N, E, d, top_k = 12, 8, 4, 2
    xg = _f32(_rng(12), 2, N, d)
    probs = np.full((2, N, E), 1.0 / E, np.float32)
    probs[1, :, 5] = probs[1, :, 6] = 0.2  # ties between two large ones
    C = r_moe.router_capacity(N, E, top_k, 1.25)
    ref_buf, ref_meta = jax.vmap(
        lambda xt, pr: r_moe._dispatch_group(xt, pr, top_k, C, jnp.float32)
    )(jnp.asarray(xg), jnp.asarray(probs))
    port_buf, port_meta = t_moe._dispatch(_t(xg), _t(probs), top_k, C)
    _meta_equal(ref_meta, port_meta)
    assert max_diff(ref_buf, port_buf) == 0.0
    assert set(port_meta[5][0].tolist()) == {0, 1}
    assert set(port_meta[5][1].tolist()) == {5, 6}


def test_router_capacity_grid():
    for n in (1, 4, 12, 100, 4096):
        for E, k, cf in ((8, 2, 1.25), (64, 8, 1.25), (384, 8, 1.0)):
            assert t_moe.router_capacity(n, E, k, cf) == \
                r_moe.router_capacity(n, E, k, cf)


# --- RG-LRU ------------------------------------------------------------------

def _rglru_params(seed, d=16, W=16, K=4):
    ref = r_rglru.init_rglru(jax.random.PRNGKey(seed), d, W, K, jnp.float32)
    return ref, _load(t_rglru.RGLRU(d, W, K, torch.float32, "cpu"), ref)


def test_temporal_conv_and_conv_step():
    ref_p, port_p = _rglru_params(13)
    rng = _rng(14)
    x = _f32(rng, 2, 9, 16)
    assert max_diff(r_rglru.temporal_conv(jnp.asarray(x), ref_p["conv_w"]),
                    t_rglru.temporal_conv(_t(x), port_p.conv_w)) < ATOL
    xt, st = _f32(rng, 2, 16), _f32(rng, 2, 3, 16)
    ro, rs = r_rglru.conv_step(jnp.asarray(xt), jnp.asarray(st),
                               ref_p["conv_w"])
    to, ts = t_rglru.conv_step(_t(xt), _t(st), port_p.conv_w)
    assert max_diff(ro, to) < ATOL and max_diff(rs, ts) == 0.0


def test_rglru_scan_and_step():
    """Sequential float32 scan against the reference's associative scan:
    1e-4 abs over 40 steps; the final state feeds a decode step."""
    ref_p, port_p = _rglru_params(15)
    rng = _rng(16)
    x = _f32(rng, 2, 40, 16)
    ro, rh = r_rglru.rglru_scan(jnp.asarray(x), ref_p)
    to, th = t_rglru.rglru_scan(_t(x), port_p)
    assert max_diff(ro, to) < ATOL and max_diff(rh, th) < ATOL
    assert th.dtype == torch.float32
    xt = _f32(rng, 2, 16)
    ro, rh = r_rglru.rglru_step(jnp.asarray(xt), rh, ref_p)
    to, th = t_rglru.rglru_step(_t(xt), th, port_p)
    assert max_diff(ro, to) < ATOL and max_diff(rh, th) < ATOL


# --- RWKV-6 ------------------------------------------------------------------

def _rwkv_params(seed, d=32, N=8, ff=48):
    rng = _rng(seed)
    tm = r_rwkv.init_rwkv_timemix(jax.random.PRNGKey(seed), d, N,
                                  jnp.float32)
    # move the constant inits (mixes, bonus, norm scale) off their values
    for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "ln_x"):
        tm[name] = jnp.asarray(rng.uniform(0.1, 0.9, d).astype(np.float32))
    tm["u_bonus"] = jnp.asarray(_f32(rng, d // N, N, scale=0.5))
    cm = r_rwkv.init_rwkv_channelmix(jax.random.PRNGKey(seed + 1), d, ff,
                                     jnp.float32)
    cm["mu_k"] = jnp.asarray(rng.uniform(0.1, 0.9, d).astype(np.float32))
    return (tm, cm,
            _load(t_rwkv.TimeMix(d, N, torch.float32, "cpu"), tm),
            _load(t_rwkv.ChannelMix(d, ff, torch.float32, "cpu"), cm))


def test_timemix_scan_and_step():
    r_tm, _, t_tm, _ = _rwkv_params(17)
    rng = _rng(18)
    x, x_prev = _f32(rng, 2, 10, 32), _f32(rng, 2, 32)
    ro, rS, rx = r_rwkv.timemix_scan(jnp.asarray(x), jnp.asarray(x_prev),
                                     r_tm, 8)
    to, tS, tx = t_rwkv.timemix_scan(_t(x), _t(x_prev), t_tm, 8)
    assert max_diff(ro, to) < ATOL and max_diff(rS, tS) < ATOL
    assert max_diff(rx, tx) == 0.0
    xt = _f32(rng, 2, 32)
    ro, (rS, rx) = r_rwkv.timemix_step(jnp.asarray(xt), (rS, rx), r_tm, 8)
    to, (tS, tx) = t_rwkv.timemix_step(_t(xt), (tS, tx), t_tm, 8)
    assert max_diff(ro, to) < ATOL and max_diff(rS, tS) < ATOL


def test_channelmix_and_step():
    _, r_cm, _, t_cm = _rwkv_params(19)
    rng = _rng(20)
    x, x_prev = _f32(rng, 2, 6, 32), _f32(rng, 2, 32)
    ro, rx = r_rwkv.channelmix(jnp.asarray(x), jnp.asarray(x_prev), r_cm)
    to, tx = t_rwkv.channelmix(_t(x), _t(x_prev), t_cm)
    assert max_diff(ro, to) < ATOL and max_diff(rx, tx) == 0.0
    ro, _ = r_rwkv.channelmix_step(jnp.asarray(x[:, 0]), jnp.asarray(x_prev),
                                   r_cm)
    to, tx = t_rwkv.channelmix_step(_t(x[:, 0]), _t(x_prev), t_cm)
    assert max_diff(ro, to) < ATOL and torch.equal(tx, _t(x[:, 0]))


# --- init scales -------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2-9b", "kimi-k2-1t-a32b",
                                  "recurrentgemma-9b", "rwkv6-7b",
                                  "whisper-small", "qwen2.5-3b"])
def test_init_params_scales_match_the_reference(arch):
    """Every parameter of the port's random init has the reference's shape
    and dtype; constant inits are equal, and random ones (1000 elements or
    more) have its standard deviation within 20% and mean near 0."""
    rcfg, tcfg = configs(arch)
    ref = params_from_reference(
        numpy_tree(ref_init_params(jax.random.PRNGKey(0), rcfg)), tcfg,
        "cpu").state_dict()
    port = init_params(torch.Generator().manual_seed(0), tcfg,
                       "cpu").state_dict()
    assert ref.keys() == port.keys()
    for name, a in ref.items():
        b = port[name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        a, b = a.double(), b.double()
        if float(a.std()) == 0.0 or name.endswith(".lam"):
            assert torch.allclose(a, b, atol=1e-6), name
        elif a.numel() >= 1000:
            assert abs(float(b.std()) / float(a.std()) - 1) < 0.2, name
            assert abs(float(b.mean())) < 0.2 * float(a.std()), name
