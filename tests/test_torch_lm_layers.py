"""The port's dense transformer layers against the reference's on the CPU:
norms, RoPE, sdpa, full-sequence attention, cached decode attention (plain,
a full cache, a sliding-window ring buffer) and the MLPs, on the same
inputs made with numpy and the reference's params bridged as numpy, fp32,
within 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as RL
from repro_torch import bridge, configs
from repro_torch.models import layers as L
from repro_torch.kernels import decode_attention as k4

TOL = 1e-5


def _cfgs(arch, **overrides):
    ref = dataclasses.replace(ref_configs.get_smoke(arch), dtype=jnp.float32, **overrides)
    port = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32, **overrides)
    return ref, port


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(port: torch.Tensor, ref, tol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=tol)


def _params(init, cfg, seed=0):
    """Reference params as numpy, and the same bridged to the port."""
    npp = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg))
    return npp, bridge.params_from_numpy(npp, "cpu")


def test_rmsnorm_and_layernorm():
    rng = np.random.default_rng(0)
    x = _rand(rng, (2, 5, 64), 3.0)
    p_rms = {"scale": 1.0 + _rand(rng, (64,), 0.1)}
    p_ln = {"scale": 1.0 + _rand(rng, (64,), 0.1), "bias": _rand(rng, (64,), 0.1)}
    for p in (p_rms, p_ln):
        got = L.apply_norm(bridge.params_from_numpy(p, "cpu"), torch.tensor(x), 1e-6)
        _close(got, RL.apply_norm(p, jnp.asarray(x), 1e-6))


@pytest.mark.parametrize("positions_ndim", [1, 2])
def test_rope(positions_ndim):
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 7, 4, 32))
    pos = np.arange(3, 10) if positions_ndim == 1 else rng.integers(0, 500, (2, 7))
    got = L.apply_rope(torch.tensor(x), torch.tensor(pos), 10_000.0)
    _close(got, RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))


@pytest.mark.parametrize("causal,window,q_offset", [(True, None, 0), (True, 3, 0), (False, None, 0), (True, None, 4)])
def test_sdpa(causal, window, q_offset):
    rng = np.random.default_rng(2)
    q, k, v = (_rand(rng, (2, t, 4, 16)) for t in (6, 10, 10))
    got = L.sdpa(torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal,
                 sliding_window=window, q_offset=q_offset)
    ref = RL.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                  sliding_window=window, q_offset=q_offset)
    _close(got, ref)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen1.5-32b", "qwen3-14b", "gemma-7b"])
def test_attention(arch):
    ref_cfg, cfg = _cfgs(arch)
    npp, p = _params(RL.init_attention, ref_cfg)
    if ref_cfg.qkv_bias:  # non-zero biases, so they are tested
        rng = np.random.default_rng(3)
        for name in ("bq", "bk", "bv"):
            npp[name] = _rand(rng, npp[name].shape, 0.1)
        p = bridge.params_from_numpy(npp, "cpu")
    x = _rand(np.random.default_rng(4), (2, 9, cfg.d_model))
    pos = np.arange(9)
    got = L.attention(p, torch.tensor(x), cfg, torch.tensor(pos))
    _close(got, RL.attention(npp, jnp.asarray(x), ref_cfg, jnp.asarray(pos)))


def test_attention_refuses_long_sequences():
    _, cfg = _cfgs("tinyllama-1.1b")
    p = L.init_attention(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.zeros((1, L.BLOCKWISE_THRESHOLD + 1, cfg.d_model))
    with pytest.raises(ValueError, match="flash.py"):
        L.attention(p, x, cfg, torch.arange(x.shape[1]))


@pytest.mark.parametrize(
    "case,S,window,positions",
    [
        ("plain", 12, None, [0, 1, 5]),
        ("full cache", 6, None, [5]),  # the last slot: every slot valid
        ("ring buffer", 4, 4, [2, 3, 4, 9]),  # pos >= S overwrites slot pos % S
    ],
)
def test_attention_decode(case, S, window, positions):
    ref_cfg, cfg = _cfgs("tinyllama-1.1b", sliding_window=window)
    npp, p = _params(RL.init_attention, ref_cfg)
    rng = np.random.default_rng(5)
    B, KV, hd = 2, cfg.num_kv_heads, cfg.resolved_head_dim
    ck, cv = _rand(rng, (B, S, KV, hd)), _rand(rng, (B, S, KV, hd))
    tk, tv = torch.tensor(ck), torch.tensor(cv)
    before = k4.launches
    for pos in positions:
        x = _rand(rng, (B, 1, cfg.d_model))
        out, ck, cv = RL.attention_decode(npp, jnp.asarray(x), ref_cfg, jnp.asarray(ck), jnp.asarray(cv),
                                          jnp.asarray(pos, jnp.int32))
        got, tk2, tv2 = L.attention_decode(p, torch.tensor(x), cfg, tk, tv, pos)
        assert tk2 is tk and tv2 is tv  # written in place
        _close(got, out)
        _close(tk, ck)  # the new K went through RoPE: rounding, not bits
        np.testing.assert_array_equal(tv.numpy(), np.asarray(cv))
    assert k4.launches == before  # the CPU takes K4's plain version


def test_attention_decode_refuses_the_int8_cache():
    _, cfg = _cfgs("tinyllama-1.1b", kv_quant=True)
    p = L.init_attention(torch.Generator().manual_seed(0), cfg, "cpu")
    c = torch.zeros((1, 4, cfg.num_kv_heads, cfg.resolved_head_dim))
    with pytest.raises(ValueError, match="kv_quant"):
        L.attention_decode(p, torch.zeros((1, 1, cfg.d_model)), cfg, c, c.clone(), 0)


@pytest.mark.parametrize("arch,kind", [("tinyllama-1.1b", "swiglu"), ("gemma-7b", "geglu"), ("whisper-small", "gelu")])
def test_mlp(arch, kind):
    ref_cfg, cfg = _cfgs(arch)
    assert cfg.mlp == kind
    npp, p = _params(RL.init_mlp, ref_cfg)
    if "b_up" in npp:  # non-zero biases, so they are tested
        rng = np.random.default_rng(6)
        npp = dict(npp, b_up=_rand(rng, npp["b_up"].shape, 0.1), b_down=_rand(rng, npp["b_down"].shape, 0.1))
        p = bridge.params_from_numpy(npp, "cpu")
    x = _rand(np.random.default_rng(7), (2, 5, cfg.d_model))
    _close(L.mlp(p, torch.tensor(x), cfg), RL.mlp(npp, jnp.asarray(x), ref_cfg))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen1.5-32b", "qwen3-14b", "whisper-small"])
def test_init_matches_the_reference_tree(arch):
    """init_attention and init_mlp give the reference's keys, shapes and
    dtypes (bf16, the config's default), and its init scales."""
    for ref_init, init in ((RL.init_attention, L.init_attention), (RL.init_mlp, L.init_mlp)):
        ref = jax.eval_shape(lambda k: ref_init(k, ref_configs.get_smoke(arch)), jax.random.PRNGKey(0))
        port = init(torch.Generator().manual_seed(0), configs.get_smoke(arch), device="cpu")
        assert sorted(port) == sorted(ref)
        for name, leaf in port.items():
            leaf = leaf["scale"] if isinstance(leaf, dict) else leaf
            expect = ref[name]["scale"] if isinstance(ref[name], dict) else ref[name]
            assert tuple(leaf.shape) == expect.shape and leaf.dtype == torch.bfloat16
    w = L.init_mlp(torch.Generator().manual_seed(0), configs.get("tinyllama-1.1b", num_layers=1), device="cpu")["w_down"]
    assert abs(float(w.float().std()) - 1 / np.sqrt(w.shape[0])) < 1e-3
