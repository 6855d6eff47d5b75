"""The port's dense LM against the reference's on the CPU, at smoke size
in fp32 with the reference's params bridged as numpy: ``forward`` and a
10-step ``decode_step`` loop within 1e-5 of the reference's, the port's
decode against its own forward within 1e-3 (the reference's invariant,
tests/test_models.py), a sliding-window ring cache, the params and cache
trees, and the families this slice does not run."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import model as RM
from repro_torch import bridge, configs, tree
from repro_torch.models import model as MD

TOL = 1e-5
DECODE_VS_FORWARD = 1e-3  # tests/test_models.py:84


def _setup(arch, **overrides):
    ref_cfg = dataclasses.replace(ref_configs.get_smoke(arch), dtype=jnp.float32, **overrides)
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32, **overrides)
    params = RM.init(jax.random.PRNGKey(0), ref_cfg)
    ported = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return ref_cfg, cfg, params, ported


def _tokens(cfg, B, T, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen1.5-32b", "qwen3-14b", "gemma-7b"])
def test_forward_matches_reference(arch):
    ref_cfg, cfg, params, ported = _setup(arch)
    toks = _tokens(cfg, 2, 12)
    expect, _ = RM.forward(params, {"tokens": jnp.asarray(toks)}, ref_cfg)
    got, aux = MD.forward(ported, {"tokens": torch.tensor(toks, dtype=torch.int64)}, cfg)
    assert got.shape == (2, 12, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=0, atol=TOL)


def test_logit_softcap_matches_reference():
    ref_cfg, cfg, params, ported = _setup("tinyllama-1.1b", logit_softcap=0.5)
    toks = _tokens(cfg, 1, 6)
    expect, _ = RM.forward(params, {"tokens": jnp.asarray(toks)}, ref_cfg)
    got, _ = MD.forward(ported, {"tokens": torch.tensor(toks, dtype=torch.int64)}, cfg)
    assert float(got.abs().max()) <= 0.5
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=0, atol=TOL)


@pytest.mark.parametrize(
    "arch,overrides,max_seq",
    [("tinyllama-1.1b", {}, 10), ("gemma-7b", {}, 10), ("tinyllama-1.1b", {"sliding_window": 4}, 10)],
)
def test_decode_loop_matches_reference_and_forward(arch, overrides, max_seq):
    """10 decode steps (B = 2) give the reference's logits and cache; with
    a 4-slot ring cache the steps past slot 3 overwrite the oldest slot."""
    ref_cfg, cfg, params, ported = _setup(arch, **overrides)
    B, T = 2, 10
    toks = _tokens(cfg, B, T, seed=1)
    ref_cache = RM.init_cache(ref_cfg, B, max_seq)
    cache = MD.init_cache(cfg, B, max_seq, device="cpu")
    assert [tuple(c["k"].shape) for c in cache] == [c["k"].shape for c in ref_cache]
    steps = []
    for t in range(T):
        expect, ref_cache = RM.decode_step(params, jnp.asarray(toks[:, t : t + 1]), ref_cache,
                                           jnp.asarray(t, jnp.int32), ref_cfg)
        got, same = MD.decode_step(ported, torch.tensor(toks[:, t : t + 1], dtype=torch.int64), cache, t, cfg)
        assert same is cache and got.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=0, atol=TOL)
        steps.append(got[:, 0])
    for ref_leaf, leaf in zip(jax.tree.leaves(ref_cache), tree.leaves(cache)):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(ref_leaf), rtol=0, atol=TOL)
    # the forward masks the same window the ring cache holds
    full, _ = MD.forward(ported, {"tokens": torch.tensor(toks, dtype=torch.int64)}, cfg)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), rtol=0, atol=DECODE_VS_FORWARD)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma-7b", "qwen1.5-32b"])
def test_init_matches_the_reference_tree(arch):
    """Keys, shapes and dtypes (bf16 by default) of the whole params tree,
    blocks stacked over repeats; the cache likewise."""
    cfg = configs.get_smoke(arch)
    ref = jax.eval_shape(lambda k: RM.init(k, ref_configs.get_smoke(arch)), jax.random.PRNGKey(0))
    port = MD.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(port["blocks"], tuple)
    ref_leaves = jax.tree.leaves_with_path(ref)
    port_leaves = list(tree.leaves_with_paths(port))
    assert len(ref_leaves) == len(port_leaves)
    for (rpath, rleaf), (path, leaf) in zip(ref_leaves, port_leaves):
        assert tuple(leaf.shape) == rleaf.shape and leaf.dtype == torch.bfloat16, (rpath, path)
    assert float(port["embed"].float().std()) == pytest.approx(0.02, rel=0.05)
    ref_cache = jax.eval_shape(lambda: RM.init_cache(ref_configs.get_smoke(arch), 3, 16))
    cache = MD.init_cache(cfg, 3, 16, device="cpu")
    assert [tuple(a.shape) for a in tree.leaves(cache)] == [a.shape for a in jax.tree.leaves(ref_cache)]
    assert all(a.dtype == torch.bfloat16 and not a.any() for a in tree.leaves(cache))


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "whisper-small", "kimi-k2-1t-a32b", "internvl2-2b",
                                  "rwkv6-3b", "grok-1-314b"])
def test_unported_families_raise(arch):
    cfg = configs.get_smoke(arch)
    with pytest.raises(ValueError, match="item 18"):
        MD.init(cfg, device="cpu")
    with pytest.raises(ValueError, match="item 18"):
        MD.init_cache(cfg, 1, 8, device="cpu")


def test_int8_cache_raises():
    with pytest.raises(ValueError, match="int8 KV cache"):
        MD.init_cache(dataclasses.replace(configs.get_smoke("tinyllama-1.1b"), kv_quant=True), 1, 8, device="cpu")
