"""Port optimizers (repro_torch.training.optimizer) against
repro.training.optimizer: the same numpy-made params tree and gradients
through both, states carried step to step in each package. Every leaf,
moment and metric agrees within 1e-6 relative to the leaf's magnitude
(float32 elementwise arithmetic, with pow and sqrt from two libraries)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optimizer as ref_opt
from repro_torch import bridge, tree
from repro_torch.training import optimizer as opt

REL_TOL = 1e-6


def _tree(seed, scale=1.0):
    """A MeshNet-like tree with a tuple node and a list of dicts."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {
        "layers": [{"w": a(3, 3, 3, 1, 4), "b": a(4)}, {"w": a(3, 3, 3, 4, 4), "b": a(4), "bn_mean": a(4)}],
        "head": {"w": a(1, 1, 1, 4, 3), "b": a(3)},
        "pair": (a(2, 5), a(7)),
    }


def _close_trees(got, expect, rel=REL_TOL):
    got_leaves = [np.asarray(t) for t in tree.leaves(bridge.params_to_numpy(got))]
    exp_leaves = [np.asarray(x) for x in jax.tree.leaves(expect)]
    assert len(got_leaves) == len(exp_leaves)
    for g, e in zip(got_leaves, exp_leaves):
        assert g.shape == e.shape and g.dtype == e.dtype
        scale = max(float(np.abs(e).max()), 1e-30)
        assert float(np.abs(g.astype(np.float64) - e).max()) <= rel * scale


def test_global_norm_and_clip():
    grads = _tree(1)
    got = opt.global_norm(bridge.params_from_numpy(grads, "cpu"))
    expect = ref_opt.global_norm(jax.tree.map(jnp.asarray, grads))
    assert abs(float(got) - float(expect)) <= REL_TOL * float(expect)
    clipped, norm = opt.clip_by_global_norm(bridge.params_from_numpy(grads, "cpu"), 1.0)
    ref_clipped, _ = ref_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 1.0)
    _close_trees(clipped, ref_clipped)
    assert abs(float(opt.global_norm(clipped)) - 1.0) < 1e-6 and float(norm) > 1.0


@pytest.mark.parametrize("schedule", ["warmup_cosine", "none"])
def test_five_adamw_steps_match_reference(schedule):
    sched = opt.warmup_cosine(2, 5) if schedule == "warmup_cosine" else None
    ref_sched = ref_opt.warmup_cosine(2, 5) if schedule == "warmup_cosine" else None
    cfg = opt.AdamWConfig(lr=3e-2, weight_decay=0.05, grad_clip_norm=1.0, schedule=sched)
    ref_cfg = ref_opt.AdamWConfig(lr=3e-2, weight_decay=0.05, grad_clip_norm=1.0, schedule=ref_sched)
    params_np = _tree(2)
    params, ref_params = bridge.params_from_numpy(params_np, "cpu"), jax.tree.map(jnp.asarray, params_np)
    state, ref_state = opt.adamw_init(params, cfg), ref_opt.adamw_init(ref_params, ref_cfg)
    assert state.step.dtype == torch.int32 and state.step.shape == ()
    for step in range(5):
        grads_np = _tree(10 + step, scale=0.7)  # global norm well above 1: clipping is active
        params, state, metrics = opt.adamw_update(bridge.params_from_numpy(grads_np, "cpu"), state, params, cfg)
        ref_params, ref_state, ref_metrics = ref_opt.adamw_update(
            jax.tree.map(jnp.asarray, grads_np), ref_state, ref_params, ref_cfg
        )
        assert float(metrics["grad_norm"]) > 1.0
        for k in ("grad_norm", "lr"):
            assert abs(float(metrics[k]) - float(ref_metrics[k])) <= REL_TOL * abs(float(ref_metrics[k]))
        _close_trees(params, ref_params)
        _close_trees(state.mu, ref_state.mu)
        _close_trees(state.nu, ref_state.nu)
        assert int(state.step) == int(ref_state.step) == step + 1


def test_sgd_steps_match_reference():
    cfg = opt.SGDConfig(lr=0.05, momentum=0.9, weight_decay=0.01, schedule=opt.constant())
    ref_cfg = ref_opt.SGDConfig(lr=0.05, momentum=0.9, weight_decay=0.01, schedule=ref_opt.constant())
    params_np = _tree(4)
    params, ref_params = bridge.params_from_numpy(params_np, "cpu"), jax.tree.map(jnp.asarray, params_np)
    state, ref_state = opt.sgd_init(params, cfg), ref_opt.sgd_init(ref_params, ref_cfg)
    for step in range(3):
        grads_np = _tree(20 + step)
        params, state, metrics = opt.sgd_update(bridge.params_from_numpy(grads_np, "cpu"), state, params, cfg)
        ref_params, ref_state, _ = ref_opt.sgd_update(jax.tree.map(jnp.asarray, grads_np), ref_state, ref_params, ref_cfg)
        _close_trees(params, ref_params)
        _close_trees(state.velocity, ref_state.velocity)
    assert float(metrics["lr"]) == pytest.approx(0.05)


def test_warmup_cosine_matches_reference():
    sched, ref_sched = opt.warmup_cosine(10, 100, 0.2), ref_opt.warmup_cosine(10, 100, 0.2)
    steps = np.arange(0, 130, 7, dtype=np.int32)
    got = sched(torch.from_numpy(steps)).numpy()
    expect = np.asarray(ref_sched(jnp.asarray(steps)))
    np.testing.assert_allclose(got, expect, rtol=REL_TOL, atol=1e-7)
