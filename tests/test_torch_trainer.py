"""Port training path (repro_torch: meshnet's training forward,
training.trainer) against the reference (repro.core.meshnet,
repro.training.trainer) on numpy-made params and batches.

Bounds, each stated where it is used:
- the training forward's logits and BatchNorm statistics: 1e-5 absolute,
  the reference's eval-forward bound (tests/test_torch_meshnet.py);
- a train step's loss, metrics and updated params: 1e-5 relative to each
  value's magnitude; the hard Dice, a float32 mean over the classes of
  terms from equal counts, summed in each framework's own order, within
  1e-6 (the reference's bound between its ops.dice and dice_score);
- the conv biases that feed a training-mode BatchNorm: their exact
  gradient is 0 and what each package computes is rounding noise (1e-8 to
  1e-6 against 0.03-0.05 for the weights), which Adam's normalisation
  turns into a step of about lr whose sign differs between packages. Their
  gradients are compared instead, at 1e-5 of the global gradient norm
  absolute; every step starts both packages from the reference's state, so
  that noise never feeds the next step. A config without BatchNorm
  compares every leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import meshnet as ref_meshnet
from repro.training import losses as ref_losses
from repro.training import trainer as ref_trainer
from repro_torch import bridge, tree
from repro_torch.core import meshnet
from repro_torch.data import mri
from repro_torch.training import trainer

ODD_SHAPE = (1, 10, 12, 14)
FORWARD_ATOL = 1e-5
STEP_REL = 1e-5
PRE_BN_BIAS_ATOL = 1e-5  # times the global gradient norm
DICE_TOL = 1e-6


def _np_params(cfg, seed):
    """MeshNet params made with numpy, with non-trivial biases and BN."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    layers, cin, c = [], cfg.in_channels, cfg.channels
    for _ in cfg.dilations:
        layer = {
            "w": (rng.standard_normal((3, 3, 3, cin, c)) * np.sqrt(2.0 / (27 * cin))).astype(f32),
            "b": (0.1 * rng.standard_normal(c)).astype(f32),
        }
        if cfg.use_batchnorm:
            layer["bn_scale"] = (1.0 + 0.2 * rng.standard_normal(c)).astype(f32)
            layer["bn_bias"] = (0.1 * rng.standard_normal(c)).astype(f32)
            layer["bn_mean"] = (0.3 * rng.standard_normal(c)).astype(f32)
            layer["bn_var"] = (0.5 + rng.random(c)).astype(f32)
        layers.append(layer)
        cin = c
    head = {
        "w": (rng.standard_normal((1, 1, 1, c, cfg.num_classes)) * np.sqrt(2.0 / c)).astype(f32),
        "b": (0.1 * rng.standard_normal(cfg.num_classes)).astype(f32),
    }
    return {"layers": layers, "head": head}


def _port_cfg(ref_cfg):
    fields = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(meshnet.MeshNetConfig)}
    return meshnet.MeshNetConfig(**fields)


def _batch(seed, shape, classes=3):
    rng = np.random.default_rng(seed)
    vol = rng.random(shape).astype(np.float32)
    lab = rng.integers(0, classes, size=shape).astype(np.int32)
    return vol, lab


# --- part 1: the training forward -------------------------------------------


@pytest.mark.parametrize("use_batchnorm", [True, False])
def test_apply_with_stats_matches_reference(use_batchnorm):
    ref_cfg = ref_meshnet.MeshNetConfig(dilations=(1, 2, 4), use_batchnorm=use_batchnorm)
    tree_np = _np_params(ref_cfg, seed=1)
    x = np.random.default_rng(2).standard_normal(ODD_SHAPE).astype(np.float32)
    expect, ref_stats = ref_meshnet.apply_with_stats(jax.tree.map(jnp.asarray, tree_np), jnp.asarray(x), ref_cfg)
    params = bridge.params_from_numpy(tree_np, "cpu")
    got, stats = meshnet.apply_with_stats(params, torch.from_numpy(x), _port_cfg(ref_cfg))
    assert got.shape == ODD_SHAPE + (3,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(expect), atol=FORWARD_ATOL)
    assert len(stats) == len(ref_stats) == 3
    for st, ref_st in zip(stats, ref_stats):
        if not use_batchnorm:
            assert st is None and ref_st is None
            continue
        for a, b in zip(st, ref_st):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=FORWARD_ATOL)
    same = meshnet.apply(params, torch.from_numpy(x), _port_cfg(ref_cfg), training=True)
    assert torch.equal(same, got)


def test_training_batchnorm_uses_the_biased_variance():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, 4, 5, 4)).astype(np.float32))
    layer = {"bn_scale": torch.ones(4), "bn_bias": torch.zeros(4), "bn_mean": torch.zeros(4), "bn_var": torch.ones(4)}
    y, mean, var = meshnet.batchnorm(x, layer, training=True)
    flat = x.reshape(-1, 4).double()
    torch.testing.assert_close(var.double(), flat.var(dim=0, unbiased=False), rtol=1e-6, atol=0)
    torch.testing.assert_close(mean.double(), flat.mean(dim=0), rtol=0, atol=1e-7)
    assert float(y.reshape(-1, 4).var(dim=0, unbiased=False).max()) == pytest.approx(1.0, abs=1e-4)


def test_dropout3d_drops_whole_channels_per_sample():
    """Dropout3d's mask is per (sample, channel), and kept values are
    scaled by 1/keep. (The masks come from a torch.Generator, so they are
    not compared with the reference's bits.)"""
    x = torch.rand((4, 5, 6, 7, 8), generator=torch.Generator().manual_seed(4)) + 0.5
    rate = 0.5
    y = meshnet.dropout3d(x, rate, torch.Generator().manual_seed(5))
    ratio = y / x
    per_channel = ratio.reshape(4, -1, 8)
    assert torch.all(per_channel == per_channel[:, :1, :])  # one value per (sample, channel)
    values = set(per_channel[:, 0, :].reshape(-1).tolist())
    assert values <= {0.0, 1.0 / (1.0 - rate)} and len(values) == 2
    again = meshnet.dropout3d(x, rate, torch.Generator().manual_seed(5))
    assert torch.equal(y, again)
    # in a training forward with a generator the rate applies; without one it does not
    cfg = meshnet.MeshNetConfig(dilations=(1, 2), dropout_rate=0.5)
    params = bridge.params_from_numpy(_np_params(cfg, seed=6), "cpu")
    vol = torch.rand((2, 6, 6, 6), generator=torch.Generator().manual_seed(7))
    plain = meshnet.apply_with_stats(params, vol, dataclasses.replace(cfg, dropout_rate=0.0))[0]
    assert torch.equal(meshnet.apply_with_stats(params, vol, cfg)[0], plain)
    dropped = meshnet.apply_with_stats(params, vol, cfg, generator=torch.Generator().manual_seed(8))[0]
    assert not torch.equal(dropped, plain)


# --- part 2: train steps against the reference -------------------------------


def _configs(use_batchnorm):
    ref_model = ref_meshnet.MeshNetConfig(dilations=(1, 2, 4), use_batchnorm=use_batchnorm)
    ref_cfg = ref_trainer.TrainConfig(model=ref_model)
    return ref_cfg, trainer.TrainConfig(model=_port_cfg(ref_model))


def _pre_bn_bias(path, use_batchnorm):
    return use_batchnorm and len(path) == 3 and path[0] == "layers" and path[2] == "b"


def _paths(tree_np):
    """Key paths of a params tree, in the order of jax.tree.leaves."""
    paths = []

    def visit(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                visit(prefix + (k,), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                visit(prefix + (i,), v)
        else:
            paths.append(prefix)

    visit((), tree_np)
    return paths


def _rel_close(got, expect, rel=STEP_REL):
    got, expect = np.asarray(got, np.float64), np.asarray(expect, np.float64)
    scale = max(float(np.abs(expect).max()), 1e-30)
    return float(np.abs(got - expect).max()) <= rel * scale


@pytest.mark.parametrize("use_batchnorm", [True, False])
def test_three_train_steps_match_reference(use_batchnorm):
    ref_cfg, cfg = _configs(use_batchnorm)
    ref_step = ref_trainer.make_train_step(ref_cfg)
    step = trainer.make_train_step(cfg)
    ref_params = jax.tree.map(jnp.asarray, _np_params(ref_cfg.model, seed=10))
    ref_state = ref_trainer.opt_mod.adamw_init(ref_params, ref_cfg.opt)
    paths = _paths(ref_params)

    def ref_loss(p, vol, lab):
        logits, _ = ref_meshnet.apply_with_stats(p, vol, ref_cfg.model)
        return ref_losses.segmentation_loss(logits, lab, 3, ref_cfg.dice_weight)[0]

    for i in range(3):
        vol, lab = _batch(20 + i, (2, 9, 10, 11))
        params = bridge.params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
        state = bridge.params_from_numpy(jax.tree.map(np.asarray, ref_state), "cpu")
        vol_t, lab_t = torch.from_numpy(vol), torch.from_numpy(lab)

        # gradients: every leaf within 1e-5 relative, the pre-BN biases at
        # 1e-5 of the global norm absolute (and both near zero)
        _, _, _, grads = trainer.loss_and_grads(params, vol_t, lab_t, cfg)
        ref_grads = jax.grad(ref_loss)(ref_params, jnp.asarray(vol), jnp.asarray(lab))
        gnorm = float(trainer.opt_mod.global_norm(grads))
        for path, g, e in zip(paths, tree.leaves(grads), jax.tree.leaves(ref_grads)):
            if _pre_bn_bias(path, use_batchnorm):
                assert float(np.abs(g.numpy() - np.asarray(e)).max()) <= PRE_BN_BIAS_ATOL * gnorm, path
                assert float(np.abs(np.asarray(e)).max()) <= PRE_BN_BIAS_ATOL * gnorm, path
            else:
                assert _rel_close(g.numpy(), e), (i, path)

        new_params, new_state, metrics = step(params, state, vol_t, lab_t)
        ref_params, ref_state, ref_metrics = ref_step(ref_params, ref_state, jnp.asarray(vol),
                                                      jnp.asarray(lab), jax.random.PRNGKey(i))
        assert set(metrics) == set(ref_metrics)
        for k in ("loss", "ce", "soft_dice_loss", "grad_norm", "lr"):
            assert _rel_close(metrics[k], ref_metrics[k]), (i, k)
        assert abs(float(metrics["dice"]) - float(ref_metrics["dice"])) < DICE_TOL
        assert int(new_state.step) == int(ref_state.step) == i + 1
        for name, got_tree, ref_tree in (("params", new_params, ref_params), ("mu", new_state.mu, ref_state.mu),
                                         ("nu", new_state.nu, ref_state.nu)):
            for path, g, e in zip(paths, tree.leaves(got_tree), jax.tree.leaves(ref_tree)):
                if not _pre_bn_bias(path, use_batchnorm):
                    assert _rel_close(g.numpy(), e), (i, name, path)
        if use_batchnorm:  # weight decay moved the running stats before the fold, as in the reference
            assert not torch.equal(new_params["layers"][0]["bn_mean"], params["layers"][0]["bn_mean"])


def test_evaluate_scores_auto_predictions_with_dice():
    cfg = trainer.TrainConfig(
        model=meshnet.MeshNetConfig(dilations=(1, 2)),
        data=mri.DataLoaderConfig(mri=mri.SyntheticMRIConfig(shape=(12, 12, 12))),
        eval_subjects=2,
    )
    params = bridge.params_from_numpy(_np_params(cfg.model, seed=30), "cpu")
    got = trainer.evaluate(params, cfg, seed=3)
    gen = torch.Generator().manual_seed(3)
    dices = []
    for _ in range(2):
        vol, lab = mri.generate(gen, cfg.data.mri, device="cpu")
        pred = meshnet.predict(params, vol[None], cfg.model)[0]
        counts = [((pred == c) & (lab == c)).sum() for c in range(3)], [(pred == c).sum() + (lab == c).sum() for c in range(3)]
        per = [1.0 if int(d) == 0 else 2.0 * float(i) / (float(d) + 1e-7) for i, d in zip(*counts)]
        dices.append(sum(per) / 3)
    assert got == pytest.approx(sum(dices) / 2, abs=1e-6)


# --- part 3: the port learns ------------------------------------------------


def test_port_trainer_learns_synthetic_gwm():
    """The reference's integration bars (tests/test_system.py,
    TestTrainingIntegration): 60 CPU steps at 24^3, batch 2, seed 1."""
    cfg = trainer.TrainConfig(
        model=meshnet.MeshNetConfig(channels=5, dropout_rate=0.0),
        data=mri.DataLoaderConfig(mri=mri.SyntheticMRIConfig(shape=(24, 24, 24)), batch_size=2),
        steps=60,
        eval_subjects=2,
        log_every=1000,
        seed=1,
    )
    res = trainer.train(cfg, verbose=False, device="cpu")
    assert res.final_dice > 0.5, res.final_dice
    first_dice = res.history[0]["dice"]
    assert res.final_dice > first_dice + 0.25, (first_dice, res.final_dice)
    assert int(res.opt_state.step) == 60


def test_train_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.train(trainer.TrainConfig(steps=1), verbose=False)
