"""Port checkpoints (repro_torch.training.checkpoint) in the reference's
on-disk format: the port's own round trip is bit-equal (params and an
AdamWState), a checkpoint the reference wrote restores in the port, and
one the port wrote restores in the reference, equal leaf for leaf, dtypes
and NamedTuple types included."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.training import checkpoint as ref_ckpt
from repro.training import optimizer as ref_opt
from repro_torch import bridge, tree
from repro_torch.core import meshnet
from repro_torch.data import mri
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training import trainer


def _np_state(seed):
    """{"params": MeshNet-like tree, "opt_state": AdamWState} of numpy arrays."""
    rng = np.random.default_rng(seed)
    params = {
        "layers": [
            {"w": rng.standard_normal((3, 3, 3, 1, 4)).astype(np.float32), "b": rng.standard_normal(4).astype(np.float32),
             "bn_mean": rng.standard_normal(4).astype(np.float32)},
            {"w": rng.standard_normal((3, 3, 3, 4, 4)).astype(np.float32), "b": rng.standard_normal(4).astype(np.float32)},
        ],
        "head": {"w": rng.standard_normal((1, 1, 1, 4, 3)).astype(np.float32), "b": rng.standard_normal(3).astype(np.float32)},
    }
    moments = jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), params)
    return params, moments


def _equal_leaves(a_leaves, b_leaves):
    assert len(a_leaves) == len(b_leaves)
    for a, b in zip(a_leaves, b_leaves):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def test_port_round_trip_is_bit_equal(tmp_path):
    params_np, moments = _np_state(0)
    params = bridge.params_from_numpy(params_np, "cpu")
    state = opt.AdamWState(step=torch.tensor(7, dtype=torch.int32),
                           mu=bridge.params_from_numpy(moments, "cpu"), nu=bridge.params_from_numpy(moments, "cpu"))
    ckpt.save(str(tmp_path / "step_000007"), {"params": params, "opt_state": state}, step=7, metadata={"run": "t"})
    restored, manifest = ckpt.restore(str(tmp_path / "step_000007"), device="cpu")
    assert manifest["step"] == 7 and manifest["metadata"] == {"run": "t"} and manifest["num_shards"] == 1
    assert set(manifest) >= {"index", "spec", "num_shards"}
    assert type(restored["opt_state"]) is opt.AdamWState
    assert restored["opt_state"].step.dtype == torch.int32 and restored["opt_state"].step.shape == ()
    _equal_leaves([t.numpy() for t in tree.leaves(restored)], [t.numpy() for t in tree.leaves({"params": params, "opt_state": state})])


def test_shards_split_and_keys_in_the_reference_format(tmp_path):
    params_np, _ = _np_state(1)
    ckpt.save(str(tmp_path), bridge.params_from_numpy(params_np, "cpu"), shard_bytes=600)
    with open(tmp_path / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["num_shards"] > 1 and "layers/0/w" in manifest["index"]
    with np.load(tmp_path / manifest["index"]["layers/0/w"]) as z:
        assert "layers|0|w" in z.files
    restored, _ = ckpt.restore(str(tmp_path), device="cpu")
    _equal_leaves(jax.tree.leaves(bridge.params_to_numpy(restored)), jax.tree.leaves(params_np))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    params_np, moments = _np_state(2)
    ref_tree = {
        "params": jax.tree.map(jnp.asarray, params_np),
        "opt_state": ref_opt.AdamWState(step=jnp.asarray(3, jnp.int32), mu=jax.tree.map(jnp.asarray, moments),
                                        nu=jax.tree.map(lambda a: jnp.asarray(a * 2), moments)),
    }
    ref_ckpt.save(str(tmp_path), ref_tree, step=3)
    restored, manifest = ckpt.restore(str(tmp_path), device="cpu")
    assert manifest["step"] == 3 and type(restored["opt_state"]) is opt.AdamWState
    _equal_leaves([t.numpy() for t in tree.leaves(restored)], jax.tree.leaves(jax.tree.map(np.asarray, ref_tree)))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    params_np, moments = _np_state(3)
    port_tree = {
        "params": bridge.params_from_numpy(params_np, "cpu"),
        "opt_state": opt.AdamWState(step=torch.tensor(5, dtype=torch.int32), mu=bridge.params_from_numpy(moments, "cpu"),
                                    nu=bridge.params_from_numpy(moments, "cpu")),
    }
    ckpt.save(str(tmp_path), port_tree, step=5)
    restored, manifest = ref_ckpt.restore(str(tmp_path))
    assert manifest["step"] == 5 and type(restored["opt_state"]) is ref_opt.AdamWState
    _equal_leaves(jax.tree.leaves(jax.tree.map(np.asarray, restored)), [t.numpy() for t in tree.leaves(port_tree)])


def test_trainer_checkpoints_and_latest_step_dir(tmp_path):
    cfg = trainer.TrainConfig(
        model=meshnet.MeshNetConfig(dilations=(1, 2)),
        data=mri.DataLoaderConfig(mri=mri.SyntheticMRIConfig(shape=(10, 10, 10)), batch_size=1),
        steps=4, ckpt_dir=str(tmp_path), ckpt_every=2, eval_subjects=1, log_every=1000,
    )
    res = trainer.train(cfg, verbose=False, device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["step_000002", "step_000004"]
    latest = ckpt.latest_step_dir(str(tmp_path))
    assert latest == os.path.join(str(tmp_path), "step_000004")
    restored, manifest = ckpt.restore(latest, device="cpu")
    assert manifest["step"] == 4 and int(restored["opt_state"].step) == 4
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(restored["params"]), tree.leaves(res.params)))
    assert ckpt.latest_step_dir(str(tmp_path / "absent")) is None
