"""The port's U-Net baseline (core/unet3d.py) against the reference's
(repro/core/unet3d.py), at ``UNet3DConfig(base_channels=4, levels=2)`` on
16^3 volumes (16 is a multiple of 2^levels; the ODD_SHAPE is not):

  * params in the reference's ``init`` tree, bridged
    (``bridge.unet3d_from_numpy``), through the reference's ``apply`` and
    the port's on the same numpy volume: logits within 1e-4 of the
    largest logit, ``predict`` equal wherever the top two logits are more
    than 1e-4 apart. The tree's paths and shapes come from
    ``jax.eval_shape`` of the reference's ``init`` and its values from
    numpy (He-scaled, biases too), because drawing the reference's own
    costs tens of seconds of compilation on the CPU;
  * the up-conv alone (the reference's ``conv_transpose`` with a DHWIO
    kernel against the port's flipped ``F.conv_transpose3d``) on a kernel
    that is not symmetric;
  * ``param_count`` and the tree's paths and shapes equal the reference's,
    and the tree round-trips through the bridge bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import unet3d as ref_unet3d
from repro_torch import bridge, tree
from repro_torch.core import unet3d

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and with a test worker on every core, more threads only contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CFG = unet3d.UNet3DConfig(base_channels=4, levels=2)
REL_TOL = 1e-4  # the megakernel logits' bound (tests/test_megakernel.py)


def ref_cfg(cfg):
    return ref_unet3d.UNet3DConfig(in_channels=cfg.in_channels, num_classes=cfg.num_classes,
                                   base_channels=cfg.base_channels, levels=cfg.levels)


def ref_shapes(cfg):
    """The reference's init tree of ``jax.ShapeDtypeStruct`` leaves."""
    return jax.eval_shape(lambda: ref_unet3d.init(jax.random.PRNGKey(0), ref_cfg(cfg)))


def ref_params(cfg, seed=0):
    """The reference's init tree filled by numpy from ``seed``: He-scaled
    normal weights and small normal biases, float32."""
    rng = np.random.default_rng(seed)

    def draw(leaf):
        shape = tuple(leaf.shape)
        scale = 0.1 if len(shape) == 1 else np.sqrt(2.0 / np.prod(shape[:-1]))
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return jax.tree.map(draw, ref_shapes(cfg))


def volume(shape, channels=None, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape + ((channels,) if channels else ()), dtype=np.float32)


@pytest.mark.parametrize(
    "cfg,shape",
    [(CFG, (1, 16, 16, 16)), (CFG, (2, 16, 8, 16)),
     (unet3d.UNet3DConfig(in_channels=2, num_classes=5, base_channels=3, levels=3), (1, 16, 16, 8))],
)
def test_apply_and_predict_equal_the_references(cfg, shape):
    p = ref_params(cfg)
    x = volume(shape, channels=cfg.in_channels if cfg.in_channels > 1 else None)
    expect = np.asarray(ref_unet3d.apply(p, x, ref_cfg(cfg)))
    got = unet3d.apply(bridge.unet3d_from_numpy(p, cfg, "cpu"), torch.from_numpy(x), cfg).numpy()
    assert got.shape == expect.shape == shape[:4] + (cfg.num_classes,)
    top = float(np.abs(expect).max())
    assert float(np.abs(got - expect).max()) <= REL_TOL * top
    top2 = np.sort(expect, axis=-1)
    clear = (top2[..., -1] - top2[..., -2]) > 1e-4
    labels = unet3d.predict(bridge.unet3d_from_numpy(p, cfg, "cpu"), torch.from_numpy(x), cfg).numpy()
    ref_labels = np.asarray(ref_unet3d.predict(p, x, ref_cfg(cfg)))
    assert labels.dtype == np.int32 and clear.mean() > 0.9
    assert np.array_equal(labels[clear], ref_labels[clear])


def test_upconv_matches_the_references_conv_transpose():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 3, 4, 5, 6), dtype=np.float32)
    w = rng.standard_normal((2, 2, 2, 6, 4), dtype=np.float32)
    b = rng.standard_normal((4,), dtype=np.float32)
    expect = np.asarray(ref_unet3d._upconv(x, w, b))
    got = unet3d._upconv(torch.from_numpy(x).permute(0, 4, 1, 2, 3), torch.from_numpy(w), torch.from_numpy(b))
    got = got.permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == expect.shape == (1, 6, 8, 10, 4)
    assert np.abs(got - expect).max() <= 1e-5 * np.abs(expect).max()
    # the flip is what makes them agree: unflipped, they differ
    plain = torch.nn.functional.conv_transpose3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3),
                                                 torch.from_numpy(w).permute(3, 4, 0, 1, 2), torch.from_numpy(b),
                                                 stride=2).permute(0, 2, 3, 4, 1).numpy()
    assert np.abs(plain - expect).max() > 1e-2


@pytest.mark.parametrize(
    "cfg", [unet3d.UNet3DConfig(), CFG, unet3d.UNet3DConfig(base_channels=8, levels=2),
            unet3d.UNet3DConfig(in_channels=2, num_classes=5, base_channels=3, levels=4)],
)
def test_param_count_and_tree_equal_the_references(cfg):
    """``param_count`` by the reference's definition (its ``init`` tree's
    leaf sizes summed, the tree from ``eval_shape``), and every leaf's
    path and shape, in the port's init too."""
    assert cfg.channel_plan() == list(ref_cfg(cfg).channel_plan())
    ref_tree = ref_shapes(cfg)
    assert cfg.param_count() == int(sum(np.prod(leaf.shape) for leaf in jax.tree.leaves(ref_tree)))
    ref_leaves = {tuple(k.key if hasattr(k, "key") else k.idx for k in path): tuple(leaf.shape)
                  for path, leaf in jax.tree_util.tree_leaves_with_path(ref_tree)}
    assert unet3d.leaf_shapes(cfg) == ref_leaves
    mine = unet3d.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert {path: tuple(t.shape) for path, t in tree.leaves_with_paths(mine)} == ref_leaves


def test_params_round_trip_through_the_bridge():
    p = ref_params(CFG, seed=3)
    back = bridge.params_to_numpy(bridge.unet3d_from_numpy(p, CFG, "cpu"))
    flat, back_flat = list(tree.leaves_with_paths(p)), list(tree.leaves_with_paths(back))
    assert [k for k, _ in flat] == [k for k, _ in back_flat]
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for (_, a), (_, b) in zip(flat, back_flat))
    with pytest.raises(ValueError, match="not the params"):
        bridge.unet3d_from_numpy(p, unet3d.UNet3DConfig(base_channels=8, levels=2), "cpu")


def test_init_is_he_and_seeded():
    a = unet3d.init(CFG, generator=torch.Generator().manual_seed(0), device="cpu")
    b = unet3d.init(CFG, generator=torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(tree.leaves_with_paths(a), tree.leaves_with_paths(b)))
    w = a["bottleneck"]["w1"]
    assert abs(float(w.std()) - (2.0 / (27 * w.shape[3])) ** 0.5) < 0.1 * (2.0 / (27 * w.shape[3])) ** 0.5
    assert float(a["dec"][0]["up_b"].abs().max()) == 0.0 and float(a["head"]["b"].abs().max()) == 0.0


def test_shape_not_a_multiple_of_the_levels_is_refused():
    p = unet3d.init(CFG, device="cpu")
    with pytest.raises(ValueError, match="multiple of 2\\^levels"):
        unet3d.apply(p, torch.zeros(1, 10, 12, 14), CFG)
