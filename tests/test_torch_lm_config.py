"""The port's LM configs against the reference's: every arch of ARCHS, its
smoke variant and its config for each input shape, field for field (the
dtype mapped from jnp to torch), with the same block pattern, repeats,
head dim and parameter counts."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro import configs as ref_configs
from repro.models.config import ModelConfig as RefModelConfig
from repro_torch import configs
from repro_torch.models.config import ModelConfig


def _torch_dtype(jdtype) -> torch.dtype:
    return getattr(torch, jnp.dtype(jdtype).name)


def _variant(pkg, arch: str, variant: str):
    if variant == "full":
        return pkg.get(arch)
    if variant == "smoke":
        return pkg.get_smoke(arch)
    return pkg.for_shape(arch, variant)


def test_registry_matches():
    assert configs.ARCHS == ref_configs.ARCHS
    assert configs.INPUT_SHAPES == ref_configs.INPUT_SHAPES
    assert [f.name for f in dataclasses.fields(ModelConfig)] == [
        f.name for f in dataclasses.fields(RefModelConfig)
    ]
    assert ModelConfig().dtype == torch.bfloat16


@pytest.mark.parametrize("variant", ["full", "smoke", *ref_configs.INPUT_SHAPES])
@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_config_matches_field_for_field(arch, variant):
    ref = _variant(ref_configs, arch, variant)
    port = _variant(configs, arch, variant)
    for field in dataclasses.fields(RefModelConfig):
        expect = getattr(ref, field.name)
        if field.name == "dtype":
            expect = _torch_dtype(expect)
        assert getattr(port, field.name) == expect, field.name
    assert port.block_pattern() == ref.block_pattern()
    assert port.num_repeats == ref.num_repeats
    assert port.resolved_head_dim == ref.resolved_head_dim
    assert port.d_inner == ref.d_inner and port.rwkv_num_heads == ref.rwkv_num_heads
    assert port.param_counts() == ref.param_counts()


def test_get_applies_overrides():
    cfg = configs.get("tinyllama-1.1b", dtype=torch.float32, num_layers=2)
    assert cfg.dtype == torch.float32 and cfg.num_layers == 2 and cfg.d_model == 2048


def test_pattern_length_must_divide_layers():
    with pytest.raises(ValueError, match="multiple of the pattern length"):
        _ = ModelConfig(num_layers=6, attn_every=4).num_repeats
