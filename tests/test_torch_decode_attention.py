"""K4's wrapper on the CPU (its plain version) against the reference:
``repro.kernels.ref.decode_attention`` on the reference's four kernel
cases (2e-5) and its bf16 case (3e-2, tests/test_kernels.py), the Pallas
K4 in interpret mode on one small case, ``pos`` as a host int and as a
(1,) int32 tensor alike, and the kernel's chunk rule (its Python mirror):
how the card's fixed grid cuts the valid slots among blocks and warps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_kernels
from repro.kernels.decode_attention import decode_attention as pallas_decode_attention
from repro_torch import bridge
from repro_torch.kernels import decode_attention as k4
from repro_torch.kernels import ref

FP32_ATOL = 2e-5  # tests/test_kernels.py:155
BF16_ATOL = 3e-2  # tests/test_kernels.py:166-169

CASES = [  # (B, H, KV, hd, S, pos), the reference's kernel cases
    (2, 8, 2, 32, 100, 57),  # GQA 4x, ragged S, mid pos
    (1, 4, 4, 16, 64, 63),  # MHA, full cache
    (3, 16, 8, 64, 200, 10),  # mostly-masked cache
    (1, 8, 1, 32, 96, 95),  # MQA
]


def _qkv(seed, B, H, KV, hd, S):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in ((B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


@pytest.mark.parametrize("B,H,KV,hd,S,pos", CASES)
def test_plain_version_matches_reference_oracle(B, H, KV, hd, S, pos):
    q, k, v = _qkv(B + S, B, H, KV, hd, S)
    before = k4.launches
    got = k4.decode_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), pos)
    assert k4.launches == before and got.dtype == torch.float32 and got.shape == (B, 1, H, hd)
    expect = ref_kernels.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=0, atol=FP32_ATOL)


def test_bf16_matches_reference_oracle():
    q, k, v = (jnp.asarray(a).astype(jnp.bfloat16) for a in _qkv(7, 2, 8, 4, 32, 80))
    tq, tk, tv = (bridge.params_from_numpy(np.asarray(a), "cpu") for a in (q, k, v))
    got = k4.decode_attention(tq, tk, tv, 40)
    assert got.dtype == torch.bfloat16
    expect = ref_kernels.decode_attention(q, k, v, 40)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(expect, np.float32), rtol=0, atol=BF16_ATOL)


@pytest.mark.parametrize("B,H,KV,hd,S,pos", CASES)
def test_tensor_pos_is_the_host_int(B, H, KV, hd, S, pos):
    """pos as a (1,) int32 tensor, the reference's operand, gives the host
    int's result, bit for bit, and the reference oracle's."""
    q, k, v = (torch.tensor(a) for a in _qkv(B + S, B, H, KV, hd, S))
    got = k4.decode_attention(q, k, v, torch.full((1,), pos, dtype=torch.int32))
    assert torch.equal(got, k4.decode_attention(q, k, v, pos))
    expect = ref_kernels.decode_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=0, atol=FP32_ATOL)


def test_plain_version_matches_pallas_kernel():
    """One small case against the Pallas K4 in interpret mode, its S cut
    into three blocks of 32 (the last ragged), pos as a host int and as a
    (1,) int32 tensor."""
    q, k, v = _qkv(11, 2, 8, 2, 32, 70)
    expect = pallas_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(45, jnp.int32),
                                     block_s=32)
    for pos in (45, torch.tensor([45], dtype=torch.int32)):
        got = ref.decode_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=0, atol=FP32_ATOL)


def test_pos_past_the_cache_attends_to_every_slot():
    q, k, v = (torch.tensor(a) for a in _qkv(3, 1, 4, 2, 16, 10))
    np.testing.assert_array_equal(k4.decode_attention(q, k, v, 25).numpy(), k4.decode_attention(q, k, v, 9).numpy())


@pytest.mark.parametrize("S,rows", [(1, 16), (57, 4), (64, 16), (290, 16), (1024, 16), (1024, 1), (2048, 64)])
def test_chunks_cover_the_valid_slots_once(S, rows):
    """The grid depends on S and B x KV alone (at most TARGET_BLOCKS blocks
    or one a row, no more chunks than a full cache has MIN_SLOTS slots); at
    every pos the (block, warp) chunks of the kernel's rule
    take every valid slot exactly once, none past n_valid, each within one
    slot of an even share."""
    splits = k4.nsplit(S, rows)
    assert 1 <= splits and splits * rows <= max(k4.TARGET_BLOCKS, rows)
    assert splits <= -(-S // k4.MIN_SLOTS)
    workers = splits * k4.WARPS
    for pos in range(S + 2):
        n_valid = min(pos + 1, S)
        cs = k4.chunks(n_valid, splits)
        assert len(cs) == workers
        assert [b for b, _ in cs] == [0] + [e for _, e in cs[:-1]] and cs[-1][1] == n_valid
        assert all(n_valid // workers - 1 <= e - b <= -(-n_valid // workers) + 1 for b, e in cs)


def test_wrapper_rejects_bad_shapes():
    q, k, v = (torch.tensor(a) for a in _qkv(0, 1, 6, 4, 16, 10))
    with pytest.raises(ValueError, match="multiple"):
        k4.decode_attention(q, k, v, 3)
    q, k, v = (torch.tensor(a) for a in _qkv(0, 1, 8, 4, 16, 10))
    with pytest.raises(ValueError, match="B=1"):
        k4.decode_attention(q, k[:, :, :, :8], v, 3)
    with pytest.raises(ValueError, match="pos"):
        k4.decode_attention(q, k, v, -1)
    for pos in (torch.tensor([3]), torch.tensor(3, dtype=torch.int32), torch.tensor([3, 4], dtype=torch.int32)):
        with pytest.raises(ValueError, match="int32"):
            k4.decode_attention(q, k, v, pos)
