"""K3's plain version against JAX flash_prefill (interpret mode), in f32 at
2e-5 — the cases of tests/test_pallas_attention.py at head sizes 64 and 128."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from jlama_tpu.ops.pallas_attention import flash_prefill as jflash
from jlama_tpu_torch.ops.attention import flash_prefill, flash_prefill_plain


def _inputs(seed, B, H, n_kv, T, S, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, hd)).astype(np.float32)
    k = rng.standard_normal((B, n_kv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, n_kv, S, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("T,S,pos0_v", [(8, 16, 0), (8, 32, 10), (16, 16, 0)])
def test_flash_prefill_plain_matches_jax(T, S, pos0_v, hd):
    B, H, n_kv = 2, 4, 2
    q, k, v = _inputs(T + S + pos0_v + hd, B, H, n_kv, T, S, hd)
    pos0 = np.asarray([pos0_v, pos0_v + 3], np.int32)
    scale = hd**-0.5
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos0), scale,
                 block_t=8, block_s=8, interpret=True)
    got = flash_prefill(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        torch.from_numpy(pos0), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_prefill_plain_softcap_and_window(hd):
    B, H, n_kv, T, S = 1, 2, 1, 8, 24
    q, k, v = _inputs(hd, B, H, n_kv, T, S, hd)
    pos0 = np.asarray([12], np.int32)
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos0), 0.125,
                 softcap=30.0, window=9, block_t=8, block_s=8, interpret=True)
    got = flash_prefill_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(pos0), 0.125, softcap=30.0, window=9)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_flash_prefill_cpu_wrapper_counts_nothing():
    q, k, v = _inputs(0, 1, 4, 2, 8, 16, 64)
    before = flash_prefill.launches
    pos0 = torch.tensor([3])
    got = flash_prefill(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos0, 0.1)
    ref = flash_prefill_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              pos0, 0.1)
    assert torch.equal(got, ref)
    assert flash_prefill.launches == before
