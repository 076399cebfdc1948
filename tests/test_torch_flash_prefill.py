"""K3's plain version against JAX flash_prefill (interpret mode), in f32 at
2e-5 — the cases of tests/test_pallas_attention.py at head sizes 64, 128 and
256 (Gemma 2's, with its softcap of 50) —
and the bf16 route's rounding model, flash_prefill_tiled_plain (P rounded to
bf16 per key tile, as the TPU kernel rounds it), against the JAX kernel on
bf16 inputs with its key and query blocks at the route's key tile."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from jlama_tpu.ops.pallas_attention import flash_prefill as jflash
from jlama_tpu_torch.ops.attention import (KEY_TILE, flash_prefill, flash_prefill_plain,
                                           flash_prefill_tiled_plain)

BF16_ULP = 2.0 ** -7  # one bf16 ulp is at most 2^-7 of the value


def _inputs(seed, B, H, n_kv, T, S, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, hd)).astype(np.float32)
    k = rng.standard_normal((B, n_kv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, n_kv, S, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("hd", [64, 128, 256])
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


@pytest.mark.parametrize("hd,cap", [(64, 30.0), (128, 30.0), (256, 50.0)])
def test_flash_prefill_plain_softcap_and_window(hd, cap):
    B, H, n_kv, T, S = 1, 2, 1, 8, 24
    q, k, v = _inputs(hd, B, H, n_kv, T, S, hd)
    pos0 = np.asarray([12], np.int32)
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos0), 0.125,
                 softcap=cap, window=9, block_t=8, block_s=8, interpret=True)
    got = flash_prefill_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(pos0), 0.125, softcap=cap, window=9)
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


# (B, H, n_kv, T, S, pos0 per row, hd, softcap, window); S a multiple of the
# key tile (128 at hd 64, 64 at hd 128, 32 at hd 256), so that the JAX
# kernel's key blocks are the route's tiles
TILED_CASES = [
    (1, 4, 2, 128, 256, (128,), 64, None, None),
    (2, 4, 2, 64, 256, (0, 150), 64, None, None),
    (2, 4, 1, 64, 192, (40, 128), 128, None, None),
    (1, 2, 1, 64, 256, (100,), 128, 30.0, 70),
    (2, 4, 2, 64, 160, (30, 96), 256, None, None),
    (1, 4, 2, 96, 224, (128,), 256, 50.0, 40),
]


def _one_p_flip(q, k, v, pos0, scale, softcap, window):
    """Per output element, 2^-7 max_j w_j |v_j| (w the softmax weights): the
    most that rounding one P to the neighbouring bf16 value (one ulp, at
    most 2^-7 of it) moves it. Two implementations whose f32 scores differ
    in the last bit now and then round one P of a row apart."""
    B, H, T, hd = q.shape
    n_kv, S = k.shape[1], k.shape[2]
    g = H // n_kv
    s = torch.einsum("bkgth,bksh->bkgts", q.reshape(B, n_kv, g, T, hd), k) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    q_pos = pos0[:, None] + torch.arange(T)[None, :]
    k_pos = torch.arange(S)[None, None, :]
    mask = k_pos <= q_pos[:, :, None]
    if window is not None:
        mask &= k_pos > q_pos[:, :, None] - window
    w = torch.softmax(torch.where(mask[:, None, None], s, torch.tensor(-1e30)), dim=-1)
    flip = (w[..., None] * v.abs()[:, :, None, None]).amax(dim=-2)
    return BF16_ULP * flip.reshape(B, H, T, hd).numpy()


@pytest.mark.parametrize("B,H,n_kv,T,S,pos0,hd,cap,win", TILED_CASES)
def test_flash_prefill_tiled_plain_matches_jax_bf16(B, H, n_kv, T, S, pos0, hd, cap, win):
    """Within 2 bf16 ulps of the JAX kernel's bf16 output plus 1e-6, plus
    one P rounded to the neighbouring bf16 value (`_one_p_flip`); the f32-P
    plain version misses that limit."""
    q, k, v = _inputs(T + S + hd, B, H, n_kv, T, S, hd)
    p0 = np.asarray(pos0, np.int32)
    scale = hd ** -0.5
    tile = KEY_TILE[hd]
    ref = np.asarray(jflash(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                            jnp.asarray(v, jnp.bfloat16), jnp.asarray(p0), scale, softcap=cap,
                            window=win, block_t=tile, block_s=tile,
                            interpret=True).astype(jnp.float32))

    def bf(a):
        return torch.from_numpy(a).to(torch.bfloat16)

    qb, kb, vb, pt = bf(q), bf(k), bf(v), torch.from_numpy(p0)
    got = flash_prefill_tiled_plain(qb, kb, vb, pt, scale, softcap=cap, window=win,
                                    block_s=tile)
    assert got.dtype == torch.bfloat16
    lim = 2 * BF16_ULP * np.abs(ref) + 1e-6 \
        + _one_p_flip(qb.float(), kb.float(), vb.float(), pt.long(), scale, cap, win)
    np.testing.assert_array_less(np.abs(got.float().numpy() - ref), lim)
    plain = flash_prefill_plain(qb, kb, vb, pt, scale, softcap=cap, window=win)
    assert (np.abs(plain.float().numpy() - ref) > lim).any()


@pytest.mark.parametrize("B,H,n_kv,T,S,pos0,hd,cap,win", TILED_CASES)
def test_flash_prefill_tiled_plain_equals_plain_f32(B, H, n_kv, T, S, pos0, hd, cap, win):
    """In f32 (P kept f32) the tiled online softmax is the dense one: 2e-5."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(hd, B, H, n_kv, T, S, hd))
    p0 = torch.tensor(pos0)
    got = flash_prefill_tiled_plain(q, k, v, p0, hd ** -0.5, softcap=cap, window=win)
    ref = flash_prefill_plain(q, k, v, p0, hd ** -0.5, softcap=cap, window=win)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=2e-5)

