"""K1's plain version against JAX q4_matmul (interpret mode) and linear.

Tolerances as in tests/test_pallas_q4.py: rtol 2e-2 / atol 5e-2 against the
JAX kernel (which rounds scales and x to bf16; atol grows as sqrt(K/512)
past K = 512) and against JAX linear, and rel < 5e-3 against an exact
product.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from jlama_tpu.nn.qarray import quantize_q4 as jquantize_q4
from jlama_tpu.ops.linear import linear as jlinear
from jlama_tpu.ops.pallas_q4 import q4_matmul as jq4_matmul
from jlama_tpu_torch.nn.qarray import QArray
from jlama_tpu_torch.ops import linear as tlinear_mod
from jlama_tpu_torch.ops.q4_matmul import (GEMV_LANE_BLOCKS, GEMV_WARPS, gemv_plan, q4_matmul,
                                           q4_matmul_plain, q4_matmul_tiled_plain, takes_gemv)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _case(shape_x, n, seed):
    rng = np.random.default_rng(seed)
    k = shape_x[-1]
    x = rng.standard_normal(shape_x).astype(np.float32)
    jw = jquantize_q4(rng.standard_normal((n, k)).astype(np.float32) * 0.1)
    tw = QArray(torch.from_numpy(np.array(jw.data)), torch.from_numpy(np.array(jw.scales)))
    return x, jw, tw


@pytest.mark.parametrize("shape_x,n", [
    ((1, 256), 256), ((8, 128), 512), ((16, 512), 128),  # tests/test_pallas_q4.py
    ((2, 3, 128), 256),  # leading dims
    ((1, 64), 384),  # uneven N
    ((2, 14336), 64),  # the 8B w2 contraction
])
def test_plain_q4_matmul_matches_jax(shape_x, n):
    x, jw, tw = _case(shape_x, n, seed=len(shape_x) + n)
    got = q4_matmul(torch.from_numpy(x), tw, out_dtype=torch.float32).numpy()
    assert got.shape == (*shape_x[:-1], n)
    jk = np.asarray(jq4_matmul(jnp.asarray(x), jw, out_dtype=jnp.float32, interpret=True))
    # the JAX kernel rounds x and the scales to bf16, an error that grows
    # as sqrt(K): the atol of tests/test_pallas_q4.py (K <= 512) scales with it
    atol = 5e-2 * max(1.0, np.sqrt(shape_x[-1] / 512))
    np.testing.assert_allclose(got, jk, rtol=2e-2, atol=atol)
    jl = np.asarray(jlinear(jnp.asarray(x), jw, out_dtype=jnp.float32))
    np.testing.assert_allclose(got, jl, rtol=2e-2, atol=5e-2)
    exact = x.astype(np.float64) @ np.asarray(jw.dequantize(jnp.float32)).T.astype(np.float64)
    rel = np.linalg.norm(got - exact) / np.linalg.norm(exact)
    assert rel < 5e-3, rel


# the M > 16 route's rounding model (x and each weight rounded to bf16, f32
# products and sums): against the JAX kernel at its tolerances, and within the
# bf16 rounding of an exact product (rel L2 < 5e-3), as q4_matmul_plain is
@pytest.mark.parametrize("m,n,k", [(17, 64, 96), (17, 40, 2048), (130, 96, 640),
                                   (130, 32, 256)])
def test_tiled_plain_matches_jax_and_exact(m, n, k):
    x, jw, tw = _case((m, k), n, seed=m * n + k)
    xt = torch.from_numpy(x)
    got = q4_matmul_tiled_plain(xt, tw.data, tw.scales, torch.float32).numpy()
    assert got.shape == (m, n)
    jk = np.asarray(jq4_matmul(jnp.asarray(x), jw, out_dtype=jnp.float32, interpret=True))
    atol = 5e-2 * max(1.0, np.sqrt(k / 512))
    np.testing.assert_allclose(got, jk, rtol=2e-2, atol=atol)
    exact = x.astype(np.float64) @ np.asarray(jw.dequantize(jnp.float32)).T.astype(np.float64)
    rel = np.linalg.norm(got - exact) / np.linalg.norm(exact)
    assert rel < 5e-3, rel
    plain = q4_matmul_plain(xt, tw.data, tw.scales, torch.float32).numpy()
    assert np.linalg.norm(plain - exact) / np.linalg.norm(exact) < 5e-3
    # bf16 out is the f32 result rounded once
    assert torch.equal(q4_matmul_tiled_plain(xt, tw.data, tw.scales, torch.bfloat16),
                       torch.from_numpy(got).to(torch.bfloat16))


def test_cpu_wrapper_runs_plain_and_counts_nothing():
    x, _, tw = _case((4, 96), 64, seed=9)
    before = q4_matmul.launches
    xt = torch.from_numpy(x)
    got = tlinear_mod.linear(xt, tw, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    ref = q4_matmul_plain(xt, tw.data, tw.scales, torch.bfloat16)
    assert torch.equal(got, ref)
    assert q4_matmul.launches == before


def test_wrapper_rejects_non_q4():
    x, _, tw = _case((1, 64), 32, seed=4)
    with pytest.raises(ValueError):
        q4_matmul(torch.from_numpy(x), QArray(tw.data, tw.scales, "q8"))


def _gemv_rows(plan, n, grid):
    """The weight row of every (tile, warp group, row) a GEMV launch of `grid`
    blocks stores, as `q4_gemv_kernel` walks them: block b takes tiles b, b +
    grid, ... below the plan's count, and row (tile * groups + group) * rows +
    r of each; rows at or past N are not stored."""
    rows, slices, tiles = plan
    groups = GEMV_WARPS // slices
    walked = np.concatenate([np.arange(b, tiles, grid) for b in range(min(grid, tiles))])
    t, g, r = np.meshgrid(walked, np.arange(groups), np.arange(rows), indexing="ij")
    got = ((t * groups + g) * rows + r).reshape(-1)
    return got[got < n]


def _gemv_slices(k, slices):
    """The [kb0, kb1) runs of K's 32-blocks of a row's slices, as
    `gemv_slice` in csrc/q4_matmul.cu computes them."""
    nb = k // 32
    per = -(-(-(-nb // 32)) // slices) * 32
    return [(min(nb, s * per), min(nb, min(nb, s * per) + per)) for s in range(slices)]


LLAMA_1B_M1 = {"wqkv": (3072, 2048), "wo": (2048, 2048), "w13": (16384, 2048),
               "w2": (2048, 8192), "lm_head": (128256, 2048)}


@pytest.mark.parametrize("m,x_dtype", [(1, torch.bfloat16), (1, torch.float32),
                                       (5, torch.float32), (16, torch.float32)])
@pytest.mark.parametrize("k", [32, 96, 800, 2048, 8192, 14336])
def test_gemv_plan_covers_every_row_and_block_once(m, x_dtype, k):
    assert takes_gemv(m, x_dtype)
    ns = list(range(1, 300)) + list(range(300, 128257, 997)) + [2048, 3072, 16384, 128256]
    for n in ns:
        plan = gemv_plan(m, n, k, 132)
        rows, slices, tiles = plan
        assert GEMV_WARPS % slices == 0 and rows in ((4, 2, 1) if m == 1 else (1,))
        assert tiles == -(-n // (rows * GEMV_WARPS // slices))
        # every output row exactly once, whatever the grid the SMs hold
        for grid in (1, 132, 2 * 132 + 1, tiles):
            got = np.bincount(_gemv_rows(plan, n, grid), minlength=n)
            assert np.array_equal(got, np.ones(n, int)), (n, grid)
        # the slices tile K's blocks in order, none empty, each whole runs of 32
        runs = _gemv_slices(k, slices)
        assert runs[0][0] == 0 and runs[-1][1] == k // 32
        assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
        assert all(lo < hi and lo % 32 == 0 for lo, hi in runs)


@pytest.mark.parametrize("sms", [132, 114, 78])
def test_gemv_plan_fills_the_sms_at_the_1b_shapes(sms):
    """At Llama-3.2-1B's decode shapes every SM gets a tile and every lane
    at least GEMV_LANE_BLOCKS loads a row (H100 SXM 132 SMs, PCIe 114, and a
    smaller part)."""
    for name, (n, k) in LLAMA_1B_M1.items():
        rows, slices, tiles = gemv_plan(1, n, k, sms)
        assert tiles >= sms, (name, rows, slices, tiles)
        lo, hi = _gemv_slices(k, slices)[0]
        assert hi - lo >= GEMV_LANE_BLOCKS * 32, (name, rows, slices)


def test_gemv_plan_prefers_rows_then_no_split():
    # the lm_head: plenty of rows, so 4 rows a warp and no split of K
    assert gemv_plan(1, 128256, 2048, 132) == (4, 1, 4008)
    # wo: 4 or 2 rows a warp leave SMs idle, and K = 2048 is 2 loads a lane
    assert gemv_plan(1, 2048, 2048, 132) == (1, 1, 256)
    # w2: K = 8192 splits 4 ways and keeps 4 rows a warp
    assert gemv_plan(1, 2048, 8192, 132) == (4, 4, 256)
    # past M = 1, one row a warp (x's rows are the reuse)
    assert gemv_plan(16, 2048, 2048, 132) == (1, 1, 256)
    # bf16 x at M = 2-16 takes the mma route, M > 16 the wgmma route
    assert not takes_gemv(2, torch.bfloat16) and not takes_gemv(17, torch.float32)


# the GEMV route's numerics (each x * (n - 8) exact in f32, f32 sums, each
# 32-block's partial scaled by its f32 scale) are q4_matmul_plain's; at M = 1
# that function is held to the JAX kernel at the decode shapes' K here
@pytest.mark.parametrize("n,k", [(64, 2048), (40, 8192), (24, 14336)])
def test_plain_m1_matches_jax_at_decode_k(n, k):
    x, jw, tw = _case((1, k), n, seed=n + k)
    got = q4_matmul(torch.from_numpy(x), tw, out_dtype=torch.float32).numpy()
    jk = np.asarray(jq4_matmul(jnp.asarray(x), jw, out_dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(got, jk, rtol=2e-2, atol=5e-2 * np.sqrt(k / 512))
    exact = x.astype(np.float64) @ np.asarray(jw.dequantize(jnp.float32)).T.astype(np.float64)
    assert np.linalg.norm(got - exact) / np.linalg.norm(exact) < 5e-3
