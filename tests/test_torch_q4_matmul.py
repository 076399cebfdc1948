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
from jlama_tpu_torch.ops.q4_matmul import q4_matmul, q4_matmul_plain, q4_matmul_tiled_plain

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
