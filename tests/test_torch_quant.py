"""The port's block quantization and QArray against jlama_tpu's."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from jlama_tpu.nn.qarray import QArray as JQArray
from jlama_tpu.quant import blockq as jbq
from jlama_tpu_torch.nn.qarray import QArray, quantize_q4
from jlama_tpu_torch.quant import blockq as tbq


def _packed(rng, shape):
    data = rng.integers(0, 256, size=shape, dtype=np.uint8)
    scales = (rng.standard_normal(shape[:-1] + (shape[-1] // 16,)) * 0.05).astype(np.float32)
    return data, scales


@pytest.mark.parametrize("shape", [(4, 16), (3, 5, 64), (2, 256)])
def test_q4_dequantize_exact(shape):
    rng = np.random.default_rng(0)
    data, scales = _packed(rng, shape)
    ref = np.asarray(jbq.q4_dequantize(jnp.asarray(data), jnp.asarray(scales)))
    got = tbq.q4_dequantize(torch.from_numpy(data), torch.from_numpy(scales)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tbq.q4_unpack(torch.from_numpy(data)).numpy(), jbq.q4_unpack_np(data)
    )


@pytest.mark.parametrize("fmt", ["q4", "q8"])
def test_qarray_dequantize_exact(fmt):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 96)).astype(np.float32)
    if fmt == "q4":
        data, scales = jbq.q4_quantize_np(x)
    else:
        data, scales = jbq.q8_quantize_np(x)
    jq = JQArray(jnp.asarray(data), jnp.asarray(scales), fmt)
    tq = QArray(torch.from_numpy(data), torch.from_numpy(scales), fmt)
    assert tq.shape == tuple(jq.shape)
    np.testing.assert_array_equal(tq.dequantize().numpy(), np.asarray(jq.dequantize()))
    np.testing.assert_array_equal(tq.unpack().numpy(), np.asarray(jq.unpack()))
    rows = np.array([4, 0, 4])
    np.testing.assert_array_equal(
        tq[torch.from_numpy(rows)].dequantize().numpy(),
        np.asarray(jq[jnp.asarray(rows)].dequantize()),
    )
    assert tq.dequantize(torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("block", [32, 64])
def test_q8_quantize_exact(block):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((5, 4, 128)) * 3).astype(np.float32)
    x[0, 0, :block] = 0.0  # an all-zero block: scale 0, values 0
    jq, js = jbq.q8_quantize(jnp.asarray(x), block=block)
    tq, ts = tbq.q8_quantize(torch.from_numpy(x), block=block)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if block == 32:
        np.testing.assert_array_equal(
            tbq.q8_dequantize(tq, ts).numpy(), np.asarray(jbq.q8_dequantize(jq, js))
        )


def test_q8_quantize_equals_jax_on_ties():
    """The port's q8_quantize against jlama_tpu's, code for code and scale for
    scale, on 10^5 seeded values of which tens of thousands land exactly on a
    half (x * 127 / amax = k + 1/2): both divide 127 / amax and amax / 127
    correctly rounded, and multiply and add apart."""
    from tests.test_torch_cuda_kernels import q8_tie_inputs

    x = q8_tie_inputs().reshape(-1, 32)
    assert x.size == 10 ** 5
    iscale = np.float32(127) / np.abs(x).max(axis=-1)
    prod = x * iscale[:, None]
    assert (prod - np.floor(prod) == 0.5).sum() > 10 ** 4
    jq, js = jbq.q8_quantize(jnp.asarray(x))
    tq, ts = tbq.q8_quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32), np.asarray(js).view(np.int32))


def test_numpy_checkpoint_path_identical():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((7, 64)).astype(np.float32)
    for ours, theirs in ((tbq.q4_quantize_np, jbq.q4_quantize_np),
                         (tbq.q8_quantize_np, jbq.q8_quantize_np)):
        a, b = ours(x), theirs(x)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    packed, scales = tbq.q4_quantize_np(x)
    np.testing.assert_array_equal(tbq.q4_pack_np(tbq.q4_unpack_np(packed)), packed)
    np.testing.assert_array_equal(
        tbq.q4_dequantize_np(packed, scales), jbq.q4_dequantize_np(packed, scales)
    )
    qa = quantize_q4(x)
    np.testing.assert_array_equal(qa.data.numpy(), packed)
