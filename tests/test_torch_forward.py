"""Tiny Llama through the port's forward against JAX forward_logits and
transformers (analogs of tests/test_llama_forward.py), float and JQ4, fused
and unfused, on the CPU (plain versions of the kernels)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tests.helpers import make_tiny_llama
from tests.test_torch_bridge import port_tree

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOKENS = np.array([[1, 5, 9, 42, 7, 13]], dtype=np.int64)


def _hd64_overrides():
    # head_size 64, so a T > 1 forward routes to flash_prefill
    return {"hidden_size": 128, "num_attention_heads": 2, "num_key_value_heads": 1,
            "intermediate_size": 128}


@pytest.fixture(scope="module", params=["hd16", "hd64"])
def tiny(request, tmp_path_factory):
    from jlama_tpu.models.loader import load_params

    over = {} if request.param == "hd16" else _hd64_overrides()
    model_dir, hf = make_tiny_llama(tmp_path_factory.mktemp(f"tfwd_{request.param}"), over)
    jp, jcfg = load_params(model_dir, float_dtype=jnp.float32)
    from jlama_tpu_torch.config import load_config

    return model_dir, hf, jp, jcfg, load_config(model_dir)


def _quantized(jp):
    from jlama_tpu.nn.qarray import quantize_q4

    layers = {k: (quantize_q4(np.asarray(v)) if k in ("wq", "wk", "wv", "wo", "w1", "w2", "w3")
                  else v) for k, v in jp["layers"].items()}
    return dict(jp, layers=layers, embed=quantize_q4(np.asarray(jp["embed"])))


def _port_logits(tp, cfg, tokens, cache=None, start=0):
    from jlama_tpu_torch.models.base import forward_logits

    T = tokens.shape[1]
    pos = torch.arange(start, start + T)[None, :].expand(tokens.shape[0], T)
    logits, _ = forward_logits(tp, cfg, torch.from_numpy(tokens), pos, cache,
                               dtype=torch.float32)
    return logits.numpy()


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_logits_match_jax_and_transformers(tiny, quant, fused):
    from jlama_tpu.models.base import forward_logits as jforward
    from jlama_tpu_torch.models.base import fuse_params
    from jlama_tpu_torch.ops.attention import flash_prefill

    _, hf, jp, jcfg, tcfg = tiny
    if quant:
        jp = _quantized(jp)
    tp = port_tree(jp)
    if fused:
        tp = fuse_params(tp)
        assert "wqkv" in tp["layers"][0] and "w13" in tp["layers"][0]
    pos = np.arange(TOKENS.shape[1])[None, :]
    ref, _ = jforward(jp, jcfg, jnp.asarray(TOKENS, jnp.int32), jnp.asarray(pos, jnp.int32),
                      dtype=jnp.float32)
    before = flash_prefill.launches
    got = _port_logits(tp, tcfg, TOKENS)
    assert flash_prefill.launches == before  # CPU: the plain version
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)
    if not quant:
        with torch.no_grad():
            hf_logits = hf(torch.from_numpy(TOKENS)).logits.numpy()
        np.testing.assert_allclose(got, hf_logits, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("quant", [False, True])
def test_kv_cache_decode_matches_full_forward(tiny, quant):
    from jlama_tpu_torch.models.base import KVCache, fuse_params

    _, _, jp, _, tcfg = tiny
    tp = fuse_params(port_tree(_quantized(jp) if quant else jp))
    full = _port_logits(tp, tcfg, TOKENS)
    cache = KVCache.init(tcfg, batch=1, max_len=16, dtype=torch.float32)
    l1 = _port_logits(tp, tcfg, TOKENS[:, :4], cache)
    np.testing.assert_allclose(l1[:, -1], full[:, 3], rtol=2e-3, atol=2e-3)
    for t in range(4, 6):
        lt = _port_logits(tp, tcfg, TOKENS[:, t : t + 1], cache, start=t)
        np.testing.assert_allclose(lt[:, 0], full[:, t], rtol=2e-3, atol=2e-3)


def test_batch_padding_invariance(tiny):
    """Rows with different tokens must not affect each other."""
    from jlama_tpu_torch.models.base import KVCache

    _, _, jp, _, tcfg = tiny
    tp = port_tree(jp)
    toks = np.array([[1, 5, 9], [1, 7, 0]], dtype=np.int64)
    l2 = _port_logits(tp, tcfg, toks, KVCache.init(tcfg, 2, 8, torch.float32))
    l1 = _port_logits(tp, tcfg, toks[:1], KVCache.init(tcfg, 1, 8, torch.float32))
    np.testing.assert_allclose(l2[0], l1[0], rtol=1e-4, atol=1e-4)
