"""The weight bridge (jlama_tpu_torch.models.convert) and the helpers the
port's tests share: a JAX param tree → numpy → the port's tree."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from jlama_tpu.nn.qarray import QArray as JQArray
from jlama_tpu_torch.models.convert import from_jax_params
from jlama_tpu_torch.nn.qarray import QArray


def jax_tree_to_numpy(tree):
    """Every leaf to numpy; a JAX QArray to (data, scales, fmt), q4s scales
    as the pair (sigma, swk)."""
    if isinstance(tree, JQArray):
        if isinstance(tree.scales, tuple):
            return (np.asarray(tree.data), tuple(np.asarray(s) for s in tree.scales), tree.fmt)
        return (np.asarray(tree.data), np.asarray(tree.scales), tree.fmt)
    if isinstance(tree, dict):
        return {k: jax_tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree_to_numpy(v) for v in tree]
    return np.asarray(tree)


def port_tree(jax_params, device="cpu"):
    return from_jax_params(jax_tree_to_numpy(jax_params), device=device)


def to_np(t) -> np.ndarray:
    if isinstance(t, QArray):
        return t.dequantize(torch.float32).numpy()
    return t.to(torch.float32).numpy()


def jax_leaf_np(v) -> np.ndarray:
    if isinstance(v, JQArray):
        return np.asarray(v.dequantize(jnp.float32))
    return np.asarray(v.astype(jnp.float32))


def assert_trees_equal(jax_params, port_params):
    """Dequantized leaves equal, layer by layer (stacked or per-layer JAX)."""
    top = {k for k in jax_params if k != "layers"}
    assert top == {k for k in port_params if k != "layers"}
    for k in top:
        np.testing.assert_array_equal(jax_leaf_np(jax_params[k]), to_np(port_params[k]))
    jl = jax_params["layers"]
    pl = port_params["layers"]
    if isinstance(jl, dict):
        assert set(jl) == set(pl[0])
        for k, v in jl.items():
            full = jax_leaf_np(v)
            for i, layer in enumerate(pl):
                np.testing.assert_array_equal(full[i], to_np(layer[k]), err_msg=k)
    else:
        for jd, pd in zip(jl, pl, strict=True):
            assert set(jd) == set(pd)
            for k in jd:
                np.testing.assert_array_equal(jax_leaf_np(jd[k]), to_np(pd[k]), err_msg=k)


@pytest.mark.parametrize("quant", [None, "q4"])
@pytest.mark.parametrize("layout", ["stacked", "per_layer"])
def test_from_jax_params_init_tree(quant, layout):
    from jlama_tpu.models.base import unstack_params
    from jlama_tpu.models.init import init_params
    from jlama_tpu.config import from_hf_config
    from tests.helpers import TINY_LLAMA_CONFIG

    cfg = from_hf_config(TINY_LLAMA_CONFIG)
    jp = init_params(cfg, seed=3, dtype=jnp.float32, quantize=quant)
    if layout == "per_layer":
        jp = unstack_params(jp, cfg)
    pp = port_tree(jp)
    assert len(pp["layers"]) == cfg.n_layers
    if quant == "q4":
        assert isinstance(pp["layers"][0]["wq"], QArray)
        assert pp["layers"][0]["wq"].data.dtype == torch.uint8
    assert_trees_equal(jp, pp)


def test_from_jax_params_bf16_leaves():
    from jlama_tpu.models.init import init_params
    from jlama_tpu.config import from_hf_config
    from tests.helpers import TINY_LLAMA_CONFIG

    cfg = from_hf_config(TINY_LLAMA_CONFIG)
    jp = init_params(cfg, seed=1, dtype=jnp.bfloat16)
    pp = port_tree(jp)
    assert pp["embed"].dtype == torch.bfloat16
    assert pp["layers"][1]["w2"].dtype == torch.bfloat16
    assert_trees_equal(jp, pp)


@pytest.mark.parametrize("arch", ["gpt2", "bert"])
def test_from_jax_params_gpt2_bert_tree(arch):
    """GPT-2's and BERT's JAX trees (stacked layers with every projection
    bias and the LayerNorm biases; wpe, the final norm's bias, BERT's token
    types, embedding norm, pooler and f32 classifier; a q4 embedding) come
    across leaf for leaf."""
    from jlama_tpu.nn.qarray import quantize_q4

    rng = np.random.default_rng(7)
    L, D, H, V, P = 2, 64, 128, 96, 32

    def f(*shape):
        return jnp.asarray(rng.standard_normal(shape, dtype=np.float32))

    layers = {k: f(L, *s) for k, s in {"wq": (D, D), "wk": (D, D), "wv": (D, D),
                                       "wo": (D, D), "w1": (H, D), "w2": (D, H)}.items()}
    layers.update({f"{k}.bias": f(L, n) for k, n in
                   {"wq": D, "wk": D, "wv": D, "wo": D, "w1": H, "w2": D}.items()})
    layers.update({f"{n}.{p}": f(L, D) for n in ("attn_norm", "ff_norm")
                   for p in ("weight", "bias")})
    top = {"embed": quantize_q4(np.asarray(f(V, D))), "wpe": f(P, D), "layers": layers}
    if arch == "gpt2":
        top.update({"final_norm.weight": f(D), "final_norm.bias": f(D)})
    else:
        top.update({"token_type_embed": f(2, D), "embed_norm.weight": f(D),
                    "embed_norm.bias": f(D), "pooler.weight": f(D, D), "pooler.bias": f(D),
                    "classifier.weight": f(3, D), "classifier.bias": f(3)})
    pp = port_tree(top)
    assert_trees_equal(top, pp)
    assert isinstance(pp["embed"], QArray) and pp["embed"].fmt == "q4"
    assert len(pp["layers"]) == L and pp["layers"][1]["w2.bias"].shape == (D,)
