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
    """Every leaf to numpy; a JAX QArray to (data, scales, fmt)."""
    if isinstance(tree, JQArray):
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
