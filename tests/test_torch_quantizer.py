"""The port's quantizer (`jlama_tpu_torch/quant/quantizer.py`) and its torch
quantizers (`quant/blockq.py::q4_quantize`, `q8_quantize_checkpoint`)
against jlama_tpu's, on the CPU: the output directories byte for byte equal
for q4 and i8, with skip and drop prefixes, from f32 and bf16 checkpoints;
each package loads the other's JQ4 checkpoint; bytes, not a tolerance, on
inputs full of rounding ties."""

import filecmp

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from jlama_tpu.quant import blockq as jblockq
from jlama_tpu.quant.quantizer import quantize_model as jquantize
from jlama_tpu_torch.quant import blockq
from jlama_tpu_torch.quant.quantizer import quantize_model
from tests.helpers import TINY_LLAMA_CONFIG, make_tiny_llama, save_torch_model


def _tie_inputs(case, seed):
    """Blocks whose q4 and q8 codes land on .5 steps and whose extremes tie
    in magnitude (both signs), beside plain normals."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((48, 256)).astype(np.float32)
    if case == "ties":
        s = rng.uniform(0.01, 3, (48 * 8, 1)).astype(np.float32)
        codes = rng.integers(-16, 17, (48 * 8, 32)).astype(np.float32) / 2
        x = (codes * s).reshape(48, 256)
        x[::2, 3] = -x[::2, 9]
    elif case == "zeros":
        x[:, :64] = 0
    elif case == "scaled":
        x *= np.float32(10.0) ** rng.integers(-20, 4, (48, 1)).astype(np.float32)
    return x


@pytest.mark.parametrize("case", ["normal", "ties", "zeros", "scaled"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_torch_quantizers_equal_numpy_and_jax(case, dtype):
    x = torch.from_numpy(_tie_inputs(case, 5)).to(dtype)
    xf = x.to(torch.float32).numpy()
    packed, scales = blockq.q4_quantize(x)
    ref = jblockq.q4_quantize_np(xf)
    assert packed.dtype == torch.uint8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(packed.numpy(), ref[0])
    np.testing.assert_array_equal(scales.numpy().view(np.uint32), ref[1].view(np.uint32))
    np.testing.assert_array_equal(packed.numpy(), blockq.q4_quantize_np(xf)[0])
    q, s = blockq.q8_quantize_checkpoint(x)
    ref = jblockq.q8_quantize_np(xf)
    np.testing.assert_array_equal(q.numpy(), ref[0])
    np.testing.assert_array_equal(s.numpy().view(np.uint32), ref[1].view(np.uint32))


def test_torch_q4_quantize_keeps_leading_dims():
    x = torch.from_numpy(_tie_inputs("normal", 1)).reshape(2, 3, 8, 256)
    packed, scales = blockq.q4_quantize(x)
    assert packed.shape == (2, 3, 8, 128) and scales.shape == (2, 3, 8, 8)
    with pytest.raises(ValueError, match="multiple of 32"):
        blockq.q4_quantize(torch.zeros(4, 40))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A tiny Llama in f32 and the same model in bf16."""
    base = tmp_path_factory.mktemp("quant_src")
    f32, _ = make_tiny_llama(base / "f32", seed=3)
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(4)
    hf = LlamaForCausalLM(LlamaConfig(**{k: v for k, v in TINY_LLAMA_CONFIG.items()
                                         if k != "model_type"})).to(torch.bfloat16).eval()
    save_torch_model(hf, base / "bf16", TINY_LLAMA_CONFIG)
    (base / "bf16" / "README.md").write_text("a model card\n")
    return {"f32": f32, "bf16": base / "bf16"}


@pytest.mark.parametrize("src", ["f32", "bf16"])
@pytest.mark.parametrize("quantize_to", ["q4", "i8"])
@pytest.mark.parametrize("prefixes", [((), ()), (("q_proj",), ("lm_head",)),
                                      (("mlp.down",), ("model.layers.1.",))])
def test_quantize_model_bytes_equal_jax(checkpoints, tmp_path, src, quantize_to, prefixes):
    skip, drop = prefixes
    seen = []
    out = quantize_model(checkpoints[src], tmp_path / "t", quantize_to=quantize_to,
                         skip_prefixes=skip, drop_prefixes=drop, device="cpu",
                         progress=lambda name, i, n: seen.append((name, i, n)))
    ref = jquantize(checkpoints[src], tmp_path / "j", quantize_to=quantize_to,
                    skip_prefixes=skip, drop_prefixes=drop)
    names = sorted(p.name for p in ref.iterdir())
    assert sorted(p.name for p in out.iterdir()) == names
    assert {"model.safetensors", "config.json", "README.md"} <= set(names)
    for n in names:
        assert filecmp.cmp(out / n, ref / n, shallow=False), n
    assert seen and seen[-1][1] == seen[-1][2]


def test_quantize_default_output_dir_and_card(checkpoints, tmp_path):
    import shutil

    src = tmp_path / "mymodel"
    shutil.copytree(checkpoints["bf16"], src)
    out = quantize_model(src, device="cpu")
    assert out == tmp_path / "mymodel-JQ4"
    readme = (out / "README.md").read_text()
    assert readme.startswith("# Quantized version of mymodel") and readme.endswith(
        "a model card\n")
    assert quantize_model(src, quantize_to="i8", device="cpu") == tmp_path / "mymodel-JI8"


def test_each_package_loads_the_others_jq4(checkpoints, tmp_path):
    from jlama_tpu.models.loader import load_params as jload
    from jlama_tpu_torch.models.loader import load_params
    from tests.test_torch_bridge import assert_trees_equal

    port_out = quantize_model(checkpoints["f32"], tmp_path / "t", device="cpu")
    jax_out = jquantize(checkpoints["f32"], tmp_path / "j")
    jp, _ = jload(port_out, float_dtype=jnp.float32)
    tp, cfg = load_params(jax_out, device="cpu", float_dtype=torch.float32)
    assert cfg.n_layers == 2 and tp["layers"][0]["wq"].fmt == "q4"
    assert_trees_equal(jp, tp)
