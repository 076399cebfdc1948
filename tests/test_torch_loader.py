"""The port's config parsing and load_params against jlama_tpu's, on tiny
float, bf16 and JQ4 checkpoints."""

import dataclasses
import json

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from tests.helpers import TINY_LLAMA_CONFIG, make_tiny_llama
from tests.test_torch_bridge import assert_trees_equal, port_tree, to_np


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    from jlama_tpu.quant.quantizer import quantize_model

    base = tmp_path_factory.mktemp("torch_loader")
    f32_dir, hf = make_tiny_llama(base / "f32")
    q4_dir = quantize_model(f32_dir, base / "jq4", quantize_to="q4")
    # a bf16 copy of the same weights
    from safetensors.torch import save_file

    bf_dir = base / "bf16"
    bf_dir.mkdir()
    sd = {k: v.to(torch.bfloat16).contiguous() for k, v in hf.state_dict().items()
          if "rotary" not in k}
    save_file(sd, bf_dir / "model.safetensors")
    (bf_dir / "config.json").write_text(json.dumps(TINY_LLAMA_CONFIG))
    return {"f32": f32_dir, "jq4": q4_dir, "bf16": bf_dir}


@pytest.mark.parametrize("kind", ["f32", "jq4", "bf16"])
def test_load_params_matches_jax(ckpts, kind):
    from jlama_tpu.models.loader import load_params as jload
    from jlama_tpu_torch.models.loader import load_params as tload
    from jlama_tpu_torch.nn.qarray import QArray

    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if kind == "bf16" else (jnp.float32, torch.float32)
    jp, jcfg = jload(ckpts[kind], float_dtype=jdt)
    tp, tcfg = tload(ckpts[kind], device="cpu", float_dtype=tdt)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert len(tp["layers"]) == tcfg.n_layers
    if kind == "jq4":
        assert isinstance(tp["layers"][0]["wq"], QArray)
        assert isinstance(tp["embed"], QArray)
    assert_trees_equal(jp, tp)
    # the bridge gives the same tree
    bridged = port_tree(jp)
    for k in ("embed", "final_norm.weight"):
        np.testing.assert_array_equal(to_np(bridged[k]), to_np(tp[k]))
    for a, b in zip(bridged["layers"], tp["layers"], strict=True):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], QArray):
                assert torch.equal(a[k].data, b[k].data) and torch.equal(a[k].scales, b[k].scales)
            else:
                assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])


@pytest.mark.parametrize("overrides", [
    {},
    {"model_type": "gemma", "hidden_size": 3072},
    {"model_type": "qwen2", "rope_scaling": {"type": "linear", "factor": 2.0}},
    {"model_type": "gemma2", "head_dim": 256, "query_pre_attn_scalar": 256,
     "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0, "sliding_window": 4096},
])
def test_config_matches_jax(overrides):
    from jlama_tpu.config import from_hf_config as jcfg
    from jlama_tpu_torch.config import from_hf_config as tcfg

    d = dict(TINY_LLAMA_CONFIG, **overrides)
    assert dataclasses.asdict(jcfg(d)) == dataclasses.asdict(tcfg(d))
    from jlama_tpu.models.init import llama_1b_config as j1, llama_8b_config as j8
    from jlama_tpu_torch.models.init import llama_1b_config as t1, llama_8b_config as t8

    assert dataclasses.asdict(j1()) == dataclasses.asdict(t1())
    assert dataclasses.asdict(j8()) == dataclasses.asdict(t8())
    # the port's Gemma-2-2B config (phase 11 of chip_smoke.py), parsed by both
    from jlama_tpu_torch.models.init import gemma2_2b_config

    g2 = gemma2_2b_config()
    assert dataclasses.asdict(jcfg(g2.raw)) == dataclasses.asdict(g2)
    assert (g2.head_size, g2.sliding_window, g2.attn_logit_softcap) == (256, 4096, 50.0)
