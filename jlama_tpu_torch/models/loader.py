"""Weight loading: HF safetensors checkpoints → per-layer torch param trees
(counterpart of `jlama_tpu/models/loader.py`, its Llama-family, Gemma 2 and
Mixtral maps).

Dtype handling as in the JAX package: F16 and BF16 widen to f32 on the host
and then take `float_dtype`; Q4 and I8 (+ `.qb` scales) become QArrays in the
checkpoint's layout; norms load as f32. Layers stay a per-layer list on the
chosen device; a Mixtral expert projection is one [E, out, in] leaf. The
other architectures' maps come in a later slice.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..config import ModelConfig, load_config
from ..device import resolve_device
from ..nn.qarray import QArray
from ..quant import blockq
from ..st import SafeTensorIndex, bf16_to_f32


def _to_np_float(arr: np.ndarray, st_dtype: str) -> np.ndarray:
    """F16/BF16 → F32 (exact); other dtypes as they are."""
    if st_dtype == "BF16":
        return bf16_to_f32(arr)
    if arr.dtype == np.float16:
        return arr.astype(np.float32)
    return arr


class WeightReader:
    """Reads possibly-quantized tensors from a SafeTensorIndex."""

    def __init__(self, idx: SafeTensorIndex, prefix: str = ""):
        self.idx = idx
        self.prefix = prefix

    def has(self, name: str) -> bool:
        return self.prefix + name in self.idx

    def load_linear(self, name: str):
        """("q4"|"q8", data, scales) when quantized, else ("f", f32-or-raw, None)."""
        data, scales, st_dtype = self.idx.load_quantized(self.prefix + name)
        if st_dtype == "Q4":
            return ("q4", np.ascontiguousarray(data), np.ascontiguousarray(scales))
        if st_dtype == "I8" and scales is not None:
            return ("q8", np.ascontiguousarray(data), np.ascontiguousarray(scales))
        return ("f", _to_np_float(np.ascontiguousarray(data), st_dtype), None)

    def load_float(self, name: str) -> np.ndarray:
        data, scales, st_dtype = self.idx.load_quantized(self.prefix + name)
        if st_dtype == "Q4":
            return blockq.q4_dequantize_np(data, scales)
        if st_dtype == "I8" and scales is not None:
            return blockq.q8_dequantize_np(data, scales)
        return _to_np_float(np.ascontiguousarray(data), st_dtype)


def _stack_linears(items: list[tuple]) -> list[tuple]:
    """Per-layer load_linear results, made uniform across layers as the JAX
    package's stacking makes them: one quantized format for all layers, or
    else (some layers skipped during quantization) f32 for all."""
    kinds = {k for k, _, _ in items}
    if kinds == {"f"} or (kinds <= {"q4", "q8"} and len(kinds) == 1):
        return items
    out = []
    for k, d, s in items:
        if k == "q4":
            d = blockq.q4_dequantize_np(d, s)
        elif k == "q8":
            d = blockq.q8_dequantize_np(d, s)
        out.append(("f", d, None))
    return out


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    # a copy: the arrays are read-only views over the checkpoint's mmap
    return torch.from_numpy(np.array(a)).to(device)


def _leaf(item: tuple, device, float_dtype):
    kind, data, scales = item
    if kind == "f":
        return _tensor(data, device).to(float_dtype)
    return QArray(_tensor(data, device), _tensor(scales, device).float(), kind)


def _llama_layer_map(prefix: str = "model.layers") -> dict[str, Callable]:
    def lin(name):
        return lambda r, i: r.load_linear(f"{prefix}.{i}.{name}.weight")

    def vec(name):
        return lambda r, i: r.load_float(f"{prefix}.{i}.{name}")

    return {
        "wq": lin("self_attn.q_proj"),
        "wk": lin("self_attn.k_proj"),
        "wv": lin("self_attn.v_proj"),
        "wo": lin("self_attn.o_proj"),
        "w1": lin("mlp.gate_proj"),
        "w2": lin("mlp.down_proj"),
        "w3": lin("mlp.up_proj"),
        "attn_norm.weight:np": vec("input_layernorm.weight"),
        "ff_norm.weight:np": vec("post_attention_layernorm.weight"),
        "wq.bias:np?": vec("self_attn.q_proj.bias"),
        "wk.bias:np?": vec("self_attn.k_proj.bias"),
        "wv.bias:np?": vec("self_attn.v_proj.bias"),
    }


def _gemma2_layer_map(prefix: str = "model.layers") -> dict[str, Callable]:
    """The Llama map with Gemma 2's four norms
    (`jlama_tpu/models/loader.py:_gemma2_layer_map`): HF's
    `post_attention_layernorm` is the norm after attention, not the FFN's
    pre-norm, which is `pre_feedforward_layernorm`."""
    m = _llama_layer_map(prefix)

    def vec(name):
        return lambda r, i: r.load_float(f"{prefix}.{i}.{name}")

    m["post_attn_norm.weight:np"] = vec("post_attention_layernorm.weight")
    m["ff_norm.weight:np"] = vec("pre_feedforward_layernorm.weight")
    m["post_ff_norm.weight:np"] = vec("post_feedforward_layernorm.weight")
    return m


def _mixtral_layer_map(n_experts: int, prefix: str = "model.layers") -> dict[str, Callable]:
    """The Llama map with the MLP replaced by the sparse MoE block
    (`jlama_tpu/models/loader.py:_mixtral_layer_map`): `router` from the
    gate, and each expert projection stacked over the experts into one
    [E, out, in] leaf, made uniform across the experts first."""
    m = _llama_layer_map(prefix)
    for k in ("w1", "w2", "w3"):
        m.pop(k)

    def expert_stack(wname):
        def f(r, i):
            items = _stack_linears([
                r.load_linear(f"{prefix}.{i}.block_sparse_moe.experts.{e}.{wname}.weight")
                for e in range(n_experts)
            ])
            kind = items[0][0]
            return (kind, np.stack([d for _, d, _ in items]),
                    None if kind == "f" else np.stack([s for _, _, s in items]))

        return f

    m["experts.w1"] = expert_stack("w1")
    m["experts.w2"] = expert_stack("w2")
    m["experts.w3"] = expert_stack("w3")
    m["router"] = lambda r, i: r.load_linear(f"{prefix}.{i}.block_sparse_moe.gate.weight")
    return m


LLAMA_FAMILY = ("llama", "mistral", "qwen2", "granite", "gemma", "gemma2")

TOPLEVEL_MAP = {
    # our key -> hf name ("?" suffix = optional)
    "embed": "model.embed_tokens.weight",
    "final_norm.weight:np": "model.norm.weight",
    "lm_head": "lm_head.weight?",
}


def load_params(
    model_dir: str | Path,
    cfg: ModelConfig | None = None,
    device=None,
    float_dtype=torch.bfloat16,
) -> tuple[dict, ModelConfig]:
    """Load a local model directory into (params, cfg) on `device` (CUDA
    unless the caller names one; raises without CUDA and without a device)."""
    device = resolve_device(device)
    model_dir = Path(model_dir)
    if cfg is None:
        cfg = load_config(model_dir)
    if cfg.model_type not in LLAMA_FAMILY + ("mixtral",):
        raise NotImplementedError(
            f"{cfg.model_type}: only the Llama-family and Mixtral loaders are ported"
        )
    idx = SafeTensorIndex(model_dir)
    try:
        r = WeightReader(idx)
        params: dict = {}
        for key, hf_name in TOPLEVEL_MAP.items():
            hf = hf_name.rstrip("?")
            if not r.has(hf):
                if hf_name.endswith("?"):
                    continue
                raise KeyError(f"missing tensor {hf!r}")
            if key.endswith(":np"):
                arr = r.load_float(hf).astype(np.float32)
                params[key[: -len(":np")]] = _tensor(arr, device)
            else:
                params[key] = _leaf(r.load_linear(hf), device, float_dtype)

        layers: list[dict] = [{} for _ in range(cfg.n_layers)]
        layer_map = (_mixtral_layer_map(cfg.n_experts) if cfg.model_type == "mixtral"
                     else _gemma2_layer_map() if cfg.model_type == "gemma2"
                     else _llama_layer_map())
        for key, fn in layer_map.items():
            optional = key.endswith("?")
            key_clean = key.replace(":np", "").rstrip("?")
            try:
                items = [fn(r, i) for i in range(cfg.n_layers)]
            except KeyError:
                if optional:
                    continue
                raise
            if ":np" in key:
                for i, a in enumerate(items):
                    layers[i][key_clean] = _tensor(a.astype(np.float32), device)
            else:
                for i, item in enumerate(_stack_linears(items)):
                    layers[i][key_clean] = _leaf(item, device, float_dtype)
        params["layers"] = layers
    finally:
        idx.close()
    return params, cfg
