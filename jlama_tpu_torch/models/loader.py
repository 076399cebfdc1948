"""Weight loading: HF safetensors checkpoints → per-layer torch param trees
(counterpart of `jlama_tpu/models/loader.py`, Llama-family map).

Dtype handling as in the JAX package: F16 and BF16 widen to f32 on the host
and then take `float_dtype`; Q4 and I8 (+ `.qb` scales) become QArrays in the
checkpoint's layout; norms load as f32. Layers stay a per-layer list on the
chosen device. The other architectures' maps come in a later slice.
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


LLAMA_FAMILY = ("llama", "mistral", "qwen2", "granite", "gemma")

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
    if cfg.model_type not in LLAMA_FAMILY:
        raise NotImplementedError(
            f"{cfg.model_type}: only the Llama-family loader is ported"
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
        for key, fn in _llama_layer_map().items():
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
