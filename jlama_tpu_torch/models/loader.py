"""Weight loading: HF safetensors checkpoints → per-layer torch param trees
(counterpart of `jlama_tpu/models/loader.py`: its Llama-family, Gemma 2,
Mixtral, GPT-2 and BERT maps).

Dtype handling as in the JAX package: F16 and BF16 widen to f32 on the host
and then take `float_dtype`; Q4 and I8 (+ `.qb` scales) become QArrays in the
checkpoint's layout; norms load as f32. Layers stay a per-layer list on the
chosen device; a Mixtral expert projection is one [E, out, in] leaf.

GPT-2 as in the JAX package: its Conv1D matrices ([in, out]) are transposed
and the fused `c_attn` split three ways, bias too, and every layer matrix
goes through `load_float` (a JQ4 checkpoint's layers come back dequantized);
only `wte` may stay q4. Checkpoint name prefixes (`bert.`, `transformer.`)
are probed; a BERT classifier head loads in f32.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import ModelConfig, load_config
from ..device import resolve_device
from ..nn.qarray import QArray
from ..quant import blockq
from ..st import SafeTensorIndex, bf16_to_f32, is_url, open_weights


def _to_np_float(arr: np.ndarray, st_dtype: str) -> np.ndarray:
    """F16/BF16 → F32 (exact); other dtypes as they are."""
    if st_dtype == "BF16":
        return bf16_to_f32(arr)
    if arr.dtype == np.float16:
        return arr.astype(np.float32)
    return arr


class Cut(NamedTuple):
    """A tp rank's part of a tensor: `axis` "rows" (the second-to-last
    dimension: a column-parallel weight), "cols" (the last: a row-parallel
    weight's inputs, or a 1-D bias), "vocab" (rows where tp divides them,
    else the whole table) or "experts" (axis 0 of an expert stack, which
    the Mixtral map reads expert by expert); None: the whole tensor."""

    axis: str | None = None
    tp: int = 1
    rank: int = 0

    def span(self, n: int, what: str) -> tuple[int, int]:
        if n % self.tp:
            raise ValueError(f"{what}: dimension of size {n} does not divide over "
                             f"tp={self.tp}")
        per = n // self.tp
        return self.rank * per, (self.rank + 1) * per


WHOLE = Cut()


class WeightReader:
    """Reads possibly-quantized tensors from a SafeTensorIndex, whole or a
    tp rank's `Cut` of them (only that slice is read)."""

    def __init__(self, idx: SafeTensorIndex, prefix: str = ""):
        self.idx = idx
        self.prefix = prefix

    def has(self, name: str) -> bool:
        return self.prefix + name in self.idx

    def _ranges(self, name: str, cut: Cut):
        """(row_range, col_range) of a cut of the tensor `name`."""
        if cut.axis is None or cut.tp == 1:
            return None, None
        ti = self.idx.info(self.prefix + name)
        if cut.axis == "cols":
            k = ti.shape[-1]
            if self.prefix + name + ".qb" in self.idx and (k // cut.tp) % 32:
                # each rank's input slice must hold whole 32-element blocks
                raise ValueError(f"{name}: {k // 32} blocks of 32 inputs do not divide over "
                                 f"tp={cut.tp}")
            return None, cut.span(k, name)
        if cut.axis == "rows" or (cut.axis == "vocab" and ti.shape[-2] % cut.tp == 0):
            return cut.span(ti.shape[-2], name), None
        if cut.axis == "vocab":
            return None, None
        raise ValueError(f"{name}: no {cut.axis!r} cut of one tensor")

    def load_linear(self, name: str, cut: Cut = WHOLE):
        """("q4"|"q8", data, scales) when quantized, else ("f", f32-or-raw, None)."""
        data, scales, st_dtype = self.idx.load_quantized(self.prefix + name,
                                                         *self._ranges(name, cut))
        if st_dtype == "Q4":
            return ("q4", np.ascontiguousarray(data), np.ascontiguousarray(scales))
        if st_dtype == "I8" and scales is not None:
            return ("q8", np.ascontiguousarray(data), np.ascontiguousarray(scales))
        return ("f", _to_np_float(np.ascontiguousarray(data), st_dtype), None)

    def load_float(self, name: str, cut: Cut = WHOLE) -> np.ndarray:
        data, scales, st_dtype = self.idx.load_quantized(self.prefix + name,
                                                         *self._ranges(name, cut))
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
        return lambda r, i, c=WHOLE: r.load_linear(f"{prefix}.{i}.{name}.weight", c)

    def vec(name):
        return lambda r, i, c=WHOLE: r.load_float(f"{prefix}.{i}.{name}", c)

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
        return lambda r, i, c=WHOLE: r.load_float(f"{prefix}.{i}.{name}", c)

    m["post_attn_norm.weight:np"] = vec("post_attention_layernorm.weight")
    m["ff_norm.weight:np"] = vec("pre_feedforward_layernorm.weight")
    m["post_ff_norm.weight:np"] = vec("post_feedforward_layernorm.weight")
    return m


def _mixtral_layer_map(n_experts: int, prefix: str = "model.layers") -> dict[str, Callable]:
    """The Llama map with the MLP replaced by the sparse MoE block
    (`jlama_tpu/models/loader.py:_mixtral_layer_map`): `router` from the
    gate, and each expert projection stacked over the experts into one
    [E, out, in] leaf, made uniform across the experts first. An "experts"
    cut reads a tp rank's E/tp experts only (expert parallelism)."""
    m = _llama_layer_map(prefix)
    for k in ("w1", "w2", "w3"):
        m.pop(k)

    def expert_stack(wname):
        def f(r, i, c=WHOLE):
            e0, e1 = (c.span(n_experts, f"layers[{i}].experts.{wname}")
                      if c.axis == "experts" else (0, n_experts))
            items = _stack_linears([
                r.load_linear(f"{prefix}.{i}.block_sparse_moe.experts.{e}.{wname}.weight")
                for e in range(e0, e1)
            ])
            kind = items[0][0]
            return (kind, np.stack([d for _, d, _ in items]),
                    None if kind == "f" else np.stack([s for _, _, s in items]))

        return f

    m["experts.w1"] = expert_stack("w1")
    m["experts.w2"] = expert_stack("w2")
    m["experts.w3"] = expert_stack("w3")
    m["router"] = lambda r, i, c=WHOLE: r.load_linear(
        f"{prefix}.{i}.block_sparse_moe.gate.weight")
    return m


def _gpt2_layer_map(d: int) -> dict[str, Callable]:
    """`jlama_tpu/models/loader.py:_gpt2_layer_map`: Conv1D weights [in, out]
    transposed to [out, in], `c_attn` [D, 3D] split into q, k, v, each bias
    sliced the same way; all through `load_float`."""

    def convt(name):
        return lambda r, i, c=WHOLE: ("f", np.ascontiguousarray(
            r.load_float(f"h.{i}.{name}.weight").T), None)

    def qkv(which):
        return lambda r, i, c=WHOLE: ("f", np.ascontiguousarray(
            r.load_float(f"h.{i}.attn.c_attn.weight")[:, which * d:(which + 1) * d].T), None)

    def vec(name, split=None):
        def f(r, i, c=WHOLE):
            b = r.load_float(f"h.{i}.{name}")
            return b if split is None else np.ascontiguousarray(b[split * d:(split + 1) * d])

        return f

    return {
        "wq": qkv(0),
        "wk": qkv(1),
        "wv": qkv(2),
        "wo": convt("attn.c_proj"),
        "w1": convt("mlp.c_fc"),
        "w2": convt("mlp.c_proj"),
        "wq.bias:np?": vec("attn.c_attn.bias", 0),
        "wk.bias:np?": vec("attn.c_attn.bias", 1),
        "wv.bias:np?": vec("attn.c_attn.bias", 2),
        "wo.bias:np?": vec("attn.c_proj.bias"),
        "w1.bias:np?": vec("mlp.c_fc.bias"),
        "w2.bias:np?": vec("mlp.c_proj.bias"),
        "attn_norm.weight:np": vec("ln_1.weight"),
        "attn_norm.bias:np": vec("ln_1.bias"),
        "ff_norm.weight:np": vec("ln_2.weight"),
        "ff_norm.bias:np": vec("ln_2.bias"),
    }


def _bert_layer_map(prefix: str = "encoder.layer") -> dict[str, Callable]:
    """`jlama_tpu/models/loader.py:_bert_layer_map`: the post-norm encoder's
    attention norm is `attention.output.LayerNorm`, its FFN norm
    `output.LayerNorm`."""

    def lin(name):
        return lambda r, i, c=WHOLE: r.load_linear(f"{prefix}.{i}.{name}.weight", c)

    def vec(name):
        return lambda r, i, c=WHOLE: r.load_float(f"{prefix}.{i}.{name}", c)

    return {
        "wq": lin("attention.self.query"),
        "wk": lin("attention.self.key"),
        "wv": lin("attention.self.value"),
        "wo": lin("attention.output.dense"),
        "w1": lin("intermediate.dense"),
        "w2": lin("output.dense"),
        "wq.bias:np?": vec("attention.self.query.bias"),
        "wk.bias:np?": vec("attention.self.key.bias"),
        "wv.bias:np?": vec("attention.self.value.bias"),
        "wo.bias:np?": vec("attention.output.dense.bias"),
        "w1.bias:np?": vec("intermediate.dense.bias"),
        "w2.bias:np?": vec("output.dense.bias"),
        "attn_norm.weight:np": vec("attention.output.LayerNorm.weight"),
        "attn_norm.bias:np": vec("attention.output.LayerNorm.bias"),
        "ff_norm.weight:np": vec("output.LayerNorm.weight"),
        "ff_norm.bias:np": vec("output.LayerNorm.bias"),
    }


LLAMA_FAMILY = ("llama", "mistral", "qwen2", "granite", "gemma", "gemma2")

TOPLEVEL_MAPS = {
    # our key -> hf name ("?" suffix = optional)
    "llama": {
        "embed": "model.embed_tokens.weight",
        "final_norm.weight:np": "model.norm.weight",
        "lm_head": "lm_head.weight?",
    },
    "gpt2": {
        "embed": "wte.weight",
        "wpe:np": "wpe.weight",
        "final_norm.weight:np": "ln_f.weight",
        "final_norm.bias:np": "ln_f.bias",
    },
    "bert": {
        "embed": "embeddings.word_embeddings.weight",
        "wpe:np": "embeddings.position_embeddings.weight",
        "token_type_embed:np": "embeddings.token_type_embeddings.weight",
        "embed_norm.weight:np": "embeddings.LayerNorm.weight",
        "embed_norm.bias:np": "embeddings.LayerNorm.bias",
        "pooler.weight": "pooler.dense.weight?",
        "pooler.bias:np": "pooler.dense.bias?",
    },
}
for _a in LLAMA_FAMILY + ("mixtral",):
    TOPLEVEL_MAPS[_a] = TOPLEVEL_MAPS["llama"]
# the probe of `_strip_prefix`: a tensor every checkpoint of the family has
_PROBE = {"gpt2": "wte.weight", "bert": "embeddings.word_embeddings.weight"}


def _strip_prefix(idx: SafeTensorIndex, cfg: ModelConfig) -> str:
    """The checkpoint's name prefix ('bert.', 'transformer.' or none), as
    `jlama_tpu/models/loader.py:_strip_prefix` finds it."""
    names = set(idx.names())
    for pref in ("bert.", "transformer.", ""):
        if pref + _PROBE.get(cfg.model_type, "model.embed_tokens.weight") in names:
            return pref
    return ""


def _layer_map(cfg: ModelConfig) -> dict[str, Callable]:
    if cfg.model_type == "mixtral":
        return _mixtral_layer_map(cfg.n_experts)
    if cfg.model_type == "gemma2":
        return _gemma2_layer_map()
    if cfg.model_type == "gpt2":
        return _gpt2_layer_map(cfg.embedding_length)
    if cfg.model_type == "bert":
        return _bert_layer_map()
    return _llama_layer_map()


def read_tree(idx, cfg: ModelConfig, device, float_dtype=torch.bfloat16,
              cut_of: Callable[[str], Cut] | None = None,
              layers: tuple[int, int] | None = None) -> dict:
    """The param tree of an open index (local or HTTP) on `device`, each
    leaf whole or, with `cut_of` (our key -> its Cut), a tp rank's cut of
    it, of which only the slice is read; with `layers` = (lo, hi) only
    those layers are read (a pipeline stage's), the top-level leaves whole
    or cut as without."""
    if cfg.model_type not in TOPLEVEL_MAPS:
        raise NotImplementedError(f"{cfg.model_type}: no loader map")
    cut_of = cut_of or (lambda key: WHOLE)
    r = WeightReader(idx, _strip_prefix(idx, cfg))
    bare = WeightReader(idx)  # tensors outside the prefix (a top-level lm_head)
    params: dict = {}
    for key, hf_name in TOPLEVEL_MAPS[cfg.model_type].items():
        hf = hf_name.rstrip("?")
        src = r if r.has(hf) else bare if bare.has(hf) else None
        if src is None:
            if hf_name.endswith("?"):
                continue
            raise KeyError(f"missing tensor {hf!r} (prefix {r.prefix!r})")
        if key.endswith(":np"):
            arr = src.load_float(hf).astype(np.float32)
            params[key[: -len(":np")]] = _tensor(arr, device)
        else:
            params[key] = _leaf(src.load_linear(hf, cut_of(key)), device, float_dtype)

    lo, hi = layers or (0, cfg.n_layers)
    out_layers: list[dict] = [{} for _ in range(lo, hi)]
    for key, fn in _layer_map(cfg).items():
        optional = key.endswith("?")
        key_clean = key.replace(":np", "").rstrip("?")
        cut = cut_of(key_clean)
        try:
            items = [fn(r, i, cut) for i in range(lo, hi)]
        except KeyError:
            if optional:
                continue
            raise
        if ":np" in key:
            for i, a in enumerate(items):
                out_layers[i][key_clean] = _tensor(a.astype(np.float32), device)
        else:
            for i, item in enumerate(_stack_linears(items)):
                out_layers[i][key_clean] = _leaf(item, device, float_dtype)
    params["layers"] = out_layers
    if cfg.model_type == "bert":  # the sequence-classification head, f32
        for name in ("classifier.weight", "classifier.bias"):
            if bare.has(name):
                params[name] = _tensor(bare.load_float(name).astype(np.float32), device)
    return params


def load_params(
    model_dir: str | Path,
    cfg: ModelConfig | None = None,
    device=None,
    float_dtype=torch.bfloat16,
) -> tuple[dict, ModelConfig]:
    """Load a model directory, or a model URL (`http(s)://`, its tensors
    fetched by ranged requests), into (params, cfg) on `device` (CUDA unless
    the caller names one; raises without CUDA and without a device). A
    mesh rank reads only its stage's layers, cut to its tp slice, through
    `parallel.distributed.load_params_sharded` (`read_tree`'s `layers` and
    `cut_of`)."""
    device = resolve_device(device)
    if not is_url(model_dir):
        model_dir = Path(model_dir)
    if cfg is None:
        cfg = load_config(model_dir)
    if cfg.model_type not in TOPLEVEL_MAPS:
        raise NotImplementedError(f"{cfg.model_type}: no loader map")
    idx = open_weights(model_dir)
    try:
        params = read_tree(idx, cfg, device, float_dtype)
    finally:
        idx.close()
    return params, cfg
