"""Random parameter initialization (counterpart of `jlama_tpu/models/init.py`).

`init_params` builds the loader's per-layer layout from a numpy generator
(std 0.02, optionally JQ4-quantized), like the JAX package. `random_q4_params`
is the fast on-device random JQ4 init for full-width runs: random packed
nibbles and small random f32 scales drawn directly on the device from a
seeded `torch.Generator`. A MoE config (`cfg.n_experts`) gets the JAX
package's expert layout (`jlama_tpu/models/init.py:51-55`) in place of w1,
w2, w3: a float `router` [E, D] and the expert stacks `experts.w1`,
`experts.w3` [E, H, D] and `experts.w2` [E, D, H], q4 where the rest is.

GPT-2 and BERT (learned positions) get the loader's layout for them: a
two-layer MLP (w1, w2, no w3), LayerNorms with biases, biases on every
projection, `wpe`, and for BERT the token types, the embedding norm, no
final norm, the pooler and, with labels, the classifier. Their norm
weights, biases and position rows are drawn away from the ones and zeros a
fresh model starts with, so that a bias or a norm in the wrong slot shows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import ModelConfig, from_hf_config
from ..device import resolve_device
from ..nn.qarray import QArray
from ..quant import blockq


def _shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The layer's projections: [out, in], and [E, out, in] for experts."""
    D, H = cfg.embedding_length, cfg.hidden_length
    qdim = cfg.n_heads * cfg.head_size
    kvdim = cfg.n_kv_heads * cfg.head_size
    out = {"wq": (qdim, D), "wk": (kvdim, D), "wv": (kvdim, D), "wo": (D, qdim)}
    if cfg.n_experts:
        E = cfg.n_experts
        out.update({"experts.w1": (E, H, D), "experts.w2": (E, D, H), "experts.w3": (E, H, D)})
    elif cfg.mlp_bias:  # gpt2/bert: the two-layer MLP
        out.update({"w1": (H, D), "w2": (D, H)})
    else:
        out.update({"w1": (H, D), "w2": (D, H), "w3": (H, D)})
    return out


def _bias_shapes(cfg: ModelConfig) -> dict[str, int]:
    """The layer's projection biases: q/k/v (qwen2, gpt2, bert), and wo, w1,
    w2 where the config has them (gpt2, bert)."""
    shapes = _shapes(cfg)
    names = ["wq", "wk", "wv"] * cfg.attn_qkv_bias + ["wo"] * cfg.attn_out_bias \
        + ["w1", "w2"] * cfg.mlp_bias
    return {f"{k}.bias": shapes[k][0] for k in names}


def _norms_and_biases(cfg: ModelConfig, device, draw=None) -> dict:
    """A layer's norm weights (the pre-norms, and Gemma 2's post-norms; with
    LayerNorm their biases too) and its projection biases, f32. draw(n, base)
    gives n values around base; None gives base itself (ones and zeros)."""
    D = cfg.embedding_length
    names = ["attn_norm", "ff_norm"] + ["post_attn_norm"] * cfg.post_attn_norm \
        + ["post_ff_norm"] * cfg.post_ff_norm

    def vec(n, base):
        if draw is None:
            return torch.full((n,), float(base), dtype=torch.float32, device=device)
        return draw(n, base)

    out = {f"{n}.weight": vec(D, 1.0) for n in names}
    if cfg.norm_type == "layernorm":
        out.update({f"{n}.bias": vec(D, 0.0) for n in names})
    out.update({k: vec(n, 0.0) for k, n in _bias_shapes(cfg).items()})
    return out


def _top_level(cfg: ModelConfig, device, draw=None) -> dict:
    """The top-level leaves besides the embedding and the lm_head: the final
    norm (none for BERT), and for learned positions `wpe`, BERT's token types,
    embedding norm, pooler ([D, D] f32: a plain product, as in the JAX
    package) and, with labels, its classifier."""
    D = cfg.embedding_length

    def vec(*shape, base):
        if draw is None:
            return torch.full(shape, float(base), dtype=torch.float32, device=device)
        return draw(math.prod(shape), base).reshape(shape)

    out = {}
    if cfg.model_type != "bert":
        out["final_norm.weight"] = vec(D, base=1.0)
        if cfg.norm_type == "layernorm":
            out["final_norm.bias"] = vec(D, base=0.0)
    if cfg.learned_pos_embeddings:
        out["wpe"] = vec(cfg.context_length, D, base=0.0)
    if cfg.model_type == "bert":
        out["token_type_embed"] = vec(cfg.type_vocab_size, D, base=0.0)
        out["embed_norm.weight"] = vec(D, base=1.0)
        out["embed_norm.bias"] = vec(D, base=0.0)
        out["pooler.weight"] = vec(D, D, base=0.0) * 0.2  # std 0.02, as the matrices
        out["pooler.bias"] = vec(D, base=0.0)
        if cfg.classification_labels:
            n = len(cfg.classification_labels)
            out["classifier.weight"] = vec(n, D, base=0.0) * 0.2
            out["classifier.bias"] = vec(n, base=0.0)
    return out


def init_params(
    cfg: ModelConfig,
    seed: int = 0,
    dtype=torch.bfloat16,
    quantize: str | None = "q4",  # None | "q4"
    device=None,
) -> dict:
    """Random-normal params (std 0.02) in the loader's layout."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    D, V = cfg.embedding_length, cfg.vocab_size

    def w(*shape):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(0.02)
        return a

    def linear_leaf(*shape):
        a = w(*shape)
        if quantize == "q4":
            packed, scales = blockq.q4_quantize_np(a)
            return QArray(torch.from_numpy(packed).to(device),
                          torch.from_numpy(scales).to(device), "q4")
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    def draw(n, base):  # learned-position models: around base, std 0.1
        a = rng.standard_normal(n, dtype=np.float32) * np.float32(0.1) + np.float32(base)
        return torch.from_numpy(a).to(device)

    away = draw if cfg.learned_pos_embeddings else None
    layers = []
    for _ in range(cfg.n_layers):
        layer = {k: linear_leaf(*s) for k, s in _shapes(cfg).items()}
        if cfg.n_experts:
            layer["router"] = torch.from_numpy(w(cfg.n_experts, D)).to(device=device,
                                                                       dtype=dtype)
        layer.update(_norms_and_biases(cfg, device, away))
        layers.append(layer)

    params: dict = {
        "embed": torch.from_numpy(w(V, D)).to(device=device, dtype=dtype),
        "layers": layers,
    }
    params.update(_top_level(cfg, device, away))
    if not cfg.tie_word_embeddings and cfg.model_type != "bert":  # bert has no lm_head
        params["lm_head"] = torch.from_numpy(w(V, D)).to(device=device, dtype=dtype)
    return params


def random_q4_params(cfg: ModelConfig, seed: int = 0, device=None,
                     layers: tuple[int, int] | None = None) -> dict:
    """Fast on-device random JQ4 weights at a config's full width.

    Every matrix, the embedding table included (which a tied lm_head then
    reads as it is), is a q4 QArray of uniform random nibbles with f32 block
    scales uniform in [0.5, 1.5] x 0.0043, so weights have std ≈ 0.02; norms
    are ones (Gemma 2's post-norms too), q/k/v biases zeros where the config
    has them, as `init_params` makes them. A MoE router is bf16 normal with
    std 0.02; the expert stacks are drawn one expert matrix at a time into
    their [E, N, K] tensors. Learned-position models (GPT-2, BERT) draw their
    norm weights, biases, `wpe`, token types and heads as normals of std 0.1
    around their ones and zeros, after every matrix of their layer; the
    draws of every other config are as they were. With `layers` = (lo, hi)
    the tree keeps only those layers (a pipeline stage's), every value as
    the whole draw's: the other layers are drawn one at a time and
    dropped."""
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    D = cfg.embedding_length

    def q4_matrix(n, k):
        data = torch.randint(0, 256, (n, k // 2), generator=g, device=device,
                             dtype=torch.uint8)
        scales = torch.rand((n, k // 32), generator=g, device=device) + 0.5
        return QArray(data, scales * 0.0043, "q4")

    def q4(*shape):
        *lead, n, k = shape
        if not lead:
            return q4_matrix(n, k)
        data = torch.empty((*lead, n, k // 2), dtype=torch.uint8, device=device)
        scales = torch.empty((*lead, n, k // 32), dtype=torch.float32, device=device)
        for d, s in zip(data.reshape(-1, n, k // 2), scales.reshape(-1, n, k // 32)):
            m = q4_matrix(n, k)
            d.copy_(m.data)
            s.copy_(m.scales)
        return QArray(data, scales, "q4")

    def draw(n, base):  # learned-position models: around base, std 0.1
        return torch.randn((n,), generator=g, device=device) * 0.1 + base

    away = draw if cfg.learned_pos_embeddings else None
    lo, hi = layers or (0, cfg.n_layers)
    out_layers = []
    for i in range(cfg.n_layers):
        layer = {k: q4(*s) for k, s in _shapes(cfg).items()}
        if cfg.n_experts:
            layer["router"] = (torch.randn((cfg.n_experts, D), generator=g, device=device)
                               * 0.02).to(torch.bfloat16)
        layer.update(_norms_and_biases(cfg, device, away))
        if lo <= i < hi:
            out_layers.append(layer)
        del layer
    params = {"embed": q4(cfg.vocab_size, D), "layers": out_layers}
    params.update(_top_level(cfg, device, away))
    if not cfg.tie_word_embeddings and cfg.model_type != "bert":  # bert has no lm_head
        params["lm_head"] = q4(cfg.vocab_size, D)
    return params


def random_float_params(cfg: ModelConfig, seed: int = 0, device=None,
                        dtype=torch.bfloat16) -> dict:
    """`random_q4_params`'s weights dequantized to `dtype`, leaf by leaf (each
    q4 leaf freed once converted): a float model at a config's full width
    (for a MoE config, float experts), drawn on the device from the seed.
    Norms and the router stay as `random_q4_params` makes them (f32 and
    bf16), as the loader gives a bf16 checkpoint's."""
    params = random_q4_params(cfg, seed, device)

    def deq(tree):
        for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
            if isinstance(v, (dict, list)):
                deq(v)
            elif isinstance(v, QArray):
                tree[k] = v.dequantize(dtype)
                del v

    deq(params)
    return params


def llama_1b_config() -> ModelConfig:
    """Llama-3.2-1B-Instruct shapes."""
    return from_hf_config(llama_1b_hf_config())


def llama_1b_hf_config() -> dict:
    """Llama-3.2-1B-Instruct's config.json (`meta-llama/Llama-3.2-1B-Instruct`)."""
    return {
        "model_type": "llama",
        "hidden_size": 2048,
        "intermediate_size": 8192,
        "num_attention_heads": 32,
        "num_key_value_heads": 8,
        "num_hidden_layers": 16,
        "head_dim": 64,
        "rms_norm_eps": 1e-5,
        "vocab_size": 128256,
        "max_position_embeddings": 131072,
        "rope_theta": 500000.0,
        "rope_scaling": {
            "rope_type": "llama3",
            "factor": 32.0,
            "low_freq_factor": 1.0,
            "high_freq_factor": 4.0,
            "original_max_position_embeddings": 8192,
        },
        "bos_token_id": 128000,
        "eos_token_id": [128001, 128008, 128009],
        "hidden_act": "silu",
        "tie_word_embeddings": True,
    }


def llama_8b_config() -> ModelConfig:
    """Llama-3.1-8B shapes."""
    return from_hf_config(
        {
            "model_type": "llama",
            "hidden_size": 4096,
            "intermediate_size": 14336,
            "num_attention_heads": 32,
            "num_key_value_heads": 8,
            "num_hidden_layers": 32,
            "rms_norm_eps": 1e-5,
            "vocab_size": 128256,
            "max_position_embeddings": 131072,
            "rope_theta": 500000.0,
            "bos_token_id": 128000,
            "eos_token_id": 128009,
            "hidden_act": "silu",
            "tie_word_embeddings": False,
        }
    )


def mixtral_8x7b_config() -> ModelConfig:
    """mistralai/Mixtral-8x7B-v0.1 shapes (its published config.json)."""
    return from_hf_config(
        {
            "model_type": "mixtral",
            "hidden_size": 4096,
            "intermediate_size": 14336,
            "num_attention_heads": 32,
            "num_key_value_heads": 8,
            "num_hidden_layers": 32,
            "head_dim": 128,
            "rms_norm_eps": 1e-5,
            "vocab_size": 32000,
            "max_position_embeddings": 32768,
            "rope_theta": 1e6,
            "num_local_experts": 8,
            "num_experts_per_tok": 2,
            "sliding_window": None,
            "bos_token_id": 1,
            "eos_token_id": 2,
            "hidden_act": "silu",
            "tie_word_embeddings": False,
        }
    )


def gemma2_2b_config() -> ModelConfig:
    """google/gemma-2-2b shapes (its published config.json): head size 256,
    a 4096-key window on the even layers, attention and final softcaps."""
    return from_hf_config(
        {
            "model_type": "gemma2",
            "hidden_size": 2304,
            "intermediate_size": 9216,
            "num_attention_heads": 8,
            "num_key_value_heads": 4,
            "num_hidden_layers": 26,
            "head_dim": 256,
            "rms_norm_eps": 1e-6,
            "vocab_size": 256000,
            "max_position_embeddings": 8192,
            "rope_theta": 10000.0,
            "sliding_window": 4096,
            "query_pre_attn_scalar": 256,
            "attn_logit_softcapping": 50.0,
            "final_logit_softcapping": 30.0,
            "bos_token_id": 2,
            "eos_token_id": 1,
            "hidden_activation": "gelu_pytorch_tanh",
            "tie_word_embeddings": True,
        }
    )


def gpt2_config() -> ModelConfig:
    """openai-community/gpt2 shapes (its published config.json): 12 layers,
    n_embd 768, 12 heads of 64, FFN 3072, vocabulary 50,257, 1,024 learned
    positions, gelu_new, LayerNorm eps 1e-5, tied lm_head."""
    return from_hf_config(
        {
            "model_type": "gpt2",
            "n_embd": 768,
            "n_head": 12,
            "n_layer": 12,
            "n_positions": 1024,
            "n_inner": None,
            "vocab_size": 50257,
            "layer_norm_epsilon": 1e-5,
            "activation_function": "gelu_new",
            "bos_token_id": 50256,
            "eos_token_id": 50256,
        }
    )


def bert_base_config() -> ModelConfig:
    """google-bert/bert-base-uncased shapes (its published config.json): 12
    layers, hidden 768, 12 heads of 64, intermediate 3072, vocabulary 30,522,
    512 positions, 2 token types, gelu, LayerNorm eps 1e-12; with a 2-label
    `id2label`, as a sequence-classification fine-tune carries one."""
    return from_hf_config(
        {
            "model_type": "bert",
            "hidden_size": 768,
            "num_attention_heads": 12,
            "num_hidden_layers": 12,
            "intermediate_size": 3072,
            "vocab_size": 30522,
            "max_position_embeddings": 512,
            "type_vocab_size": 2,
            "layer_norm_eps": 1e-12,
            "hidden_act": "gelu",
            "id2label": {"0": "LABEL_0", "1": "LABEL_1"},
        }
    )
