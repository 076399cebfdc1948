"""Random parameter initialization (counterpart of `jlama_tpu/models/init.py`).

`init_params` builds the loader's per-layer layout from a numpy generator
(std 0.02, optionally JQ4-quantized), like the JAX package. `random_q4_params`
is the fast on-device random JQ4 init for full-width runs: random packed
nibbles and small random f32 scales drawn directly on the device from a
seeded `torch.Generator`. A MoE config (`cfg.n_experts`) gets the JAX
package's expert layout (`jlama_tpu/models/init.py:51-55`) in place of w1,
w2, w3: a float `router` [E, D] and the expert stacks `experts.w1`,
`experts.w3` [E, H, D] and `experts.w2` [E, D, H], q4 where the rest is.
"""

from __future__ import annotations

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
    else:
        out.update({"w1": (H, D), "w2": (D, H), "w3": (H, D)})
    return out


def _norms_and_biases(cfg: ModelConfig, device) -> dict:
    """A layer's norm weights (ones, f32: the pre-norms, and Gemma 2's
    post-norms) and, where the config has them, zero q/k/v biases."""
    D = cfg.embedding_length
    names = ["attn_norm", "ff_norm"] + ["post_attn_norm"] * cfg.post_attn_norm \
        + ["post_ff_norm"] * cfg.post_ff_norm
    out = {f"{n}.weight": torch.ones(D, dtype=torch.float32, device=device) for n in names}
    if cfg.attn_qkv_bias:
        for k in ("wq", "wk", "wv"):
            out[k + ".bias"] = torch.zeros(_shapes(cfg)[k][0], device=device)
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

    layers = []
    for _ in range(cfg.n_layers):
        layer = {k: linear_leaf(*s) for k, s in _shapes(cfg).items()}
        if cfg.n_experts:
            layer["router"] = torch.from_numpy(w(cfg.n_experts, D)).to(device=device,
                                                                       dtype=dtype)
        layer.update(_norms_and_biases(cfg, device))
        layers.append(layer)

    params: dict = {
        "embed": torch.from_numpy(w(V, D)).to(device=device, dtype=dtype),
        "layers": layers,
        "final_norm.weight": torch.ones(D, dtype=torch.float32, device=device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = torch.from_numpy(w(V, D)).to(device=device, dtype=dtype)
    return params


def random_q4_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Fast on-device random JQ4 weights at a config's full width.

    Every matrix, the embedding table included (which a tied lm_head then
    reads as it is), is a q4 QArray of uniform random nibbles with f32 block
    scales uniform in [0.5, 1.5] x 0.0043, so weights have std ≈ 0.02; norms
    are ones (Gemma 2's post-norms too), q/k/v biases zeros where the config
    has them, as `init_params` makes them. A MoE router is bf16 normal with
    std 0.02; the expert stacks are drawn one expert matrix at a time into
    their [E, N, K] tensors."""
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

    layers = []
    for _ in range(cfg.n_layers):
        layer = {k: q4(*s) for k, s in _shapes(cfg).items()}
        if cfg.n_experts:
            layer["router"] = (torch.randn((cfg.n_experts, D), generator=g, device=device)
                               * 0.02).to(torch.bfloat16)
        layer.update(_norms_and_biases(cfg, device))
        layers.append(layer)
    params = {"embed": q4(cfg.vocab_size, D), "layers": layers,
              "final_norm.weight": torch.ones(D, dtype=torch.float32, device=device)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = q4(cfg.vocab_size, D)
    return params


def llama_1b_config() -> ModelConfig:
    """Llama-3.2-1B-Instruct shapes."""
    return from_hf_config(
        {
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
    )


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
