"""Random parameter initialization (counterpart of `jlama_tpu/models/init.py`).

`init_params` builds the loader's per-layer layout from a numpy generator
(std 0.02, optionally JQ4-quantized), like the JAX package. `random_q4_params`
is the fast on-device random JQ4 init for full-width runs: random packed
nibbles and small random f32 scales drawn directly on the device from a
seeded `torch.Generator`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelConfig, from_hf_config
from ..device import resolve_device
from ..nn.qarray import QArray
from ..quant import blockq


def _shapes(cfg: ModelConfig) -> dict[str, tuple[int, int]]:
    D, H = cfg.embedding_length, cfg.hidden_length
    qdim = cfg.n_heads * cfg.head_size
    kvdim = cfg.n_kv_heads * cfg.head_size
    return {"wq": (qdim, D), "wk": (kvdim, D), "wv": (kvdim, D), "wo": (D, qdim),
            "w1": (H, D), "w2": (D, H), "w3": (H, D)}


def init_params(
    cfg: ModelConfig,
    seed: int = 0,
    dtype=torch.bfloat16,
    quantize: str | None = "q4",  # None | "q4"
    device=None,
) -> dict:
    """Random-normal params (std 0.02) in the loader's layout."""
    device = resolve_device(device)
    if cfg.n_experts:
        raise NotImplementedError("MoE configs are not ported yet")
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

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    layers = []
    for _ in range(cfg.n_layers):
        layer = {k: linear_leaf(*s) for k, s in _shapes(cfg).items()}
        layer["attn_norm.weight"] = ones(D)
        layer["ff_norm.weight"] = ones(D)
        if cfg.post_attn_norm:
            layer["post_attn_norm.weight"] = ones(D)
        if cfg.post_ff_norm:
            layer["post_ff_norm.weight"] = ones(D)
        if cfg.attn_qkv_bias:
            for k in ("wq", "wk", "wv"):
                layer[k + ".bias"] = torch.zeros(_shapes(cfg)[k][0], device=device)
        layers.append(layer)

    params: dict = {
        "embed": torch.from_numpy(w(V, D)).to(device=device, dtype=dtype),
        "layers": layers,
        "final_norm.weight": ones(D),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = torch.from_numpy(w(V, D)).to(device=device, dtype=dtype)
    return params


def random_q4_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Fast on-device random JQ4 weights at a config's full width.

    Every matrix, the embedding table included (which a tied lm_head then
    reads as it is), is a q4 QArray of uniform random nibbles with f32 block
    scales uniform in [0.5, 1.5] x 0.0043, so weights have std ≈ 0.02; norms
    are ones."""
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    D = cfg.embedding_length

    def q4(n, k):
        data = torch.randint(0, 256, (n, k // 2), generator=g, device=device,
                             dtype=torch.uint8)
        scales = torch.rand((n, k // 32), generator=g, device=device) + 0.5
        return QArray(data, scales * 0.0043, "q4")

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    layers = []
    for _ in range(cfg.n_layers):
        layer = {k: q4(*s) for k, s in _shapes(cfg).items()}
        layer["attn_norm.weight"] = ones(D)
        layer["ff_norm.weight"] = ones(D)
        layers.append(layer)
    params = {"embed": q4(cfg.vocab_size, D), "layers": layers,
              "final_norm.weight": ones(D)}
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
