"""Transformer layers as plain functions on tensors (counterpart of the
dense-cache parts of `jlama_tpu/nn/layers.py`).

Conventions, as in the JAX package:
- activations: [B, T, D]
- attention KV cache per layer: k, v [B, n_kv, S, head_size]
- weights: [out, in] (HF Linear layout) — see ops.linear

Difference from the JAX package: the cache is updated in place
(`_update_cache`), since torch tensors are mutable and the write then costs
only the T new rows. The paged branch of `self_attention_block` comes with
the serving slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.attention import HEAD_SIZES, flash_prefill
from ..ops.linear import linear
from .rope import apply_rope


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             weight_offset: float = 0.0) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    w = weight.to(torch.float32)
    if weight_offset:
        w = w + weight_offset  # gemma's (1+w)
    return (normed * w).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * weight.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def norm(x, params: dict, cfg: ModelConfig, prefix: str) -> torch.Tensor:
    w = params[f"{prefix}.weight"]
    if cfg.norm_type == "rmsnorm":
        return rms_norm(x, w, cfg.norm_eps, cfg.rmsnorm_weight_offset)
    return layer_norm(x, w, params[f"{prefix}.bias"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind in ("silu", "swish"):
        return F.silu(x)
    if kind in ("gelu", "gelu_new", "gelu_fast", "gelu_pytorch_tanh"):
        # the tanh approximation for all GELU variants but "gelu"
        return F.gelu(x, approximate="tanh" if kind != "gelu" else "none")
    if kind == "tanh":
        return torch.tanh(x)
    raise ValueError(f"unknown activation {kind!r}")


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


class KVLayerCache(NamedTuple):
    k: torch.Tensor  # [B, n_kv, S, hd]
    v: torch.Tensor  # [B, n_kv, S, hd]


def attention_scores_mask(
    q_positions: torch.Tensor,  # [B, T] absolute positions of the query tokens
    kv_len: int,
    causal: bool,
    sliding_window: int | None,
    seq_lengths: torch.Tensor | None = None,  # [B] valid tokens per row
) -> torch.Tensor:
    """Boolean mask [B, T, S]: True = attendable."""
    kv_pos = torch.arange(kv_len, device=q_positions.device)[None, None, :]
    qp = q_positions[:, :, None]
    if causal:
        mask = kv_pos <= qp
    else:
        mask = torch.ones(qp.shape[:2] + (kv_len,), dtype=torch.bool,
                          device=q_positions.device)
    if sliding_window is not None:
        mask = mask & (kv_pos > qp - sliding_window)
    if seq_lengths is not None:
        mask = mask & (kv_pos < seq_lengths[:, None, None])
    return mask


def multi_head_attention(
    q: torch.Tensor,  # [B, T, n_heads, hd]
    k: torch.Tensor,  # cache layout [B, n_kv, S, hd]
    v: torch.Tensor,
    mask: torch.Tensor,  # [B, T, S] bool
    scale: float,
    softcap: float | None = None,
) -> torch.Tensor:
    """Dense attention with GQA head-group mapping, f32 softmax.

    Returns [B, T, n_heads, hd]."""
    B, T, n_heads, hd = q.shape
    n_kv = k.shape[1]
    g = n_heads // n_kv
    qg = q.reshape(B, T, n_kv, g, hd)
    scores = torch.einsum(
        "btkgh,bksh->bkgts", qg.to(torch.float32), k.to(torch.float32)
    )
    scores = scores * scale
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    m = mask[:, None, None, :, :]
    scores = torch.where(m, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bkgts,bksh->btkgh", probs.to(v.dtype).to(torch.float32), v.to(torch.float32)
    )
    return out.reshape(B, T, n_heads, hd).to(q.dtype)


def attention_scale(cfg: ModelConfig) -> float:
    if cfg.attention_multiplier is not None:  # granite
        return cfg.attention_multiplier
    if cfg.query_pre_attn_scalar is not None:  # gemma2
        return cfg.query_pre_attn_scalar ** -0.5
    return cfg.head_size ** -0.5


def self_attention_block(
    x: torch.Tensor,  # [B, T, D] (already normed)
    params: dict,
    cfg: ModelConfig,
    positions: torch.Tensor,  # [B, T]
    cache: KVLayerCache | None,
    cos: torch.Tensor | None,
    sin: torch.Tensor | None,
    sliding_window: int | None,
    attn_window: int | None = None,
) -> tuple[torch.Tensor, KVLayerCache | None]:
    """QKV projections, RoPE, cache update, attention, output projection.

    attn_window: upper bound on the live context (bucketed by the caller);
    attention then reads only that prefix of the cache (a view here).
    """
    B, T, D = x.shape
    hd = cfg.head_size

    if "wqkv" in params:
        qdim = cfg.n_heads * hd
        kvdim = cfg.n_kv_heads * hd
        qkv = linear(x, params["wqkv"], params.get("wqkv.bias"))
        q, k, v = qkv.split((qdim, kvdim, kvdim), dim=-1)
    else:
        q = linear(x, params["wq"], params.get("wq.bias"))
        k = linear(x, params["wk"], params.get("wk.bias"))
        v = linear(x, params["wv"], params.get("wv.bias"))
    q = q.reshape(B, T, cfg.n_heads, hd)
    k = k.reshape(B, T, cfg.n_kv_heads, hd)
    v = v.reshape(B, T, cfg.n_kv_heads, hd)

    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    k_new = k.transpose(1, 2)  # [B, n_kv, T, hd]
    v_new = v.transpose(1, 2)
    if cache is not None:
        _update_cache(cache.k, k_new, positions)
        _update_cache(cache.v, v_new, positions)
        k_att, v_att = cache.k, cache.v
        if attn_window is not None and attn_window < k_att.shape[2]:
            k_att = k_att[:, :, :attn_window]
            v_att = v_att[:, :, :attn_window]
    else:
        k_att, v_att = k_new, v_new
    kv_len = k_att.shape[2]
    scale = attention_scale(cfg)

    if T > 1 and cfg.causal and hd in HEAD_SIZES:
        # K3: unlike the JAX gate (head_size % 128, a Mosaic limit), any
        # head size the kernel is built for takes it, Llama-3.2-1B's 64 too
        out = flash_prefill(
            q.transpose(1, 2),
            k_att.to(q.dtype),
            v_att.to(q.dtype),
            positions[:, 0],
            scale,
            softcap=cfg.attn_logit_softcap,
            window=sliding_window,
        ).transpose(1, 2)
    else:
        mask = attention_scores_mask(
            positions, kv_len, cfg.causal, sliding_window
        )
        out = multi_head_attention(
            q, k_att, v_att, mask, scale, cfg.attn_logit_softcap
        )
    out = out.reshape(B, T, cfg.n_heads * hd)
    out = linear(out, params["wo"], params.get("wo.bias"))
    return out, cache


def _update_cache(cache: torch.Tensor, new: torch.Tensor, positions: torch.Tensor) -> None:
    """Write new [B, n_kv, T, hd] into cache [B, n_kv, S, hd] in place, row b's
    T tokens at slots positions[b] (contiguous from positions[b, 0], as the
    JAX package's dynamic_update_slice writes them). The slot indices stay
    on the device, so the write needs no host sync."""
    new = new.to(cache.dtype)
    for b in range(cache.shape[0]):
        cache[b].index_copy_(1, positions[b].to(torch.int64), new[b])


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_block(x: torch.Tensor, params: dict, cfg: ModelConfig) -> torch.Tensor:
    if "w13" in params:  # fused gate+up (see models.base.fuse_params)
        h = linear(x, params["w13"])
        g, u = h.chunk(2, dim=-1)
        return linear(activation(g, cfg.activation) * u, params["w2"])
    if "w3" in params:  # gated (llama family): w2(act(w1(x)) * w3(x))
        gate = activation(linear(x, params["w1"]), cfg.activation)
        up = linear(x, params["w3"])
        return linear(gate * up, params["w2"])
    # classic 2-layer MLP with biases (gpt2/bert)
    h = activation(linear(x, params["w1"], params.get("w1.bias")), cfg.activation)
    return linear(h, params["w2"], params.get("w2.bias"))
