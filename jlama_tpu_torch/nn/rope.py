"""Rotary position embeddings (counterpart of `jlama_tpu/nn/rope.py`).

HF rotate-half convention with linear and llama3-style frequency scaling.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import ModelConfig


def rope_frequencies(cfg: ModelConfig) -> np.ndarray:
    """Per-dimension inverse frequencies [head_size/2], f32, with scaling."""
    hs = cfg.head_size
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, hs, 2, dtype=np.float64) / hs))
    rs = cfg.rope_scaling
    if rs.rope_type == "linear":
        inv = inv / rs.factor
    elif rs.rope_type == "llama3":
        low_wl = rs.original_max_position_embeddings / rs.low_freq_factor
        high_wl = rs.original_max_position_embeddings / rs.high_freq_factor
        wl = 2 * math.pi / inv
        scaled = np.where(wl > low_wl, inv / rs.factor, inv)
        smooth = (rs.original_max_position_embeddings / wl - rs.low_freq_factor) / (
            rs.high_freq_factor - rs.low_freq_factor
        )
        smoothed = (1 - smooth) / rs.factor * inv + smooth * inv
        is_medium = (wl <= low_wl) & (wl >= high_wl)
        scaled = np.where(is_medium, smoothed, scaled)
        inv = scaled
    return inv.astype(np.float32)


def rope_cos_sin(
    positions: torch.Tensor, inv_freq: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given positions. positions [...], returns [..., hs/2]."""
    angles = positions[..., None].to(torch.float32) * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF rotate-half RoPE in f32 (f64 for f64 x).

    x: [..., T, n_heads, head_size]; cos/sin: [..., T, head_size/2].
    """
    half = x.shape[-1] // 2
    ct = torch.promote_types(x.dtype, torch.float32)
    x1 = x[..., :half].to(ct)
    x2 = x[..., half:].to(ct)
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    out1 = x1 * c - x2 * s
    out2 = x2 * c + x1 * s
    return torch.cat([out1, out2], dim=-1).to(x.dtype)
