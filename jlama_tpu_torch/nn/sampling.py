"""Token sampling on the device (counterpart of `jlama_tpu/nn/sampling.py`).

Greedy when temperature == 0, otherwise temperature-scaled categorical
sampling after optional top-k and top-p (nucleus) masks. The masks are the
JAX package's, step for step. The draw uses the Gumbel-max trick on uniforms
from a `torch.Generator` on the logits' device: it cannot reproduce JAX's
threefry bits, so seeded draws match the JAX package in distribution only.
"""

from __future__ import annotations

import torch


def _filter(scaled: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """The top-k then top-p masks (-inf outside), as the JAX package applies them."""
    V = scaled.shape[-1]
    if 0 < top_k < V:
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
        kth = sorted_desc[:, top_k - 1 : top_k]
        scaled = torch.where(scaled >= kth, scaled, torch.full_like(scaled, -torch.inf))
    if top_p < 1.0:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff = torch.where(cum - probs > top_p, -torch.inf, sorted_logits)
        threshold = torch.where(torch.isfinite(cutoff), cutoff, torch.inf).amin(
            dim=-1, keepdim=True
        )
        scaled = torch.where(scaled < threshold, torch.full_like(scaled, -torch.inf), scaled)
    return scaled


def sample_token(
    logits: torch.Tensor,  # [B, V] f32
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Sample one token per row. Returns [B] int64 on the logits' device.

    temperature 0 → greedy (argmax, no draw); top_k <= 0 keeps all tokens;
    top_p >= 1 skips the nucleus mask."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    scaled = logits / max(float(temperature), 1e-6)
    scaled = _filter(scaled, int(top_k), float(top_p))
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(scaled + gumbel, dim=-1)
