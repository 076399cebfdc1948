"""Chunked decode loop (counterpart of `jlama_tpu/runtime/device_loop.py`).

The JAX package runs N decode steps as one jitted `lax.while_loop` that exits
when every row has hit a stop id. Here the host issues the whole chunk
without waiting on the device (the sampled token feeds the next step as a
device tensor, and no step reads a value back), copies the chunk's tokens to
the host once, and trims each row after its first stop id. Steps issued
after a stop write K/V only at slots past the row's final position, which a
later forward overwrites before it attends to them, and they draw from the
generator only after generation has ended, so the ids, `n_valid` and the
session position equal the JAX loop's. CUDA graphs come in a later PR.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..models.base import forward_hidden, lm_logits
from ..nn.sampling import sample_token

# fixed-size stop-id buffer (pad with -1, which no vocab id matches)
MAX_STOP_IDS = 8


def pad_stop_ids(stop_ids) -> list[int]:
    """Stop ids padded with -1 to MAX_STOP_IDS, or the next power of two."""
    ids = sorted(set(int(t) for t in stop_ids))
    width = MAX_STOP_IDS
    while width < len(ids):
        width *= 2
    return ids + [-1] * (width - len(ids))


def decode_loop(
    params: dict,
    cfg: ModelConfig,
    cache,
    token: torch.Tensor,  # [B, 1] on the device
    position: torch.Tensor,  # [B, 1] on the device
    generator: torch.Generator | None,
    temperature: float,
    top_k: int,
    top_p: float,
    stop_ids: list[int],
    n_steps: int,
    attn_window: int,
    compute_dtype,
    inv_freq: torch.Tensor,
) -> tuple[list[list[int]], list[int]]:
    """Run n_steps decode steps. Returns (tokens per row up to and including
    its first stop id, n_valid per row)."""
    outs = []
    for _ in range(n_steps):
        hidden, cache = forward_hidden(
            params, cfg, token, position, cache, dtype=compute_dtype,
            attn_window=attn_window, inv_freq=inv_freq,
        )
        logits = lm_logits(params, cfg, hidden[:, -1:, :])[:, 0]
        nxt = sample_token(logits, generator, temperature, top_k, top_p)
        outs.append(nxt)
        token = nxt[:, None]
        position = position + 1
    ids = torch.stack(outs, dim=1).cpu().tolist()  # the chunk's one sync
    stop = set(stop_ids) - {-1}
    rows, n_valid = [], []
    for row in ids:
        n = len(row)
        for i, t in enumerate(row):
            if t in stop:
                n = i + 1
                break
        rows.append(row[:n])
        n_valid.append(n)
    return rows, n_valid
