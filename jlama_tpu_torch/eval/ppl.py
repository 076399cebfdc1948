"""Perplexity evaluation (counterpart of `jlama_tpu/eval/ppl.py`).

The standard sliding-window protocol: concatenate the corpus, score it in
windows of `seq_len` that advance by `stride`, and count only the last
`stride` targets of each window (the overlap is context only), so every
target token is scored exactly once; a final partial window scores its
targets past the previous window's. It gates the quality of a weight format:
q4 against float, q4s (with its int8 activations, K5) against q4.

The corpus is any local text file; nothing is downloaded.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..models.base import forward_logits, params_to


def _window_nll(params, cfg, ids, count_from: int, dtype, device) -> tuple[float, int]:
    """Summed NLL of the targets of one window from index `count_from` on,
    and their count."""
    tokens = torch.as_tensor(np.asarray(ids, dtype=np.int64), device=device)[None, :]
    positions = torch.arange(tokens.shape[1], device=device)[None, :]
    logits, _ = forward_logits(params, cfg, tokens, positions, None, dtype=dtype)
    logp = torch.log_softmax(logits[0, :-1].to(torch.float32), dim=-1)
    nll = -logp.gather(-1, tokens[0, 1:, None])[:, 0]
    return float(nll[count_from:].sum()), nll.shape[0] - count_from


def score_tokens(
    params: dict,
    cfg: ModelConfig,
    token_ids,
    seq_len: int = 1024,
    stride: int = 512,
    dtype=torch.float32,
    progress=None,
    device=None,
) -> float:
    """Perplexity over token_ids by the sliding-window protocol. Runs on
    `device` (CUDA unless the caller names one; the params are moved there)."""
    device = resolve_device(device)
    params = params_to(params, device)
    n = len(token_ids)
    total_nll, total_cnt = 0.0, 0
    start = 0
    with torch.inference_mode():
        while start + 1 < n:
            end = min(start + seq_len, n)
            count_from = 0 if start == 0 else (seq_len - stride - 1)
            if end - start - 1 <= count_from:
                break  # the tail was fully scored by the previous window
            nll, cnt = _window_nll(params, cfg, token_ids[start:end], count_from, dtype,
                                   device)
            total_nll += nll
            total_cnt += cnt
            if progress:
                progress(end, n)
            if end == n:
                break
            start += stride
    return math.exp(total_nll / max(total_cnt, 1))


def evaluate_file(
    model_dir: str | Path,
    text_path: str | Path,
    tokenizer=None,
    seq_len: int = 1024,
    stride: int = 512,
    max_tokens: int | None = None,
    dtype=torch.float32,
    device=None,
) -> float:
    """Perplexity of a local model directory on a local text file, through
    the port's `load_params` and tokenizer."""
    from ..models.loader import load_params
    from ..tokenizers import load_tokenizer

    params, cfg = load_params(model_dir, device=device, float_dtype=dtype)
    tok = tokenizer or load_tokenizer(model_dir)
    text = Path(text_path).read_text(encoding="utf-8")
    ids = np.asarray(tok.encode(text), dtype=np.int64)
    if max_tokens:
        ids = ids[:max_tokens]
    return score_tokens(params, cfg, ids, seq_len, stride, dtype, device=device)
