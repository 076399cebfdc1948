"""Token sampling on the device (counterpart of `jlama_tpu/nn/sampling.py`).

Greedy when temperature == 0, otherwise temperature-scaled categorical
sampling after optional top-k and top-p (nucleus) masks. The masks are the
JAX package's, step for step. temperature, top_k and top_p are each a
Python number or a per-row [B] tensor (continuous batching: every sequence
carries its own sampling parameters). Static fast paths, as in the JAX
package: a Python temperature of 0 returns the argmax without a draw, and a
Python top_k <= 0 (or >= V) or top_p >= 1 skips that mask's sort.

The draw is the Gumbel-max trick. Its uniforms come either from a
`torch.Generator` (the single-stream `Engine`), or, when `seeds` and `steps`
are given, from a counter-based hash of (seed, step, vocab index) computed on
the device: each row then draws from its own stream, the counterpart of the
JAX scheduler's `fold_in(PRNGKey(seed), step)`, so a seeded request samples
the same tokens whatever else shares its batch. Neither can reproduce JAX's
threefry bits: seeded draws match the JAX package in distribution only.
"""

from __future__ import annotations

import functools

import torch

_M32 = 0xFFFFFFFF


def _rows(v, B: int, dtype, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype).reshape(B)
    return torch.full((B,), v, dtype=dtype, device=device)


def _filter(scaled: torch.Tensor, top_k, top_p) -> torch.Tensor:
    """The top-k then top-p masks (-inf outside), as the JAX package applies
    them; top_k and top_p are Python numbers or per-row [B] tensors."""
    B, V = scaled.shape
    if not (isinstance(top_k, int) and (top_k <= 0 or top_k >= V)):
        k = _rows(top_k, B, torch.int64, scaled.device)
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
        kth = torch.gather(sorted_desc, 1, (torch.clamp(k, 1, V) - 1)[:, None])
        keep_all = ((k <= 0) | (k >= V))[:, None]
        scaled = torch.where((scaled >= kth) | keep_all, scaled,
                             torch.full_like(scaled, -torch.inf))
    if not (isinstance(top_p, (int, float)) and top_p >= 1.0):
        p = _rows(top_p, B, torch.float32, scaled.device)
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        cutoff = torch.where(cum - probs > p[:, None], -torch.inf, sorted_logits)
        threshold = torch.where(torch.isfinite(cutoff), cutoff, torch.inf).amin(
            dim=-1, keepdim=True
        )
        scaled = torch.where(scaled < threshold, torch.full_like(scaled, -torch.inf), scaled)
    return scaled


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without int64 overflow."""
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (hi + x * (c & 0xFFFF)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer hash (Wellons' lowbias32) on int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


@functools.lru_cache(maxsize=4)
def _index_hash(n: int, device: torch.device) -> torch.Tensor:
    """The vocabulary's half of the hash, [n] int64, made once per size
    (callers only read it)."""
    return _mix32(torch.arange(n, dtype=torch.int64, device=device) ^ 0x9E3779B9)


def counter_uniform(seeds: torch.Tensor, steps: torch.Tensor, n: int) -> torch.Tensor:
    """Uniforms in (0, 1), [B, n] f32: element (b, i) is a hash of
    (seeds[b], steps[b], i), so each row's draw depends on nothing else."""
    seed = seeds.to(torch.int64) & _M32
    step = steps.to(device=seeds.device, dtype=torch.int64) & _M32
    row = _mix32((_mix32(seed) + step) & _M32)  # [B]
    h = _mix32(row[:, None] ^ _index_hash(n, seeds.device)[None, :])
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def sample_token(
    logits: torch.Tensor,  # [B, V] f32
    generator: torch.Generator | None = None,
    temperature=0.0,
    top_k=0,
    top_p=1.0,
    seeds: torch.Tensor | None = None,  # [B] per-row stream keys
    steps: torch.Tensor | None = None,  # [B] per-row step counters
) -> torch.Tensor:
    """Sample one token per row. Returns [B] int64 on the logits' device.

    temperature 0 → greedy (argmax, no draw) for that row; top_k <= 0 keeps
    all tokens of a row; top_p >= 1 skips its nucleus mask. With `seeds`
    (and `steps`) each row draws from its own counter-based stream and
    `generator` is not used."""
    greedy = torch.argmax(logits, dim=-1)
    if isinstance(temperature, (int, float)) and temperature == 0.0:
        return greedy
    B = logits.shape[0]
    temp = _rows(temperature, B, torch.float32, logits.device)
    scaled = logits / torch.clamp(temp, min=1e-6)[:, None]
    scaled = _filter(scaled, top_k, top_p)
    if seeds is not None:
        u = counter_uniform(seeds, steps if steps is not None else torch.zeros_like(seeds),
                            scaled.shape[-1])
    else:
        u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    if isinstance(temperature, (int, float)):
        return sampled
    return torch.where(temp == 0.0, greedy, sampled)
