"""Paged KV cache: a fixed page pool on the device + per-sequence page tables
(counterpart of `jlama_tpu/kv/paged.py`).

Layout, as in the JAX package (head-major, so that pools compare pool for
pool with it and a suspended session's payload has the same shape):
  k_pool, v_pool: [n_layers, n_kv_heads, n_pages, page_size, head_size]
  page table row: [max_pages_per_seq] int32 page ids

Page 0 is reserved as a scratch page, so that unallocated table entries
point somewhere harmless. A q8 pool is a QArray: int8 payload plus f32
scales [..., head_size / blk] with blk = 32, or head_size where 32 does not
divide it.

Difference from the JAX package: the pools are updated in place (torch
tensors are mutable), by the K4 kernel (`ops/kv_write.py`), which also
applies RoPE to q and k in the same launch; a layer's pool is
a view of the stacked pool, so the forward pass takes a per-layer list of
views (`PagedKVCache.layer_states`) and nothing is copied.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..nn.qarray import QArray
from ..ops.kv_write import kv_write


class PagedKVState(NamedTuple):
    """Pools: tensors (bf16/f32) or q8 QArrays, [L, n_kv, n_pages, ps, hd]
    for the whole model or [n_kv, n_pages, ps, hd] for one layer."""

    k_pool: torch.Tensor | QArray
    v_pool: torch.Tensor | QArray


@dataclass
class PageAllocator:
    """Host-side page bookkeeping, a copy of the JAX package's.

    groups > 1 (data-parallel serving): the page id space is partitioned
    into `groups` equal ranges, one per dp shard; a sequence allocates only
    from its group's range. Page g*(n_pages//groups) of each range is that
    group's scratch page (group 0's is page 0)."""

    n_pages: int
    groups: int = 1
    free: list[list[int]] = field(default_factory=list)
    by_seq: dict[str, list[int]] = field(default_factory=dict)
    group_of: dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        per = self.n_pages // self.groups
        # first page of each group's range reserved as its scratch target
        self.free = [
            list(range((g + 1) * per - 1, g * per, -1))
            for g in range(self.groups)
        ]

    def scratch(self, group: int = 0) -> int:
        return group * (self.n_pages // self.groups)

    def pages_for(self, seq_id: str) -> list[int]:
        return self.by_seq.setdefault(seq_id, [])

    def ensure_capacity(
        self, seq_id: str, n_tokens: int, page_size: int, group: int = 0
    ) -> list[int]:
        pages = self.pages_for(seq_id)
        if pages:
            group = self.group_of.get(seq_id, group)
        needed = -(-n_tokens // page_size)
        free = self.free[group]
        while len(pages) < needed:
            if not free:
                raise MemoryError("KV page pool exhausted")
            pages.append(free.pop())
            self.group_of[seq_id] = group
        return pages

    def release(self, seq_id: str) -> None:
        pages = self.by_seq.pop(seq_id, [])
        g = self.group_of.pop(seq_id, 0)
        self.free[g].extend(reversed(pages))

    @property
    def n_free(self) -> int:
        return sum(len(f) for f in self.free)


class PagedKVCache:
    """Pool + allocator + padded page-table assembly."""

    def __init__(
        self,
        cfg: ModelConfig,
        n_pages: int,
        page_size: int = 64,
        max_pages_per_seq: int | None = None,
        dtype=torch.bfloat16,
        groups: int = 1,
        device=None,
    ):
        """dtype: a torch float dtype, or "q8" for a quantized pool (int8
        payload + f32 block scales along head_size). device: CUDA unless
        named; raises without CUDA and without it."""
        device = resolve_device(device)
        self.cfg = cfg
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_pages_per_seq = max_pages_per_seq or (
            -(-cfg.context_length // page_size)
        )
        shape = (cfg.n_layers, cfg.n_kv_heads, n_pages, page_size, cfg.head_size)
        if dtype == "q8":
            # block-32 scales where 32 divides head_size, else one per row
            blk = 32 if cfg.head_size % 32 == 0 else cfg.head_size
            sshape = shape[:-1] + (cfg.head_size // blk,)

            def qpool():
                return QArray(torch.zeros(shape, dtype=torch.int8, device=device),
                              torch.zeros(sshape, dtype=torch.float32, device=device), "q8")

            self.state = PagedKVState(qpool(), qpool())
        else:
            self.state = PagedKVState(torch.zeros(shape, dtype=dtype, device=device),
                                      torch.zeros(shape, dtype=dtype, device=device))
        self.alloc = PageAllocator(n_pages, groups=groups)

    def layer_states(self) -> list[PagedKVState]:
        """One PagedKVState per layer, each a view of the stacked pools."""
        k, v = self.state
        return [PagedKVState(k[l], v[l]) for l in range(self.cfg.n_layers)]

    def page_table(
        self, seq_ids: list[str], groups: list[int] | None = None
    ) -> np.ndarray:
        """Padded page tables [B, max_pages_per_seq]; unallocated entries
        point at the row's group scratch page (page 0 for group 0)."""
        P = self.max_pages_per_seq
        out = np.zeros((len(seq_ids), P), dtype=np.int32)
        for i, sid in enumerate(seq_ids):
            g = groups[i] if groups else self.alloc.group_of.get(sid, 0)
            if g:
                out[i, :] = self.alloc.scratch(g)
            pages = self.alloc.pages_for(sid)
            out[i, : len(pages)] = pages
        return out


# ---------------------------------------------------------------------------
# device-side ops
# ---------------------------------------------------------------------------


def page_size_of(pool) -> int:
    return (pool.data if isinstance(pool, QArray) else pool).shape[-2]


def write_kv_layer(
    k_pool,  # [n_kv, n_pages, ps, hd] (one layer): tensor or q8 QArray
    v_pool,
    k_new: torch.Tensor,  # [B, T, n_kv, hd]
    v_new: torch.Tensor,
    page_tables: torch.Tensor,  # [B, P] int32
    positions: torch.Tensor,  # [B, T] absolute token positions
    *,
    q: torch.Tensor | None = None,  # [B, T, H, hd]
    cos: torch.Tensor | None = None,  # [B, T, hd/2] f32
    sin: torch.Tensor | None = None,
) -> torch.Tensor | None:
    """Write the new K/V rows into the pool at their (page, offset) slots, in
    place, in one K4 launch; q8 pools quantize each row per block in the
    same pass (the JAX function returns new pools; this one mutates). With
    cos/sin the same launch first rotates q and k (the JAX package's
    `apply_rope` on both before its write) and returns the rotated q; else q
    comes back as it was given."""
    return kv_write(k_pool, v_pool, k_new, v_new, page_tables, positions, q=q, cos=cos, sin=sin)


def gather_pool(pool, page_tables: torch.Tensor, dtype) -> torch.Tensor:
    """One pool's pages for each row: [B, P*ps, n_kv, hd] in `dtype` (q8
    values dequantized in f32, then cast)."""
    pt = page_tables.long()
    if isinstance(pool, QArray):
        d = pool.data[:, pt]  # [n_kv, B, P, ps, hd] int8
        s = pool.scales[:, pt]  # [n_kv, B, P, ps, hd/blk]
        blk = d.shape[-1] // s.shape[-1]
        x = d.reshape(*d.shape[:-1], d.shape[-1] // blk, blk).to(torch.float32)
        x = (x * s[..., None]).reshape(d.shape).to(dtype)
    else:
        x = pool[:, pt].to(dtype)
    n_kv, B, P, ps, hd = x.shape
    # [n_kv, B, S, hd] storage seen as [B, S, n_kv, hd]: a view, no copy
    return x.reshape(n_kv, B, P * ps, hd).permute(1, 2, 0, 3)


def gather_kv_layer(
    k_pool,
    v_pool,
    page_tables: torch.Tensor,  # [B, P]
    dtype=torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each sequence's KV window [B, P*ps, n_kv, hd] (plain torch indexing;
    an XLA gather in the JAX package). q8 pools are dequantized after the
    gather, so only the live pages are."""
    return gather_pool(k_pool, page_tables, dtype), gather_pool(v_pool, page_tables, dtype)
