"""Captured decode steps: one CUDA graph per step key (the counterpart of the
JAX package's jitted decode programs, `jlama_tpu/runtime/device_loop.py` and
the scheduler's `_decode_step` in `jlama_tpu/runtime/scheduler.py`, which
run a decode step as one dispatch).

A step function takes no arguments: it reads its inputs from the static
tensors of a `DecodeInputs` (tokens, positions, step counters, sampling
parameters, page tables), and ends with `DecodeInputs.advance`, which writes
the sampled tokens back into the static `tokens` and advances `positions`
and `steps` in place, so that replays chain with no host work.
`StepGraphs.run(key, fn)` runs it:

- at the first use of a key, eagerly: kernel builds, plans, cached tables
  and every buffer a wrapper makes on first need come into being outside
  any capture;
- at the second use, it captures fn with `torch.cuda.graph` on the one
  memory pool of its owner's graphs, then replays the graph; every later
  use replays it. So every step runs exactly once for real, and a key used
  once pays no capture;
- on the CPU (the device the caller named), and on the card when its owner
  was built with `graphs=False` (the eager yardstick), eagerly every time.

A capture that fails raises; nothing falls back to eager. A graph keeps the
addresses it was captured on, so every tensor a step reads has to outlive
its graphs: the static inputs and outputs here, the owner's caches, and the
wrappers' cached tables and ticket buffers, which are never dropped.

The kernel wrappers' `launches` counters count launches on the device: a
capture takes each counter's delta and puts the counter back, and each
replay adds the delta.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def kernel_wrappers() -> tuple:
    """The kernel wrappers whose `launches` counters a replay advances."""
    from ..ops.attention import flash_prefill, paged_decode
    from ..ops.kv_write import kv_write
    from ..ops.moe_float import grouped_mm
    from ..ops.moe_q4 import moe_gather, moe_groups, moe_q4_matmul
    from ..ops.q4_matmul import q4_matmul
    from ..ops.w8a8 import q4s_matmul

    return (q4_matmul, q4s_matmul, flash_prefill, paged_decode, kv_write, moe_q4_matmul,
            moe_groups, moe_gather, grouped_mm)


class DecodeInputs:
    """The static inputs of a decode step over `batch` rows on one device.

    pages: the page-table width ([batch, pages] int32 `page_tables`; 0 for
    a dense cache). history: slots of a [batch, history] record of sampled
    tokens, indexed by `steps` (0: no record)."""

    def __init__(self, batch: int, device, pages: int = 0, history: int = 0):
        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.tokens = zeros(batch, 1)
        self.positions = zeros(batch, 1)
        self.steps = zeros(batch)
        self.seeds = zeros(batch)
        self.temps = zeros(batch, dtype=torch.float32)
        self.top_ks = zeros(batch)
        self.top_ps = zeros(batch, dtype=torch.float32)
        self.pres = zeros(batch, dtype=torch.float32)
        self.freq = zeros(batch, dtype=torch.float32)
        self.page_tables = zeros(batch, pages, dtype=torch.int32) if pages else None
        self.history = zeros(batch, history) if history else None

    def load(self, **values) -> None:
        """Copy host values (numbers, lists, numpy arrays) into the static
        tensors of those names: on the card from pinned memory, ordered on
        the current stream, without waiting for it."""
        for name, value in values.items():
            dst = getattr(self, name)
            src = torch.from_numpy(np.ascontiguousarray(value)).to(dst.dtype).reshape(dst.shape)
            if dst.is_cuda:
                src = src.pin_memory()
            dst.copy_(src, non_blocking=True)

    def advance(self, toks: torch.Tensor) -> None:
        """The end of a step: record the sampled tokens [batch], feed them to
        the next step and advance positions and steps, all in place."""
        if self.history is not None:
            self.history.scatter_(1, self.steps[:, None], toks[:, None])
        self.tokens.copy_(toks[:, None])
        self.positions.add_(1)
        self.steps.add_(1)


class StepGraphs:
    """One owner's decode steps by key (see the module docstring).

    graphs: capture on the card; False runs every step eagerly there (the
    yardstick). counters: the objects whose `launches` a replay advances
    (the kernel wrappers by default)."""

    def __init__(self, device, graphs: bool = True, counters=None):
        self.device = torch.device(device)
        self.capture = graphs and self.device.type == "cuda"
        self.counters = kernel_wrappers() if counters is None else tuple(counters)
        self._seen: set = set()
        self._graphs: dict = {}  # key -> (graph, outputs, counter deltas)
        self._pool = None
        self.eager_steps = 0
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0  # memory_reserved added by the captures

    def stats(self) -> dict:
        return dict(graphs=len(self._graphs), keys=len(self._seen),
                    eager_steps=self.eager_steps, replays=self.replays,
                    capture_s=self.capture_s, pool_bytes=self.pool_bytes)

    def run(self, key, fn):
        """fn's outputs for this step: on a replay the graph's own output
        tensors, overwritten by the next replay of the same key."""
        entry = self._graphs.get(key)
        if entry is None and self.capture and key in self._seen:
            entry = self._capture(key, fn)
        if entry is None:
            self._seen.add(key)
            self.eager_steps += 1
            return fn()
        graph, outputs, delta = entry
        graph.replay()
        for c, d in zip(self.counters, delta):
            c.launches += d
        self.replays += 1
        return outputs

    def _capture(self, key, fn):
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        # what torch.cuda.graph does on entry, here first, so that the
        # reserved memory before and after measures what the capture added
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = [c.launches for c in self.counters]
        graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: the capturing thread may not sync or allocate
            # outside the pool; request threads' own work is not the graph's
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                outputs = fn()
        finally:
            delta = tuple(c.launches - b for c, b in zip(self.counters, before))
            for c, b in zip(self.counters, before):
                c.launches = b
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        self._graphs[key] = entry = (graph, outputs, delta)
        self.capture_s += time.perf_counter() - t0
        return entry
