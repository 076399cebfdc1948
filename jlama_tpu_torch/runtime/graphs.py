"""Captured steps: one CUDA graph per step key (the counterpart of the JAX
package's jitted programs: the decode loop of
`jlama_tpu/runtime/device_loop.py`, the scheduler's `_decode_step`, and the
`Engine`'s and the scheduler's jitted `_prefill`, each one dispatch).

A step function takes no arguments: it reads its inputs from static tensors
that the caller loads from the host before the step. A decode step reads a
`DecodeInputs` (tokens, positions, step counters, sampling parameters, page
tables, stop ids) and ends with `DecodeInputs.advance`, which writes the
sampled tokens back into the static `tokens`, advances `positions` and
`steps` and marks the rows that sampled a stop id `done`, all in place, so
that replays chain with no host work. A prefill reads a `PrefillInputs`
(tokens, positions and page tables of one key's shape) and writes the KV
cache; it has no output. `StepGraphs.run(key, fn)` runs a step:

- at the first use of a key, eagerly: kernel builds, plans, cached tables
  and every buffer a wrapper makes on first need come into being outside
  any capture;
- at the second use, it captures fn with `torch.cuda.graph` on its owner's
  one memory pool (an owner's decode and prefill graphs share it), then
  replays the graph; every later use replays it. So every step runs exactly
  once for real, and a key used once pays no capture;
- on the CPU (the device the caller named), on the card when its owner was
  built with `graphs=False` (the eager yardstick, for decode and prefill
  alike), and while the debug hook is on (`utils/debug.py`: a host callback
  cannot run inside a graph), eagerly every time. A step run under the hook
  neither captures nor replays nor counts as a key's use.

A capture that fails raises; nothing falls back to eager. A graph keeps the
addresses it was captured on, so every tensor a step reads has to outlive
its graphs: the static inputs here, the owner's caches, and the wrappers'
cached tables and ticket buffers, which are never dropped. What a wrapper
builds on the host per call is built once, at capture: the TMA tensor maps
of K1's, K3's and K5's wgmma routes are kernel parameters, encoded for the
addresses of the graph's own tensors, so a replay reuses them as they are;
no wrapper on these paths syncs with the host.

The kernel wrappers' `launches` counters count launches on the device: a
capture takes each counter's delta and puts the counter back, and each
replay adds the delta.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..utils import debug

# the stop-id buffer's least width (the JAX package's MAX_STOP_IDS); a
# larger set doubles it, each width its own buffer and its own graphs
MAX_STOP_IDS = 8


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


def stop_width(n: int) -> int:
    """The stop-id buffer's width for n ids: 8, doubled until they fit (the
    JAX package's `pad_stop_ids`)."""
    width = MAX_STOP_IDS
    while width < n:
        width *= 2
    return width


def _load(dst: torch.Tensor, value) -> None:
    """Copy a host value (numbers, lists, numpy arrays) into a static tensor:
    on the card from pinned memory, ordered on the current stream, without
    waiting for it."""
    src = torch.from_numpy(np.ascontiguousarray(value)).to(dst.dtype).reshape(dst.shape)
    if dst.is_cuda:
        src = src.pin_memory()
    dst.copy_(src, non_blocking=True)


class DecodeInputs:
    """The static inputs of a decode step over `batch` rows on one device.

    pages: the page-table width ([batch, pages] int32 `page_tables`; 0 for
    a dense cache). history: slots of a [batch, history] record of sampled
    tokens, indexed by `steps` (0: no record). stops: keep a per-row `done`
    flag against a stop-id buffer (`set_stops`), for a loop that exits once
    every row is done."""

    def __init__(self, batch: int, device, pages: int = 0, history: int = 0,
                 stops: bool = False):
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
        self.done = zeros(batch, dtype=torch.bool) if stops else None
        self.stop_bufs: dict[int, torch.Tensor] = {}  # width -> [width] ids, never dropped

    def load(self, **values) -> None:
        """Copy host values into the static tensors of those names."""
        for name, value in values.items():
            _load(getattr(self, name), value)

    def set_stops(self, stop_ids) -> int:
        """Load the sorted stop ids, padded with -1 (no vocabulary id), into
        the buffer of their width, and clear `done`. Returns the width, which
        the step passes to `advance` (and its key holds)."""
        ids = sorted({int(t) for t in stop_ids})
        width = stop_width(len(ids))
        buf = self.stop_bufs.get(width)
        if buf is None:
            buf = self.stop_bufs[width] = torch.full((width,), -1, dtype=torch.int64,
                                                     device=self.tokens.device)
        _load(buf, ids + [-1] * (width - len(ids)))
        _load(self.done, np.zeros(self.done.shape, bool))
        return width

    def advance(self, toks: torch.Tensor, stop_width: int = 0) -> None:
        """The end of a step: record the sampled tokens [batch], feed them to
        the next step and advance positions and steps, all in place; with a
        stop width, mark the rows whose token is a stop id done."""
        if self.history is not None:
            self.history.scatter_(1, self.steps[:, None], toks[:, None])
        self.tokens.copy_(toks[:, None])
        self.positions.add_(1)
        self.steps.add_(1)
        if stop_width:
            self.done |= (toks[:, None] == self.stop_bufs[stop_width]).any(dim=1)

    def done_flag(self) -> tuple:
        """Start copying "every row is done" to the host: (flag, event); on
        the card a non-blocking copy into pinned memory and the event that
        marks it, on the CPU the value itself and no event."""
        flag = self.done.all()
        if not flag.is_cuda:
            return flag, None
        host = torch.empty((), dtype=torch.bool, pin_memory=True)
        host.copy_(flag, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(flag.device))
        return host, ev


class PrefillInputs:
    """The static inputs of one prefill key: tokens and positions [rows, T]
    and, over a paged pool, page tables [rows, pages] int32."""

    def __init__(self, rows: int, length: int, device, pages: int = 0):
        self.tokens = torch.zeros((rows, length), dtype=torch.int64, device=device)
        self.positions = torch.zeros((rows, length), dtype=torch.int64, device=device)
        self.page_tables = (torch.zeros((rows, pages), dtype=torch.int32, device=device)
                            if pages else None)

    def load(self, **values) -> None:
        for name, value in values.items():
            _load(getattr(self, name), value)


class StepGraphs:
    """One owner's steps by key (see the module docstring).

    graphs: capture on the card; False runs every step eagerly there (the
    yardstick). counters: the objects whose `launches` a replay advances
    (the kernel wrappers by default). pool_of: another owner's StepGraphs
    whose memory pool these graphs share (an owner's prefill graphs share
    its decode graphs' pool)."""

    def __init__(self, device, graphs: bool = True, counters=None,
                 pool_of: "StepGraphs | None" = None, eager_reason: str | None = None):
        self.device = torch.device(device)
        self.capture = graphs and self.device.type == "cuda"
        self.eager_reason = eager_reason  # why an owner runs its steps eagerly, if it says
        self.counters = kernel_wrappers() if counters is None else tuple(counters)
        self._seen: set = set()
        self._graphs: dict = {}  # key -> (graph, outputs, counter deltas)
        self._inputs: dict = {}  # key -> its static inputs (`inputs`)
        self._pool = pool_of._pool if pool_of is not None else [None]  # one shared handle
        self.eager_steps = 0
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0  # memory_reserved added by the captures

    def stats(self) -> dict:
        st = dict(graphs=len(self._graphs), keys=len(self._seen),
                  eager_steps=self.eager_steps, replays=self.replays,
                  capture_s=self.capture_s, pool_bytes=self.pool_bytes)
        if self.eager_reason is not None:  # an owner that never captures says why
            st["eager_reason"] = self.eager_reason
        return st

    def inputs(self, key, make):
        """The static inputs of a key, made by make() at its first use and
        kept (its graph reads them by address)."""
        inp = self._inputs.get(key)
        if inp is None:
            inp = self._inputs[key] = make()
        return inp

    def run(self, key, fn):
        """fn's outputs for this step: on a replay the graph's own output
        tensors, overwritten by the next replay of the same key."""
        if debug.enabled():
            self.eager_steps += 1
            return fn()
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
        if self._pool[0] is None:
            self._pool[0] = torch.cuda.graph_pool_handle()
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
            with torch.cuda.graph(graph, pool=self._pool[0], capture_error_mode="thread_local"):
                outputs = fn()
        finally:
            delta = tuple(c.launches - b for c, b in zip(self.counters, before))
            for c, b in zip(self.counters, before):
                c.launches = b
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        self._graphs[key] = entry = (graph, outputs, delta)
        self.capture_s += time.perf_counter() - t0
        return entry
