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

Steps on a mesh (the counterpart of the JAX package's jitted `shard_map`
steps and its jitted pipeline tick window): a tp step's collectives and a
pp stage's hand-overs are host work between parts of the step's device
work, which one graph cannot hold (gloo's collectives run on the host; NCCL's
inside a capture would need every rank's GPU of its own). Each such op is a
`boundary`: while a step is captured, the capture ends at the op, the op's
buffers are made outside any capture and the op is recorded with them (not
run: a capture runs nothing), and the next segment's capture begins in the
owner's same pool. A key's graph is then a chain of segments, and a replay
runs segment 0, op 0, segment 1, ... in capture order, the only order in
which segments that share one pool may run. Each segment carries its own
launch-counter deltas. Outside a capture a boundary op runs at once, so
eager steps (first uses, the CPU, the yardstick) run as before. On one
device a step has no boundary and its graph is one segment.
`record_plan()` lists the boundary ops of the steps run inside it, in
order (the CPU tests hold every rank's plan equal).
"""

from __future__ import annotations

import contextlib
import threading
import time
import warnings

import numpy as np
import torch

from ..utils import debug

# the stop-id buffer's least width (the JAX package's MAX_STOP_IDS); a
# larger set doubles it, each width its own buffer and its own graphs
MAX_STOP_IDS = 8

# this thread's capture in progress (`_Segments`) and plan recorder (a list)
_LOCAL = threading.local()


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


def boundary(desc: tuple, build):
    """A boundary op of the step being run (module docstring): host work
    between two parts of its device work. build() makes the op's buffers
    and returns (op, result): op() does the work on those buffers, the same
    ones at every run; result is what the caller gets (tensors among the
    buffers, or None). Outside a capture op() runs now; while a StepGraphs
    captures on this thread, the segment ends, build() runs outside the
    capture, op is recorded for the replays, and the next segment begins.
    desc (what the op is: name, shapes, dtype) goes to the plan being
    recorded, if any."""
    plan = getattr(_LOCAL, "plan", None)
    if plan is not None:
        plan.append(desc)
    segs = getattr(_LOCAL, "capture", None)
    if segs is None:
        op, result = build()
        op()
        return result
    segs.close()
    op, result = build()
    segs.ops.append(op)
    segs.open()
    return result


def capturing() -> bool:
    """Whether a step is being captured on this thread (its boundary ops'
    buffers, made between two segments, too)."""
    return getattr(_LOCAL, "capture", None) is not None


@contextlib.contextmanager
def record_plan():
    """The boundary ops of the steps run inside, in order: yields the list
    that each op's desc is appended to."""
    prev, _LOCAL.plan = getattr(_LOCAL, "plan", None), []
    try:
        yield _LOCAL.plan
    finally:
        _LOCAL.plan = prev


class _Segments:
    """One key's step as a chain of CUDA graphs cut at its boundary ops. It
    stands in for the CUDAGraph that `torch.cuda.graph` captures into: its
    capture_begin opens the first segment (on the capture stream, in the
    pool, in the mode that torch.cuda.graph passes) and its capture_end
    closes the last; `boundary` closes and opens the ones between."""

    def __init__(self, counters):
        self.graphs: list = []
        self.ops: list = []  # ops[i] runs between graphs[i] and graphs[i + 1]
        self.deltas: list = []  # per segment: its launches of each counter
        self.replays = 0
        self._counters = counters
        self._args = None
        self._graph = self._marks = None

    def capture_begin(self, *args, **kw):
        self._args = (args, kw)
        self.open()

    def capture_end(self):
        self.close()

    def open(self):
        args, kw = self._args
        self._marks = [c.launches for c in self._counters]
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(*args, **kw)

    def close(self):
        graph, self._graph = self._graph, None
        if graph is None:  # a failure between a close and the next open
            return
        self.graphs.append(graph)
        self.deltas.append(tuple(c.launches - m for c, m in zip(self._counters, self._marks)))
        with warnings.catch_warnings():
            # a segment between two ops may hold no work (a hand-over right
            # after a receive); replaying it launches nothing
            warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
            graph.capture_end()

    def replay(self):
        ops = self.ops
        for i, graph in enumerate(self.graphs):
            graph.replay()
            if i < len(ops):
                ops[i]()
        self.replays += 1


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
        self._graphs: dict = {}  # key -> (its _Segments, outputs, counter deltas)
        self._inputs: dict = {}  # key -> its static inputs (`inputs`)
        self._pool = pool_of._pool if pool_of is not None else [None]  # one shared handle
        self.eager_steps = 0
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0  # memory_reserved added by the captures

    def stats(self) -> dict:
        st = dict(graphs=len(self._graphs), keys=len(self._seen),
                  segments=sum(len(e[0].graphs) for e in self._graphs.values()),
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
        segs, outputs, delta = entry
        segs.replay()
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
        segs = _Segments(self.counters)
        _LOCAL.capture = segs
        try:
            # thread_local: the capturing thread may not sync or allocate
            # outside the pool; request threads' own work is not the graph's
            with torch.cuda.graph(segs, pool=self._pool[0], capture_error_mode="thread_local"):
                outputs = fn()
        finally:
            _LOCAL.capture = None
            for c, b in zip(self.counters, before):
                c.launches = b
        delta = tuple(sum(d) for d in zip(*segs.deltas)) if segs.deltas else \
            (0,) * len(self.counters)
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        self._graphs[key] = entry = (segs, outputs, delta)
        self.capture_s += time.perf_counter() - t0
        return entry
