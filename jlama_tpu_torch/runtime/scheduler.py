"""Continuous batching over the paged KV pool, on one device (counterpart of
`jlama_tpu/runtime/scheduler.py`).

A fixed-slot decode batch where sequences join as they arrive and leave as
they finish:

- decode: one forward over all n_slots rows per step (empty slots run a
  dummy sequence against the scratch page and are ignored on the host); the
  attention of every layer is one K2 launch over the live pages; on the card
  a step is a captured CUDA graph (`runtime/graphs.py`), one per (window,
  all greedy, all top_k 0, all top_p 1, penalties), the JAX jit's static
  arguments plus the greedy fast path, all reading one set of static
  inputs; `warmup` captures the greedy and the plain sampled graph of every
  window;
- prefill: chunks of at most `prefill_chunk` tokens, batched across every
  request still prefilling, interleaved with the decode steps; each chunk
  writes its KV rows into the request's pages (K4) and attends over the
  gathered live window (K3);
- chained decode windows: when the batch is steady, up to `decode_lag` steps
  are issued back to back, each sampled token fed to the next step in
  place, and their tokens come back through non-blocking copies into
  pinned host memory, waited on by an event when the window is drained, one
  window late; the host's bookkeeping then overlaps the device's work;
- per-row sampling parameters, per-row seeded streams, presence/frequency
  penalties from per-slot token counts kept on the device;
- sessions: pages stay with a session between requests, least recently used
  idle sessions are suspended to host RAM beyond `max_sessions` or when the
  pool runs out, and resume into fresh pages;
- `weight_format="q4s"`: W4A8 serving (the JAX CLI's `serve --pallas
  w8a8`): the 2-D q4 weights are re-quantized to q4s once, after fusing, and
  every projection and the lm_head take K5.

MoE configs (Mixtral) serve with q4 experts through K6 (`ops/moe_q4.py`).

Tool calls: a request with `tools` whose finished text holds a tool-shaped
JSON finishes TOOL_CALL with `tool_calls` set, as in the JAX package.

`embed_engine`: the `Engine` that answers `/v1/embeddings` beside the
scheduler (None: no embeddings). The JAX CLI's `serve` attaches one that
shares the scheduler's fused tree, `Engine(sched.params, sched.cfg,
tokenizer, device=sched.device, fuse=False, moe_ragged=False)`, so that the
layer weights are held once.

Not ported yet (see ROADMAP.md): meshes (tp/dp page groups), the multi-host
step channel, q4s MoE, and suspending to disk.
"""

from __future__ import annotations

import os
import queue
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..kv.paged import PagedKVCache
from ..models.base import (check_moe_device, forward_hidden, fuse_params, lm_logits, params_to,
                           prepare_moe_ragged, rope_inv_freq)
from ..nn.qarray import QArray
from ..nn.sampling import sample_token
from ..ops.w8a8 import prepare_params_for_w8a8
from ..prompt import extract_tool_calls
from ..utils.metrics import GLOBAL_METRICS
from .engine import FinishReason, Response, _bucket
from .graphs import DecodeInputs, StepGraphs


class RequestState(str, Enum):
    QUEUED = "QUEUED"
    PREFILLING = "PREFILLING"
    RUNNING = "RUNNING"
    DONE = "DONE"


@dataclass
class GenRequest:
    prompt_ids: list[int]
    max_new_tokens: int = 256
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    stop_ids: set[int] = field(default_factory=set)
    stop_strings: list[str] = field(default_factory=list)
    seed: int | None = None  # per-request sampling seed (OpenAI `seed`)
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    on_token: Callable[[int], None] | None = None
    session_id: str | None = None  # KV affinity across requests
    tools: list | None = None  # Tool schemas: finished output is scanned for calls
    id: str = field(default_factory=lambda: str(uuid.uuid4()))

    # filled by the scheduler
    state: RequestState = RequestState.QUEUED
    out_ids: list[int] = field(default_factory=list)
    finish: FinishReason | None = None
    position: int = 0
    cur_token: int = 0
    slot: int = -1
    t_start: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    # chunked-prefill progress: full token list and next index to prefill
    _pf_ids: list[int] = field(default_factory=list)
    _pf_done: int = 0
    text_override: str | None = None  # set when a stop string truncates output
    tool_calls: list = field(default_factory=list)
    error: str | None = None
    done_event: threading.Event = field(default_factory=threading.Event)

    def to_response(self, tokenizer=None) -> Response:
        text = ""
        if self.text_override is not None:
            text = self.text_override
        elif tokenizer is not None:
            visible = [t for t in self.out_ids if t not in self.stop_ids]
            text = tokenizer.decode(visible)
        return Response(
            response_text=text,
            response_text_with_special_tokens=(
                tokenizer.decode(self.out_ids, skip_special=False) if tokenizer else ""
            ),
            finish_reason=self.finish or FinishReason.ERROR,
            prompt_tokens=len(self.prompt_ids),
            generated_tokens=len(self.out_ids),
            prompt_time_ms=(self.t_first - self.t_start) * 1000,
            generate_time_ms=(self.t_done - self.t_first) * 1000,
            token_ids=list(self.out_ids),
            tool_calls=list(self.tool_calls),
            error=self.error,
        )


class BatchScheduler:
    def __init__(
        self,
        params: dict,
        cfg: ModelConfig,
        tokenizer=None,
        n_slots: int = 8,
        n_pages: int = 512,
        page_size: int = 64,
        max_seq_len: int | None = None,
        kv_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        seed: int = 0,
        mesh=None,
        prefill_chunk: int = 256,
        max_sessions: int = 64,
        fuse: bool = True,
        decode_lag: int | None = None,
        weight_format: str | None = None,
        step_channel=None,
        device=None,
        decode_graphs: bool = True,
        moe_ragged: bool = True,
    ):
        """kv_dtype: a torch float dtype or "q8". device: CUDA unless named;
        raises without CUDA and without it. The params are moved there.
        decode_graphs=False runs every decode step eagerly on the card too
        (the yardstick the graphs are held against).

        weight_format: None keeps the weights as they are. "q4s" re-quantizes
        the 2-D q4 weights to the W4A8 format after fusing (q4s rows are never
        concatenated), and a tied lm_head gets a q4s copy. The JAX package's
        "q4k" (its TPU kernel's own q4 layout) has no counterpart and raises:
        K1 reads the checkpoint's JQ4 layout as it is, so None serves q4.

        moe_ragged: as in the JAX package, float MoE experts are transposed
        once into the grouped layout; q4 experts are left as they are (K6
        reads them). q4s with MoE and float experts on the card raise
        NotImplementedError."""
        if weight_format not in (None, "q4s"):
            raise ValueError(f"weight_format {weight_format!r}: expected None or 'q4s' "
                             "(q4 weights need no repack: pass None)")
        if mesh is not None:
            raise NotImplementedError("meshes (tp/dp serving) are not ported yet")
        if step_channel is not None:
            raise NotImplementedError("multi-host serving (step_channel) is not ported yet")
        if weight_format == "q4s" and cfg.n_experts:
            raise NotImplementedError("q4s serving of MoE experts is not ported yet "
                                      "(ROADMAP: q4s MoE)")
        self.device = resolve_device(device)
        params = params_to(params, self.device)
        if fuse:
            params = fuse_params(params)
        if cfg.n_experts:
            if moe_ragged:
                params = prepare_moe_ragged(params)
            check_moe_device(params, self.device)
        if weight_format == "q4s":
            params = prepare_params_for_w8a8(params)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.n_slots = n_slots
        self.compute_dtype = compute_dtype
        max_seq = min(max_seq_len or cfg.context_length, cfg.context_length)
        self.max_seq_len = max_seq
        self.kv = PagedKVCache(
            cfg, n_pages=n_pages, page_size=page_size,
            max_pages_per_seq=-(-max_seq // page_size), dtype=kv_dtype, device=self.device,
        )
        self._layers = self.kv.layer_states()  # per-layer views of the pools
        self.inv_freq = rope_inv_freq(cfg, self.device)
        self.slots: list[GenRequest | None] = [None] * n_slots
        self.pending: queue.Queue[GenRequest] = queue.Queue()
        # session resume state: session_id -> (position, pending_token); the
        # pages stay allocated under the session's kv key between requests;
        # insertion order == LRU order (entries re-inserted on use)
        self.session_state: dict[str, tuple[int, int | None]] = {}
        self._suspended: dict[str, tuple] = {}
        self.max_sessions = max_sessions
        self.prefill_chunk = prefill_chunk
        # double-buffered decode windows: the undrained window's host token
        # buffers + its running-request snapshot; page releases are deferred
        # while a chained window may still write through old page tables
        self._undrained: tuple | None = None
        self._release_q: list[str] = []
        # the static variants of the chain's steps (set by each host-fed window)
        self._chain_tail: dict | None = None
        # one set of static step inputs, read by every decode graph
        self._in = DecodeInputs(n_slots, self.device, pages=self.kv.max_pages_per_seq)
        self.graphs = StepGraphs(self.device, decode_graphs)
        self.degraded: str | None = None
        self._rng = np.random.default_rng(seed)
        # per-slot generated-token counts for presence/frequency penalties,
        # on the device, scatter-updated inside the decode step
        self.counts = torch.zeros((n_slots, cfg.vocab_size), dtype=torch.int32,
                                  device=self.device)
        self._slot_idx = torch.arange(n_slots, device=self.device)
        self._lock = threading.RLock()
        self._running = False
        self._thread: threading.Thread | None = None
        # chained decode depth: when the batch is steady (nothing pending or
        # prefilling, every running row has headroom), up to `decode_lag`
        # steps are issued back to back and the host consumes their tokens
        # one window behind; stop conditions are checked up to `decode_lag`
        # tokens late and tokens sampled past a stop are discarded (their KV
        # writes land in slots the next real token overwrites)
        if decode_lag is None:
            decode_lag = int(os.environ.get("JLAMA_DECODE_LAG", "4"))
        self.decode_lag = max(1, decode_lag)
        # streaming requests get their tokens at window drains: cap the
        # window at stream_lag while any running request streams
        self.stream_lag = max(
            1, int(os.environ.get("JLAMA_STREAM_LAG", str(min(4, self.decode_lag))))
        )
        # inter-token latency budget (ms): caps the window depth so that the
        # drain interval (~ depth x step time, an EWMA of drain spacing)
        # stays under it
        self.itl_budget_ms = float(os.environ.get("JLAMA_ITL_BUDGET_MS", "0")) or None
        # prefill fairness: at most this many requests advance per prefill
        # call, oldest first
        self.prefill_fair_rows = int(os.environ.get("JLAMA_PREFILL_FAIR_ROWS", "0")) or None
        self._step_ms: float | None = None
        self._last_drain: float | None = None
        # eviction epoch: an interval holding a suspend is no step-time sample
        self._evictions = 0
        self._drain_evictions = 0
        # device calls issued, read against the kernels' launch counters
        self.n_prefill_calls = 0
        self.n_decode_steps = 0
        self.embed_engine = None  # an Engine over self.params for embeddings

    # ------------------------------------------------------------------
    # device calls
    # ------------------------------------------------------------------

    def _dev(self, x, dtype=torch.int64) -> torch.Tensor:
        """A host array on the device, through pinned memory, without
        waiting for the device's queue."""
        t = torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _to_host(self, toks: torch.Tensor) -> tuple:
        """Start copying a step's tokens to the host: (buffer, event)."""
        if self.device.type != "cuda":
            return toks, None
        host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
        host.copy_(toks, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return host, ev

    @staticmethod
    def _fetch(item) -> np.ndarray:
        host, ev = item
        if ev is not None:
            ev.synchronize()
        return host.numpy()

    def _call_prefill(self, toks, pos, pt, win: int) -> None:
        with torch.inference_mode():
            forward_hidden(
                self.params, self.cfg, self._dev(toks), self._dev(pos),
                (self._layers, self._dev(pt, torch.int32)), dtype=self.compute_dtype,
                attn_window=win, inv_freq=self.inv_freq,
            )
        self.n_prefill_calls += 1

    def _counts_reset(self, slot: int) -> None:
        with torch.inference_mode():
            self.counts[slot].zero_()

    def _decode_step(self, ct: dict, win: int) -> torch.Tensor:
        """One decode step over all slots on the static inputs: forward,
        penalties, sampling. Returns the sampled ids [B]."""
        s = self._in
        hidden, _ = forward_hidden(
            self.params, self.cfg, s.tokens, s.positions, (self._layers, s.page_tables),
            dtype=self.compute_dtype, attn_window=win, inv_freq=self.inv_freq,
        )
        logits = lm_logits(self.params, self.cfg, hidden[:, -1:, :])[:, 0]
        if ct["use_pen"]:
            # OpenAI presence/frequency penalties over generated tokens
            cf = self.counts.to(torch.float32)
            logits = logits - s.freq[:, None] * cf
            logits = logits - s.pres[:, None] * (cf > 0)
        # per-row streams keyed by (seed, step): a seeded request samples the
        # same tokens whatever its batch; all-greedy, top_k 0 and top_p 1
        # batches skip the draw and the sorts
        toks = sample_token(
            logits, None, 0.0 if ct["all_greedy"] else s.temps,
            top_k=0 if ct["all_k0"] else s.top_ks,
            top_p=1.0 if ct["all_p1"] else s.top_ps,
            seeds=s.seeds, steps=s.steps,
        )
        if ct["use_pen"]:
            self.counts[self._slot_idx, toks] += 1
        s.advance(toks)
        return toks

    def _run_decode_window(
        self, tokens, positions, pts, seeds, steps, temps, top_ps, top_ks,
        pres, freq, all_p1: bool, all_k0: bool, use_pen: bool, win: int,
        depth: int,
    ) -> list:
        """Issue `depth` chained decode steps from host inputs."""
        self._in.load(tokens=tokens, positions=positions, steps=steps, seeds=seeds,
                      temps=temps, top_ps=top_ps, top_ks=top_ks, pres=pres, freq=freq,
                      page_tables=pts)
        self._chain_tail = {
            "all_p1": all_p1, "all_k0": all_k0, "use_pen": use_pen,
            "all_greedy": not bool(np.any(np.asarray(temps) != 0.0)),
        }
        return self._chain_steps(win, depth)

    def _chain_steps(self, win: int, depth: int, pts=None) -> list:
        """Advance the device-side decode chain `depth` steps from the static
        inputs (each step feeds its tokens to the next in place, so a later
        window continues without a host round trip). `pts` replaces the page
        tables (a chained window may span pages allocated after they were
        loaded)."""
        ct = self._chain_tail
        key = (win, ct["all_greedy"], ct["all_k0"], ct["all_p1"], ct["use_pen"])
        with torch.inference_mode():
            if pts is not None:
                self._in.load(page_tables=pts)
            toks_windows = []
            for _ in range(depth):
                toks = self.graphs.run(key, lambda: self._decode_step(ct, win))
                self.n_decode_steps += 1
                toks_windows.append(self._to_host(toks))
        return toks_windows

    # ------------------------------------------------------------------

    def _window_buckets(self, max_context: int) -> list[int]:
        cap = self.kv.max_pages_per_seq * self.kv.page_size
        limit = min(max_context, cap, self.max_seq_len)
        wins: list[int] = []
        w = 16
        while True:
            b = min(_bucket(w), cap, self.max_seq_len)
            if b not in wins:
                wins.append(b)
            if b >= limit:
                break
            w = b + 1
        return wins

    def warmup(self, max_context: int | None = None,
               prefill_rows: tuple | None = None,
               decode_windows: list | None = None,
               prefill_windows: list | None = None) -> None:
        """Run every (window, prefill-rows, chunk) shape that serving traffic
        up to `max_context` tokens will hit once, so that first requests do
        not pay for first-use costs (kernel builds, allocator growth, cuBLAS
        handles). Every decode window runs twice for the greedy and for the
        sampled step without top-k, top-p or penalties, so that on the card
        both graphs are captured. Dummy inputs run against the scratch page
        (zero page tables), so no sequence state is touched."""
        wins = self._window_buckets(max_context or self.max_seq_len)
        decode_windows = decode_windows if decode_windows is not None else wins
        prefill_windows = prefill_windows if prefill_windows is not None else wins
        B = self.n_slots
        if prefill_rows is None:
            prefill_rows, r = [], 1
            while r <= B:
                prefill_rows.append(r)
                r *= 2
        zeros = lambda *s: np.zeros(s, np.int32)  # noqa: E731
        dec_pt = self.kv.page_table(["__empty__"] * B)
        for win in decode_windows:
            for temp in (0.0, 1.0):
                window = self._run_decode_window(
                    zeros(B, 1), zeros(B, 1), dec_pt,
                    zeros(B), zeros(B), np.full(B, temp, np.float32),
                    np.ones(B, np.float32), zeros(B), np.zeros(B, np.float32),
                    np.zeros(B, np.float32), True, True, False, win, 2,
                )
                [self._fetch(t) for t in window]
        chunk = self.prefill_chunk
        for rows in prefill_rows:
            pf_pt = self.kv.page_table(["__empty__"] * rows)
            for win in prefill_windows:
                if win < chunk:
                    continue
                toks = zeros(rows, chunk)
                pos = np.broadcast_to(np.arange(chunk, dtype=np.int32), (rows, chunk)).copy()
                self._call_prefill(toks, pos, pf_pt, win)

    def submit(self, req: GenRequest) -> GenRequest:
        req.t_start = time.perf_counter()
        if self.degraded:
            req.error = f"scheduler degraded: {self.degraded}"
            req.finish = FinishReason.ERROR
            req.state = RequestState.DONE
            req.done_event.set()
            return req
        self.pending.put(req)
        return req

    def generate(self, prompt_ids: list[int], **kw) -> Response:
        """Blocking submit+wait (runs the loop inline if not started)."""
        req = GenRequest(prompt_ids=list(prompt_ids), **kw)
        self.submit(req)
        if self._running:
            req.done_event.wait()
        else:
            while req.state != RequestState.DONE:
                self.step()
        return req.to_response(self.tokenizer)

    # ------------------------------------------------------------------

    def _kv_key(self, req: GenRequest) -> str:
        return req.session_id or req.id

    def _touch_session(self, session_id: str) -> None:
        """Move a session to most-recently-used position (dict order = LRU)."""
        if session_id in self.session_state:
            self.session_state[session_id] = self.session_state.pop(session_id)

    def _idle_sessions_lru(self) -> list[str]:
        active = {r.session_id for r in self.slots if r is not None and r.session_id}
        return [s for s in self.session_state if s not in active]

    def _evict_for_pages(self) -> bool:
        """Free pages by suspending the least recently used idle session to
        host RAM. Returns True if something was evicted."""
        for sid in self._idle_sessions_lru():
            if self.suspend_session(sid):
                self._evictions += 1
                return True
        return False

    def _ensure_capacity_evicting(self, key: str, upto: int) -> bool:
        while True:
            try:
                self.kv.alloc.ensure_capacity(key, upto, self.kv.page_size)
                return True
            except MemoryError:
                if not self._evict_for_pages():
                    return False

    def _admit(self) -> None:
        free = [i for i in range(self.n_slots) if self.slots[i] is None]
        deferred: list[GenRequest] = []
        while free:
            try:
                req = self.pending.get_nowait()
            except queue.Empty:
                break
            slot = free[0]
            key = self._kv_key(req)
            # session resume: prepend the pending (sampled but not yet
            # forwarded) token and continue from the stored position
            prompt_ids = list(req.prompt_ids)
            start_pos = 0
            if req.session_id:
                if req.session_id in self._suspended and not self.resume_session(
                    req.session_id
                ):
                    deferred.append(req)  # no pages even after eviction
                    continue
                if req.session_id in self.session_state:
                    start_pos, pending_tok = self.session_state[req.session_id]
                    if pending_tok is not None:
                        prompt_ids = [pending_tok] + prompt_ids
                    self._touch_session(req.session_id)

            n = len(prompt_ids)
            if n == 0 or start_pos + n >= self.max_seq_len:
                req.finish = FinishReason.ERROR
                req.state = RequestState.DONE
                req.done_event.set()
                continue
            if not self._ensure_capacity_evicting(key, start_pos + n):
                deferred.append(req)  # retry when pages free up
                break
            if req.seed is None:
                # unseeded requests still get a fixed per-request stream so
                # batch composition never perturbs their samples
                req.seed = int(self._rng.integers(0, 2**31 - 1))
            # prefill runs in <= prefill_chunk-token chunks interleaved with
            # decode steps, so admissions do not stall the running batch
            req._pf_ids = prompt_ids
            req._pf_done = 0
            req.position = start_pos
            req.slot = slot
            req.state = RequestState.PREFILLING
            self.slots[slot] = req
            free.remove(slot)
            if req.presence_penalty or req.frequency_penalty:
                self._counts_reset(slot)
        for r in deferred:
            self.pending.put(r)

    def _advance_prefill(self) -> None:
        """Run at most ONE prefill call per iteration, batched across all the
        requests still prefilling: concurrent arrivals share the chunk's
        weight reads, and the decode inter-token latency stays bounded by
        the one call."""
        todo = []
        for req in self.slots:
            if req is None or req.state != RequestState.PREFILLING:
                continue
            remaining = len(req._pf_ids) - 1 - req._pf_done
            if remaining > 0:
                todo.append((req, remaining))
            else:
                self._promote_prefilled(req)
        if not todo:
            return
        ps = self.kv.page_size
        table_len = self.kv.max_pages_per_seq * ps
        chunk = min(self.prefill_chunk, max(rem for _, rem in todo))
        bucket = chunk if chunk == self.prefill_chunk else _bucket(chunk)
        # rows must fit pos+bucket inside their page table: pads write to
        # contiguous future positions, and past-table positions would clamp
        # onto the row's LAST real page (corrupting it). Rows near their
        # table end run alone with an exact (pad-free) bucket instead.
        fit = [rt for rt in todo if rt[0].position + bucket <= table_len]
        if not fit:
            req, rem = todo[0]
            chunk = min(self.prefill_chunk, rem)
            bucket = chunk  # exact length: no pads past the table
            fit = [(req, rem)]
        if self.prefill_fair_rows is not None:
            # FIFO fairness: only the oldest K requests advance this call
            fit = sorted(fit, key=lambda rt: rt[0].t_start)
            fit = fit[: self.prefill_fair_rows]
        batch = []
        for req, rem in fit:
            take = min(rem, bucket)
            if self._ensure_capacity_evicting(self._kv_key(req), req.position + take):
                batch.append((req, take))
            # rows without page capacity sit this call out; retried next step
        if not batch:
            return
        # the row count rides powers of two, so that the shapes a server
        # sees stay few; pad rows run the scratch page
        rows = 1
        while rows < len(batch):
            rows *= 2
        toks = np.zeros((rows, bucket), dtype=np.int32)
        pos = np.zeros((rows, bucket), dtype=np.int32)
        seq_ids = ["__empty__"] * rows
        win = 0
        for i, (req, take) in enumerate(batch):
            ids = req._pf_ids
            toks[i, :take] = ids[req._pf_done : req._pf_done + take]
            pos[i] = np.arange(req.position, req.position + bucket)
            seq_ids[i] = self._kv_key(req)
            win = max(win, _bucket(req.position + bucket))
        pt = self.kv.page_table(seq_ids)
        win = min(win, table_len)
        self._call_prefill(toks, pos, pt, win)
        for req, take in batch:
            req._pf_done += take
            req.position += take
            if req._pf_done >= len(req._pf_ids) - 1:
                self._promote_prefilled(req)

    def _promote_prefilled(self, req: GenRequest) -> None:
        req.cur_token = req._pf_ids[-1] if req._pf_ids else req.cur_token
        req.state = RequestState.RUNNING
        req.t_first = time.perf_counter()
        req._pf_ids = []

    def _finish(self, req: GenRequest, reason: FinishReason) -> None:
        req.finish = reason
        if req.tools and self.tokenizer is not None and reason in (FinishReason.STOP_TOKEN,
                                                                    FinishReason.MAX_TOKENS):
            # here, so that the Response's finish reason is final
            stops = req.stop_ids or set(self.cfg.eos_token_ids)
            text = (req.text_override if req.text_override is not None
                    else self.tokenizer.decode([t for t in req.out_ids if t not in stops]))
            calls = extract_tool_calls(text, req.tools)
            if calls:
                req.tool_calls = calls
                req.finish = FinishReason.TOOL_CALL
        req.state = RequestState.DONE
        req.t_done = time.perf_counter()
        GLOBAL_METRICS.record(req.to_response())
        if req.session_id:
            # keep the session's pages; remember where to resume
            self.session_state.pop(req.session_id, None)
            self.session_state[req.session_id] = (req.position, req.cur_token)
            # bound live sessions: LRU-suspend to host beyond max_sessions
            while len(self.session_state) > self.max_sessions:
                idle = self._idle_sessions_lru()
                if not idle or not self.suspend_session(idle[0]):
                    break
        else:
            key = self._kv_key(req)
            if self._undrained is not None:
                # an in-flight chained window may still write through the
                # old page tables; release only after it drains
                self._release_q.append(key)
            else:
                self.kv.alloc.release(key)
        self.slots[req.slot] = None
        req.slot = -1
        req.done_event.set()

    def _flush_releases(self) -> None:
        while self._release_q:
            self.kv.alloc.release(self._release_q.pop())

    def drop_session(self, session_id: str) -> None:
        with self._lock:
            if any(r is not None and r.session_id == session_id for r in self.slots):
                return  # active in the batch: caller retries after finish
            self.session_state.pop(session_id, None)
            self.kv.alloc.release(session_id)
            self._suspended.pop(session_id, None)

    # ------------------------------------------------------------------
    # session offload: an idle session's pages move to host RAM and its
    # device pages are freed; a resume copies them into fresh pages
    # ------------------------------------------------------------------

    def suspend_session(self, session_id: str, to_dir: str | None = None) -> bool:
        if to_dir is not None:
            raise NotImplementedError("suspending a session to disk is not ported yet")
        with self._lock:
            return self._suspend_session_locked(session_id)

    def _suspend_session_locked(self, session_id: str) -> bool:
        if session_id not in self.session_state:
            return False
        if any(r is not None and r.session_id == session_id for r in self.slots):
            # an ACTIVE session's pages are being written by in-flight steps
            return False
        pages = self.kv.alloc.pages_for(session_id)
        if not pages:
            return False
        payload = self._suspend_pages(np.asarray(pages, dtype=np.int64))
        self._suspended[session_id] = (payload, self.session_state[session_id])
        self.kv.alloc.release(session_id)
        self.session_state.pop(session_id)
        return True

    def _suspend_pages(self, idxs_np) -> tuple:
        """The session's pages [L, n_kv, n, ps, hd] (payload and scales for
        q8 pools) gathered out of the pools into host RAM."""
        idxs = torch.from_numpy(idxs_np).to(self.device)

        def take(pool):
            if isinstance(pool, QArray):
                return QArray(take(pool.data), take(pool.scales), pool.fmt)
            return pool[:, :, idxs].cpu()

        with torch.inference_mode():
            return ("ram", take(self.kv.state.k_pool), take(self.kv.state.v_pool))

    def resume_session(self, session_id: str) -> bool:
        with self._lock:
            return self._resume_session_locked(session_id)

    def _resume_session_locked(self, session_id: str) -> bool:
        if session_id not in self._suspended:
            return False
        payload, state = self._suspended[session_id]
        host_k = payload[1]
        n_pages = (host_k.data if isinstance(host_k, QArray) else host_k).shape[2]
        ps = self.kv.page_size
        # allocate with eviction; a full pool must NOT raise out of the
        # scheduler loop (that would fail every in-flight request): the
        # session stays suspended and its requester retries
        while True:
            try:
                pages = self.kv.alloc.ensure_capacity(session_id, n_pages * ps, ps)
                break
            except MemoryError:
                if not self._evict_for_pages():
                    self.kv.alloc.release(session_id)  # partial alloc back
                    return False
        self._suspended.pop(session_id)
        self._restore_pages(payload, np.asarray(pages, dtype=np.int64))
        self.session_state[session_id] = state
        return True

    def _restore_pages(self, payload, idxs_np) -> None:
        idxs = torch.from_numpy(idxs_np).to(self.device)

        def put(pool, host):
            if isinstance(pool, QArray):
                put(pool.data, host.data)
                put(pool.scales, host.scales)
            else:
                pool[:, :, idxs] = host.to(self.device, pool.dtype)

        with torch.inference_mode():
            put(self.kv.state.k_pool, payload[1])
            put(self.kv.state.v_pool, payload[2])

    def _check_stop_strings(self, r: GenRequest) -> bool:
        """True if one of the request's stop strings just completed; sets
        `text_override` to the text truncated at the first stop occurrence."""
        if not r.stop_strings or self.tokenizer is None:
            return False
        # a stop string of L chars spans at most L tokens, so decoding the
        # last L+2 tokens always covers an occurrence that ENDS at the
        # newest token (any earlier occurrence was caught on a prior step)
        window = max(len(s) for s in r.stop_strings) + 2
        tail = self.tokenizer.decode(r.out_ids[-window:])
        if not any(s in tail for s in r.stop_strings):
            return False
        stops = r.stop_ids or set(self.cfg.eos_token_ids)
        full = self.tokenizer.decode([t for t in r.out_ids if t not in stops])
        cut = min((i for i in (full.find(s) for s in r.stop_strings) if i >= 0),
                  default=len(full))
        r.text_override = full[:cut]
        return True

    def _try_chain_dispatch(self, und) -> tuple | None:
        """Dispatch the NEXT decode window chained off the undrained one (no
        host input needed), or None if membership/pages/headroom forbid it.
        Called BEFORE draining `und`, so that the drain's wait for the
        device overlaps this window's work instead of serializing with it."""
        running, _, depth = und
        if not self.pending.empty():
            return None
        if any(r is not None and r.state != RequestState.RUNNING for r in self.slots):
            return None
        if not running:
            return None
        # budget from the CONFIGURED lag (not the in-flight depth), so that a
        # depth cut by the latency budget can recover when the step speeds up
        lag = self.decode_lag
        if any(r.on_token is not None for r in running):
            lag = min(lag, self.stream_lag)
        depth_next = self._budget_lag(lag)
        # host-side positions lag by the in-flight window's `depth` tokens
        head = min(
            min(r.max_new_tokens - len(r.out_ids) for r in running),
            min(self.max_seq_len - 1 - r.position for r in running),
        )
        if head < depth + depth_next:
            return None
        for r in running:
            if not self._ensure_capacity_evicting(
                self._kv_key(r), r.position + depth + depth_next
            ):
                return None
        win = min(
            _bucket(max(r.position for r in running) + depth + depth_next),
            self.kv.max_pages_per_seq * self.kv.page_size,
        )
        # rebuild page tables: the capacity just ensured may have allocated
        # pages that did not exist when the tail's tables were built
        seq_ids = ["__empty__"] * self.n_slots
        for r in running:
            seq_ids[r.slot] = self._kv_key(r)
        pts = self.kv.page_table(seq_ids)
        return (running, self._chain_steps(win, depth_next, pts), depth_next)

    def _budget_lag(self, lag: int) -> int:
        """Depth cap from the inter-token latency budget (identity when no
        budget is set or no step-time estimate exists yet). Floors at 2 when
        chained decode is on: depth 1 never drains through _drain_window,
        so one polluted step-time sample would cut the depth with no sample
        left to recover from."""
        if self.itl_budget_ms is None or not self._step_ms:
            return max(1, lag)
        lo = 2 if self.decode_lag > 1 else 1
        # the floor applies to the BUDGET, never raising depth above the
        # explicitly requested lag
        return min(max(1, lag), max(lo, int(self.itl_budget_ms / self._step_ms)))

    def _drain_window(self, und) -> None:
        running, toks_windows, depth = und
        self._apply_sampled(running, [self._fetch(t) for t in toks_windows])
        # EWMA of per-step time from drain spacing; only back-to-back chained
        # drains are a valid sample, and an interval holding a session
        # suspend is skipped (it measures the offload, not the step)
        now = time.perf_counter()
        if self._last_drain is not None and self._evictions == self._drain_evictions:
            ms = (now - self._last_drain) * 1000.0 / max(1, depth)
            self._step_ms = ms if self._step_ms is None else 0.8 * self._step_ms + 0.2 * ms
        self._drain_evictions = self._evictions
        self._last_drain = now if self._undrained is not None else None

    def step(self) -> int:
        """One scheduler iteration: admit, one prefill chunk, one decode
        window. Serialized with the public session operations (which may be
        called from request threads) by the scheduler's RLock."""
        with self._lock:
            return self._step_locked()

    def _step_locked(self) -> int:
        und = self._undrained
        if und is not None:
            self._undrained = None
            nxt = self._try_chain_dispatch(und)
            self._undrained = nxt  # set before drain: page releases defer
            self._drain_window(und)
            if self._undrained is not None:
                return len([r for r in self.slots if r is not None])
        self._flush_releases()
        self._admit()
        self._advance_prefill()
        running = [r for r in self.slots if r is not None and r.state == RequestState.RUNNING]
        if not running:
            # nothing decoding: let prefills catch up without idling
            return len([r for r in self.slots if r is not None])

        B = self.n_slots
        ps = self.kv.page_size
        tokens = np.zeros((B, 1), dtype=np.int32)
        positions = np.zeros((B, 1), dtype=np.int32)
        temps = np.zeros(B, dtype=np.float32)
        top_ps = np.ones(B, dtype=np.float32)
        top_ks = np.zeros(B, dtype=np.int32)
        seeds = np.zeros(B, dtype=np.int64)
        steps = np.zeros(B, dtype=np.int32)
        pres = np.zeros(B, dtype=np.float32)
        freq = np.zeros(B, dtype=np.float32)
        seq_ids = ["__empty__"] * B
        for r in list(running):
            # make sure the page holding `position` exists before the write
            key = self._kv_key(r)
            if not self._ensure_capacity_evicting(key, r.position + 1):
                # out of pages even after eviction: this row sits the step
                # out (its slot runs the dummy sequence on the scratch page)
                running.remove(r)
                continue
            tokens[r.slot, 0] = r.cur_token
            positions[r.slot, 0] = r.position
            temps[r.slot] = r.temperature
            top_ps[r.slot] = r.top_p
            top_ks[r.slot] = r.top_k
            seeds[r.slot] = r.seed or 0
            steps[r.slot] = len(r.out_ids)
            pres[r.slot] = r.presence_penalty
            freq[r.slot] = r.frequency_penalty
            seq_ids[r.slot] = key
        if not running:
            return len([r for r in self.slots if r is not None])

        use_pen = bool(np.any(pres != 0.0) or np.any(freq != 0.0))

        # chained window depth: several steps back to back when the batch is
        # steady. Page capacity for the whole window is ensured BEFORE the
        # page tables are built, so every step's KV writes land in mapped
        # pages.
        depth = 1
        if (
            self.decode_lag > 1
            and not use_pen
            and self.pending.empty()
            and all(r is None or r.state == RequestState.RUNNING for r in self.slots)
        ):
            head = min(
                min(r.max_new_tokens - len(r.out_ids) for r in running),
                min(self.max_seq_len - 1 - r.position for r in running),
            )
            lag = self.decode_lag
            if any(r.on_token is not None for r in running):
                lag = min(lag, self.stream_lag)
            depth = max(1, min(self._budget_lag(lag), head))
            for r in running:
                if not self._ensure_capacity_evicting(self._kv_key(r), r.position + depth):
                    depth = 1
                    break

        pts = self.kv.page_table(seq_ids)
        win = min(_bucket(int(positions.max()) + depth), self.kv.max_pages_per_seq * ps)
        all_p1 = bool(np.all(top_ps >= 1.0))
        all_k0 = bool(np.all(top_ks <= 0))
        toks_windows = self._run_decode_window(
            tokens, positions, pts, seeds, steps, temps, top_ps, top_ks,
            pres, freq, all_p1, all_k0, use_pen, win, depth,
        )
        if depth > 1:
            # steady state: defer the drain, the next step dispatches a
            # chained window first
            self._undrained = (running, toks_windows, depth)
        else:
            self._apply_sampled(running, [self._fetch(t) for t in toks_windows])
        return len([r for r in self.slots if r is not None])

    def _apply_sampled(self, running, windows) -> None:
        """Apply sampled-token windows ([B]-indexed host arrays, oldest first)
        to the running requests: stop checks, finishes, callbacks. Tokens
        sampled past a request's stop are discarded."""
        for toks_host in windows:
            for r in running:
                if r.state != RequestState.RUNNING:
                    continue  # finished earlier in this window; discard
                nxt = int(toks_host[r.slot])
                if not r.out_ids:
                    # the first token is served when the host has it
                    r.t_first = time.perf_counter()
                r.position += 1
                r.cur_token = nxt
                r.out_ids.append(nxt)
                stops = r.stop_ids or set(self.cfg.eos_token_ids)
                if nxt in stops:
                    self._finish(r, FinishReason.STOP_TOKEN)
                elif self._check_stop_strings(r):
                    self._finish(r, FinishReason.STOP_TOKEN)
                elif len(r.out_ids) >= r.max_new_tokens:
                    self._finish(r, FinishReason.MAX_TOKENS)
                elif r.position + 1 >= self.max_seq_len:
                    self._finish(r, FinishReason.MAX_TOKENS)
                elif r.on_token is not None:
                    r.on_token(nxt)

    # ------------------------------------------------------------------

    def _fail_active(self, message: str) -> None:
        """Finish every in-flight request with ERROR and the message (the
        serving loop survives a failed step)."""
        self._undrained = None  # drop any half-dispatched window
        for r in list(self.slots):
            if r is None:
                continue
            r.error = message
            self._finish(r, FinishReason.ERROR)
        while True:
            try:
                r = self.pending.get_nowait()
            except queue.Empty:
                break
            r.error = message
            r.finish = FinishReason.ERROR
            r.state = RequestState.DONE
            r.done_event.set()
        self._flush_releases()

    def start(self) -> None:
        """Run the scheduling loop on a background thread (serving mode)."""
        if self._running:
            return
        self._running = True

        def loop():
            while self._running:
                try:
                    n = self.step()
                except Exception as e:  # noqa: BLE001 — surface, don't die
                    traceback.print_exc()
                    self._fail_active(f"{type(e).__name__}: {e}")
                    continue
                if n == 0 and self.pending.empty():
                    time.sleep(0.001)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
