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
  inputs;
- prefill: chunks of at most `prefill_chunk` tokens, batched across every
  request still prefilling, interleaved with the decode steps; each chunk
  writes its KV rows into the request's pages (K4) and attends over the
  gathered live window (K3); on the card a prefill call is a captured CUDA
  graph, one per (rows, chunk, window) (the JAX package's jitted
  `_prefill`), each with static tokens, positions and page tables of its
  own, sharing the decode graphs' memory pool;
- `warmup` runs every decode variant and every prefill key that traffic up
  to a context length can reach twice, so that on the card each is captured
  before the first request;
- chained decode windows: when the batch is steady, up to `decode_lag` steps
  are issued back to back, each sampled token fed to the next step in
  place, and their tokens come back through non-blocking copies into
  pinned host memory, waited on by an event when the window is drained, one
  window late; the host's bookkeeping then overlaps the device's work;
- per-row sampling parameters, per-row seeded streams, presence/frequency
  penalties from per-slot token counts kept on the device;
- sessions: pages stay with a session between requests, least recently used
  idle sessions are suspended to host RAM beyond `max_sessions` or when the
  pool runs out, and resume into fresh pages; `suspend_session(sid,
  to_dir=...)` writes them to `{to_dir}/{sid}.kv.npz` instead, the JAX
  scheduler's file (each pool leaf as a uint8 view), which either package
  resumes;
- `weight_format="q4s"`: W4A8 serving (the JAX CLI's `serve --pallas
  w8a8`): the 2-D q4 weights are re-quantized to q4s once, after fusing, and
  every projection and the lm_head take K5.

MoE configs (Mixtral) serve with q4 experts through K6 (`ops/moe_q4.py`),
with q4s attention, router and lm_head under `weight_format="q4s"`, and with
float experts through the card's grouped product (`ops/moe_float.py`).

Tool calls: a request with `tools` whose finished text holds a tool-shaped
JSON finishes TOOL_CALL with `tool_calls` set, as in the JAX package.

`embed_engine`: the `Engine` that answers `/v1/embeddings` beside the
scheduler (None: no embeddings). The JAX CLI's `serve` attaches one that
shares the scheduler's fused tree, `Engine(sched.params, sched.cfg,
tokenizer, device=sched.device, fuse=False, moe_ragged=False)`, so that the
layer weights are held once.

Tensor parallelism (`mesh` with tp > 1): one process per rank,
each holding its slice of the fused tree (`parallel/mesh.py::shard_params`)
and n_kv/tp heads of the KV pool, its forward under a tp context
(`parallel/tp_forward.py`: an all-reduce after wo and w2, the
vocabulary-sharded embedding and lm_head). Rank 0 owns the scheduler: the
page allocator, the sessions, the HTTP server. Before each device call it
publishes the call's inputs on `step_channel` (`runtime/coordination.py`:
ops prefill, decode, decode_chain, counts_reset, suspend, resume, sdrop,
ping, stop, and the pipelined scheduler's ptick, at the JAX leader's
points), and the other ranks replay them in
`run_follower`. A chained window (decode_chain) carries no tokens: every rank
samples its own from the same gathered logits with the same seeds and
counters, so all ranks feed back the same ids. A disk suspend writes one
file per rank, `{to_dir}/{sid}.kv.p{global rank}.npz` (the JAX package's
multi-process layout). On the card the steps are CUDA graphs under tp too
(the JAX package's jitted shard_map steps): a step's collectives are its
boundary ops (`runtime/graphs.py`), so its graph is a chain of segments,
the compute between two collectives each, and the collectives run between
the segments' replays; `warmup()` captures the same keys on every rank,
whose followers reach each key's first and second use at the leader's
steps. MoE under tp is expert parallelism: each rank holds E/tp experts of
every layer (`nn/layers.py::moe_block`).

Data parallelism (`mesh` with dp > 1; `jlama_tpu/runtime/scheduler.py:
151-184, 475-550, 780-818, 869-916, 1017-1050, 1186`): a world of dp × tp
ranks, rank r tp rank r % tp of dp group r // tp. Group g owns the slots g ·
n_slots/dp onward and the page range g · n_pages/dp onward
(`kv/paged.py`: the allocator's groups; a rank's pool holds its range
only). The leader (global rank 0) keeps the one host scheduler: a session is
pinned to its group (admission takes a free slot of that group, a
suspended session remembers it), eviction looks only in the group that
needs pages, and prefill rows are laid out in dp blocks, each padded to the
same power of two. Every rank replays the published step on its group's
rows and page range only; the first tp rank of each group then sends its
rows' sampled ids to the leader (`mesh.rows`, one all-gather in dp order,
which is slot order). A suspend gathers the pages on the session's group
only, and a disk suspend writes that group's files. At tp = 1 a rank's
forward holds no collective, so its decode steps and prefills stay CUDA
graphs, the id gather outside them.

Pipeline parallelism (`mesh` with pp > 1; `jlama_tpu/runtime/scheduler.py`
on a pp mesh, which the JAX package runs through GSPMD): a world of dp × pp
× tp ranks, rank r tp rank r % tp of stage (r // tp) % pp of dp group
r // (pp · tp). Each rank holds its stage's L/pp layers (cut to its tp
slice) and a pool of those layers' pages. This scheduler runs every device
call stage by stage (`parallel/pipeline.py::stage_hidden`): stage 0 embeds
and runs its layers, writing its pages, and hands the hidden state on; the
last stage computes the logits and samples, and the ring's wrap-around
carries the ids back to stage 0, whose first rank of each dp group then
sends them to the leader as under dp. This is `serve --no-pp-pipeline`; the
pipelined decode is `runtime/pipelined.py::PipelinedScheduler`. The leader
keeps the allocator, the sessions and the server and publishes each call as
under tp; every rank replays its stage's part. A suspend gathers each
rank's own layers' pages (a disk suspend writes one file per rank). On the
card a stage's step is a chain of graph segments cut at its hand-overs
(its receive from the previous stage, its send to the next, the ids' way
back to stage 0), which run between the replays.

Under tp, q4s serves each rank's slice converted to K5's layout (its
column-parallel rows, its 256-groups of wo's and w2's K, its vocabulary
rows of the lm_head): the cut of the whole converted tree, so each rank's K
of wo and w2 must be a multiple of 256 (`parallel/mesh.py::
check_q4s_rank`). On a mesh, `embed_engine` is an `Engine` over the same
rank tree (`Engine(..., mesh=, step_channel=, step_lock=)`): the leader
publishes its embed calls as the step ops embed_hidden and embed_pool,
under the scheduler's lock so that they keep their place among the steps,
and `run_follower` replays them on the ranks of dp group 0; the other dp
groups skip them (an embed call runs on the leader's group only, where the
JAX package runs it replicated over dp).
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
from ..models.base import (check_moe_device, fuse_params, lm_logits, params_to,
                           prepare_moe_ragged, rope_inv_freq)
from ..nn.qarray import QArray
from ..nn.sampling import sample_token
from ..ops.w8a8 import prepare_params_for_w8a8
from ..parallel.mesh import RankSlice, check_q4s_rank, check_whole, rank_params
from ..parallel.pipeline import stage_cfg, stage_hidden
from ..parallel.tp_forward import TPCtx, check_tp, tp_context
from ..prompt import extract_tool_calls
from ..utils.metrics import GLOBAL_METRICS
from .engine import FinishReason, Response, _bucket
from .graphs import DecodeInputs, PrefillInputs, StepGraphs


def _has_qleaves(params: dict) -> bool:
    """Whether any weight of the tree is quantized (q4 row-parallel slices
    must then hold whole blocks)."""
    leaves = [v for k, v in params.items() if k != "layers"]
    leaves += [v for d in params["layers"] for v in d.values()]
    return any(isinstance(v, QArray) for v in leaves)


def _pool_leaves(k, v) -> list:
    """The leaves of (k, v) in the JAX package's tree order: [k, v] for
    float pools, [k.data, k.scales, v.data, v.scales] for q8 ones."""
    return [t for p in (k, v) for t in ((p.data, p.scales) if isinstance(p, QArray) else (p,))]


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
        decode_graphs: bool | None = None,
        moe_ragged: bool = True,
    ):
        """kv_dtype: a torch float dtype or "q8". device: CUDA unless named;
        raises without CUDA and without it. The params are moved there.
        decode_graphs=False runs every decode step and every prefill call
        eagerly on the card too (the yardstick the graphs are held against);
        None or True: graphs on the card, on one device and on every mesh
        (a step's collectives and hand-overs cut its graph into segments).

        mesh: a `parallel.mesh.Mesh`; tp > 1 takes this rank's `TPGroup`
        (`mesh.group`), and the params are either the full tree, which each
        rank fuses (interleaved per rank), slices and moves to its device
        (the group's unless `device` is named), or this rank's `RankSlice`
        (`parallel/distributed.py::load_params_sharded`, which reads only
        the slice); dp > 1 takes its dp index and, on a group's first tp
        rank, `mesh.rows` (module docstring). step_channel: rank 0's
        publishing end or a follower's receiving end
        (`runtime/coordination.py`). pp > 1 takes the rank's stage ring
        (`mesh.ring`) and runs stage by stage (module docstring). Layers
        that pp does not divide raise, as do heads or experts that tp does
        not divide, slots or pages that dp does not, and under q4s a rank's
        K of wo or w2 that is no multiple of 256: nothing runs unsharded in
        their place.

        weight_format: None keeps the weights as they are. "q4s" re-quantizes
        the 2-D q4 weights to the W4A8 format after fusing (q4s rows are never
        concatenated), and a tied lm_head gets a q4s copy. The JAX package's
        "q4k" (its TPU kernel's own q4 layout) has no counterpart and raises:
        K1 reads the checkpoint's JQ4 layout as it is, so None serves q4.

        moe_ragged: as in the JAX package, float MoE experts are transposed
        once into the grouped layout; q4 experts are left as they are (K6
        reads them). q4s with MoE converts as the JAX package does: its
        `prepare_params_for_w8a8` takes 2-D leaves and the stacked [L, N, K]
        ones, so the attention weights, a q4 router [E, D] (K a multiple of
        256) and the lm_head go to q4s and K5, and the expert stacks
        [L, E, N, K] stay q4 for K6; the port's layers are not stacked, and
        its 2-D rule gives the same tree."""
        if weight_format not in (None, "q4s"):
            raise ValueError(f"weight_format {weight_format!r}: expected None or 'q4s' "
                             "(q4 weights need no repack: pass None)")
        tp = dp = pp = 1
        if mesh is not None:
            check_tp(cfg, mesh, quantized=_has_qleaves(params), n_slots=n_slots,
                     n_pages=n_pages)
            tp, dp, pp = mesh.tp, mesh.dp, mesh.pp
        if tp > 1 and mesh.group is None:
            raise ValueError(f"mesh tp={tp} needs this rank's TPGroup (mesh.group)")
        if step_channel is not None and tp * dp * pp == 1:
            raise ValueError("a step_channel needs a mesh of more than one rank (dp * pp * tp "
                             "> 1): multi-process serving is mesh serving")
        self._chan = step_channel
        tp_rank = mesh.group.rank if tp > 1 else 0
        self._dp, self._g = dp, mesh.dp_index if mesh is not None else 0
        self._spg = n_slots // dp  # slots of a dp group: this rank's rows
        self._rows = mesh.rows if dp > 1 else None  # the ids' way to the leader
        self._ring = mesh.ring if pp > 1 else None  # the stage ring
        stage = mesh.stage if pp > 1 else 0
        self._first_layer = stage * (cfg.n_layers // pp)  # the stage's first layer
        self._world = dp * pp * tp
        self._grank = (self._g * pp + stage) * tp + tp_rank  # global rank
        self._is_leader = self._grank == 0
        self._tp: TPCtx | None = None
        self.fwd_cfg = cfg  # the forward's view: a rank's heads under tp
        if self._world > 1 and device is None and mesh.group is not None:
            device = mesh.group.device
        if tp > 1 or pp > 1:
            self.device = resolve_device(device)
            params, self._tp, self.fwd_cfg = rank_params(params, cfg, mesh, self.device, fuse)
        else:
            check_whole(params, cfg)
            self.device = resolve_device(device)
            params = params_to(params, self.device)
            if fuse:
                params = fuse_params(params)
        if cfg.n_experts:
            if moe_ragged:
                params = prepare_moe_ragged(params)
            check_moe_device(params, self.device)
        if weight_format == "q4s":
            if tp > 1:
                check_q4s_rank(params, tp)
            params = prepare_params_for_w8a8(params)
        if tp > 1 or pp > 1:  # the rank's slice says so (an Engine sharing it reads it)
            vocab = ((self._tp.embed_vocab_sharded, self._tp.lm_head_vocab_sharded) if tp > 1
                     else (False, False))
            params = RankSlice(params, tp, tp_rank, vocab, pp, stage)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.n_slots = n_slots
        self.compute_dtype = compute_dtype
        max_seq = min(max_seq_len or cfg.context_length, cfg.context_length)
        self.max_seq_len = max_seq
        self.kv = PagedKVCache(
            stage_cfg(self.fwd_cfg, pp), n_pages=n_pages, page_size=page_size,
            max_pages_per_seq=-(-max_seq // page_size), dtype=kv_dtype, device=self.device,
            groups=dp, group=self._g if dp > 1 else None,
        )
        self._layers = self.kv.layer_states()  # per-layer views of the pools
        self.inv_freq = rope_inv_freq(cfg, self.device)
        self.slots: list[GenRequest | None] = [None] * n_slots
        self.pending: queue.Queue[GenRequest] = queue.Queue()
        # session resume state: session_id -> (position, pending_token); the
        # pages stay allocated under the session's kv key between requests;
        # insertion order == LRU order (entries re-inserted on use)
        self.session_state: dict[str, tuple[int, int | None]] = {}
        self._suspended: dict[str, tuple] = {}  # session -> (payload, state)
        # session -> (its dp group, its page count), kept beside a suspend
        self._suspended_at: dict[str, tuple[int, int]] = {}
        self.max_sessions = max_sessions
        self.prefill_chunk = prefill_chunk
        # double-buffered decode windows: the undrained window's host token
        # buffers + its running-request snapshot; page releases are deferred
        # while a chained window may still write through old page tables
        self._undrained: tuple | None = None
        self._release_q: list[str] = []
        # the static variants of the chain's steps (set by each host-fed window)
        self._chain_tail: dict | None = None
        # one set of static step inputs, read by every decode graph (this
        # rank's rows: its dp group's slots)
        self._in = DecodeInputs(self._spg, self.device, pages=self.kv.max_pages_per_seq)
        # on a mesh too: a step's collectives and hand-overs cut its graph
        # into segments (runtime/graphs.py)
        graphs = decode_graphs is not False
        eager = None if graphs else "decode_graphs=False: the eager yardstick"
        self.graphs = StepGraphs(self.device, graphs, eager_reason=eager)
        self.prefill_graphs = StepGraphs(self.device, graphs, pool_of=self.graphs,
                                         eager_reason=eager)
        self.degraded: str | None = None
        self._rng = np.random.default_rng(seed)
        # per-slot generated-token counts for presence/frequency penalties,
        # on the device, scatter-updated inside the decode step
        self.counts = torch.zeros((self._spg, cfg.vocab_size), dtype=torch.int32,
                                  device=self.device)
        self._slot_idx = torch.arange(self._spg, device=self.device)
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
        # every decode step's sampled ids of this rank's rows as host arrays,
        # when a list (the check that each rank fed back the leader's ids)
        self.sampled_log: list | None = None
        self.embed_engine = None  # an Engine over self.params for embeddings

    # ------------------------------------------------------------------
    # device calls
    # ------------------------------------------------------------------

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

    def _local(self, a):
        """This rank's block of a per-row host array (its dp group's rows:
        block g of dp equal blocks); the array itself at dp = 1."""
        if self._dp == 1:
            return a
        n = len(a) // self._dp
        return a[self._g * n:(self._g + 1) * n]

    def _gather_ids(self, toks: torch.Tensor):
        """dp: the ids of every group's rows on the leader, as a window item.
        The first tp rank of each group sends its rows' ids over `mesh.rows`
        (one all-gather in dp order: slot order); the other tp ranks send
        nothing (their group's first rank holds the same ids) and get None."""
        if self._rows is None:
            if self._is_leader:
                raise RuntimeError("dp > 1 needs mesh.rows on the leader (the group that "
                                   "carries each dp group's sampled ids to it)")
            return None
        return self._rows.all_gather(toks.to("cpu", torch.int32), dim=0), None

    def _call_prefill(self, toks, pos, pt, win: int) -> None:
        """One prefill call over [rows, T] host tokens, positions and page
        tables [rows, P] (under dp: dp blocks of rows, this rank running its
        group's block against its page range): on the card one graph per
        (rows, T, window), from that key's static inputs."""
        if self._chan is not None and self._is_leader:
            self._chan.publish({"op": "prefill", "toks": toks, "pos": pos, "pt": pt,
                                "win": int(win)})
        toks, pos, pt = self._local(toks), self._local(pos), self.kv.local_tables(self._local(pt))
        rows, T = toks.shape
        key = (rows, T, win)
        inp = self.prefill_graphs.inputs(
            key, lambda: PrefillInputs(rows, T, self.device, pages=self.kv.max_pages_per_seq))
        inp.load(tokens=toks, positions=pos, page_tables=pt)

        def run():
            self._forward(inp.tokens, inp.positions, (self._layers, inp.page_tables), win)

        with torch.inference_mode(), tp_context(self._tp):
            self.prefill_graphs.run(key, run)
        self.n_prefill_calls += 1

    def _forward(self, tokens, positions, cache, win: int):
        """One forward's hidden states over the paged cache; under pp the
        stage-serial forward, whose hidden state ends on the last stage
        (None on the others)."""
        return stage_hidden(self._ring, self.params, self.fwd_cfg, tokens, positions, cache,
                            self.compute_dtype, win, self.inv_freq, self._first_layer)

    def _counts_reset(self, slot: int) -> None:
        if self._chan is not None and self._is_leader:
            self._chan.publish({"op": "counts_reset", "slot": int(slot)})
        row = slot - self._g * self._spg
        if 0 <= row < self._spg:  # a slot of this rank's dp group
            with torch.inference_mode():
                self.counts[row].zero_()

    def _decode_step(self, ct: dict, win: int) -> torch.Tensor:
        """One decode step over all slots on the static inputs: forward,
        penalties, sampling. Returns the sampled ids [B]. Under pp the last
        stage samples and sends the ids to stage 0, which returns them; the
        stages between return None."""
        s = self._in
        hidden = self._forward(s.tokens, s.positions, (self._layers, s.page_tables), win)
        if hidden is None:  # a stage before the last: stage 0 takes the last stage's ids
            toks = (self._ring.exchange(recv_last=((self._spg,), torch.int64))[1]
                    if self._ring.first else None)
            s.advance(toks if toks is not None else s.tokens[:, 0])
            return toks
        logits = lm_logits(self.params, self.fwd_cfg, hidden[:, -1:, :])[:, 0]
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
        if self._ring is not None:  # the wrap-around: the ids back to stage 0
            self._ring.exchange(send_first=toks)
        s.advance(toks)
        return toks

    def _run_decode_window(
        self, tokens, positions, pts, seeds, steps, temps, top_ps, top_ks,
        pres, freq, all_p1: bool, all_k0: bool, use_pen: bool, win: int,
        depth: int,
    ) -> list:
        """Issue `depth` chained decode steps from host inputs (rank 0
        publishes them first)."""
        if self._chan is not None and self._is_leader:
            self._chan.publish(
                {"op": "decode", "tokens": tokens, "positions": positions, "pts": pts,
                 "seeds": seeds, "steps": steps, "temps": temps, "top_ps": top_ps,
                 "top_ks": top_ks, "pres": pres, "freq": freq, "all_p1": all_p1,
                 "all_k0": all_k0, "use_pen": use_pen, "win": int(win), "depth": int(depth)})
        loc = self._local
        self._in.load(tokens=loc(tokens), positions=loc(positions), steps=loc(steps),
                      seeds=loc(seeds), temps=loc(temps), top_ps=loc(top_ps),
                      top_ks=loc(top_ks), pres=loc(pres), freq=loc(freq),
                      page_tables=self.kv.local_tables(loc(pts)))
        # the variant from every row, so that all ranks run the same one
        all_greedy = not bool(np.any(np.asarray(temps) != 0.0))
        # an all-greedy step ignores top-k and top-p: one variant for them all
        self._chain_tail = {
            "all_p1": all_p1 or all_greedy, "all_k0": all_k0 or all_greedy,
            "use_pen": use_pen, "all_greedy": all_greedy,
        }
        return self._chain_steps(win, depth)

    def run_follower(self) -> None:
        """The loop of a rank > 0: replay rank 0's device calls from the step
        channel, so that every rank issues the same collectives in the same
        order (`jlama_tpu/runtime/scheduler.py:run_follower`). Returns when
        rank 0 publishes "stop"; raises ConnectionError when rank 0 is gone."""
        if self._chan is None or self._is_leader:
            raise RuntimeError("run_follower needs a step channel on a rank > 0")
        while True:
            msg = self._chan.next()
            op = msg["op"]
            if op == "stop":
                return
            if op == "ping":  # rank 0's idle heartbeat
                continue
            if op == "prefill":
                self._call_prefill(msg["toks"], msg["pos"], msg["pt"], msg["win"])
            elif op == "decode":
                self._run_decode_window(
                    msg["tokens"], msg["positions"], msg["pts"], msg["seeds"], msg["steps"],
                    msg["temps"], msg["top_ps"], msg["top_ks"], msg["pres"], msg["freq"],
                    msg["all_p1"], msg["all_k0"], msg["use_pen"], msg["win"], msg["depth"])
            elif op == "decode_chain":
                self._chain_steps(msg["win"], msg["depth"], msg.get("pts"))
            elif op == "counts_reset":
                self._counts_reset(msg["slot"])
            elif op == "suspend":  # the session's dp group's ranks hold its pages
                group = msg.get("group", 0)
                if group == self._g:
                    payload = self._suspend_pages(msg["sid"], msg["idxs"], msg["dir"])
                    self._suspended[msg["sid"]] = (payload, None)
            elif op == "resume":
                if msg.get("group", 0) == self._g:
                    payload = self._suspended.pop(msg["sid"])[0]
                    self._restore_pages(self._payload_leaves(msg["sid"], payload),
                                        msg["idxs"])
            elif op == "sdrop":
                self._suspended.pop(msg["sid"], None)
            elif op in ("embed_hidden", "embed_pool"):
                # the leader's embed_engine call: its forward under the tp
                # group of dp group 0 (the other dp groups skip it)
                eng = self.embed_engine
                if eng is None:
                    raise RuntimeError("the leader published an embed step but this rank "
                                       "has no embed_engine")
                if self._g == 0:
                    if op == "embed_hidden":
                        eng.run_embed_hidden(msg["toks"], msg["pos"], msg["tt"], msg["lens"])
                    else:
                        eng.run_embed_pooled(msg["toks"], msg["pos"], msg["tt"], msg["lens"],
                                             msg["pooling"])
            elif op == "ptick":
                self._run_ticks(msg, publish=False, collect=False)
            else:
                raise ValueError(f"unknown step op {op!r}")

    def _chain_steps(self, win: int, depth: int, pts=None) -> list:
        """Advance the device-side decode chain `depth` steps from the static
        inputs (each step feeds its tokens to the next in place, so a later
        window continues without a host round trip). `pts` replaces the page
        tables (a chained window may span pages allocated after they were
        loaded). Under dp each step's ids are gathered to the leader outside
        the step (its graph holds no collective)."""
        ct = self._chain_tail
        key = (win, ct["all_greedy"], ct["all_k0"], ct["all_p1"], ct["use_pen"])
        with torch.inference_mode(), tp_context(self._tp):
            if pts is not None:
                self._in.load(page_tables=self.kv.local_tables(self._local(pts)))
            toks_windows = []
            for _ in range(depth):
                toks = self.graphs.run(key, lambda: self._decode_step(ct, win))
                self.n_decode_steps += 1
                if toks is None:  # a pp stage between the first and the last
                    toks_windows.append(None)
                    continue
                toks_windows.append(self._to_host(toks) if self._dp == 1
                                    else self._gather_ids(toks))
                if self.sampled_log is not None:
                    self.sampled_log.append(toks.cpu().numpy())
        return toks_windows

    def _run_ticks(self, msg: dict, publish: bool, collect: bool):
        raise ValueError("the leader published a pipelined tick window (step op 'ptick'), "
                         "which only the PipelinedScheduler (runtime/pipelined.py) runs")

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

    def _prefill_bucket(self, chunk: int) -> int:
        """The prefill length of a call whose longest row takes `chunk` tokens."""
        return chunk if chunk == self.prefill_chunk else _bucket(chunk)

    def warmup(self, max_context: int | None = None,
               prefill_rows: tuple | None = None,
               decode_windows: list | None = None,
               prefill_windows: list | None = None) -> None:
        """Run every decode variant and (rows, chunk, window) prefill shape
        that serving traffic up to `max_context` tokens will hit twice, so
        that first requests do not pay for first-use costs (kernel builds,
        allocator growth, cuBLAS handles) and, on the card, every graph is
        captured. The decode variants of a window: greedy, and sampled with
        and without top-k and top-p, each with and without penalties; the
        prefill chunks: `prefill_chunk` and every shorter bucket. Dummy
        inputs run against the scratch page (zero page tables), so no
        sequence state is touched."""
        wins = self._window_buckets(max_context or self.max_seq_len)
        decode_windows = decode_windows if decode_windows is not None else wins
        prefill_windows = prefill_windows if prefill_windows is not None else wins
        B, dp = self.n_slots, self._dp
        if prefill_rows is None:
            prefill_rows, r = [], 1
            while True:  # the powers of two _advance_prefill rounds rows up to
                prefill_rows.append(r * dp)  # dp: a block of r rows a group
                if r >= self._spg:
                    break
                r *= 2
        zeros = lambda *s: np.zeros(s, np.int32)  # noqa: E731
        # dummy tables point at each row's group scratch page
        dec_pt = self.kv.page_table(["__empty__"] * B, groups=self._slot_groups())
        variants = [(0.0, 0, 1.0, pen) for pen in (0.0, 0.5)] + [
            (1.0, k, p, pen) for k in (0, 40) for p in (1.0, 0.9) for pen in (0.0, 0.5)]
        for win in decode_windows:
            for temp, top_k, top_p, pen in variants:
                window = self._run_decode_window(
                    zeros(B, 1), zeros(B, 1), dec_pt,
                    zeros(B), zeros(B), np.full(B, temp, np.float32),
                    np.full(B, top_p, np.float32), np.full(B, top_k, np.int32),
                    np.full(B, pen, np.float32), np.zeros(B, np.float32),
                    top_p >= 1.0, top_k <= 0, pen != 0.0, win, 2,
                )
                [self._fetch(t) for t in window]
        cap = self.kv.max_pages_per_seq * self.kv.page_size
        buckets = sorted({self._prefill_bucket(c) for c in range(1, self.prefill_chunk + 1)})
        for rows in prefill_rows:
            pf_pt = self.kv.page_table(["__empty__"] * rows,
                                       groups=[i // (rows // dp) for i in range(rows)])
            for bucket in buckets:
                pos = np.broadcast_to(np.arange(bucket, dtype=np.int32), (rows, bucket)).copy()
                for win in prefill_windows:
                    if win < min(bucket, cap):
                        continue
                    for _ in range(2):
                        self._call_prefill(zeros(rows, bucket), pos, pf_pt, win)

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

    def _evict_for_pages(self, group: int = 0) -> bool:
        """Free pages by suspending the least recently used idle session to
        host RAM. Returns True if something was evicted. Under dp only a
        session of the group that needs pages frees useful ones (the groups'
        page ranges are disjoint)."""
        for sid in self._idle_sessions_lru():
            if self._dp > 1 and self.kv.alloc.group_of.get(sid, 0) != group:
                continue
            if self.suspend_session(sid):
                self._evictions += 1
                return True
        return False

    def _ensure_capacity_evicting(self, key: str, upto: int, group: int = 0) -> bool:
        while True:
            try:
                self.kv.alloc.ensure_capacity(key, upto, self.kv.page_size, group=group)
                return True
            except MemoryError:
                if not self._evict_for_pages(group):
                    return False

    def _group_of_slot(self, slot: int) -> int:
        return slot // self._spg

    def _slot_groups(self) -> list[int] | None:
        """Each slot's dp group (its page tables' scratch page); None at dp = 1."""
        return None if self._dp == 1 else [self._group_of_slot(s) for s in range(self.n_slots)]

    def _admit(self) -> None:
        free = [i for i in range(self.n_slots) if self.slots[i] is None]
        deferred: list[GenRequest] = []
        while free:
            try:
                req = self.pending.get_nowait()
            except queue.Empty:
                break
            key = self._kv_key(req)
            # dp: a session with live or suspended pages is pinned to the
            # group that owns its page range; the slot is chosen before any
            # resume, so that a busy group causes no resume and re-suspend
            want_g = None
            if self._dp > 1:
                want_g = self.kv.alloc.group_of.get(key)
                if want_g is None and key in self._suspended_at:
                    want_g = self._suspended_at[key][0]
            slot = next((s for s in free if want_g in (None, self._group_of_slot(s))), None)
            if slot is None:
                deferred.append(req)  # that group's slots are busy; retried later
                continue
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
            if not self._ensure_capacity_evicting(key, start_pos + n, self._group_of_slot(slot)):
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
        bucket = self._prefill_bucket(chunk)
        # rows must fit pos+bucket inside their page table: pads write to
        # contiguous future positions, which the JAX scheduler clamps onto
        # the row's LAST real page. Rows near their table end run alone, as
        # there; their bucket keeps its pads (so that warm-up knows its
        # shape), since K4 drops a write past the page table.
        fit = [rt for rt in todo if rt[0].position + bucket <= table_len]
        if not fit:
            req, rem = todo[0]
            bucket = self._prefill_bucket(min(self.prefill_chunk, rem))
            fit = [(req, rem)]
        if self.prefill_fair_rows is not None:
            # FIFO fairness: only the oldest K requests advance this call
            fit = sorted(fit, key=lambda rt: rt[0].t_start)
            fit = fit[: self.prefill_fair_rows]
        batch = []
        for req, rem in fit:
            take = min(rem, bucket)
            if self._ensure_capacity_evicting(self._kv_key(req), req.position + take,
                                              self._group_of_slot(req.slot)):
                batch.append((req, take))
            # rows without page capacity sit this call out; retried next step
        if not batch:
            return
        # the row count rides powers of two, so that the shapes a server
        # sees stay few; pad rows run the scratch page. dp: the rows are dp
        # blocks of rpg rows, block g group g's requests (each rank prefills
        # its own block), its pad rows on the group's scratch page
        dp = self._dp
        by_g: dict[int, list] = {}
        for req, take in batch:
            by_g.setdefault(self._group_of_slot(req.slot), []).append((req, take))
        rpg = 1
        while rpg < max(len(v) for v in by_g.values()):
            rpg *= 2
        rows = dp * rpg
        toks = np.zeros((rows, bucket), dtype=np.int32)
        pos = np.zeros((rows, bucket), dtype=np.int32)
        seq_ids = ["__empty__"] * rows
        win = 0
        for g, items in by_g.items():
            for j, (req, take) in enumerate(items):
                i = g * rpg + j
                ids = req._pf_ids
                toks[i, :take] = ids[req._pf_done : req._pf_done + take]
                pos[i] = np.arange(req.position, req.position + bucket)
                seq_ids[i] = self._kv_key(req)
                win = max(win, _bucket(req.position + bucket))
        pt = self.kv.page_table(seq_ids, groups=[i // rpg for i in range(rows)] if dp > 1
                                else None)
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
            self._suspended_at.pop(session_id, None)
            if self._suspended.pop(session_id, None) is not None and self._chan is not None:
                # free the followers' copies too
                self._chan.publish({"op": "sdrop", "sid": session_id})

    # ------------------------------------------------------------------
    # session offload: an idle session's pages move to host RAM (or to a
    # file) and its device pages are freed; a resume copies them into fresh
    # pages
    # ------------------------------------------------------------------

    def suspend_session(self, session_id: str, to_dir: str | None = None) -> bool:
        """Move an idle session's pages off the device: to host RAM, or with
        `to_dir` to `{to_dir}/{session_id}.kv.npz` (the JAX scheduler's
        file, which its `resume_session` reads too). False if the session is
        unknown, active or holds no page."""
        with self._lock:
            return self._suspend_session_locked(session_id, to_dir)

    def _suspend_session_locked(self, session_id: str, to_dir: str | None = None) -> bool:
        if session_id not in self.session_state:
            return False
        if any(r is not None and r.session_id == session_id for r in self.slots):
            # an ACTIVE session's pages are being written by in-flight steps
            return False
        pages = self.kv.alloc.pages_for(session_id)
        if not pages:
            return False
        idxs = np.asarray(pages, dtype=np.int64)
        # the session's dp group, kept so that its resume allocates from the
        # same range (its rows run there)
        group = self.kv.alloc.group_of.get(session_id, 0)
        if self._chan is not None:
            # the followers of its group gather their own heads' pages
            self._chan.publish({"op": "suspend", "sid": session_id, "idxs": idxs,
                                "dir": to_dir, "group": group})
        payload = (self._suspend_pages(session_id, idxs, to_dir) if group == self._g
                   else ("remote",))  # another group's ranks hold the pages
        self._suspended[session_id] = (payload, self.session_state[session_id])
        self._suspended_at[session_id] = (group, len(pages))
        self.kv.alloc.release(session_id)
        self.session_state.pop(session_id)
        return True

    def _suspend_pages(self, session_id: str, idxs_np, to_dir: str | None) -> tuple:
        """The session's pages [L, n_kv, n, ps, hd] (payload and scales for
        q8 pools) gathered out of the pools on the device, one copy to the
        host per leaf; kept in RAM, or written to `{to_dir}/{session_id}.kv.npz`
        with each leaf, in `_pool_leaves` order, saved as a contiguous uint8
        view (npz has no bf16). With more than one rank each rank of the
        session's dp group writes its own heads to
        `{to_dir}/{session_id}.kv.p{global rank}.npz`, each leaf with a
        leading axis of the shards it holds (one), as a JAX process writes its
        addressable shards ("mdisk"). idxs_np: global page ids."""
        idxs = torch.from_numpy(self.kv.local_tables(idxs_np)).to(self.device)

        def take(pool):
            if isinstance(pool, QArray):
                return QArray(take(pool.data), take(pool.scales), pool.fmt)
            return pool[:, :, idxs].cpu()

        with torch.inference_mode():
            k_host, v_host = take(self.kv.state.k_pool), take(self.kv.state.v_pool)
        if to_dir is None:
            return ("ram", k_host, v_host)
        os.makedirs(to_dir, exist_ok=True)
        leaves = _pool_leaves(k_host, v_host)
        if self._world > 1:
            np.savez(self._rank_file(to_dir, session_id),
                     *[a[None].contiguous().view(torch.uint8).numpy() for a in leaves])
            return ("mdisk", to_dir)
        np.savez(f"{to_dir}/{session_id}.kv.npz",
                 *[a.contiguous().view(torch.uint8).numpy() for a in leaves])
        return ("disk", to_dir)

    def _rank_file(self, to_dir: str, session_id: str) -> str:
        return f"{to_dir}/{session_id}.kv.p{self._grank}.npz"

    def resume_session(self, session_id: str) -> bool:
        with self._lock:
            return self._resume_session_locked(session_id)

    def _resume_session_locked(self, session_id: str) -> bool:
        if session_id not in self._suspended:
            return False
        payload, state = self._suspended[session_id]
        group, n_pages = self._suspended_at.get(session_id, (0, None))
        host = None if payload[0] == "remote" else self._payload_leaves(session_id, payload)
        if n_pages is None:  # a payload put there from outside: its pages say
            n_pages = host[0].shape[2]
        ps = self.kv.page_size
        # allocate with eviction, in the session's dp group; a full pool must
        # NOT raise out of the scheduler loop (that would fail every in-flight
        # request): the session stays suspended and its requester retries
        while True:
            try:
                pages = self.kv.alloc.ensure_capacity(session_id, n_pages * ps, ps, group=group)
                break
            except MemoryError:
                if not self._evict_for_pages(group):
                    self.kv.alloc.release(session_id)  # partial alloc back
                    return False
        idxs = np.asarray(pages, dtype=np.int64)
        if self._chan is not None:
            self._chan.publish({"op": "resume", "sid": session_id, "idxs": idxs,
                                "group": group})
        self._suspended.pop(session_id)
        self._suspended_at.pop(session_id, None)
        if host is not None:
            self._restore_pages(host, idxs)
        self.session_state[session_id] = state
        return True

    def _payload_leaves(self, session_id: str, payload) -> list:
        """A suspend payload's pages as host tensors in `_pool_leaves` order:
        a file is read whole and left where it is, as the JAX scheduler
        leaves it, its uint8 members viewed back through the pool leaves'
        dtypes."""
        if payload[0] == "ram":
            return _pool_leaves(payload[1], payload[2])
        pools = _pool_leaves(self.kv.state.k_pool, self.kv.state.v_pool)
        if payload[0] == "mdisk":  # this rank's file; its one shard
            with np.load(self._rank_file(payload[1], session_id)) as z:
                return [torch.from_numpy(z[f]).view(p.dtype)[0] for f, p in zip(z.files, pools)]
        with np.load(f"{payload[1]}/{session_id}.kv.npz") as z:
            return [torch.from_numpy(z[f]).view(p.dtype) for f, p in zip(z.files, pools)]

    def _restore_pages(self, host: list, idxs_np) -> None:
        """Scatter the pages `host` (`_pool_leaves` order) into the pool
        pages idxs_np (global ids)."""
        idxs = torch.from_numpy(self.kv.local_tables(idxs_np)).to(self.device)
        with torch.inference_mode():
            for pool, h in zip(_pool_leaves(self.kv.state.k_pool, self.kv.state.v_pool), host):
                pool[:, :, idxs] = h.to(self.device, pool.dtype)

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
                self._kv_key(r), r.position + depth + depth_next, self._group_of_slot(r.slot)
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
        pts = self.kv.page_table(seq_ids, groups=self._slot_groups())
        if self._chan is not None:
            # no tokens: each rank feeds back the ids it sampled itself
            self._chan.publish({"op": "decode_chain", "depth": int(depth_next),
                                "win": int(win), "pts": pts})
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
            if not self._ensure_capacity_evicting(key, r.position + 1,
                                                  self._group_of_slot(r.slot)):
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
                if not self._ensure_capacity_evicting(self._kv_key(r), r.position + depth,
                                                      self._group_of_slot(r.slot)):
                    depth = 1
                    break

        pts = self.kv.page_table(seq_ids, groups=self._slot_groups())
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
            last_ping = time.monotonic()
            while self._running:
                try:
                    n = self.step()
                except Exception as e:  # noqa: BLE001 — surface, don't die
                    traceback.print_exc()
                    if isinstance(e, ConnectionError) and self._chan is not None:
                        # a follower is gone: the next collective would hang
                        # every rank left, so stop serving (/healthz turns 503)
                        self.degraded = str(e)
                    self._fail_active(f"{type(e).__name__}: {e}")
                    continue
                if n == 0 and self.pending.empty():
                    if self._chan is not None and time.monotonic() - last_ping > 5.0:
                        # idle heartbeat: followers tell a quiet leader from a
                        # dead one (JLAMA_STEP_TIMEOUT)
                        last_ping = time.monotonic()
                        try:
                            self._chan.publish({"op": "ping"})
                        except ConnectionError as e:
                            self.degraded = str(e)
                    time.sleep(0.001)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
