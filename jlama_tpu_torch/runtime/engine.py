"""Inference engine: bucketed prefill, chunked decode, sessions, streaming
(counterpart of the generation part of `jlama_tpu/runtime/engine.py`).

- prompt prefill in length buckets, all but the last prompt token; on the
  card a prefill is a captured CUDA graph (`runtime/graphs.py`), one per
  (cache slot, bucket, window) up to `PREFILL_GRAPH_MAX` tokens, reading its
  tokens and positions from static inputs of its own (the JAX package's
  jitted `_prefill`); longer buckets run eagerly;
- the last prompt token and every generated token through the chunked decode
  loop (`runtime/device_loop.py`), sampling on the device; on the card each
  decode step is a captured CUDA graph, one per (cache slot, window, greedy,
  no top-k, no top-p, stop-id width), replayed up to `chunk` times before
  the chunk's one copy to the host; the loop stops issuing steps once the
  row has sampled a stop id (the JAX loop's exit), within
  `device_loop.steps_after_stop_bound()` steps on the card;
- per-session dense KV caches in at most `max_device_sessions` device cache
  slots, made on first need and kept for the engine's life (a graph reads
  its slot by address): a new session takes a free slot, zeroed; an idle
  one is offloaded to host memory (least recently used first) and its slot
  freed, and resumes into a free slot by a copy;
- seeded draws from the counter-based stream `nn/sampling.py::counter_uniform`
  keyed by (seed, tokens generated in this call), so the ids do not depend
  on the chunk size;
- Response carries the same fields and finish reasons as the JAX package;
- embeddings and classification (`embed_tokens`, `embed_batch`, `embed`,
  `classify`): a forward without a cache over rows in power-of-two row and
  length buckets, pad keys masked through `seq_lengths`, pooled on the
  device, so that only [R, D] comes back to the host.

On a tp mesh (`mesh=`) each rank holds its slice of the weights
(`parallel/mesh.py::rank_params`: a `RankSlice`, or the whole tree, which
it cuts) and n_kv/tp heads of each cache slot, and runs its forward under
the rank's `TPGroup` (`parallel/tp_forward.py`). `generate` is SPMD: every
rank calls it with the same arguments and seed, samples the same ids from
the gathered logits and so runs the same steps; on the card its decode
steps and prefills are graphs cut at their collectives into segments
(`runtime/graphs.py`), as the tp scheduler's are. With a
`step_channel` the leader (global rank 0) publishes each embed call
(`run_embed_hidden`, `run_embed_pooled`) as the step ops embed_hidden and
embed_pool before it runs it, holding `step_lock` (the scheduler's lock)
across both so that the call keeps its place among the scheduler's steps;
the other ranks replay it in `BatchScheduler.run_follower`.

On a pp mesh each rank holds its stage's layers (and a cache slot of those
layers) and every forward runs stage by stage (`parallel/pipeline.py::
stage_hidden`): stage 0 embeds, each stage runs its layers and hands the
hidden state on. `generate` is SPMD as under tp: the last stage samples and
broadcasts each id to every stage, so that every rank runs the same steps;
a step's receive, send and broadcast cut its graph into segments.
An embed call's result comes back to stage 0 over the ring's wrap-around
(the other stages' calls return None).
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable

import numpy as np
import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..models.base import (KVCache, check_moe_device, fuse_params, lm_logits,
                           params_to, prepare_moe_ragged, rope_inv_freq)
from ..nn.layers import KVLayerCache
from ..nn.qarray import QArray
from ..nn.sampling import sample_token
from ..parallel.mesh import RankSlice, check_whole, rank_params
from ..parallel.pipeline import stage_cfg, stage_hidden
from ..parallel.tp_forward import TPCtx, check_tp, tp_context
from ..prompt import PromptContext, extract_tool_calls
from ..utils.metrics import GLOBAL_METRICS
from .device_loop import decode_loop
from .graphs import DecodeInputs, PrefillInputs, StepGraphs

# the longest prefill bucket captured as a CUDA graph; longer ones run eagerly:
# on Llama-3.2-1B a capture past it adds 192-384 MB to the graph pool (the
# decode graphs hold 4 MB) to save 10-16 % of the prefill's time
PREFILL_GRAPH_MAX = 2048


class FinishReason(str, Enum):
    MAX_TOKENS = "MAX_TOKENS"
    STOP_TOKEN = "STOP_TOKEN"
    TOOL_CALL = "TOOL_CALL"
    ERROR = "ERROR"


@dataclass
class Response:
    response_text: str
    response_text_with_special_tokens: str
    finish_reason: FinishReason
    prompt_tokens: int
    generated_tokens: int
    prompt_time_ms: float
    generate_time_ms: float
    token_ids: list[int] = field(default_factory=list)
    tool_calls: list = field(default_factory=list)
    error: str | None = None  # set when finish_reason == ERROR


@dataclass
class Session:
    """Cache invariant: positions [0, position) are written; `pending` is the
    last sampled token (to occupy slot `position`) not yet forwarded."""

    slot: int | None  # the device cache slot; None while offloaded
    position: int = 0
    pending: int | None = None
    last_used: float = 0.0
    host: torch.Tensor | None = None  # the slot's content while offloaded (LRU evicted)

    @property
    def on_host(self) -> bool:
        return self.slot is None


def _bucket(n: int, buckets=(16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)) -> int:
    """Length bucket for attn_window / prefill length: geometric everywhere
    (powers of two past 8192)."""
    for b in buckets:
        if n <= b:
            return b
    b = buckets[-1]
    while b < n:
        b *= 2
    return b


def pool_hidden(params: dict, hidden: torch.Tensor, lens: torch.Tensor,
                pooling: str) -> torch.Tensor:
    """[R, T, D] hidden states of right-padded rows with `lens` valid tokens
    -> [R, D] f32, on their device (`jlama_tpu/runtime/engine.py:
    _pooled_nocache`). CLS: the first token; MODEL: the last valid one; both
    through BERT's pooler (dense + tanh, a plain f32 product) where the tree
    has one. MAX, SUM and AVG (anything else) over the valid tokens, then L2
    normalized."""
    h = hidden.to(torch.float32)
    R, T, _ = h.shape
    if pooling in ("MODEL", "CLS"):
        if pooling == "CLS":
            v = h[:, 0]
        else:
            v = h[torch.arange(R, device=h.device), (lens.long() - 1).clamp(min=0)]
        w = params.get("pooler.weight")
        if w is not None:
            w = w.dequantize(torch.float32) if isinstance(w, QArray) else w.to(torch.float32)
            v = v @ w.t()
            if "pooler.bias" in params:
                v = v + params["pooler.bias"].to(torch.float32)
            v = torch.tanh(v)
        return v
    m = (torch.arange(T, device=h.device)[None, :] < lens[:, None])[..., None]
    if pooling == "MAX":
        v = torch.where(m, h, torch.full_like(h, -torch.inf)).amax(dim=1)
    elif pooling == "SUM":
        v = (h * m).sum(dim=1)
    else:  # AVG
        v = (h * m).sum(dim=1) / lens[:, None].to(torch.float32).clamp(min=1.0)
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / n.clamp(min=1e-12)


class Engine:
    """Single-model, single-stream inference engine over a param tree."""

    def __init__(
        self,
        params: dict,
        cfg: ModelConfig,
        tokenizer=None,
        device=None,
        max_seq_len: int | None = None,
        kv_dtype=torch.bfloat16,
        compute_dtype=torch.bfloat16,
        max_device_sessions: int = 8,
        fuse: bool = True,
        decode_graphs: bool | None = None,
        moe_ragged: bool = True,
        mesh=None,
        step_channel=None,
        step_lock=None,
    ):
        """device: CUDA unless named; raises without CUDA and without it.
        The params are moved there (a no-op for params already on it).
        decode_graphs=False runs every decode step and every prefill eagerly
        on the card too (the yardstick the graphs are held against); None or
        True: graphs on the card, on one device and on a mesh. moe_ragged: as in the
        JAX package, float MoE experts are transposed once into the grouped
        layout (`models.base.prepare_moe_ragged`); q4 experts are left as they
        are (K6), and float experts take the card's grouped product
        (`ops/moe_float.py`).

        mesh: a `parallel.mesh.Mesh` whose tp > 1 takes this rank's
        `TPGroup`, whose pp > 1 its stage ring, and the params as the whole
        tree or this rank's `RankSlice` (module docstring); without one, a
        rank's slice raises.
        step_channel, step_lock: the scheduler's step channel and lock, for
        an Engine that answers embeddings beside a mesh scheduler."""
        self.device = resolve_device(device)
        tp = mesh.tp if mesh is not None else 1
        pp = mesh.pp if mesh is not None else 1
        self._tp: TPCtx | None = None
        self._ring = mesh.ring if pp > 1 else None  # the stage ring
        stage = mesh.stage if pp > 1 else 0
        self._first_layer = stage * (cfg.n_layers // pp)
        self.fwd_cfg = cfg  # the forward's view: a rank's heads under tp
        if tp > 1 or pp > 1:
            if tp > 1 and mesh.group is None:
                raise ValueError(f"mesh tp={tp} needs this rank's TPGroup (mesh.group)")
            check_tp(cfg, mesh)
            params, self._tp, self.fwd_cfg = rank_params(params, cfg, mesh, self.device, fuse)
        else:
            check_whole(params, cfg)
            params = params_to(params, self.device)
            if fuse:
                params = fuse_params(params)
        tp_rank = mesh.group.rank if tp > 1 else 0
        self._is_leader = mesh is None or (mesh.dp_index * pp + stage) * tp + tp_rank == 0
        self._chan = step_channel
        self._lock = step_lock if step_lock is not None else threading.RLock()
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_seq_len = min(max_seq_len or cfg.context_length, cfg.context_length)
        self.kv_dtype = kv_dtype
        self.compute_dtype = compute_dtype
        if cfg.n_experts:
            if moe_ragged:
                params = prepare_moe_ragged(params)
            check_moe_device(params, self.device)
        self.params = params
        self.inv_freq = rope_inv_freq(cfg, self.device)
        self.sessions: dict[str, Session] = {}
        self.max_device_sessions = max_device_sessions
        # device cache slots, each one tensor [L, 2 (k, v), 1, n_kv, S, hd]
        # seen as a KVCache of views; made on first need, never freed
        self._slot_bufs: list[torch.Tensor] = []
        self._slot_caches: list[KVCache] = []
        self._free_slots: list[int] = []
        if tp > 1 or pp > 1:
            vocab = ((self._tp.embed_vocab_sharded, self._tp.lm_head_vocab_sharded) if tp > 1
                     else (False, False))
            self.params = RankSlice(params, tp, tp_rank, vocab, pp, stage)
        self._cache_cfg = stage_cfg(self.fwd_cfg, pp)  # a cache slot's layers: the stage's
        self._in = DecodeInputs(1, self.device, history=self.max_seq_len, stops=True)
        # on a mesh too: a step's collectives and hand-overs cut its graph
        # into segments (runtime/graphs.py)
        graphs = decode_graphs is not False
        eager = None if graphs else "decode_graphs=False: the eager yardstick"
        self.graphs = StepGraphs(self.device, graphs, eager_reason=eager)
        self.prefill_graphs = StepGraphs(self.device, graphs, pool_of=self.graphs,
                                         eager_reason=eager)

    # ------------------------------------------------------------------
    # sessions
    # ------------------------------------------------------------------

    def _evict_lru_to_host(self) -> None:
        """Offload the least-recently-used on-device session caches to host
        RAM, freeing their slots, so that a chat server cannot fill device
        memory one session at a time."""
        on_dev = [(s.last_used, sid) for sid, s in self.sessions.items() if not s.on_host]
        if len(on_dev) < self.max_device_sessions:
            return
        on_dev.sort()
        for _, sid in on_dev[: len(on_dev) - self.max_device_sessions + 1]:
            sess = self.sessions[sid]
            sess.host = self._slot_bufs[sess.slot].to("cpu", copy=True)
            self._free_slots.append(sess.slot)
            sess.slot = None

    def _take_slot(self) -> int:
        """A free device cache slot (after offloading, if the device holds
        max_device_sessions sessions), made if none is free."""
        self._evict_lru_to_host()
        if self._free_slots:
            return self._free_slots.pop()
        cfg = self._cache_cfg
        buf = torch.zeros((cfg.n_layers, 2, 1, cfg.n_kv_heads, self.max_seq_len, cfg.head_size),
                          dtype=self.kv_dtype, device=self.device)
        self._slot_bufs.append(buf)
        self._slot_caches.append(KVCache([KVLayerCache(b[0], b[1]) for b in buf]))
        return len(self._slot_bufs) - 1

    def get_session(self, session_id: str | None) -> tuple[str, Session]:
        sid = session_id or str(uuid.uuid4())
        if sid not in self.sessions:
            slot = self._take_slot()
            self._slot_bufs[slot].zero_()  # KVCache.init's zeros
            self.sessions[sid] = Session(slot=slot)
        sess = self.sessions[sid]
        if sess.on_host:
            slot = self._take_slot()
            self._slot_bufs[slot].copy_(sess.host)
            sess.slot, sess.host = slot, None
        sess.last_used = time.monotonic()
        return sid, sess

    def drop_session(self, session_id: str) -> None:
        sess = self.sessions.pop(session_id, None)
        if sess is not None and not sess.on_host:
            self._free_slots.append(sess.slot)

    def _prefill(self, slot: int, toks: np.ndarray, pos: np.ndarray, win: int) -> None:
        """Prefill [1, T] tokens at their positions into a cache slot: on
        the card one graph per (slot, T, window) up to PREFILL_GRAPH_MAX
        tokens, from that key's static inputs."""
        cache = self._slot_caches[slot]

        def run(tokens, positions):
            self._forward(tokens, positions, cache, win)

        T = toks.shape[1]
        if T > PREFILL_GRAPH_MAX:
            with torch.inference_mode(), tp_context(self._tp):
                run(torch.from_numpy(toks).to(self.device), torch.from_numpy(pos).to(self.device))
            return
        key = (slot, T, win)
        inp = self.prefill_graphs.inputs(key, lambda: PrefillInputs(1, T, self.device))
        inp.load(tokens=toks, positions=pos)
        with torch.inference_mode(), tp_context(self._tp):
            self.prefill_graphs.run(key, lambda: run(inp.tokens, inp.positions))

    def _decode_step(self, cache: KVCache, win: int, greedy: bool, no_top_k: bool,
                     no_top_p: bool, stop_width: int) -> torch.Tensor:
        """One decode step on the static inputs: the sampled ids [1] (under
        pp sampled on the last stage and broadcast to every stage)."""
        s = self._in
        hidden = self._forward(s.tokens, s.positions, cache, win)
        if hidden is None:  # a stage before the last: the last stage's id
            nxt = torch.zeros((1,), dtype=torch.int64, device=self.device)
        else:
            logits = lm_logits(self.params, self.fwd_cfg, hidden[:, -1:, :])[:, 0]
            nxt = sample_token(logits, None, 0.0 if greedy else s.temps,
                               top_k=0 if no_top_k else s.top_ks,
                               top_p=1.0 if no_top_p else s.top_ps, seeds=s.seeds, steps=s.steps)
        if self._ring is not None:
            self._ring.broadcast_last(nxt)
        s.advance(nxt, stop_width)
        return nxt

    def _forward(self, tokens, positions, cache, win, token_types=None, seq_lengths=None):
        """One forward's hidden states; under pp the stage-serial forward,
        whose hidden state ends on the last stage (None on the others)."""
        return stage_hidden(self._ring, self.params, self.fwd_cfg, tokens, positions, cache,
                            self.compute_dtype, win, self.inv_freq, self._first_layer,
                            token_types, seq_lengths)

    # ------------------------------------------------------------------
    # token-level generation
    # ------------------------------------------------------------------

    def generate_tokens(
        self,
        prompt_ids: list[int],
        max_new_tokens: int = 256,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        session_id: str | None = None,
        seed: int = 0,
        on_token: Callable[[int, float], None] | None = None,
        stop_ids: set[int] | None = None,
    ) -> Response:
        sid, sess = self.get_session(session_id)
        cfg = self.cfg
        dev = self.device
        stop = set(stop_ids) if stop_ids is not None else set(cfg.eos_token_ids)

        prompt_ids = list(prompt_ids)
        if sess.pending is not None:
            prompt_ids = [sess.pending] + prompt_ids
            sess.pending = None
        start_pos = sess.position
        n_prompt = len(prompt_ids)
        if start_pos + n_prompt + max_new_tokens > self.max_seq_len:
            max_new_tokens = max(0, self.max_seq_len - start_pos - n_prompt)

        t0 = time.perf_counter()
        # prefill all but the last prompt token; the last goes through decode
        # so that sampling follows in the same step
        if n_prompt > 1:
            ctx = prompt_ids[:-1]
            bucket = _bucket(len(ctx))
            if start_pos + bucket > self.max_seq_len:
                bucket = len(ctx)  # a bucketed write would not fit
            toks = np.zeros((1, bucket), dtype=np.int64)
            toks[0, : len(ctx)] = ctx
            # pads get contiguous future positions: their K/V land at
            # not-yet-attendable slots and are overwritten by the real token
            # that later occupies each slot (the cache write precedes
            # attention within a step), so they never leak into results
            pos = np.arange(start_pos, start_pos + bucket, dtype=np.int64)[None, :]
            win = min(_bucket(start_pos + bucket), self.max_seq_len)
            self._prefill(sess.slot, toks, pos, win)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prompt_time = (time.perf_counter() - t0) * 1000

        t1 = time.perf_counter()
        cur = int(prompt_ids[-1])
        cur_pos = start_pos + n_prompt - 1
        out_ids: list[int] = []
        finish = FinishReason.MAX_TOKENS
        # N tokens per host round trip; streaming callbacks fire per chunk,
        # so a smaller chunk keeps chat latency interactive
        chunk_max = int(os.environ.get("JLAMA_DEVICE_CHUNK", "32"))
        if on_token is not None:
            chunk_max = min(chunk_max, 8)
        # the static inputs, once a call: every step advances them in place
        self._in.load(tokens=[[cur]], positions=[[cur_pos]], steps=[0], seeds=[seed],
                      temps=[temperature], top_ks=[top_k], top_ps=[top_p])
        width = self._in.set_stops(stop)
        cache = self._slot_caches[sess.slot]
        # static variants, as sample_token's fast paths for Python numbers
        greedy = temperature == 0.0
        no_top_k = top_k <= 0 or top_k >= cfg.vocab_size
        no_top_p = top_p >= 1.0
        while len(out_ids) < max_new_tokens:
            chunk = min(chunk_max, max_new_tokens - len(out_ids),
                        self.max_seq_len - 1 - cur_pos)
            if chunk <= 0:
                break
            win = min(_bucket(cur_pos + chunk + 1), self.max_seq_len)
            with torch.inference_mode(), tp_context(self._tp):
                rows, nval = decode_loop(
                    self.graphs, (sess.slot, win, greedy, no_top_k, no_top_p, width),
                    lambda: self._decode_step(cache, win, greedy, no_top_k, no_top_p, width),
                    self._in, len(out_ids), chunk, stop,
                )
            toks_out = rows[0]
            out_ids.extend(toks_out)
            cur_pos += nval[0]
            if toks_out:
                cur = toks_out[-1]
            if toks_out and toks_out[-1] in stop:
                finish = FinishReason.STOP_TOKEN
                break
            if on_token is not None:
                ms_per_tok = (time.perf_counter() - t1) * 1000 / max(len(out_ids), 1)
                for t in toks_out:
                    on_token(t, ms_per_tok)
        gen_time = (time.perf_counter() - t1) * 1000

        sess.position = cur_pos
        sess.pending = cur

        text = ""
        text_special = ""
        if self.tokenizer is not None:
            visible = [t for t in out_ids if t not in stop]
            text = self.tokenizer.decode(visible)
            text_special = self.tokenizer.decode(out_ids, skip_special=False)
        return Response(
            response_text=text,
            response_text_with_special_tokens=text_special,
            finish_reason=finish,
            prompt_tokens=n_prompt,
            generated_tokens=len(out_ids),
            prompt_time_ms=prompt_time,
            generate_time_ms=gen_time,
            token_ids=out_ids,
        )

    # ------------------------------------------------------------------
    # embeddings and classification
    # ------------------------------------------------------------------

    def _dev_in(self, x) -> torch.Tensor | None:
        return None if x is None else torch.as_tensor(np.asarray(x)).long().to(self.device)

    def _publish(self, msg: dict) -> None:
        if self._chan is not None and self._is_leader:
            self._chan.publish(msg)

    def _hidden(self, toks, pos, tt, lens) -> torch.Tensor | None:
        """The forward without a cache (no publishing): hidden [R, T, D]
        (under pp on the last stage; None on the others)."""
        with torch.inference_mode(), tp_context(self._tp):
            return self._forward(self._dev_in(toks), self._dev_in(pos), None, None,
                                 self._dev_in(tt), self._dev_in(lens))

    def _to_first(self, t: torch.Tensor | None, shape, dtype) -> torch.Tensor | None:
        """Under pp, an embed call's result from the last stage on stage 0
        (the ring's wrap-around); the stages between get None."""
        ring = self._ring
        if ring is None:
            return t
        with torch.inference_mode():
            if ring.last:
                ring.exchange(send_first=t)
                return None
            if ring.first:
                return ring.exchange(recv_last=(shape, dtype))[1]
        return None

    def run_embed_hidden(self, toks, pos, tt, lens=None) -> torch.Tensor:
        """The forward without a cache over host arrays [R, T] (token types
        `tt` and valid lengths `lens` [R] optional): hidden [R, T, D] on the
        device (the leader publishes it first: module docstring)."""
        with self._lock:
            self._publish({"op": "embed_hidden", "toks": np.asarray(toks),
                           "pos": np.asarray(pos), "tt": None if tt is None else np.asarray(tt),
                           "lens": None if lens is None else np.asarray(lens)})
            h = self._hidden(toks, pos, tt, lens)
            return self._to_first(h, (*np.shape(toks), self.cfg.embedding_length),
                                  self.compute_dtype)

    def run_embed_pooled(self, toks, pos, tt, lens, pooling: str) -> torch.Tensor:
        """`run_embed_hidden` pooled on the device (`pool_hidden`): [R, D] f32
        (the leader publishes it first, as one step)."""
        with self._lock:
            self._publish({"op": "embed_pool", "toks": np.asarray(toks), "pos": np.asarray(pos),
                           "tt": None if tt is None else np.asarray(tt),
                           "lens": np.asarray(lens), "pooling": pooling})
            hidden = self._hidden(toks, pos, tt, lens)
            v = None
            if hidden is not None:
                with torch.inference_mode():
                    v = pool_hidden(self.params, hidden, self._dev_in(lens), pooling)
            return self._to_first(v, (np.shape(toks)[0], self.cfg.embedding_length),
                                  torch.float32)

    def embed_tokens(self, token_ids: list[int], pooling: str = "AVG",
                     token_types: list[int] | None = None) -> np.ndarray:
        return self.embed_batch([token_ids], pooling,
                                None if token_types is None else [token_types])[0]

    def embed_batch(self, token_lists: list[list[int]], pooling: str = "AVG",
                    token_types: list[list[int]] | None = None,
                    max_rows: int = 32) -> list[np.ndarray]:
        """Embed many sequences in batched forwards: sorted by length, rows in
        power-of-two row and length buckets, at most `max_rows` a forward;
        shorter rows are padded on the right and their pad keys masked, so a
        row's vector is the one it gets alone."""
        out: list[np.ndarray | None] = [None] * len(token_lists)
        order = sorted(range(len(token_lists)), key=lambda i: len(token_lists[i]))
        for c0 in range(0, len(order), max_rows):
            idxs = order[c0:c0 + max_rows]
            rows = 1
            while rows < len(idxs):
                rows *= 2
            T = _bucket(max(len(token_lists[i]) for i in idxs))
            toks = np.zeros((rows, T), dtype=np.int64)
            pos = np.broadcast_to(np.arange(T, dtype=np.int64), (rows, T)).copy()
            lens = np.ones(rows, dtype=np.int64)
            tt = None if token_types is None else np.zeros((rows, T), dtype=np.int64)
            for r, i in enumerate(idxs):
                ids = token_lists[i]
                toks[r, :len(ids)] = ids
                lens[r] = len(ids)
                if tt is not None and token_types[i] is not None:
                    tt[r, :len(token_types[i])] = token_types[i]
            vecs = self.run_embed_pooled(toks, pos, tt, lens, pooling).cpu().numpy()
            for r, i in enumerate(idxs):
                out[i] = vecs[r]
        return out  # type: ignore[return-value]

    def embed(self, text: str, pooling: str = "AVG") -> np.ndarray:
        return self.embed_tokens(self.tokenizer.encode(text), pooling=pooling)

    def classify(self, text: str, pooling: str | None = None) -> dict[str, float]:
        """embed -> the classifier head -> softmax -> {label: probability}.
        Pooling CLS for BERT, MODEL otherwise; the head runs on the host in f32,
        as in the JAX package."""
        labels = self.cfg.classification_labels
        if labels is None or "classifier.weight" not in self.params:
            raise ValueError("model has no classification head")
        if pooling is None:
            pooling = "CLS" if self.cfg.model_type == "bert" else "MODEL"
        v = self.embed_tokens(self.tokenizer.encode(text), pooling=pooling)
        w = self.params["classifier.weight"].to(torch.float32).cpu().numpy()
        b = self.params.get("classifier.bias")
        b = np.zeros(w.shape[0], np.float32) if b is None else \
            b.to(torch.float32).cpu().numpy()
        logits = w @ v + b
        p = np.exp(logits - logits.max())
        p /= p.sum()
        return {labels[i]: float(p[i]) for i in range(len(p)) if i in labels}

    # ------------------------------------------------------------------
    # text-level generation
    # ------------------------------------------------------------------

    def encode_prompt(self, text: str) -> list[int]:
        """Tokenize with BOS handling."""
        ids = self.tokenizer.encode(text)
        bos = self.tokenizer.bos_id
        add_bos = self.tokenizer.spec.add_bos_token
        if add_bos is None:
            add_bos = self.cfg.bos_token_id is not None
        if add_bos and bos is not None and (not ids or ids[0] != bos):
            ids = [bos] + ids
        return ids

    def generate(
        self,
        prompt,
        session_id: str | None = None,
        temperature: float = 0.0,
        max_new_tokens: int = 256,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        on_token: Callable[[str, float], None] | None = None,
    ) -> Response:
        """Generate from a string or a PromptContext; with tools attached, a
        tool-shaped output becomes `tool_calls` and finishes TOOL_CALL.

        on_token streams decoded TEXT fragments (UTF-8 safe: partial
        codepoints are buffered until complete)."""
        if self.tokenizer is None:
            raise ValueError("generate() needs a tokenizer; use generate_tokens()")
        ctx = prompt if isinstance(prompt, PromptContext) else PromptContext.of(str(prompt))
        ids = self.encode_prompt(ctx.prompt)
        stream_buf: list[int] = []

        def tok_cb(tok: int, ms: float) -> None:
            stream_buf.append(tok)
            text = self.tokenizer.decode(stream_buf)
            if text and not text.endswith("�"):
                on_token(text, ms)
                stream_buf.clear()

        resp = self.generate_tokens(
            ids,
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            session_id=session_id,
            seed=seed,
            on_token=tok_cb if on_token else None,
        )
        if ctx.has_tools:
            calls = extract_tool_calls(resp.response_text, ctx.tools)
            if calls:
                resp.tool_calls = calls
                resp.finish_reason = FinishReason.TOOL_CALL
        GLOBAL_METRICS.record(resp)
        return resp

    def builder(self) -> "GenerateBuilder":
        return GenerateBuilder(self)


@dataclass
class GenerateBuilder:
    """Fluent request builder."""

    engine: Engine
    _session: str | None = None
    _prompt: str | None = None
    _temperature: float = 0.0
    _max_tokens: int = 256
    _top_p: float = 1.0
    _top_k: int = 0
    _seed: int = 0
    _on_token: Callable[[str, float], None] | None = None

    def session(self, session_id: str) -> "GenerateBuilder":
        self._session = session_id
        return self

    def prompt(self, prompt: str) -> "GenerateBuilder":
        self._prompt = prompt
        return self

    def temperature(self, t: float) -> "GenerateBuilder":
        self._temperature = t
        return self

    def max_tokens(self, n: int) -> "GenerateBuilder":
        self._max_tokens = n
        return self

    def top_p(self, p: float) -> "GenerateBuilder":
        self._top_p = p
        return self

    def top_k(self, k: int) -> "GenerateBuilder":
        self._top_k = k
        return self

    def seed(self, s: int) -> "GenerateBuilder":
        self._seed = s
        return self

    def on_token(self, cb) -> "GenerateBuilder":
        self._on_token = cb
        return self

    def generate(self) -> Response:
        if self._prompt is None:
            raise ValueError("prompt not set")
        return self.engine.generate(
            self._prompt,
            session_id=self._session,
            temperature=self._temperature,
            max_new_tokens=self._max_tokens,
            top_k=self._top_k,
            top_p=self._top_p,
            seed=self._seed,
            on_token=self._on_token,
        )
