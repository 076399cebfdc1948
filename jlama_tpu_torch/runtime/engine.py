"""Inference engine: bucketed prefill, chunked decode, sessions, streaming
(counterpart of the generation part of `jlama_tpu/runtime/engine.py`).

- prompt prefill in length buckets, all but the last prompt token;
- the last prompt token and every generated token through the chunked decode
  loop (`runtime/device_loop.py`), sampling on the device; on the card each
  decode step is a captured CUDA graph (`runtime/graphs.py`), one per
  (cache slot, window, greedy, no top-k, no top-p), replayed `chunk` times
  before the chunk's one copy to the host;
- per-session dense KV caches in at most `max_device_sessions` device cache
  slots, made on first need and kept for the engine's life (a graph reads
  its slot by address): a new session takes a free slot, zeroed; an idle
  one is offloaded to host memory (least recently used first) and its slot
  freed, and resumes into a free slot by a copy;
- seeded draws from the counter-based stream `nn/sampling.py::counter_uniform`
  keyed by (seed, tokens generated in this call), so the ids do not depend
  on the chunk size;
- Response carries the same fields and finish reasons as the JAX package.

Embeddings, classification, meshes and the multi-host step channel come in
later slices.
"""

from __future__ import annotations

import os
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable

import torch

from ..config import ModelConfig
from ..device import resolve_device
from ..models.base import (KVCache, check_moe_device, forward_hidden, fuse_params, lm_logits,
                           params_to, prepare_moe_ragged, rope_inv_freq)
from ..nn.layers import KVLayerCache
from ..nn.sampling import sample_token
from .device_loop import decode_loop
from .graphs import DecodeInputs, StepGraphs


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
        decode_graphs: bool = True,
        moe_ragged: bool = True,
    ):
        """device: CUDA unless named; raises without CUDA and without it.
        The params are moved there (a no-op for params already on it).
        decode_graphs=False runs every decode step eagerly on the card too
        (the yardstick the graphs are held against). moe_ragged: as in the
        JAX package, float MoE experts are transposed once into the grouped
        layout (`models.base.prepare_moe_ragged`); q4 experts are left as they
        are, and float experts on the card raise NotImplementedError."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.max_seq_len = min(max_seq_len or cfg.context_length, cfg.context_length)
        self.kv_dtype = kv_dtype
        self.compute_dtype = compute_dtype
        params = params_to(params, self.device)
        if fuse:
            params = fuse_params(params)
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
        self._in = DecodeInputs(1, self.device, history=self.max_seq_len)
        self.graphs = StepGraphs(self.device, decode_graphs)

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
        cfg = self.cfg
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

    def _decode_step(self, cache: KVCache, win: int, greedy: bool, no_top_k: bool,
                     no_top_p: bool) -> torch.Tensor:
        """One decode step on the static inputs: the sampled ids [1]."""
        s = self._in
        hidden, _ = forward_hidden(
            self.params, self.cfg, s.tokens, s.positions, cache, dtype=self.compute_dtype,
            attn_window=win, inv_freq=self.inv_freq,
        )
        logits = lm_logits(self.params, self.cfg, hidden[:, -1:, :])[:, 0]
        nxt = sample_token(logits, None, 0.0 if greedy else s.temps,
                           top_k=0 if no_top_k else s.top_ks,
                           top_p=1.0 if no_top_p else s.top_ps, seeds=s.seeds, steps=s.steps)
        s.advance(nxt)
        return nxt

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
            toks = torch.zeros((1, bucket), dtype=torch.int64)
            toks[0, : len(ctx)] = torch.tensor(ctx, dtype=torch.int64)
            # pads get contiguous future positions: their K/V land at
            # not-yet-attendable slots and are overwritten by the real token
            # that later occupies each slot (the cache write precedes
            # attention within a step), so they never leak into results
            pos = torch.arange(start_pos, start_pos + bucket, dtype=torch.int64)[None, :]
            win = min(_bucket(start_pos + bucket), self.max_seq_len)
            with torch.inference_mode():
                forward_hidden(
                    self.params, cfg, toks.to(dev), pos.to(dev), self._slot_caches[sess.slot],
                    dtype=self.compute_dtype, attn_window=win, inv_freq=self.inv_freq,
                )
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
            with torch.inference_mode():
                rows, nval = decode_loop(
                    self.graphs, (sess.slot, win, greedy, no_top_k, no_top_p),
                    lambda: self._decode_step(cache, win, greedy, no_top_k, no_top_p),
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
        prompt: str,
        session_id: str | None = None,
        temperature: float = 0.0,
        max_new_tokens: int = 256,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        on_token: Callable[[str, float], None] | None = None,
    ) -> Response:
        """Generate from a string. on_token streams decoded TEXT fragments
        (UTF-8 safe: partial codepoints are buffered until complete).

        Chat templates and tool-call extraction come with the CLI slice."""
        if self.tokenizer is None:
            raise ValueError("generate() needs a tokenizer; use generate_tokens()")
        ids = self.encode_prompt(str(prompt))
        stream_buf: list[int] = []

        def tok_cb(tok: int, ms: float) -> None:
            stream_buf.append(tok)
            text = self.tokenizer.decode(stream_buf)
            if text and not text.endswith("�"):
                on_token(text, ms)
                stream_buf.clear()

        return self.generate_tokens(
            ids,
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            session_id=session_id,
            seed=seed,
            on_token=tok_cb if on_token else None,
        )

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
