"""Pipeline parallelism over `torch.distributed` (counterpart of
`jlama_tpu/parallel/pipeline.py`).

The JAX package runs its pp ring as one `shard_map` program over the pp
axis, its stages handing activations on by `jax.lax.ppermute` over ICI. The
torch idiom is one process per (dp, pp, tp) place: stage s holds the layers
[s·L/pp, (s+1)·L/pp) (`stage_range`, the JAX `_range` split), and its rank
hands its activations to the same tp rank of stage s + 1 by point-to-point
send and receive (`StageRing`). The ring's wrap-around, from the last stage
to stage 0, carries the sampled ids back to the leader's stage.

- `pipelined_forward`: the GPipe forward (`make_pipelined_forward`): M
  microbatches in the M + pp − 1 tick order of the JAX scan; stage 0 embeds,
  each stage runs its layers, the last stage keeps the finished microbatches
  and broadcasts them to every stage (JAX: the psum of the masked buffer).
- `ring_tick` and `decode_cell`: a tick's boundary exchange and a stage's
  decode cell, shared by the dense tick below and the pipelined scheduler's
  tick window over the paged pool (`runtime/pipelined.py`).
- `PipelinedDecode`: the dense pipelined decode tick (`make_pipelined_decode`):
  at tick t stage s runs microbatch (t − s) mod M against its own layers'
  dense cache, M = pp; the last stage computes the logits of the microbatch
  that just left the ring, broadcast to every stage as the JAX psum does.
- `stage_hidden`: one stage-serial forward (the schedulers' prefill, the
  `--no-pp-pipeline` decode step, the embeddings): stage 0 embeds and runs
  its layers, each later stage receives, runs its layers and hands on; the
  hidden state ends on the last stage.

A stage that has no valid input at a tick (the pipeline's fill) waits on its
receive and computes nothing in that tick's place, where the JAX stages
compute on zeros whose results are thrown away; no result changes. Every
tick begins with one exchange that posts the stage's send of its last
output and its receive of its next input together, so that the ring's
cycle cannot deadlock.
"""

from __future__ import annotations

import time
from dataclasses import replace

import torch

from ..config import ModelConfig


def stage_range(n_layers: int, pp: int, stage: int) -> tuple[int, int]:
    """[start, end) of stage `stage`'s layers (`jlama_tpu/parallel/
    distributed.py:_range`)."""
    if n_layers % pp:
        raise ValueError(f"n_layers must divide by pp (n_layers={n_layers}, pp={pp})")
    per = n_layers // pp
    return stage * per, (stage + 1) * per


def stage_cfg(cfg: ModelConfig, pp: int) -> ModelConfig:
    """A stage's view of the config: its L/pp layers (the KV pool's and the
    dense cache's layer count)."""
    if pp == 1:
        return cfg
    stage_range(cfg.n_layers, pp, 0)
    return replace(cfg, n_layers=cfg.n_layers // pp)


def stage_cut(params: dict, cfg: ModelConfig, pp: int, stage: int) -> dict:
    """Stage `stage`'s tree of a whole tree: its layers, and every top-level
    leaf whole (replicated over pp, the JAX package's `P()` for them)."""
    if pp == 1:
        return params
    lo, hi = stage_range(cfg.n_layers, pp, stage)
    if len(params["layers"]) != cfg.n_layers:
        raise ValueError(f"a tree of {len(params['layers'])} layers is no whole tree of the "
                         f"config's {cfg.n_layers}: pass a stage's tree as its RankSlice")
    return dict(params, layers=params["layers"][lo:hi])


class StageRing:
    """One rank's stage channel: its stage of the pp ranks that share its dp
    group and tp rank, the global ranks of the previous and the next stage
    (wrapping around), and `group`, the `TPGroup` of those pp ranks (the
    broadcasts from the last stage).

    Point-to-point route: NCCL and CPU tensors go directly. gloo's TCP
    transport takes a tensor's address as host memory: on the H100 (torch
    2.11) a gloo exchange of CUDA tensors failed on the sender (`writev ...
    Bad address`) and closed the pair under its peer, ending both ranks
    (`jlama_tpu_torch/scripts/probe_gloo_p2p.py`), so no probe can be run
    in the ranks themselves, as `TPGroup` probes its collectives; gloo with
    a CUDA tensor goes through pinned host memory, always (`route` says
    which). Any failure raises.

    `calls` and `seconds` count the exchanges this rank made and the host
    seconds spent in them."""

    def __init__(self, stage: int, pp: int, prev: int, next: int, backend: str,
                 device: torch.device, group=None):
        if pp < 2:
            raise ValueError(f"a stage ring needs pp >= 2, not {pp}")
        self.stage, self.pp = stage, pp
        self.prev, self.next = prev, next
        self.backend, self.device = backend, torch.device(device)
        self.group = group
        self.route = "host" if self.device.type == "cuda" and backend == "gloo" else "direct"
        self.calls, self.seconds = 0, 0.0

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.pp - 1

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if self.route == "direct":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def _buffer(self, shape, dtype) -> torch.Tensor:
        if self.route == "direct":
            return torch.empty(shape, dtype=dtype, device=self.device)
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def exchange(self, send_next=None, send_first=None, recv_prev=None, recv_last=None):
        """Post this rank's sends and receives together, then wait for all
        of them: `send_next` to the next stage, `send_first` (the last
        stage's ids) to stage 0, and receives of (shape, dtype) from the
        previous stage (`recv_prev`) and, on stage 0, from the last one
        (`recv_last`). Returns (from previous, from last), each a tensor on
        the rank's device or None.

        The exchange is a boundary op of the step being run
        (`runtime/graphs.py::boundary`): in a captured step it runs between
        two segments on buffers made once for the key (the tensors sent,
        their pinned host copies on the host route, the receive buffers and
        their device copies), and the tensors returned keep their
        addresses."""
        import torch.distributed as dist

        from ..runtime.graphs import boundary

        if send_first is not None and not self.last:
            raise ValueError("only the last stage sends to stage 0")
        if recv_last is not None and not self.first:
            raise ValueError("only stage 0 receives from the last stage")
        if send_next is not None and self.last:
            raise ValueError("the last stage has no next stage (its ids go to stage 0)")
        sends = [(name, t.contiguous()) for name, t in (("send_next", send_next),
                                                         ("send_first", send_first))
                 if t is not None]
        recvs = [(name, spec) for name, spec in (("recv_prev", recv_prev),
                                                 ("recv_last", recv_last))]
        if not sends and recv_prev is None and recv_last is None:
            return None, None
        desc = ("exchange", tuple((name, tuple(t.shape), t.dtype) for name, t in sends)
                + tuple((name, tuple(spec[0]), spec[1]) for name, spec in recvs
                        if spec is not None))
        host = self.route == "host"

        def build():
            out_bufs = [(t, torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if host
                         else t) for _, t in sends]
            in_bufs = [None if spec is None else self._buffer(*spec) for _, spec in recvs]
            results = tuple(None if b is None else
                            (torch.empty(b.shape, dtype=b.dtype, device=self.device) if host
                             else b) for b in in_bufs)

            def run():
                t0 = time.perf_counter()
                ops = []
                for t, b in out_bufs:
                    if b is not t:
                        b.copy_(t)
                    ops.append(dist.P2POp(dist.isend, b, self.next))
                ops += [dist.P2POp(dist.irecv, b, self.prev) for b in in_bufs if b is not None]
                for w in dist.batch_isend_irecv(ops):
                    w.wait()
                for b, r in zip(in_bufs, results):
                    if b is not None and r is not b:
                        r.copy_(b)
                self.calls += 1
                self.seconds += time.perf_counter() - t0

            return run, results

        return boundary(desc, build)

    def send_next(self, t: torch.Tensor) -> None:
        self.exchange(send_next=t)

    def recv_prev(self, shape, dtype) -> torch.Tensor:
        return self.exchange(recv_prev=(shape, dtype))[0]

    def exchange_back(self, send_prev=None, recv_next=None):
        """The backward's hand-over, against the ring's direction (the train
        step, `parallel/train.py`): post `send_prev` to the previous stage
        and a receive of `recv_next` (shape, dtype) from the next one
        together, then wait. Returns what came from the next stage, or
        None."""
        import torch.distributed as dist

        if send_prev is not None and self.first:
            raise ValueError("stage 0 has no previous stage to send back to")
        if recv_next is not None and self.last:
            raise ValueError("the last stage has no next stage to receive from")
        t0 = time.perf_counter()
        ops, buf = [], None
        if send_prev is not None:
            ops.append(dist.P2POp(dist.isend, self._out(send_prev), self.prev))
        if recv_next is not None:
            buf = self._buffer(*recv_next)
            ops.append(dist.P2POp(dist.irecv, buf, self.next))
        if not ops:
            return None
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        self.calls += 1
        self.seconds += time.perf_counter() - t0
        return None if buf is None else buf.to(self.device)

    def broadcast_last(self, t: torch.Tensor) -> torch.Tensor:
        """`t` from the last stage on every stage, in place (the JAX psum of
        a buffer that only the last stage filled)."""
        return self.group.broadcast_(t, src=self.pp - 1)


def stage_hidden(ring: StageRing | None, params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 positions: torch.Tensor, cache, dtype, attn_window=None, inv_freq=None,
                 first_layer: int = 0, token_types=None, seq_lengths=None):
    """One stage-serial forward: stage 0 embeds `tokens` and runs its
    layers; every later stage receives the hidden state [B, T, D] in
    `dtype` from the previous one, runs its layers and hands it on. Returns
    the hidden state on the last stage, None on the others. Without a ring
    (one device, or a tp rank) the tree's whole forward."""
    from ..models.base import _embed, forward_hidden, forward_layers

    if ring is None:
        return forward_hidden(params, cfg, tokens, positions, cache, dtype, attn_window,
                              inv_freq, token_types, seq_lengths)[0]
    if ring.first:
        x = _embed(params, cfg, tokens, positions, token_types, dtype)
    else:
        x = ring.recv_prev((*tokens.shape, cfg.embedding_length), dtype)
    x = forward_layers(params, cfg, x, positions, cache, attn_window, inv_freq, seq_lengths,
                       first_layer)
    if ring.last:
        return x
    if x.dtype != dtype:
        raise RuntimeError(f"stage {ring.stage}'s hidden state is {x.dtype}, the ring carries "
                           f"{dtype}")
    ring.send_next(x)
    return None


def ring_tick(ring: StageRing, t: int, n_cells: int | None, send=None, send_ids=None,
              recv=None, ids_back=None):
    """The boundary of tick t on this stage: one exchange posting together
    the hand-on of tick t − 1 (`send`, the activation for the next stage;
    `send_ids`, on the last stage, the ids for stage 0), the receive of this
    tick's input (`recv`, its (shape, dtype)) where this stage is not the
    first and has a cell at t, and on stage 0 with `ids_back` (their shape)
    the ids that left the ring at tick t − 1. Stage s's cells are the ticks
    s ... s + n_cells − 1 (`n_cells` None: every tick from s on). Returns
    (c, prev, ids): this stage's cell index t − s or None, the activation
    received or None, the ids received or None."""
    s, pp = ring.stage, ring.pp

    def has(stage, tick):
        c = tick - stage
        return c >= 0 and (n_cells is None or c < n_cells)

    want_ids = ids_back is not None and ring.first and has(pp - 1, t - 1)
    prev, ids = ring.exchange(
        send_next=send, send_first=send_ids,
        recv_prev=recv if not ring.first and has(s, t) else None,
        recv_last=(ids_back, torch.int64) if want_ids else None)
    return (t - s if has(s, t) else None), prev, ids


def decode_cell(ring: StageRing, params: dict, cfg: ModelConfig, tokens: torch.Tensor, prev,
                positions: torch.Tensor, cache, dtype, attn_window=None, inv_freq=None,
                first_layer: int = 0):
    """One decode cell of a stage: stage 0 embeds `tokens` [b] at
    `positions` [b, 1], a later stage takes `prev` [b, 1, D], which the
    previous stage handed on; the stage's layers run against `cache` (a
    dense `KVCache` or the paged (layers, page table)). Returns (the
    activation to hand on, None) on a stage before the last, (None, the f32
    logits [b, V]) on the last."""
    from ..models.base import _embed, forward_layers, lm_logits

    x = _embed(params, cfg, tokens[:, None], positions, None, dtype) if ring.first else prev
    y = forward_layers(params, cfg, x, positions, cache, attn_window, inv_freq,
                       first_layer=first_layer)
    if not ring.last:
        return y, None
    return None, lm_logits(params, cfg, y[:, -1:, :])[:, 0]


def pipelined_forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                      positions: torch.Tensor, n_microbatches: int, ring: StageRing,
                      dtype=torch.float32) -> torch.Tensor:
    """The GPipe forward of `make_pipelined_forward`: hidden [B, T, D] on
    every stage, from this stage's tree (`stage_cut`: its layers). The
    batch splits into M microbatches of B/M rows, which all take the first
    microbatch's positions (as there); M + pp − 1 ticks, stage s running
    microbatch t − s at tick t."""
    from ..models.base import _embed, forward_layers

    B, T = tokens.shape
    M, pp = n_microbatches, ring.pp
    if B % M:
        raise ValueError(f"batch {B} must divide into {M} microbatches")
    b, D = B // M, cfg.embedding_length
    first = ring.stage * len(params["layers"])
    pos_b = positions[:b]
    x_all = _embed(params, cfg, tokens, positions, None, dtype).reshape(M, b, T, D) \
        if ring.first else None
    out = torch.zeros((M, b, T, D), dtype=dtype, device=tokens.device)
    pending = None
    for t in range(M + pp):  # the last boundary only hands on
        mb, prev, _ = ring_tick(ring, t, M, send=pending, recv=((b, T, D), dtype))
        pending = None
        if mb is None:
            continue
        y = forward_layers(params, cfg, x_all[mb] if ring.first else prev, pos_b, None,
                           first_layer=first)
        if ring.last:
            out[mb] = y
        else:
            pending = y
    ring.broadcast_last(out)
    return out.reshape(B, T, D)


class PipelinedDecode:
    """The dense pipelined decode of `make_pipelined_decode`: M = pp
    microbatches of b rows, each stage's layers with their own dense cache
    [b, n_kv, max_len, hd] a microbatch. `tick(tokens, positions, t)`
    (both [M, b]) advances every stage by one cell: stage s runs microbatch
    (t − s) mod M, stage 0 embedding its tokens, the others taking what the
    previous stage handed on; from tick pp − 1 on it returns, on every
    stage, the f32 logits [b, V] of microbatch (t − pp + 1) mod M (the one
    fed again at tick t + 1), else None. `tp` is the stage's tp context;
    the caches live on `device` (CUDA unless named).

    A tick is a step of `graphs` (`runtime/graphs.py`), keyed by its
    microbatch (each has its own cache), whether it hands an activation on
    and whether it returns logits: its exchange and the logits' broadcast
    are boundary ops, the cell a segment. The cell reads its tokens and
    positions from static copies made before the step, and hands its
    activation on from one static buffer."""

    def __init__(self, params: dict, cfg: ModelConfig, ring: StageRing, b: int, max_len: int,
                 dtype=torch.float32, device=None, tp=None):
        from ..device import resolve_device
        from ..models.base import KVCache, rope_inv_freq
        from ..runtime.graphs import StepGraphs

        device = resolve_device(device)
        self.params, self.cfg, self.ring, self.b, self.dtype = params, cfg, ring, b, dtype
        self.M = ring.pp
        self.first = ring.stage * len(params["layers"])
        scfg = replace(cfg, n_layers=len(params["layers"]))
        self.caches = [KVCache.init(scfg, b, max_len, dtype, device) for _ in range(self.M)]
        self.inv_freq = rope_inv_freq(cfg, device)
        self.tp = tp
        self.graphs = StepGraphs(device)
        self._tokens = torch.zeros((b,), dtype=torch.int64, device=device)
        self._positions = torch.zeros((b, 1), dtype=torch.int64, device=device)
        self._act = torch.zeros((b, 1, cfg.embedding_length), dtype=dtype, device=device)
        self._send = False  # whether the last tick computed an activation to hand on

    def tick(self, tokens: torch.Tensor, positions: torch.Tensor, t: int):
        from .tp_forward import tp_context

        ring, b = self.ring, self.b
        c = t - ring.stage if t >= ring.stage else None
        mb = None if c is None else c % self.M
        emit, send = t >= ring.pp - 1, self._send
        with torch.inference_mode(), tp_context(self.tp):
            if mb is not None:
                self._tokens.copy_(tokens[mb])
                self._positions.copy_(positions[mb][:, None])

            def step():
                _, prev, _ = ring_tick(ring, t, None, send=self._act if send else None,
                                       recv=((b, 1, self.cfg.embedding_length), self.dtype))
                logits = None
                if mb is not None:
                    act, logits = decode_cell(
                        ring, self.params, self.cfg, self._tokens, prev, self._positions,
                        self.caches[mb], self.dtype, inv_freq=self.inv_freq,
                        first_layer=self.first)
                    if act is not None:
                        self._act.copy_(act)
                if not emit:
                    return None
                if logits is None:
                    logits = torch.zeros((b, self.cfg.vocab_size), dtype=torch.float32,
                                         device=self._act.device)
                return ring.broadcast_last(logits)

            out = self.graphs.run((mb, send, emit), step)
        self._send = mb is not None and not ring.last
        return out
