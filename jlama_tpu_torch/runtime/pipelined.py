"""Pipeline-parallel serving: the BatchScheduler decoding through the pp ring
(counterpart of `jlama_tpu/runtime/pipelined.py`).

Slot s of a dp group's n_slots/dp lives in microbatch s // b, row s % b,
with b = n_slots / (dp · pp) rows a microbatch and M = pp microbatches (full
pipeline occupancy). Each scheduler step runs one self-contained window of
(pp − 1) + M·W ticks (W = `decode_lag`, shrunk to 1 while work waits):
stage s runs microbatch (t − s) mod M at tick t, the last stage samples the
microbatch that just left the ring, and the ring's wrap-around carries its
ids to stage 0, which feeds them back one tick later. No pipeline state is
carried across windows, so admissions and finishes never meet in-flight
activations.

The JAX window computes every (stage, tick) cell, on zeros where a stage has
no input yet and on the next token's first passes at its end, and throws
those results away; here a stage computes only the M·W cells whose token is
sampled in the window, and waits on its receive for the others. The pages
then hold at every position below a row's position what the JAX pool holds
(the fill ticks' JAX writes are overwritten by the real token before the
window ends; the tail's land at the row's position, which the next window
writes again first).

KV lives in the flat scheduler's pool and allocator, each rank's pool
holding its stage's layers (and its tp heads), so sessions, suspend (a disk
suspend writes one file per rank) and q8 pools work as there. Prefill runs
stage by stage through the base scheduler's batched chunked prefill
(`parallel/pipeline.py::stage_hidden`; the JAX package runs it through
GSPMD, its stages serializing alike).

Sampling happens on the last stage, from the seeds, steps, temperatures,
top-k and top-p that the window's message carries, through the port's
counter-based streams (`nn/sampling.py::counter_uniform`), so a seeded
request samples what the port's one-device scheduler samples.

Multi-process: the leader publishes each window as `{"op": "ptick", ...}`
on the step channel; every rank replays it in `run_follower`. dp × pp: each
dp group is a whole ring over its page group and its slots; the first rank
of each group's stage 0 sends the window's ids to the leader (`mesh.rows`).

Refused with the JAX error: presence and frequency penalties.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn.sampling import sample_token
from ..parallel.pipeline import decode_cell, ring_tick
from ..parallel.tp_forward import tp_context
from .engine import FinishReason, _bucket
from .graphs import DecodeInputs
from .scheduler import BatchScheduler, GenRequest, RequestState


class PipelinedScheduler(BatchScheduler):
    def __init__(self, params, cfg, tokenizer=None, *, mesh, n_slots=8, n_pages=512,
                 page_size=64, max_seq_len=None, kv_dtype=torch.bfloat16,
                 compute_dtype=torch.bfloat16, seed=0, decode_lag=None, prefill_chunk=256,
                 max_sessions=64, fuse=True, moe_ragged=True, weight_format=None,
                 step_channel=None, device=None, decode_graphs=None):
        """As `BatchScheduler` on a mesh whose pp >= 2; n_slots must divide
        by dp · pp (each dp group's slots into pp microbatches).
        decode_graphs=False runs every tick window eagerly on the card too
        (the yardstick)."""
        if mesh is None or mesh.pp < 2:
            raise ValueError("PipelinedScheduler needs a mesh with pp >= 2")
        pp = mesh.pp
        if n_slots % pp:
            raise ValueError(f"n_slots ({n_slots}) must divide by pp ({pp})")
        if n_slots % (mesh.dp * pp):
            raise ValueError(f"n_slots ({n_slots}) must divide by dp * pp ({mesh.dp * pp}): "
                             "each dp group's slots split into pp microbatches")
        super().__init__(
            params, cfg, tokenizer, n_slots=n_slots, n_pages=n_pages, page_size=page_size,
            max_seq_len=max_seq_len, kv_dtype=kv_dtype, compute_dtype=compute_dtype,
            seed=seed, mesh=mesh, prefill_chunk=prefill_chunk, max_sessions=max_sessions,
            fuse=fuse, decode_lag=decode_lag, weight_format=weight_format,
            step_channel=step_channel, device=device, moe_ragged=moe_ragged,
            decode_graphs=decode_graphs)
        self.pp = pp
        self.M = pp  # microbatches == stages (full pipeline occupancy)
        self.b = self._spg // pp  # rows a microbatch
        # every window's sampled ids of this rank, when a list: stage 0 logs
        # each window's [n_slots/dp] ids, the last stage each cell's
        self.window_log: list | None = None
        # the ticks of the windows run, and the cells this rank computed
        # (M·W a window on every stage), read against the kernels' launches
        self.n_ticks = 0
        self.n_cells = 0

    # -- admission tweaks ----------------------------------------------

    def submit(self, req: GenRequest) -> GenRequest:
        if req.presence_penalty or req.frequency_penalty:
            req.error = "presence/frequency penalties are not supported with the pp pipeline"
            req.finish = FinishReason.ERROR
            req.state = RequestState.DONE
            req.done_event.set()
            return req
        return super().submit(req)

    def warmup(self, max_context=None, prefill_rows=None, decode_windows=None,
               prefill_windows=None) -> None:
        """Run a tick window (W = 1) at every window bucket twice, so that on
        the card each is captured, and every prefill shape that traffic up
        to `max_context` tokens reaches."""
        wins = self._window_buckets(max_context or self.max_seq_len)
        decode_windows = decode_windows if decode_windows is not None else wins
        B = self.n_slots
        zeros = lambda *s: np.zeros(s, np.int32)  # noqa: E731
        pts = self.kv.page_table(["__empty__"] * B, groups=self._slot_groups())
        for win in decode_windows:
            for _ in range(2):
                self._run_ticks(
                    {"tokens": zeros(B), "positions": zeros(B), "pts": pts,
                     "seeds": zeros(B), "steps": zeros(B), "temps": np.zeros(B, np.float32),
                     "top_ps": np.ones(B, np.float32), "top_ks": zeros(B),
                     "n_ticks": (self.pp - 1) + self.M, "win": int(win)},
                    publish=True, collect=False)
        super().warmup(max_context, prefill_rows, decode_windows=[],
                       prefill_windows=prefill_windows)

    # -- tick windows (leader + follower replay) -----------------------

    def _run_ticks(self, msg: dict, publish: bool, collect: bool):
        """Run one tick window from host inputs (`msg`: per-slot tokens,
        positions, page tables and sampling parameters, the tick count and
        the attention window). Returns, on the leader with `collect`, the
        window's W arrays of sampled ids [n_slots] (sample w of every slot);
        None elsewhere.

        The window is one step of `graphs` (the JAX package's jitted tick
        window), keyed by (ticks, attention window, all greedy, all top_k
        0, all top_p 1) and read from that key's static inputs: on the card
        its cells are graph segments and its exchanges the boundary ops
        between them (`runtime/graphs.py`)."""
        if publish and self._chan is not None and self._is_leader:
            self._chan.publish({"op": "ptick", **msg})
        ring, M, b = self._ring, self.M, self.b
        n_ticks, win = int(msg["n_ticks"]), int(msg["win"])
        W = (n_ticks - (self.pp - 1)) // M
        loc = self._local
        greedy = not bool(np.any(np.asarray(loc(msg["temps"])) != 0.0))
        all_k0 = not bool(np.any(np.asarray(loc(msg["top_ks"])) > 0))
        all_p1 = bool(np.all(np.asarray(loc(msg["top_ps"])) >= 1.0))
        key = ("ptick", n_ticks, win, greedy, all_k0, all_p1)
        inp = self.graphs.inputs(key, lambda: DecodeInputs(
            M * b, self.device, pages=self.kv.max_pages_per_seq))
        inp.load(tokens=loc(msg["tokens"]), positions=loc(msg["positions"]),
                 page_tables=self.kv.local_tables(np.asarray(loc(msg["pts"]))),
                 seeds=loc(msg["seeds"]), steps=loc(msg["steps"]), temps=loc(msg["temps"]),
                 top_ps=loc(msg["top_ps"]), top_ks=loc(msg["top_ks"]))
        with torch.inference_mode(), tp_context(self._tp):
            ids, cells = self.graphs.run(
                key, lambda: self._window(inp, n_ticks, win, W, greedy, all_k0, all_p1))
        self.n_decode_steps += W
        self.n_ticks += n_ticks
        self.n_cells += M * W
        if self.window_log is not None and cells is not None:
            self.window_log.extend(cells.cpu().numpy())
        if not ring.first:
            return None
        win_ids = ids.reshape(W, M * b).cpu()
        if self.window_log is not None:
            self.window_log.extend(win_ids.numpy())
        if self._dp > 1:
            if self._rows is None:  # stage 0's other tp ranks: their first rank sends
                return None
            win_ids = self._rows.all_gather(win_ids.to(torch.int32), dim=1)
        return list(win_ids.numpy()) if collect else None

    def _window(self, inp: DecodeInputs, n_ticks: int, win: int, W: int, greedy: bool,
                all_k0: bool, all_p1: bool):
        """One tick window on the static inputs: (ids [W, M, b] on stage 0,
        each cell's sampled ids [M·W, b] on the last stage), None where a
        stage has none."""
        ring, M, b, pp = self._ring, self.M, self.b, self.pp
        tokens = inp.tokens.reshape(M, b)
        positions = inp.positions.reshape(M, b)
        pts = inp.page_tables.reshape(M, b, -1)
        act = ((b, 1, self.cfg.embedding_length), self.compute_dtype)
        ids = torch.zeros((W, M, b), dtype=torch.int64, device=self.device) \
            if ring.first else None
        cells = [] if ring.last else None
        feed = list(tokens)  # stage 0: each microbatch's next token
        pending_act = pending_ids = None
        for t in range(n_ticks + 1):  # the last boundary only hands on
            c, prev, got = ring_tick(ring, t, M * W, send=pending_act, send_ids=pending_ids,
                                     recv=act, ids_back=(b,))
            pending_act = pending_ids = None
            if got is not None:  # stage 0: the ids that left the ring at tick t - 1
                w, mb = divmod(t - 1 - (pp - 1), M)
                ids[w, mb] = got
                feed[mb] = got
            if c is None:
                continue
            w, mb = divmod(c, M)
            pending_act, logits = decode_cell(
                ring, self.params, self.fwd_cfg, feed[mb], prev, (positions[mb] + w)[:, None],
                (self._layers, pts[mb]), self.compute_dtype, win, self.inv_freq,
                self._first_layer)
            if logits is None:
                continue
            r = slice(mb * b, (mb + 1) * b)
            pending_ids = sample_token(
                logits, None, 0.0 if greedy else inp.temps[r],
                top_k=0 if greedy or all_k0 else inp.top_ks[r],
                top_p=1.0 if greedy or all_p1 else inp.top_ps[r],
                seeds=inp.seeds[r], steps=inp.steps[r] + w)
            cells.append(pending_ids)
        return ids, (torch.stack(cells) if cells is not None else None)

    # -- the pipelined decode window -----------------------------------

    def _step_locked(self) -> int:
        self._flush_releases()
        self._admit()
        self._advance_prefill()
        running = [r for r in self.slots if r is not None and r.state == RequestState.RUNNING]
        if not running:
            return len([r for r in self.slots if r is not None])

        B, M, pp = self.n_slots, self.M, self.pp
        ps = self.kv.page_size
        # W tokens a slot a window; the (pp - 1)-tick fill is amortized over
        # M·W samples. Shrink to 1 while work waits, so that admissions and
        # prefills stay responsive.
        W = self.decode_lag
        if not self.pending.empty() or any(
                r is not None and r.state != RequestState.RUNNING for r in self.slots):
            W = 1
        head = min(min(r.max_new_tokens - len(r.out_ids) for r in running),
                   min(self.max_seq_len - 1 - r.position for r in running))
        W = max(1, min(W, head))

        # page capacity for the whole window; rows that cannot get pages even
        # after eviction sit this window out on the scratch page
        for r in list(running):
            if not self._ensure_capacity_evicting(self._kv_key(r), r.position + W,
                                                  self._group_of_slot(r.slot)):
                running.remove(r)
        if not running:
            return len([r for r in self.slots if r is not None])

        tokens = np.zeros(B, dtype=np.int32)
        positions = np.zeros(B, dtype=np.int32)
        temps = np.zeros(B, dtype=np.float32)
        top_ps = np.ones(B, dtype=np.float32)
        top_ks = np.zeros(B, dtype=np.int32)
        seeds = np.zeros(B, dtype=np.int64)
        steps = np.zeros(B, dtype=np.int32)
        seq_ids = ["__empty__"] * B
        win = 0
        for r in running:
            tokens[r.slot] = r.cur_token
            positions[r.slot] = r.position
            temps[r.slot] = r.temperature
            top_ps[r.slot] = r.top_p
            top_ks[r.slot] = r.top_k
            seeds[r.slot] = r.seed or 0
            steps[r.slot] = len(r.out_ids)
            seq_ids[r.slot] = self._kv_key(r)
            win = max(win, _bucket(r.position + W))
        pts = self.kv.page_table(seq_ids, groups=self._slot_groups())
        win = min(win, self.kv.max_pages_per_seq * ps)
        windows = self._run_ticks(
            {"tokens": tokens, "positions": positions, "pts": pts, "seeds": seeds,
             "steps": steps, "temps": temps, "top_ps": top_ps, "top_ks": top_ks,
             "n_ticks": (pp - 1) + M * W, "win": int(win)},
            publish=True, collect=True)
        self._apply_sampled(running, windows)
        return len([r for r in self.slots if r is not None])
