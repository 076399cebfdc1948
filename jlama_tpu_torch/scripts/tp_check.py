"""The rank program of chip_smoke.py's mesh phases: the ranks of the port's
tp (phase 16), dp x tp (phase 17) and expert-parallel (phase 18) serving
paths, one process each, on random JQ4 weights from a seed.

    rank_main(rank, world, store_path, out_path, spec)

`spec` names the model ("llama8b", "llama1b", "mixtral", cut to
`spec["layers"]`, or `hf_config`), the mesh (`dp`, default 1; tp = world /
dp; rank r is tp rank r % tp of dp group r // tp) and the work. Each rank
joins the world through a FileStore at `store_path` (the backend and device
from `spec`: ranks sharing one GPU take gloo, which NCCL refuses), builds the
mesh BatchScheduler from the full random tree (each rank keeps its slice:
its heads, its E/tp experts; its dp group's pages and rows), and rank 0
leads it over the step channel (port 0, handed over through the store)
while the others run `run_follower`. In order:

0. on CUDA under gloo, `route_check`: each collective by the route the
   group picked at first use and again staged through pinned host memory,
   both exact;
1. the logits of the last `spec["logit_rows"]` positions of a
   `spec["prefill"]`-token prompt through the tp forward (no cache: K1 and
   K3; K6 on each rank's experts), all ranks in step; rank 0's logits are
   broadcast over the world and every rank compares its own with them;
   with `spec["k6"]`, K6 on the rank's local experts of layer 0
   (`k6_check`: the decode and the prefill route against their plain
   models over the rank's range, foreign rows exactly 0, a bit-equal
   repeat; timed on rank 0);
2. `spec["requests"]` served requests (seeded prompts and lengths, half of
   them sampled), every rank's sampled ids logged per decode step, and the
   kernels' launches counted from 0 over them; the scheduler runs on
   graphs (the default: on the card each step a chain of segments cut at
   its collectives), and every rank prints each decode step's logits
   (`LogitsPrints`);
3. a decode timing run: a request a slot (16-token prompts), the wall time
   per decode step once every row decodes; and torch.profiler over `profile`
   steps of it on rank 0 (device time by kernel), with the collectives'
   host time from the group's calls;
4. a session suspended to disk (one file per rank of its dp group; under
   dp the session sits in group 1, the leader's group full of short
   requests when it arrives) and resumed, its greedy ids against a session
   that never suspended; then `spec["greedy"]` greedy requests;
5. the eager yardstick (`decode_graphs=False`) over the same slice: the
   served requests again, whose ids, launches and logits' prints must be
   the graphed run's, then a timed decode as in 3 (every rank's launches
   as its calls imply);
6. `Engine(mesh=)` on every rank in step (SPMD), `ENGINE_NEW` greedy
   tokens on graphs and eagerly: the same ids, prints and launches, graphs
   captured and replayed;
7. on rank 0, after the followers stop: the same weights on one device
   through the single-device path, the same prompt's logits, and their
   relative L2 distance from the tp logits (`REL_L2_LIMIT`); the greedy
   requests through a single-device BatchScheduler, whose ids must equal
   the mesh's; the Engine's tokens on one device.

Each rank pickles its results to `out_path`; the caller starts the ranks
and waits for them (`start_ranks`, `wait_ranks`) and compares them
(`check_ranks`): chip_smoke.py phase 16, tests/test_torch_tp_check.py on
the CPU. `routes_main` runs `route_check` alone
(tests/test_torch_cuda_tp.py).
"""

from __future__ import annotations

import math
import multiprocessing as mp
import pickle
import tempfile
import time
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import numpy as np

KERNEL_GROUPS = (("q4_matmul", ("q4_gemv_kernel", "q4_mma_kernel", "q4_wgmma_kernel")),
                 ("paged_decode", ("paged_decode",)), ("flash_prefill", ("flash_prefill",)),
                 ("kv_write", ("kv_write",)), ("memcpy", ("Memcpy", "memcpy")))


def start_ranks(target, args_of, world: int, deadline_s: float):
    """One `spawn` process per rank running target(*args_of(rank)), started;
    returns them and the monotonic time of their deadline."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(r), daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return procs, time.monotonic() + deadline_s


def wait_ranks(procs, end: float) -> str | None:
    """Wait for every rank until `end` and kill those still running then;
    None when every rank exited with 0, else what went wrong."""
    try:
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            return f"rank(s) {hung} still running at the deadline, killed"
        codes = [p.exitcode for p in procs]
        return None if codes == [0] * len(procs) else f"rank exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)


def route_check(torch, group) -> dict:
    """Each of the group's collectives on f32 tensors of its device (the
    dtype the tp forward's collectives carry): by the route the group
    picked at its first use, then staged through pinned host memory
    (`routes` set to "host" for the call, then put back), each against the
    sum, concatenation or copy that every rank computes from the ranks'
    seeded inputs. Returns {op: [route picked, max |error|, max |error|
    staged]} (an error is inf where the result left the device)."""
    xs = [torch.randn((16, 64), generator=torch.Generator().manual_seed(r))
          for r in range(group.size)]
    want = {"all_reduce": sum(xs[1:], xs[0]), "all_gather": torch.cat(xs, dim=-1),
            "broadcast": xs[0]}
    out = {}
    for op, ref in want.items():
        key, errs = (op, torch.float32), []
        for staged in (False, True):
            picked = group.routes.get(key)
            if staged:
                group.routes[key] = "host"
            x = xs[group.rank].to(group.device)
            if op == "all_gather":
                got = group.all_gather(x, dim=-1)
            elif op == "all_reduce":
                got = group.all_reduce_(x)
            else:
                got = group.broadcast_(x, src=0)
            if staged:
                group.routes[key] = picked
            errs.append((got.cpu() - ref).abs().max().item() if got.device == group.device
                        else math.inf)
        out[op] = [group.routes[key], *errs]
    return out


def routes_main(rank: int, world: int, store_path: str, out_path: str) -> None:
    """`route_check` alone on ranks of cuda:0 over gloo; pickles its result."""
    import torch

    from ..parallel.distributed import init_tp_group, shutdown

    group = init_tp_group(world, rank, device="cuda:0", backend="gloo", store_path=store_path,
                          timeout_s=60)
    out = route_check(torch, group)
    shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _config(spec):
    from ..config import from_hf_config
    from ..models.init import llama_1b_config, llama_8b_config, mixtral_8x7b_config

    if spec.get("hf_config"):
        return from_hf_config(spec["hf_config"])
    base = {"llama8b": llama_8b_config, "llama1b": llama_1b_config,
            "mixtral": mixtral_8x7b_config}[spec.get("model", "llama8b")]()
    return replace(base, n_layers=spec["layers"])


def _kernels(moe: bool = False):
    from ..ops.attention import flash_prefill, paged_decode
    from ..ops.kv_write import kv_write
    from ..ops.q4_matmul import q4_matmul

    out = {"q4_matmul": q4_matmul, "paged_decode": paged_decode,
           "flash_prefill": flash_prefill, "kv_write": kv_write}
    if moe:
        from ..ops.moe_q4 import moe_gather, moe_groups, moe_q4_matmul

        out.update(moe_q4_matmul=moe_q4_matmul, moe_groups=moe_groups, moe_gather=moe_gather)
    return out


class _CollectiveClock:
    """Host seconds spent in the collectives of some groups: the sum of
    their `calls` and `seconds` (a collective counts where it runs, on its
    replay's turn inside a captured step too; with gloo every call returns
    once the result is on the rank)."""

    def __init__(self, *groups):
        self.groups = [g for g in groups if g is not None]

    @property
    def calls(self) -> int:
        return sum(g.calls for g in self.groups)

    @property
    def seconds(self) -> float:
        return sum(g.seconds for g in self.groups)


class LogitsPrints:
    """A print of every f32 logits tensor this process computes through
    `lm_logits` (`models.base`'s, as `runtime.scheduler` and
    `runtime.engine` call it): the sum of its elements' bit patterns as
    int32, and their sum weighted by position (1, 2, ...), both in int64,
    into the next row of a device buffer through a device-side counter,
    so that a captured step prints at each replay. Equal prints: the same
    bits, barring a collision. `begin()` starts a session's buffer (a graph
    captured in it keeps printing into it); `take()` returns its [n, 2]
    prints."""

    N = 1 << 14  # prints a session keeps (later ones overwrite the last)

    def __init__(self, torch, device):
        from ..models import base
        from ..runtime import engine, scheduler

        self.torch, self.device = torch, torch.device(device)
        self.buf = self.ctr = None
        self._weights = {}
        self._kept = []  # every session's buffers: a graph writes them by address
        inner = base.lm_logits

        def lm_logits(params, cfg, hidden):
            out = inner(params, cfg, hidden)
            if self.buf is not None and out.dtype == torch.float32:
                self._print(out)
            return out

        for mod in (base, engine, scheduler):
            mod.lm_logits = lm_logits

    def _print(self, logits):
        torch = self.torch
        bits = logits.detach().contiguous().view(torch.int32).reshape(-1)
        w = self._weights.get(bits.numel())
        if w is None:
            from ..runtime.graphs import capturing

            if capturing():  # a capture runs nothing: the weights would stay unwritten
                raise RuntimeError("LogitsPrints: a new logits shape first met in a capture")
            w = self._weights[bits.numel()] = torch.arange(
                1, bits.numel() + 1, dtype=torch.int32, device=bits.device)
        v = torch.stack([bits.sum(dtype=torch.int64), (bits * w).sum(dtype=torch.int64)])
        self.buf.index_copy_(0, self.ctr.clamp(max=self.N - 1), v[None])
        self.ctr.add_(1)

    def begin(self) -> None:
        torch = self.torch
        self.buf = torch.zeros((self.N, 2), dtype=torch.int64, device=self.device)
        self.ctr = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._kept.append((self.buf, self.ctr))

    def take(self) -> np.ndarray:
        n = min(int(self.ctr), self.N)
        out = self.buf[:n].cpu().numpy()
        self.buf = self.ctr = None
        return out


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ids(rng, n, vocab):
    return [int(x) for x in rng.integers(1, min(vocab, 120000), n)]


def _logits(torch, sched, ids, rows, tp):
    """The last `rows` positions' f32 logits of one prompt, no cache."""
    from ..models.base import forward_hidden, lm_logits
    from ..parallel.tp_forward import tp_context

    toks = torch.tensor([ids], dtype=torch.long, device=sched.device)
    pos = torch.arange(len(ids), device=sched.device)[None]
    with torch.inference_mode(), tp_context(tp):
        h, _ = forward_hidden(sched.params, sched.fwd_cfg, toks, pos, None,
                              dtype=sched.compute_dtype)
        return lm_logits(sched.params, sched.fwd_cfg, h[:, -rows:])[0]


def _serve(sched, reqs):
    from ..runtime.scheduler import RequestState

    for r in reqs:
        sched.submit(r)
    while not all(r.state == RequestState.DONE for r in reqs):
        sched.step()


# K6 under EP against its route's plain model over the rank's expert range
# (chip_smoke.py's MOE_TOL / MOE_MODEL_TOL): max |kernel - model| <= 1e-4 *
# max|model|, plus one bf16 ulp of the value (2^-7 of it) for a bf16 output
K6_TOL = 1e-4
K6_RS = (2, 32, 1024)  # an Engine's decode, a 16-slot step, a 512-token prefill


def k6_check(torch, sched, cfg, tp_rank: int, timed: bool) -> dict:
    """K6 on this rank's local experts of layer 0 (E/tp of them, the model's
    tp_rank · E/tp onward), at K6_RS selections of seeded routing over the
    model's E experts: gate and up in one call, then w2, each against its
    route's plain model with the same range (the decode route against
    moe_q4_matmul_plain, the prefill route against its rounding model),
    every foreign row exactly 0, a second call bit-equal; with `timed` (rank
    0 on the card) each call's device time, median of 10 after an L2
    flush. Returns {R: {route, foreign rows, max errors, ms}}."""
    from ..ops.moe_q4 import (moe_q4_gate_up, moe_q4_matmul, moe_q4_matmul_plain,
                              moe_q4_matmul_tiled_plain, takes_decode)

    dev = sched.device
    lay = sched.params["layers"][0]
    w1, w3, w2 = lay["experts.w1"], lay["experts.w3"], lay["experts.w2"]
    n_local, K = w1.shape[0], cfg.n_experts_per_token
    lo = tp_rank * n_local
    timer = None
    if timed:
        from ..utils.cuda_timer import Timer

        timer = Timer(dev)
    g = torch.Generator(device=dev).manual_seed(5)
    xdt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    out = {"lo": lo, "n_local": n_local}
    for r in K6_RS:
        t = r // K
        e = torch.rand((t, cfg.n_experts), generator=g, device=dev).argsort(dim=1)[:, :K]
        e = e.to(torch.int32)
        x = torch.randn((t, w1.shape[2]), generator=g, device=dev).to(xdt)
        h = torch.randn((r, w2.shape[2]), generator=g, device=dev).to(xdt)
        route = "decode" if dev.type != "cuda" or takes_decode(r) else "prefill"
        model = moe_q4_matmul_plain if route == "decode" else moe_q4_matmul_tiled_plain
        el = e.reshape(-1).long() - lo
        foreign = ((el < 0) | (el >= n_local))

        def run():
            gate, up = moe_q4_gate_up(x, w1, w3, e, xdt, lo=lo)
            return gate, up, moe_q4_matmul(h, w2, e.reshape(-1), torch.float32, lo=lo)

        ys = run()
        again = run()
        row = {"route": route, "foreign_rows": int(foreign.sum()),
               "repeat_bit_equal": all(torch.equal(a, b) for a, b in zip(ys, again))}
        errs, zero = [], True
        for y, (xx, w, ee) in zip(ys, ((x, w1, e), (x, w3, e), (h, w2, e.reshape(-1)))):
            ref = model(xx, w, ee, torch.float32, lo=lo)
            d = (y.float() - ref).abs()
            lim = K6_TOL * ref.abs().max().item()
            if y.dtype == torch.bfloat16:
                lim = lim + 2.0 ** -7 * ref.abs()
            row.setdefault("within", True)
            row["within"] = row["within"] and bool((d <= lim).all())
            errs.append(d.max().item())
            zero = zero and bool((y.reshape(r, -1)[foreign] == 0).all())
        row.update(max_abs_err=max(errs), foreign_zero=zero)
        if timer is not None:
            row["gate_up_ms"] = timer(lambda: moe_q4_gate_up(x, w1, w3, e, xdt, lo=lo))
            row["w2_ms"] = timer(lambda: moe_q4_matmul(h, w2, e.reshape(-1), torch.float32,
                                                       lo=lo))
        out[r] = row
    return out


def _served_specs(rng, spec, vocab) -> list[dict]:
    """The served requests of step 2 (seeded prompts and lengths, half of
    them sampled), as GenRequest arguments."""
    return [dict(prompt_ids=_ids(rng, int(rng.integers(32, spec["prefill"] + 1)), vocab),
                 max_new_tokens=spec["new_tokens"], temperature=0.8 if i % 2 else 0.0,
                 top_k=40 if i % 2 else 0, seed=100 + i)
            for i in range(spec["requests"])]


def _serve_specs(torch, sched, specs, kernels) -> dict:
    """Serve the requests; their ids and finishes, the seconds, the prefill
    calls and decode steps, and the kernels' launches since their reset."""
    from ..runtime.scheduler import GenRequest

    pf0, dec0 = sched.n_prefill_calls, sched.n_decode_steps
    reqs = [GenRequest(stop_ids={-1}, **s) for s in specs]
    t0 = time.perf_counter()
    _serve(sched, reqs)
    return dict(serve_s=time.perf_counter() - t0, served=[list(r.out_ids) for r in reqs],
                finish=[r.finish.value for r in reqs], n_prefill=sched.n_prefill_calls - pf0,
                n_decode=sched.n_decode_steps - dec0,
                launches={k: fn.launches for k, fn in kernels.items()})


# the timed requests' prompt: their positions (72 to 120) keep every decode
# window in the 128-token bucket, so that the timed steps hold no key's first
# use or capture
TIMED_PROMPT, TIMED_NEW = 72, 48
WARM_STEPS = 2  # scheduler steps between every slot decoding and the timing


def _timed_decode(torch, sched, spec, rng, clock, profile: bool) -> dict:
    """A request a slot (`TIMED_PROMPT`-token prompts), every slot decoding
    and `WARM_STEPS` more scheduler steps run: the wall time per decode step
    over `spec["timed_steps"]` steps, the collectives' host time in them and
    the steps that were a key's first use (0 on graphs: every step a
    replay); with `profile` (on the card) torch.profiler over
    `spec["profile"]` more steps (device time by kernel group). Then the
    requests run to their end."""
    from ..runtime.scheduler import GenRequest, RequestState

    cfg, out = sched.cfg, {}
    reqs = [GenRequest(prompt_ids=_ids(rng, TIMED_PROMPT, cfg.vocab_size),
                       max_new_tokens=TIMED_NEW, stop_ids={-1}) for _ in range(sched.n_slots)]
    for r in reqs:
        sched.submit(r)
    while not all(r.state == RequestState.RUNNING and r.out_ids for r in reqs):
        sched.step()
    for _ in range(WARM_STEPS):
        sched.step()
    _sync(torch, sched.device)
    g0 = sched.graphs.stats()
    t0, n0, c0 = time.perf_counter(), sched.n_decode_steps, (clock.calls, clock.seconds)
    while sched.n_decode_steps - n0 < spec["timed_steps"]:
        sched.step()
    _sync(torch, sched.device)
    steps = sched.n_decode_steps - n0
    out["timed_first_uses"] = sched.graphs.stats()["eager_steps"] - g0["eager_steps"]
    out["decode_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / steps
    out["decode_steps_timed"] = steps
    out["collective_ms_per_step"] = (clock.seconds - c0[1]) * 1e3 / steps
    out["collectives_per_step"] = (clock.calls - c0[0]) / steps
    if profile and spec["profile"] and sched.device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        c1 = (clock.calls, clock.seconds)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0, n0 = time.perf_counter(), sched.n_decode_steps
            while sched.n_decode_steps - n0 < spec["profile"]:
                sched.step()
            _sync(torch, sched.device)
            wall = (time.perf_counter() - t0) * 1e3
        steps = sched.n_decode_steps - n0
        groups = {g: 0.0 for g, _ in KERNEL_GROUPS} | {"other": 0.0}
        for e in prof.key_averages():
            if str(e.device_type).endswith("CUDA"):
                g = next((g for g, names in KERNEL_GROUPS if any(s in e.key for s in names)),
                         "other")
                groups[g] += e.self_device_time_total / 1e3
        out["profile"] = dict(steps=steps, wall_ms=wall, device_ms_by_group=groups,
                              collective_host_ms=(clock.seconds - c1[1]) * 1e3,
                              collective_calls=clock.calls - c1[0])
    _serve(sched, reqs)
    return out


def _lead(torch, sched, spec, rng, out, clock, kernels):
    """Rank 0's part of steps 2-4."""
    from ..runtime.scheduler import GenRequest

    cfg = sched.cfg
    out["served_specs"] = _served_specs(rng, spec, cfg.vocab_size)
    out.update(_serve_specs(torch, sched, out["served_specs"], kernels))
    out.update(_timed_decode(torch, sched, spec, rng, clock, profile=True))
    # a session suspended to disk, one file per rank of its dp group, against
    # one that never was; under dp both sit in group 1 (short requests fill
    # the leader's group first), so that the leader holds none of their pages
    first, second = _ids(rng, 300, cfg.vocab_size), _ids(rng, 40, cfg.vocab_size)
    fill = [GenRequest(prompt_ids=_ids(rng, 8, cfg.vocab_size), max_new_tokens=2,
                       stop_ids={-1}) for _ in range(sched._spg if sched._dp > 1 else 0)]
    sess = [GenRequest(prompt_ids=list(first), max_new_tokens=16, session_id=sid,
                       stop_ids={-1}) for sid in ("disk", "kept")]
    _serve(sched, fill + sess)
    out["disk_group"] = sched.kv.alloc.group_of.get("disk")
    with tempfile.TemporaryDirectory() as d:
        ok = sched.suspend_session("disk", to_dir=d) and sched.resume_session("disk")
        # this request's collectives come after every rank's resume, which
        # read its file: the directory outlives them
        out["disk_ids"] = sched.generate(second, max_new_tokens=32, session_id="disk",
                                         stop_ids={-1}).token_ids
        out["disk_files"] = sorted(p.name for p in Path(d).iterdir())
    out["disk_ok"] = ok
    out["disk_group_after"] = sched.kv.alloc.group_of.get("disk")
    out["kept_ids"] = sched.generate(second, max_new_tokens=32, session_id="kept",
                                     stop_ids={-1}).token_ids
    # greedy requests, held against one device on rank 0 after the followers stop
    out["greedy_prompts"] = [_ids(rng, int(rng.integers(16, 257)), cfg.vocab_size)
                             for _ in range(spec.get("greedy", 0))]
    greedy = [GenRequest(prompt_ids=list(p), max_new_tokens=spec["new_tokens"], stop_ids={-1})
              for p in out["greedy_prompts"]]
    _serve(sched, greedy)
    out["greedy_ids"] = [list(r.out_ids) for r in greedy]


ENGINE_NEW = 8  # the Engine check's greedy tokens, after a 100-token prompt


def engine_check(torch, params, cfg, mesh, device, prints, prompt, kernels) -> dict:
    """`Engine(mesh=)` on every rank, SPMD (each rank its slice, the same
    call): `ENGINE_NEW` greedy tokens after `prompt`, on graphs (the
    default) and on the eager yardstick (`decode_graphs=False`): per run
    the ids, the logits' prints, the kernels' launches and the graph
    stats."""
    from ..runtime.engine import Engine

    out = {}
    for run, graphs in (("graphs", True), ("eager", False)):
        eng = Engine(params, cfg, device=device, max_seq_len=512, fuse=False, mesh=mesh,
                     decode_graphs=graphs)
        for fn in kernels.values():
            fn.launches = 0
        prints.begin()
        ids = eng.generate_tokens(list(prompt), max_new_tokens=ENGINE_NEW,
                                  stop_ids=set()).token_ids
        _sync(torch, device)
        out[run] = dict(ids=ids, prints=prints.take(), graphs=eng.graphs.stats(),
                        launches={k: fn.launches for k, fn in kernels.items()})
        del eng
    return out


def graphs_problem(g: dict, cuda: bool, eager: bool = False) -> str | None:
    """What is wrong with a mesh owner's graph stats, or None: on the card a
    graphed owner captured graphs and replayed them, the eager yardstick
    captured nothing and says why; on the CPU nothing captures, and only
    the yardstick gives a reason."""
    if eager:
        return None if g["graphs"] == 0 and g.get("eager_reason") else f"eager {g}"
    if "eager_reason" in g or (cuda and not (g["graphs"] > 0 and g["replays"] > 0)) or (
            not cuda and g["graphs"]):
        return f"graphs {g}"
    return None


def prints_problem(a, b, n: int) -> str | None:
    """Whether two runs' logits prints agree over their first n (both must
    hold them), or what is wrong."""
    if len(a) < n or len(b) < n or n == 0:
        return f"{len(a)} and {len(b)} prints for {n} steps"
    if not np.array_equal(a[:n], b[:n]):
        k = int(np.flatnonzero((a[:n] != b[:n]).any(axis=1))[0])
        return f"the logits differ from step {k} of {n}"
    return None


def _recording(sched, calls: list):
    """sched's prefill call, recording each call's [rows, T] in `calls`."""
    inner = sched._call_prefill

    def recorded(toks, pos, pt, win):
        calls.append(tuple(toks.shape))
        return inner(toks, pos, pt, win)

    return recorded


def rank_main(rank: int, world: int, store_path: str, out_path: str, spec: dict) -> None:
    import torch

    from ..models.base import fuse_params
    from ..models.init import random_q4_params
    from ..parallel.distributed import init_mesh_group, shutdown
    from ..parallel.tp_forward import TPGroup
    from ..runtime.coordination import StepChannel
    from ..runtime.engine import Engine
    from ..runtime.scheduler import BatchScheduler

    if spec.get("threads"):
        torch.set_num_threads(spec["threads"])
    dp = spec.get("dp", 1)
    mesh = init_mesh_group(dp, world // dp, rank, device=spec["device"],
                           backend=spec["backend"], store_path=store_path,
                           timeout_s=spec["timeout_s"])
    group = mesh.group
    # the world, for rank 0's logits (the tp group is the world at dp = 1)
    world_group = group if dp == 1 else TPGroup(rank, world, None, group.backend, group.device,
                                                group.store)
    cfg = _config(spec)
    moe = bool(cfg.n_experts)
    out = {"rank": rank, "world": world, "backend": group.backend, "device": str(group.device),
           "layers": cfg.n_layers, "dp_index": mesh.dp_index, "tp_rank": group.rank}
    t0 = time.perf_counter()
    params = random_q4_params(cfg, seed=spec["seed"], device=group.device)
    if rank == 0:
        chan = StepChannel.serve(0, world - 1, host="127.0.0.1", timeout=spec["timeout_s"],
                                 on_bound=lambda p: group.store.set("tp_check_port", str(p)))
    else:
        chan = StepChannel.connect("127.0.0.1", int(group.store.get("tp_check_port")),
                                   timeout=spec["timeout_s"])
    n_slots = spec.get("n_slots", 16)
    sched = BatchScheduler(params, cfg, n_slots=n_slots, n_pages=spec["n_pages"], page_size=64,
                           max_seq_len=2048, device=group.device, mesh=mesh, step_channel=chan)
    del params
    if group.device.type == "cuda":
        torch.cuda.empty_cache()
    out["setup_s"] = time.perf_counter() - t0
    lay = sched.params["layers"][0]
    out["shapes"] = {k: tuple(v.data.shape) for k, v in lay.items() if hasattr(v, "fmt")}
    # the lm_head's rows (a tied one is the embedding's)
    out["shapes"]["lm_head"] = tuple(sched.params.get("lm_head", sched.params["embed"]).data.shape)
    out["shapes"]["pool"] = tuple(sched.kv.state.k_pool.shape)
    out["rows"] = sched._in.tokens.shape[0]
    # 0. both routes of every collective, where gloo carries CUDA tensors
    out["route_check"] = (route_check(torch, group) if group.device.type == "cuda"
                          and group.backend == "gloo" and group.size > 1 else None)
    clock = _CollectiveClock(group if group.size > 1 else None, mesh.rows)
    prints = LogitsPrints(torch, group.device)
    rng = np.random.default_rng(spec["seed"])
    engine_prompt = _ids(np.random.default_rng(spec["seed"] + 3), 100, cfg.vocab_size)
    # 1. the prefill's logits, every rank in step (no step channel)
    ids = _ids(rng, spec["prefill"], cfg.vocab_size)
    _sync(torch, group.device)
    t0 = time.perf_counter()
    logits = _logits(torch, sched, ids, spec["logit_rows"], sched._tp)
    _sync(torch, group.device)
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    lead = logits.clone()
    world_group.broadcast_(lead, src=0)
    out["logits_equal_rank0"] = bool(torch.equal(lead, logits))
    if spec.get("k6"):
        out["k6"] = k6_check(torch, sched, cfg, group.rank,
                             timed=rank == 0 and group.device.type == "cuda")
    # 2.-4.: rank 0 leads, the others replay; every rank counts its launches
    # and records its prefill calls' shapes (the rows of K6's routes)
    sched.sampled_log = []
    kernels = _kernels(moe)
    for fn in kernels.values():
        fn.launches = 0
    pf0, dec0 = sched.n_prefill_calls, sched.n_decode_steps
    calls = []
    sched._call_prefill = _recording(sched, calls)
    prints.begin()
    if rank == 0:
        _lead(torch, sched, spec, rng, out, clock, kernels)
        chan.publish({"op": "stop"})
    else:
        sched.run_follower()
    out["prints"] = prints.take()
    out["launches_all"] = {k: fn.launches for k, fn in kernels.items()}
    out["n_prefill_all"] = sched.n_prefill_calls - pf0
    out["n_decode_all"] = sched.n_decode_steps - dec0
    out["prefill_shapes"] = list(calls)
    out["sampled_log"] = [np.asarray(t) for t in sched.sampled_log]
    out["routes"] = {f"{op} {str(dt).replace('torch.', '')}": r
                     for (op, dt), r in group.routes.items()}
    out["graphs"] = sched.graphs.stats()
    out["prefill_graphs"] = sched.prefill_graphs.stats()
    out["collective_calls"], out["collective_s"] = clock.calls, clock.seconds
    if group.device.type == "cuda" and moe:
        from ..ops.moe_q4 import decode_max_r

        out["decode_max_r"] = decode_max_r()
    # 5. the eager yardstick over the same slice: the served requests again,
    # then a timed decode; every rank counts its launches from 0
    eager = BatchScheduler(sched.params, cfg, n_slots=n_slots, n_pages=spec["n_pages"],
                           page_size=64, max_seq_len=2048, device=group.device, mesh=mesh,
                           step_channel=chan, fuse=False, decode_graphs=False)
    for fn in kernels.values():
        fn.launches = 0
    pf0, dec0, calls = eager.n_prefill_calls, eager.n_decode_steps, []
    eager._call_prefill = _recording(eager, calls)
    prints.begin()
    yard = {}
    if rank == 0:
        yard = _serve_specs(torch, eager, out["served_specs"], kernels)
        yard.update(_timed_decode(torch, eager, spec, np.random.default_rng(spec["seed"] + 7),
                                  clock, profile=False))
        chan.publish({"op": "stop"})
    else:
        eager.run_follower()
    yard.update(prints=prints.take(), launches_all={k: fn.launches for k, fn in kernels.items()},
                n_prefill_all=eager.n_prefill_calls - pf0,
                n_decode_all=eager.n_decode_steps - dec0, prefill_shapes=list(calls),
                graphs=eager.graphs.stats())
    out["eager"] = yard
    del eager
    chan.close()
    # 6. Engine(mesh=), every rank in step, on graphs and eagerly
    out["engine"] = engine_check(torch, sched.params, cfg, mesh, group.device, prints,
                                 engine_prompt, kernels)
    if rank == 0:
        # 5. the same weights on one device, the single-device path
        del sched
        if group.device.type == "cuda":
            torch.cuda.empty_cache()
        full = fuse_params(random_q4_params(cfg, seed=spec["seed"], device=group.device))
        one = SimpleNamespace(params=full, fwd_cfg=cfg, device=group.device,
                              compute_dtype=torch.bfloat16)
        ref = _logits(torch, one, ids, spec["logit_rows"], None)
        eng = Engine(full, cfg, device=group.device, max_seq_len=512, fuse=False)
        out["engine_single_ids"] = eng.generate_tokens(
            list(engine_prompt), max_new_tokens=ENGINE_NEW, stop_ids=set()).token_ids
        del eng
        out["logits_rel_l2"] = float(torch.linalg.vector_norm(logits - ref)
                                     / torch.linalg.vector_norm(ref))
        out["logits_finite"] = bool(torch.isfinite(logits).all())
        out["logits_shape"] = tuple(logits.shape)
        if out["greedy_prompts"]:
            one = BatchScheduler(full, cfg, n_slots=n_slots, n_pages=spec["n_pages"],
                                 page_size=64, max_seq_len=2048, device=group.device,
                                 fuse=False)
            from ..runtime.scheduler import GenRequest

            reqs = [GenRequest(prompt_ids=list(p), max_new_tokens=spec["new_tokens"],
                               stop_ids={-1}) for p in out["greedy_prompts"]]
            _serve(one, reqs)
            out["greedy_single_ids"] = [list(r.out_ids) for r in reqs]
    if spec.get("train"):
        # the train step on this mesh, each rank against one device
        # (scripts/train_check.py), once the serving trees are freed
        from .train_check import rank_train

        sched = one = full = params = single = None  # noqa: F841
        if group.device.type == "cuda":
            torch.cuda.empty_cache()
        out["train"] = rank_train(mesh, spec["train"])
    shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def expected_launches(n_layers: int, n_prefill: int, n_decode: int, cuda: bool,
                      moe: bool = False, n_gather_fwd: int = 0) -> dict:
    """The path's kernels' launches for a rank's prefill calls and decode
    steps on the card: K2 a layer a decode step, K3 a layer a prefill call,
    K4 a layer a forward; K1 4 projections a layer a forward and the lm_head
    a decode step, or for a MoE model 2 (wqkv, wo) and K6: one grouping and
    two matmul launches a layer a forward over the rank's experts, and two
    gathers a layer in each of the `n_gather_fwd` forwards whose selections
    take K6's prefill route. The launches do not depend on the rows a rank
    runs (its dp group's n_slots/dp). The CPU runs the plain versions and
    counts nothing."""
    names = ["q4_matmul", "paged_decode", "flash_prefill", "kv_write"]
    if moe:
        names += ["moe_q4_matmul", "moe_groups", "moe_gather"]
    if not cuda:
        return dict.fromkeys(names, 0)
    fwd = n_prefill + n_decode
    out = {"q4_matmul": (2 if moe else 4) * n_layers * fwd + n_decode,
           "paged_decode": n_layers * n_decode, "flash_prefill": n_layers * n_prefill,
           "kv_write": n_layers * fwd}
    if moe:
        out.update(moe_q4_matmul=2 * n_layers * fwd, moe_groups=n_layers * fwd,
                   moe_gather=2 * n_layers * n_gather_fwd)
    return out


def gather_forwards(res: dict, cfg, dp: int, n_slots: int) -> int:
    """The forwards of a rank whose K6 selections (its rows x tokens x top-k)
    pass the decode route's limit: its prefill calls by their recorded
    shapes, and its decode steps (n_slots/dp rows of one token)."""
    thr = res.get("decode_max_r")
    if thr is None:
        return 0
    K = cfg.n_experts_per_token
    pf = sum(1 for rows, T in res["prefill_shapes"] if (rows // dp) * T * K > thr)
    return pf + (res["n_decode_all"] if (n_slots // dp) * K > thr else 0)


# the tp logits' limit, rel L2 from the single-device path: 1e-2, about 60
# times the 1.608e-4 that the card measured at Llama-3.1-8B's widths (bf16,
# 32 layers, tp = 2) and a fifth of the 5e-2 that PERF.md fixes for the
# card's logits against a plain reference
REL_L2_LIMIT = 1e-2


def _want_shapes(cfg, spec, tp: int, dp: int) -> dict:
    qdim, kvdim = cfg.n_heads * cfg.head_size, cfg.n_kv_heads * cfg.head_size
    D, H, V = cfg.embedding_length, cfg.hidden_length, cfg.vocab_size
    out = {"wqkv": ((qdim + 2 * kvdim) // tp, D // 2), "wo": (D, qdim // tp // 2),
           "lm_head": (V // tp, D // 2),
           "pool": (cfg.n_layers, cfg.n_kv_heads // tp, spec["n_pages"] // dp, 64,
                    cfg.head_size)}
    if cfg.n_experts:
        E = cfg.n_experts // tp
        out.update({"experts.w1": (E, H, D // 2), "experts.w3": (E, H, D // 2),
                    "experts.w2": (E, D, H // 2)})
    else:
        out.update({"w13": (2 * H // tp, D // 2), "w2": (D, H // tp // 2)})
    return out


def check_ranks(ranks: list[dict], spec: dict, rel_l2_limit: float = REL_L2_LIMIT) -> list[str]:
    """What must hold of the ranks' results (rank order); the failures, as
    sentences (empty when every check holds)."""
    bad = []
    cfg, world = _config(spec), len(ranks)
    dp = spec.get("dp", 1)
    tp = world // dp
    n_slots = spec.get("n_slots", 16)
    moe = bool(cfg.n_experts)
    cuda = spec["device"] != "cpu"
    lead = ranks[0]
    want_shapes = _want_shapes(cfg, spec, tp, dp)
    for r, res in enumerate(ranks):
        if (res["rank"], res["world"], res["backend"]) != (r, world, spec["backend"]):
            bad.append(f"rank {r}: rank/world/backend {res['rank']}/{res['world']}/"
                       f"{res['backend']}")
        if (res["dp_index"], res["tp_rank"]) != (r // tp, r % tp):
            bad.append(f"rank {r}: dp group {res['dp_index']}, tp rank {res['tp_rank']}")
        if res["shapes"] != want_shapes:
            bad.append(f"rank {r}: local shapes {res['shapes']} != {want_shapes}")
        if res["rows"] != n_slots // dp:
            bad.append(f"rank {r}: {res['rows']} decode rows, not n_slots/dp")
        if not res["logits_equal_rank0"]:
            bad.append(f"rank {r}: its prefill logits differ from rank 0's")
        want = expected_launches(cfg.n_layers, res["n_prefill_all"], res["n_decode_all"], cuda,
                                 moe, gather_forwards(res, cfg, dp, n_slots))
        if res["launches_all"] != want or (cuda and min(want[k] for k in want
                                                        if k != "moe_gather") == 0):
            bad.append(f"rank {r}: launches {res['launches_all']} != {want}")
        if (res["n_prefill_all"], res["n_decode_all"]) != (lead["n_prefill_all"],
                                                          lead["n_decode_all"]):
            bad.append(f"rank {r}: {res['n_prefill_all']} prefill calls and "
                       f"{res['n_decode_all']} decode steps, rank 0 "
                       f"{lead['n_prefill_all']} and {lead['n_decode_all']}")
        first = ranks[r - r % tp]  # its dp group's first rank: the same rows
        log, lead_log = res["sampled_log"], first["sampled_log"]
        if not lead_log or len(log) != len(lead_log) or any(
                not np.array_equal(a, b) for a, b in zip(log, lead_log)):
            bad.append(f"rank {r}: its sampled ids are not rank {r - r % tp}'s, step for step")
        rc = res["route_check"]
        if cuda and spec["backend"] == "gloo" and tp > 1 and (not rc or any(
                v[0] not in ("direct", "host") or v[1:] != [0.0, 0.0] for v in rc.values())):
            bad.append(f"rank {r}: the collectives' routes {rc}")
        for what, g, eager in (("decode", res["graphs"], False),
                               ("prefill", dict(res["prefill_graphs"], replays=1), False),
                               ("yardstick", res["eager"]["graphs"], True)):
            why = graphs_problem(g, cuda, eager)
            if why:
                bad.append(f"rank {r}: {what} {why}")
        # the eager yardstick: its launches as its calls imply, its logits
        # those of the graphed run's served requests, bit for bit
        y = res["eager"]
        want = expected_launches(cfg.n_layers, y["n_prefill_all"], y["n_decode_all"], cuda,
                                 moe, gather_forwards(dict(y, decode_max_r=res.get(
                                     "decode_max_r")), cfg, dp, n_slots))
        if y["launches_all"] != want:
            bad.append(f"rank {r}: the yardstick's launches {y['launches_all']} != {want}")
        why = prints_problem(res["prints"], y["prints"], lead["n_decode"])
        if why:
            bad.append(f"rank {r}: graphed against eager, {why}")
        e = res["engine"]
        for run in ("graphs", "eager"):
            want = expected_launches(cfg.n_layers, 1, ENGINE_NEW, cuda, moe,
                                     int(moe and cuda and 99 * cfg.n_experts_per_token
                                         > res.get("decode_max_r", 0)))
            if e[run]["launches"] != want:
                bad.append(f"rank {r}: Engine ({run}) launches {e[run]['launches']} != {want}")
        why = (graphs_problem(e["graphs"]["graphs"], cuda)
               or graphs_problem(e["eager"]["graphs"], cuda, eager=True)
               or prints_problem(e["graphs"]["prints"], e["eager"]["prints"], ENGINE_NEW))
        if why or e["graphs"]["ids"] != e["eager"]["ids"] or e["graphs"]["ids"] != lead[
                "engine"]["graphs"]["ids"]:
            bad.append(f"rank {r}: Engine(mesh=): {why}, ids {e['graphs']['ids']} / eager "
                       f"{e['eager']['ids']} / rank 0 {lead['engine']['graphs']['ids']}")
        k6 = res.get("k6")
        if spec.get("k6") and (not k6 or (k6["lo"], k6["n_local"]) != (
                (r % tp) * cfg.n_experts // tp, cfg.n_experts // tp) or any(
                not (k6[n]["within"] and k6[n]["foreign_zero"] and k6[n]["repeat_bit_equal"])
                for n in K6_RS)):
            bad.append(f"rank {r}: K6 over its experts {k6}")
        if spec.get("k6") and cuda and [k6[n]["route"] for n in K6_RS] != [
                "decode", "decode", "prefill"]:
            bad.append(f"rank {r}: K6's routes {[k6[n]['route'] for n in K6_RS]}")
    want = expected_launches(cfg.n_layers, lead["n_prefill"], lead["n_decode"], cuda, moe,
                             gather_forwards(dict(lead, n_decode_all=lead["n_decode"],
                                                  prefill_shapes=lead["prefill_shapes"][
                                                      :lead["n_prefill"]]), cfg, dp, n_slots))
    if lead["launches"] != want:
        bad.append(f"served requests: launches {lead['launches']} != {want}")
    y = lead["eager"]
    if (y["served"], y["launches"], y["n_prefill"], y["n_decode"]) != (
            lead["served"], lead["launches"], lead["n_prefill"], lead["n_decode"]):
        bad.append(f"served requests: the eager yardstick's ids, launches, prefill calls or "
                   f"decode steps differ from the graphs' ({y['launches']}, {y['n_prefill']}, "
                   f"{y['n_decode']} against {lead['launches']}, {lead['n_prefill']}, "
                   f"{lead['n_decode']})")
    if lead["engine"]["graphs"]["ids"] != lead["engine_single_ids"]:
        bad.append(f"Engine(mesh=): ids {lead['engine']['graphs']['ids']}, one device's "
                   f"{lead['engine_single_ids']}")
    if lead["finish"] != ["MAX_TOKENS"] * spec["requests"] or any(
            len(ids) != spec["new_tokens"] for ids in lead["served"]):
        bad.append(f"served requests: finishes {lead['finish']}")
    if not (lead["logits_finite"] and lead["logits_shape"] == (spec["logit_rows"],
                                                                cfg.vocab_size)):
        bad.append(f"tp logits: finite {lead['logits_finite']}, shape {lead['logits_shape']}")
    if not lead["logits_rel_l2"] < rel_l2_limit:
        bad.append(f"tp logits: rel L2 {lead['logits_rel_l2']:.3e} from the single-device "
                   f"path (limit {rel_l2_limit})")
    group = 1 if dp > 1 else 0
    files = [f"disk.kv.p{group * tp + t}.npz" for t in range(tp)]
    if not lead["disk_ok"] or lead["disk_files"] != files or lead["disk_ids"] != lead[
            "kept_ids"] or len(lead["disk_ids"]) != 32 or lead["disk_group"] != group \
            or lead["disk_group_after"] != group:
        bad.append(f"disk suspend: ok {lead['disk_ok']}, group {lead['disk_group']} -> "
                   f"{lead['disk_group_after']}, files {lead['disk_files']}, ids "
                   f"{lead['disk_ids'][:6]}... against {lead['kept_ids'][:6]}...")
    if spec.get("greedy") and (lead.get("greedy_ids") != lead.get("greedy_single_ids") or any(
            len(ids) != spec["new_tokens"] for ids in lead["greedy_ids"])):
        diff = [i for i, (a, b) in enumerate(zip(lead["greedy_ids"],
                                                 lead.get("greedy_single_ids") or []))
                if a != b]
        bad.append(f"greedy requests: the mesh's ids differ from one device's in requests "
                   f"{diff}")
    if spec.get("train"):
        from .train_check import check_train

        bad += check_train([r["train"] for r in ranks], spec["train"])
    return bad
