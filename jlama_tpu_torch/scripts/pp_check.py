"""The rank program of chip_smoke.py's pp phase (phase 20): the port's
pipeline-parallel serving at pp stages, one process a rank, on random JQ4
weights from a seed.

    rank_main(rank, world, store_path, out_path, spec)

`spec` names the model ("llama8b", "llama1b", cut to `spec["layers"]`, or
`hf_config`; tp_check's `_config`), pp (= world: tp = dp = 1) and the work.
Each rank joins the world through a FileStore at `store_path` (the backend
and device from `spec`: ranks sharing one GPU take gloo), draws only its
stage's layers of the seeded tree (`random_q4_params(layers=)`, every value
the whole draw's), and serves; rank 0 leads over the step channel (port 0,
handed over through the store), the others run `run_follower`. In order:

1. the logits of the last `spec["logit_rows"]` positions of a
   `spec["prefill"]`-token prompt through the stage-serial forward (no
   cache: K1 and K3), all ranks in step, broadcast from the last stage;
2. the PipelinedScheduler: `spec["requests"]` greedy requests of
   `spec["new_tokens"]` tokens, each rank's kernel launches counted from 0
   over them; a timing run (a request a slot, 16-token prompts): the wall
   time of a tick window once every row decodes, its ticks, the stage
   ring's exchanges and their host time; torch.profiler over
   `spec["profile"]` windows on rank 0 (device time by kernel group); a
   session suspended to disk (one file per rank) and resumed, its ids
   against a session that never suspended;
3. the stage-serial BatchScheduler (`serve --no-pp-pipeline`): the same
   requests, launches counted, a timed decode; both schedulers run on
   graphs (the default: on the card a stage's step or tick window is a
   chain of segments cut at its hand-overs), and then each again as its
   eager yardstick (`decode_graphs=False`: the requests, and the ring's
   timed windows), whose ids, launches and logits' prints on the last
   stage (`tp_check.LogitsPrints`) must be the graphed run's;
4. `Engine(mesh=)` on both stages in step, `tp_check.ENGINE_NEW` greedy
   tokens on graphs and eagerly (`tp_check.engine_check`);
5. on rank 0, after the followers stop: the whole tree on one device
   through the single-device path, the same prompt's logits (expected bit
   for bit: the same kernels at the same shapes, and the ring only copies
   bytes), the requests through a single-device BatchScheduler, whose ids
   every scheduler's must equal, and the Engine's tokens.

Each rank pickles its results to `out_path`; `check_ranks` holds them
(chip_smoke.py phase 20; tests/test_torch_pp_check.py on the CPU).
"""

from __future__ import annotations

import pickle
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from .tp_check import (ENGINE_NEW, KERNEL_GROUPS, TIMED_NEW, TIMED_PROMPT, WARM_STEPS,
                       LogitsPrints, _config, _ids, _kernels, _logits, _serve, _sync,
                       engine_check, graphs_problem, prints_problem)

REL_L2_LIMIT = 1e-2  # tp_check's, the fall-back where the logits are not bit-equal
NAMES = ("pipe", "serial")
# the runs: each scheduler on graphs (the default), then its eager yardstick
RUNS = (("pipe", True), ("serial", True), ("pipe_eager", False), ("serial_eager", False))


def _reset(kernels) -> None:
    for fn in kernels.values():
        fn.launches = 0


def _timed(torch, sched, ring, spec, rng, out, name, profile=True):
    """Every slot decoding (`tp_check.TIMED_PROMPT`-token prompts, then
    `tp_check.WARM_STEPS` scheduler steps): the wall time of `spec["timed"]`
    scheduler steps (tick windows for the ring, decode windows for the
    stage-serial scheduler), their ticks, the ring's exchanges and the
    steps that were a key's first use; on the card torch.profiler over
    `spec["profile"]` steps (device time by group)."""
    from ..runtime.scheduler import GenRequest, RequestState

    cfg = sched.cfg
    reqs = [GenRequest(prompt_ids=_ids(rng, TIMED_PROMPT, cfg.vocab_size),
                       max_new_tokens=TIMED_NEW, stop_ids={-1}) for _ in range(sched.n_slots)]
    for r in reqs:
        sched.submit(r)
    while not all(r.state == RequestState.RUNNING and r.out_ids for r in reqs):
        sched.step()
    for _ in range(WARM_STEPS):
        sched.step()

    def run(n):
        _sync(torch, sched.device)
        t0, tok0 = time.perf_counter(), sum(len(r.out_ids) for r in reqs)
        c0, s0, k0 = ring.calls, ring.seconds, getattr(sched, "n_ticks", 0)
        d0, e0 = sched.n_decode_steps, sched.graphs.stats()["eager_steps"]
        for _ in range(n):
            sched.step()
        _sync(torch, sched.device)
        return dict(wall_ms=(time.perf_counter() - t0) * 1e3, steps=n,
                    tokens=sum(len(r.out_ids) for r in reqs) - tok0,
                    decode_steps=sched.n_decode_steps - d0,
                    ticks=getattr(sched, "n_ticks", 0) - k0, p2p_calls=ring.calls - c0,
                    p2p_ms=(ring.seconds - s0) * 1e3,
                    first_uses=sched.graphs.stats()["eager_steps"] - e0)

    t = out[name + "_timed"] = run(spec["timed"])
    t["ms_per_step"] = t["wall_ms"] / t["steps"]
    if t["ticks"]:
        t["ms_per_tick"] = t["wall_ms"] / t["ticks"]
        t["p2p_calls_per_tick"] = t["p2p_calls"] / t["ticks"]
        t["p2p_ms_per_tick"] = t["p2p_ms"] / t["ticks"]
    if profile and spec["profile"] and sched.device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            p = run(spec["profile"])
        groups = {g: 0.0 for g, _ in KERNEL_GROUPS} | {"other": 0.0}
        for e in prof.key_averages():
            if str(e.device_type).endswith("CUDA"):
                g = next((g for g, names in KERNEL_GROUPS if any(s in e.key for s in names)),
                         "other")
                groups[g] += e.self_device_time_total / 1e3
        p["device_ms_by_group"] = groups
        out[name + "_profile"] = p
    _serve(sched, reqs)


def _disk_check(sched, rng, out, n_first):
    """A session suspended to disk (each rank its stage's pages, one file a
    rank) and resumed, against one that never suspended."""
    from ..runtime.scheduler import GenRequest

    cfg = sched.cfg
    first, second = _ids(rng, n_first, cfg.vocab_size), _ids(rng, 40, cfg.vocab_size)
    _serve(sched, [GenRequest(prompt_ids=list(first), max_new_tokens=16, session_id=sid,
                              stop_ids={-1}) for sid in ("disk", "kept")])
    with tempfile.TemporaryDirectory() as d:
        ok = sched.suspend_session("disk", to_dir=d) and sched.resume_session("disk")
        out["disk_ids"] = sched.generate(second, max_new_tokens=32, session_id="disk",
                                         stop_ids={-1}).token_ids
        out["disk_files"] = sorted(p.name for p in Path(d).iterdir())
    out["disk_ok"] = ok
    out["kept_ids"] = sched.generate(second, max_new_tokens=32, session_id="kept",
                                     stop_ids={-1}).token_ids


def rank_main(rank: int, world: int, store_path: str, out_path: str, spec: dict) -> None:
    import torch

    from ..models.base import fuse_params, lm_logits
    from ..models.init import random_q4_params
    from ..parallel.distributed import init_mesh_group, shutdown
    from ..parallel.mesh import RankSlice
    from ..parallel.pipeline import stage_hidden, stage_range
    from ..runtime.coordination import StepChannel
    from ..runtime.engine import Engine
    from ..runtime.pipelined import PipelinedScheduler
    from ..runtime.scheduler import BatchScheduler, GenRequest

    if spec.get("threads"):
        torch.set_num_threads(spec["threads"])
    mesh = init_mesh_group(1, 1, rank, pp=world, device=spec["device"],
                           backend=spec["backend"], store_path=store_path,
                           timeout_s=spec["timeout_s"])
    ring, dev = mesh.ring, mesh.group.device
    cfg = _config(spec)
    lo, hi = stage_range(cfg.n_layers, world, mesh.stage)
    out = {"rank": rank, "world": world, "stage": mesh.stage, "backend": mesh.group.backend,
           "route": ring.route, "layers": (lo, hi)}
    t0 = time.perf_counter()
    params = RankSlice(fuse_params(random_q4_params(cfg, spec["seed"], dev, layers=(lo, hi))),
                       1, 0, (False, False), world, mesh.stage)
    if rank == 0:
        chan = StepChannel.serve(0, world - 1, host="127.0.0.1", timeout=spec["timeout_s"],
                                 on_bound=lambda p: mesh.group.store.set("pp_port", str(p)))
    else:
        chan = StepChannel.connect("127.0.0.1", int(mesh.group.store.get("pp_port")),
                                   timeout=spec["timeout_s"])
    _sync(torch, dev)
    out["setup_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(spec["seed"])
    engine_prompt = _ids(np.random.default_rng(spec["seed"] + 3), 100, cfg.vocab_size)
    # 1. the prefill's logits through the stage-serial forward, every rank in step
    ids = _ids(rng, spec["prefill"], cfg.vocab_size)
    rows = spec["logit_rows"]
    _sync(torch, dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        toks = torch.tensor([ids], dtype=torch.long, device=dev)
        pos = torch.arange(len(ids), device=dev)[None]
        h = stage_hidden(ring, params, cfg, toks, pos, None, torch.bfloat16, first_layer=lo)
        logits = (lm_logits(params, cfg, h[:, -rows:])[0] if ring.last else
                  torch.zeros((rows, cfg.vocab_size), dtype=torch.float32, device=dev))
        ring.broadcast_last(logits)
    _sync(torch, dev)
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    prompts = [_ids(rng, int(rng.integers(32, spec["prefill"] + 1)), cfg.vocab_size)
               for _ in range(spec["requests"])]
    kernels = _kernels()
    max_seq = spec.get("max_seq_len", 2048)
    prints = LogitsPrints(torch, dev)
    # 2. and 3.: rank 0 leads each scheduler, the others replay; every rank
    # counts its launches from 0 over the requests; each on graphs (the
    # default), then again as the eager yardstick (the requests, and the
    # ring's timed windows)
    for name, graphs in RUNS:
        cls = PipelinedScheduler if name.startswith("pipe") else BatchScheduler
        sched = cls(params, cfg, n_slots=spec["n_slots"], n_pages=spec["n_pages"],
                    page_size=64, max_seq_len=max_seq, device=dev, mesh=mesh,
                    step_channel=chan, decode_graphs=graphs)
        sched.sampled_log = []
        if name.startswith("pipe"):
            sched.window_log = []
        pf0, dec0, cells0 = sched.n_prefill_calls, sched.n_decode_steps, 0
        _reset(kernels)
        prints.begin()
        if rank == 0:
            reqs = [GenRequest(prompt_ids=list(p), max_new_tokens=spec["new_tokens"],
                               stop_ids={-1}) for p in prompts]
            t0 = time.perf_counter()
            _serve(sched, reqs)
            out[name + "_serve_s"] = time.perf_counter() - t0
            out[name + "_ids"] = [list(r.out_ids) for r in reqs]
            out[name + "_launches"] = {k: fn.launches for k, fn in kernels.items()}
            out[name + "_counts"] = (sched.n_prefill_calls - pf0,
                                     getattr(sched, "n_cells", 0) - cells0,
                                     sched.n_decode_steps - dec0)
            if graphs or name == "pipe_eager":
                _timed(torch, sched, ring, spec, rng, out, name, profile=graphs)
            if name == "pipe":
                _disk_check(sched, rng, out, spec.get("disk_prompt", 300))
            chan.publish({"op": "stop"})
        else:
            sched.run_follower()
        out[name + "_prints"] = prints.take()
        out[name + "_launches_all"] = {k: fn.launches for k, fn in kernels.items()}
        out[name + "_counts_all"] = (sched.n_prefill_calls - pf0,
                                     getattr(sched, "n_cells", 0) - cells0,
                                     sched.n_decode_steps - dec0)
        out[name + "_graphs"] = sched.graphs.stats()
        out[name + "_pool"] = tuple(sched.kv.state.k_pool.shape)
        out[name + "_log"] = [np.asarray(t) for t in (sched.window_log if name.startswith("pipe")
                                                      else sched.sampled_log)]
        del sched
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    # 4. Engine(mesh=), both stages in step, on graphs and eagerly
    out["engine"] = engine_check(torch, params, cfg, mesh, dev, prints, engine_prompt, kernels)
    out["p2p_calls"], out["p2p_s"] = ring.calls, ring.seconds
    chan.close()
    if rank == 0:
        # 4. the whole tree on one device, the single-device path
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        full = fuse_params(random_q4_params(cfg, seed=spec["seed"], device=dev))
        one = SimpleNamespace(params=full, fwd_cfg=cfg, device=dev,
                              compute_dtype=torch.bfloat16)
        ref = _logits(torch, one, ids, rows, None)
        out["logits_bit_equal"] = bool(torch.equal(ref, logits))
        out["logits_rel_l2"] = float(torch.linalg.vector_norm(logits - ref)
                                     / torch.linalg.vector_norm(ref))
        out["logits_finite"] = bool(torch.isfinite(logits).all())
        out["logits_shape"] = tuple(logits.shape)
        single = BatchScheduler(full, cfg, n_slots=spec["n_slots"], n_pages=spec["n_pages"],
                                page_size=64, max_seq_len=max_seq, device=dev, fuse=False)
        reqs = [GenRequest(prompt_ids=list(p), max_new_tokens=spec["new_tokens"],
                           stop_ids={-1}) for p in prompts]
        _serve(single, reqs)
        out["single_ids"] = [list(r.out_ids) for r in reqs]
        del single
        eng = Engine(full, cfg, device=dev, max_seq_len=512, fuse=False)
        out["engine_single_ids"] = eng.generate_tokens(
            list(engine_prompt), max_new_tokens=ENGINE_NEW, stop_ids=set()).token_ids
        del eng
    if spec.get("train"):
        # the train step on this mesh, each rank against one device
        # (scripts/train_check.py), once the serving trees are freed
        from .train_check import rank_train

        sched = one = full = params = single = None  # noqa: F841
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["train"] = rank_train(mesh, spec["train"])
    shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def expected_launches(n_layers: int, pp: int, stage: int, n_prefill: int, n_fwd: int,
                      cuda: bool) -> dict:
    """A stage's K1-K4 launches for its prefill calls and its decode forwards
    (the ring's cells, or the stage-serial scheduler's steps) on the card:
    K1 4 projections a layer a forward and, on the last stage only, the
    lm_head a decode forward; K2 a layer a decode forward; K3 a layer a
    prefill call; K4 a layer a forward. The CPU counts nothing."""
    names = ("q4_matmul", "paged_decode", "flash_prefill", "kv_write")
    if not cuda:
        return dict.fromkeys(names, 0)
    ls = n_layers // pp
    return {"q4_matmul": 4 * ls * (n_prefill + n_fwd) + (n_fwd if stage == pp - 1 else 0),
            "paged_decode": ls * n_fwd, "flash_prefill": ls * n_prefill,
            "kv_write": ls * (n_prefill + n_fwd)}


def check_ranks(ranks: list[dict], spec: dict, rel_l2_limit: float = REL_L2_LIMIT) -> list[str]:
    """What must hold of the ranks' results (rank order); the failures, as
    sentences (empty when every check holds)."""
    bad = []
    cfg, pp = _config(spec), len(ranks)
    cuda = spec["device"] != "cpu"
    lead = ranks[0]
    for r, res in enumerate(ranks):
        if (res["rank"], res["stage"], res["backend"]) != (r, r, spec["backend"]):
            bad.append(f"rank {r}: rank/stage/backend {res['rank']}/{res['stage']}/"
                       f"{res['backend']}")
        want_route = "host" if cuda and spec["backend"] == "gloo" else "direct"
        if res["route"] != want_route:
            bad.append(f"rank {r}: point-to-point route {res['route']}, not {want_route}")
        ls = cfg.n_layers // pp
        if res["layers"] != (r * ls, (r + 1) * ls):
            bad.append(f"rank {r}: layers {res['layers']}")
        for name, graphs in RUNS:
            n_pf, n_cells, n_dec = res[name + "_counts_all"]
            fwd = n_cells if name.startswith("pipe") else n_dec
            want = expected_launches(cfg.n_layers, pp, r, n_pf, fwd, cuda)
            got = res[name + "_launches_all"]
            if got != want or (cuda and min(want.values()) == 0):
                bad.append(f"rank {r}: {name} launches {got} != {want}")
            if res[name + "_counts_all"][0] != lead[name + "_counts_all"][0] or \
                    res[name + "_counts_all"][2] != lead[name + "_counts_all"][2]:
                bad.append(f"rank {r}: {name} prefill calls and decode steps "
                           f"{res[name + '_counts_all']}, rank 0 {lead[name + '_counts_all']}")
            why = graphs_problem(res[name + "_graphs"], cuda, eager=not graphs)
            if why:
                bad.append(f"rank {r}: {name} {why}")
            if res[name + "_pool"][0] != ls:
                bad.append(f"rank {r}: {name} pool {res[name + '_pool']} holds not its "
                           f"{ls} layers")
        # the logits (the last stage's): each run's served requests on graphs
        # against its eager yardstick, bit for bit
        for name, k in (("pipe", 1), ("serial", 2)):
            a, b = res[name + "_prints"], res[name + "_eager_prints"]
            why = (prints_problem(a, b, lead[name + "_counts"][k]) if r == pp - 1
                   else None if len(a) == len(b) == 0 else f"{len(a)}, {len(b)} prints")
            if why:
                bad.append(f"rank {r}: {name} graphed against eager, {why}")
        e = res["engine"]
        for run in ("graphs", "eager"):
            want = expected_launches(cfg.n_layers, pp, r, 1, ENGINE_NEW, cuda)
            if e[run]["launches"] != want:
                bad.append(f"rank {r}: Engine ({run}) launches {e[run]['launches']} != {want}")
        n_prints = ENGINE_NEW if r == pp - 1 else 0
        why = (graphs_problem(e["graphs"]["graphs"], cuda)
               or graphs_problem(e["eager"]["graphs"], cuda, eager=True)
               or (prints_problem(e["graphs"]["prints"], e["eager"]["prints"], n_prints)
                   if n_prints else None))
        if why or e["graphs"]["ids"] != e["eager"]["ids"] or e["graphs"]["ids"] != lead[
                "engine"]["graphs"]["ids"]:
            bad.append(f"rank {r}: Engine(mesh=): {why}, ids {e['graphs']['ids']} / eager "
                       f"{e['eager']['ids']} / rank 0 {lead['engine']['graphs']['ids']}")
        if r == pp - 1:
            # what the last stage sampled is what stage 0 got, in order
            for name, _ in RUNS:
                a, b = (np.concatenate([np.ravel(x) for x in log]) if log else np.zeros(0)
                        for log in (res[name + "_log"], lead[name + "_log"]))
                if not len(a) or not np.array_equal(a, b):
                    bad.append(f"{name}: the last stage's sampled ids are not stage 0's")
    for name, _ in RUNS:
        if lead[name + "_ids"] != lead["single_ids"] or any(
                len(ids) != spec["new_tokens"] for ids in lead[name + "_ids"]):
            diff = [i for i, (a, b) in enumerate(zip(lead[name + "_ids"], lead["single_ids"]))
                    if a != b]
            bad.append(f"{name}: the ids differ from one device's in requests {diff}")
    for name in NAMES:
        if (lead[name + "_launches"], lead[name + "_counts"]) != (
                lead[name + "_eager_launches"], lead[name + "_eager_counts"]):
            bad.append(f"{name}: the eager yardstick's launches or counts differ from the "
                       f"graphs' ({lead[name + '_eager_launches']}, "
                       f"{lead[name + '_eager_counts']} against {lead[name + '_launches']}, "
                       f"{lead[name + '_counts']})")
    if lead["engine"]["graphs"]["ids"] != lead["engine_single_ids"]:
        bad.append(f"Engine(mesh=): ids {lead['engine']['graphs']['ids']}, one device's "
                   f"{lead['engine_single_ids']}")
    if not (lead["logits_finite"] and lead["logits_shape"] == (spec["logit_rows"],
                                                                cfg.vocab_size)):
        bad.append(f"pp logits: finite {lead['logits_finite']}, shape {lead['logits_shape']}")
    if not lead["logits_bit_equal"] and not lead["logits_rel_l2"] < rel_l2_limit:
        bad.append(f"pp logits: rel L2 {lead['logits_rel_l2']:.3e} from the single-device "
                   f"path (limit {rel_l2_limit})")
    files = [f"disk.kv.p{r}.npz" for r in range(pp)]
    if not lead["disk_ok"] or lead["disk_files"] != files or \
            lead["disk_ids"] != lead["kept_ids"] or len(lead["disk_ids"]) != 32:
        bad.append(f"disk suspend: ok {lead['disk_ok']}, files {lead['disk_files']}, ids "
                   f"{lead['disk_ids'][:6]}... against {lead['kept_ids'][:6]}...")
    if spec.get("train"):
        from .train_check import check_train

        bad += check_train([r["train"] for r in ranks], spec["train"])
    return bad
