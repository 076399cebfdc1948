"""The rank processes of the pp tests (tests/test_torch_pipeline.py,
tests/test_torch_pipelined_sched.py): each joins a gloo world on the CPU
through a FileStore, once per mesh (the process group is torn down and
joined again with a fresh store between meshes), and runs the port's
pipeline on the tiny llama. Imports torch and the port only (the processes
start with `spawn`). The ranks start and are reaped through
tests/torch_tp_ranks.py's helpers, under its deadline."""

import pickle
from pathlib import Path

import numpy as np

WORLD = 4

# tests/test_pipeline.py's cases: (pp, M) of the GPipe forward, (pp, tp) of
# the dense decode; each runs on a mesh of the four ranks ((1, 4, 1),
# (2, 2, 1): each dp group a ring of its own, (1, 2, 2))
FORWARD_CASES = ((2, 2), (2, 4), (4, 2))
DECODE_CASES = ((2, 1), (2, 2), (4, 1))
PIPE_MESHES = {(1, 4, 1): {"forward": (4, 2), "decode": (4, 1)},
               (2, 2, 1): {"forward": (2, 2, 2, 4), "decode": (2, 1)},
               (1, 2, 2): {"decode": (2, 2)}}
DECODE_S, DECODE_STEPS = 32, 8
DECODE_PROMPTS = [[1, 7, 23], [2, 11, 5, 9]]


def forward_inputs(n_micro):
    """tests/test_pipeline.py::test_pipelined_forward_matches's tokens."""
    B, T = n_micro * 2, 6
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (B, T)), np.broadcast_to(np.arange(T), (B, T))


def decode_prompts(pp):
    rng = np.random.default_rng(1)
    prompts = [list(p) for p in DECODE_PROMPTS]
    while len(prompts) < pp:
        prompts.append([int(x) for x in rng.integers(1, 200, 3)])
    return prompts[:pp]


def _join(rank, dims, store_path):
    from jlama_tpu_torch.parallel.distributed import init_mesh_group

    dp, pp, tp = dims
    return init_mesh_group(dp, tp, rank, pp=pp, device="cpu", store_path=store_path,
                           timeout_s=60)


def _stage_tree(params, cfg, mesh):
    """The rank's tree: its stage's layers of the whole tree, fused, cut to
    its tp slice (`rank_params`)."""
    from jlama_tpu_torch.parallel.mesh import rank_params

    return rank_params(params, cfg, mesh, "cpu")


def dense_decode(params, cfg, mesh, pp):
    """tests/test_pipeline.py::test_pipelined_decode_matches_single_device's
    driver on `PipelinedDecode`: b = 1 a microbatch, the prompts fed first,
    then greedy continuations; every rank drives the same ticks (the logits
    reach every stage)."""
    import torch

    from jlama_tpu_torch.parallel.pipeline import PipelinedDecode

    tree, tp, lcfg = _stage_tree(params, cfg, mesh)
    M = pp
    dec = PipelinedDecode(tree, lcfg, mesh.ring, 1, DECODE_S, torch.float32, "cpu", tp)
    feeds = decode_prompts(pp)
    outs = [[] for _ in range(M)]
    fed = [1] * M
    tokens = np.zeros((M, 1), np.int64)
    positions = np.zeros((M, 1), np.int64)
    for mb in range(M):
        tokens[mb, 0] = feeds[mb][0]
    total = M * (max(len(p) for p in feeds) + DECODE_STEPS + pp)
    for t in range(total):
        logits = dec.tick(torch.from_numpy(tokens), torch.from_numpy(positions), t)
        mb = (t - pp + 1) % M
        if logits is not None:
            nxt = int(torch.argmax(logits[0]))
            if fed[mb] >= len(feeds[mb]) and len(outs[mb]) < DECODE_STEPS:
                outs[mb].append(nxt)
                feeds[mb].append(nxt)
            if fed[mb] < len(feeds[mb]):
                tokens[mb, 0] = feeds[mb][fed[mb]]
                positions[mb, 0] = fed[mb]
                fed[mb] += 1
        if all(len(o) >= DECODE_STEPS for o in outs):
            break
    return [o[:DECODE_STEPS] for o in outs], mesh.ring.calls


def pipeline_rank_main(rank, store_base, model_dir, out_dir):
    """test_torch_pipeline.py's rank: for each mesh of PIPE_MESHES, the GPipe
    forward's hidden states (each (pp, M) case) and the dense decode's
    greedy ids, on every rank."""
    import torch

    from jlama_tpu_torch.models.loader import load_params
    from jlama_tpu_torch.parallel.distributed import shutdown
    from jlama_tpu_torch.parallel.pipeline import pipelined_forward

    torch.set_num_threads(1)
    params, cfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    results = {}
    for i, (dims, work) in enumerate(PIPE_MESHES.items()):
        mesh = _join(rank, dims, f"{store_base}.{i}")
        pp = dims[1]
        res = results[dims] = {"stage": mesh.stage, "dp_index": mesh.dp_index,
                               "tp_rank": mesh.group.rank, "route": mesh.ring.route}
        fwd = work.get("forward", ())
        for j in range(0, len(fwd), 2):
            n_micro = fwd[j + 1]
            tree, _, _ = _stage_tree(params, cfg, mesh)
            toks, pos = forward_inputs(n_micro)
            with torch.inference_mode():
                h = pipelined_forward(tree, cfg, torch.from_numpy(toks),
                                      torch.from_numpy(np.ascontiguousarray(pos)), n_micro,
                                      mesh.ring, torch.float32)
            res["forward", n_micro] = h.numpy()
        if "decode" in work:
            res["decode"], res["calls"] = dense_decode(params, cfg, mesh, pp)
        shutdown()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)


# ---------------------------------------------------------------------------
# the schedulers (tests/test_torch_pipelined_sched.py)
# ---------------------------------------------------------------------------

SCHED = dict(n_slots=4, n_pages=64, page_size=8, max_seq_len=64)  # _pipe_sched's
GREEDY = [[1, 5, 9, 42, 7], [1, 7, 3], [2, 8, 1, 4], [1, 9]]
CONCURRENT = [[1, 5, 9, 42, 7], [1, 7, 3], [2, 8, 1, 4], [1, 9, 2, 2, 6, 4]]
SAMPLED = dict(prompt=[1, 5, 9, 42, 7], max_new_tokens=6, temperature=0.8, seed=11)
SAMPLED_BATCH = dict(max_new_tokens=8, temperature=0.9, top_k=20, top_p=0.9, seed=5)
EMBED = [[1, 5, 9, 42, 7], [1, 7, 3], [2, 8, 1, 4, 6, 9, 12]]
# tests/test_multiprocess.py::test_two_process_pp_pipeline's requests and
# scheduler (two slots, a lag of 2)
MP_SCHED = dict(n_slots=2, n_pages=16, page_size=8, max_seq_len=64, decode_lag=2)
MP_REQS = (([1, 5, 9, 42], 6, None), ([1, 7, 3], 5, "sess"), ([2, 17], 4, "sess"))
SCHED_MESHES = ((1, 2, 2), (2, 2, 1), (1, 2, 1))


def run_requests(sched, prompts, **kw):
    from jlama_tpu_torch.runtime.scheduler import GenRequest, RequestState

    reqs = [sched.submit(GenRequest(prompt_ids=list(p), **kw)) for p in prompts]
    for _ in range(400):
        if all(r.state == RequestState.DONE for r in reqs):
            return [list(r.out_ids) for r in reqs]
        sched.step()
    raise AssertionError("requests did not finish")


def sessions(sched, off_dir=None):
    """test_pipelined_sessions_resume and _session_suspend_resume: a session
    of two requests; with `off_dir`, a second session suspended to RAM and a
    third to disk (one file per rank) between their requests."""
    out = {"s1": sched.generate([1, 5, 9], max_new_tokens=4, session_id="sess").token_ids,
           "s2": sched.generate([42, 7], max_new_tokens=4, session_id="sess").token_ids}
    if off_dir is None:
        return out
    for sid, where in (("ram", None), ("disk", off_dir)):
        out[sid + "1"] = sched.generate([1, 5, 9], max_new_tokens=4, session_id=sid).token_ids
        assert sched.suspend_session(sid, to_dir=where), sid
        assert sid in sched._suspended
        out[sid + "2"] = sched.generate([42, 7], max_new_tokens=4, session_id=sid).token_ids
    return out


def _lead_pipe(sched, off_dir):
    from jlama_tpu_torch.runtime.scheduler import GenRequest

    out = {"greedy": [sched.generate(p, max_new_tokens=6).token_ids for p in GREEDY],
           "concurrent": run_requests(sched, CONCURRENT, max_new_tokens=6)}
    s = SAMPLED
    out["sampled"] = sched.generate(s["prompt"], max_new_tokens=s["max_new_tokens"],
                                    temperature=s["temperature"], seed=s["seed"]).token_ids
    out["sampled_batch"] = run_requests(sched, CONCURRENT, **SAMPLED_BATCH)
    out.update(sessions(sched, off_dir))
    r = sched.submit(GenRequest(prompt_ids=[1, 5], presence_penalty=0.5))
    out["penalty"] = (r.finish.value, r.error)
    return out


def sched_rank_main(rank, store_base, model_dir, out_dir):
    """test_torch_pipelined_sched.py's rank: on (1, 2, 2) the
    PipelinedScheduler's scenarios (greedy, concurrent, sampled, sessions,
    RAM and disk suspend, penalties refused), its q8 pool, the stage-serial
    BatchScheduler (`--no-pp-pipeline`) and the Engine on the mesh
    (embeddings, greedy ids); on (2, 2, 1) the PipelinedScheduler over two
    dp rings; on (1, 2, 1), ranks 0 and 1 alone,
    test_two_process_pp_pipeline's requests. Rank 0 leads over the step
    channel, the others replay."""
    import torch

    from jlama_tpu_torch.models.loader import load_params
    from jlama_tpu_torch.parallel.distributed import shutdown
    from jlama_tpu_torch.runtime.coordination import StepChannel
    from jlama_tpu_torch.runtime.engine import Engine
    from jlama_tpu_torch.runtime.pipelined import PipelinedScheduler
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler

    torch.set_num_threads(1)
    params, cfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    results = {}
    for i, dims in enumerate(SCHED_MESHES):
        world = dims[0] * dims[1] * dims[2]
        if rank >= world:
            continue
        mesh = _join(rank, dims, f"{store_base}.{i}")
        store = mesh.group.store
        if rank == 0:
            chan = StepChannel.serve(0, world - 1, host="127.0.0.1", timeout=60,
                                     on_bound=lambda p: store.set("step_port", str(p)))
        else:
            chan = StepChannel.connect("127.0.0.1", int(store.get("step_port")), timeout=60)
        res = results[dims] = {"stage": mesh.stage, "dp_index": mesh.dp_index,
                               "tp_rank": mesh.group.rank}
        kw = dict(compute_dtype=torch.float32, device="cpu", mesh=mesh, step_channel=chan)
        if dims == (1, 2, 1):
            scenarios = [("mp", PipelinedScheduler, dict(MP_SCHED, kv_dtype=torch.float32))]
        elif dims == (2, 2, 1):
            scenarios = [("dp", PipelinedScheduler, dict(SCHED, kv_dtype=torch.float32))]
        else:
            scenarios = [("pipe", PipelinedScheduler, dict(SCHED, kv_dtype=torch.float32)),
                         ("q8", PipelinedScheduler, dict(SCHED, kv_dtype="q8")),
                         ("serial", BatchScheduler, dict(SCHED, kv_dtype=torch.float32))]
        for name, cls, skw in scenarios:
            sched = cls(params, cfg, **skw, **kw)
            sched.sampled_log = []
            if name == "serial":
                sched.embed_engine = Engine(sched.params, cfg, device="cpu", max_seq_len=64,
                                            compute_dtype=torch.float32,
                                            kv_dtype=torch.float32, fuse=False, mesh=mesh,
                                            step_channel=chan, step_lock=sched._lock)
            if rank == 0:
                res[name] = lead(sched, name, str(Path(out_dir) / f"off_{name}"))
                chan.publish({"op": "stop"})
            else:
                sched.run_follower()
            res[name + "/pool"] = tuple(sched.kv.state.k_pool.shape if name != "q8"
                                        else sched.kv.state.k_pool.data.shape)
            res[name + "/layers"] = len(sched.params["layers"])
            res[name + "/graphs"] = sched.graphs.stats()
            res[name + "/log"] = [np.asarray(t) for t in sched.sampled_log]
            res[name + "/calls"] = mesh.ring.calls
            if name == "serial":
                # the Engine's generate is SPMD: every rank runs it
                eng = sched.embed_engine
                res["engine_ids"] = eng.generate_tokens(GREEDY[0], max_new_tokens=6).token_ids
                res["engine_graphs"] = eng.graphs.stats()
        chan.close()
        shutdown()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)


def lead(sched, name, off_dir):
    """Rank 0's requests of a scenario; their ids by label."""
    if name == "pipe":
        return _lead_pipe(sched, off_dir)
    if name == "q8":
        return {"greedy": sched.generate(SAMPLED["prompt"], max_new_tokens=6).token_ids}
    if name == "dp":
        return {"concurrent": run_requests(sched, CONCURRENT, max_new_tokens=6),
                "sessions": sessions(sched)}
    if name == "mp":  # warmed up first (tick windows and prefill shapes), as serve --prewarm
        sched.warmup(max_context=32)
        out = []
        for p, n, sid in MP_REQS:
            out.append(sched.generate(p, max_new_tokens=n, session_id=sid).token_ids)
        return {"ids": out}
    out = {"greedy": [sched.generate(p, max_new_tokens=6).token_ids for p in GREEDY],
           "concurrent": run_requests(sched, CONCURRENT, max_new_tokens=6),
           "sessions": sessions(sched, off_dir)}
    eng = sched.embed_engine
    out["embed"] = eng.embed_batch(EMBED, pooling="AVG")
    return out
