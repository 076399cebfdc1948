"""The rank processes of tests/test_torch_tp_serving.py: each joins a gloo
group on the CPU through a FileStore, loads the tiny checkpoint, and serves
the scenarios with the port's tp BatchScheduler, rank 0 as the leader and
the others replaying its steps. Imports torch and the port only (the
processes start with `spawn`, from a fresh import of this module).
`start_ranks` and `wait_ranks` start and reap them for every multi-process
test here, under its deadline."""

import pickle
from pathlib import Path

import numpy as np

PROMPT = [1, 5, 9, 42, 7]
CONCURRENT = [[1, 5, 9], [1, 7, 30, 12], [1, 2], [1, 44, 17, 80, 3]]
SCHED = dict(n_slots=4, n_pages=64, page_size=8, max_seq_len=64)
# name -> (weights, kv pool); q4 also runs the sessions, float the sampled requests
SCENARIOS = {"q4": ("q4", "f32"), "float": ("float", "f32"), "q8pool": ("float", "q8")}
Q4_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")
WORLD = 2
DEADLINE = 90  # seconds for all rank processes, start to exit


def start_ranks(target, args_of, world=WORLD):
    """One `spawn` process per rank, started; returns them and their deadline."""
    from jlama_tpu_torch.scripts.tp_check import start_ranks as start

    return start(target, args_of, world, DEADLINE)


def wait_ranks(procs, end):
    """Wait for every rank until `end`; kill them all and fail if one is
    still running then or one failed."""
    from jlama_tpu_torch.scripts.tp_check import wait_ranks as wait

    err = wait(procs, end)
    assert err is None, f"{err} ({DEADLINE} s)"


def quantize_layers(params):
    """The 7 projections of every layer to q4 (the embedding and lm_head
    stay float), as tests/test_shard_map_tp.py quantizes the JAX tree."""
    from jlama_tpu_torch.nn.qarray import quantize_q4

    out = dict(params)
    out["layers"] = [{k: quantize_q4(v.numpy()) if k in Q4_KEYS else v for k, v in d.items()}
                     for d in params["layers"]]
    return out


def run_requests(sched, prompts, **kw):
    from jlama_tpu_torch.runtime.scheduler import GenRequest, RequestState

    reqs = [sched.submit(GenRequest(prompt_ids=list(p), **kw)) for p in prompts]
    for _ in range(400):
        if all(r.state == RequestState.DONE for r in reqs):
            return [list(r.out_ids) for r in reqs]
        sched.step()
    raise AssertionError("requests did not finish")


def greedy(sched):
    return {"single": sched.generate(PROMPT, max_new_tokens=8).token_ids,
            "concurrent": run_requests(sched, CONCURRENT, max_new_tokens=6)}


def sessions(sched, off_dir=None):
    """Two sessions of two requests; with `off_dir`, the first suspended to
    RAM and the second to disk between their requests."""
    out = {"r3": sched.generate([1, 11, 13], max_new_tokens=4, session_id="sess").token_ids}
    if off_dir:
        assert sched.suspend_session("sess"), "RAM suspend"
    out["r4"] = sched.generate([2, 17], max_new_tokens=4, session_id="sess").token_ids
    out["r5"] = sched.generate([1, 19], max_new_tokens=3, session_id="disk").token_ids
    if off_dir:
        assert sched.suspend_session("disk", to_dir=off_dir), "disk suspend"
    out["r6"] = sched.generate([2, 23], max_new_tokens=3, session_id="disk").token_ids
    return out


def lead(sched, name, off_dir):
    """Rank 0's requests for a scenario; their ids by label."""
    out = greedy(sched)
    if name == "q4":
        out.update(sessions(sched, off_dir))
        sched.drop_session("sess")
    if name == "float":
        out["sampled"] = run_requests(sched, CONCURRENT, max_new_tokens=8, temperature=0.9,
                                      top_k=20, top_p=0.9, seed=5)
    return out


def rank_main(rank: int, world: int, store_path: str, model_dir: str, out_dir: str) -> None:
    import torch

    from jlama_tpu_torch.models.loader import load_params
    from jlama_tpu_torch.nn.qarray import QArray
    from jlama_tpu_torch.parallel.distributed import init_tp_group, shutdown
    from jlama_tpu_torch.parallel.mesh import Mesh
    from jlama_tpu_torch.runtime.coordination import StepChannel
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler

    torch.set_num_threads(2)  # tiny shapes; the test machine runs other workers
    group = init_tp_group(world, rank, device="cpu", store_path=store_path, timeout_s=60)
    params, cfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    weights = {"float": params, "q4": quantize_layers(params)}
    if rank == 0:
        chan = StepChannel.serve(0, world - 1, host="127.0.0.1", timeout=60,
                                 on_bound=lambda p: group.store.set("step_port", str(p)))
    else:
        chan = StepChannel.connect("127.0.0.1", int(group.store.get("step_port")), timeout=60)
    results = {"backend": group.backend}
    for name, (w, kv) in SCENARIOS.items():
        sched = BatchScheduler(weights[w], cfg, kv_dtype="q8" if kv == "q8" else torch.float32,
                               compute_dtype=torch.float32, device="cpu",
                               mesh=Mesh(1, 1, world, group), step_channel=chan, **SCHED)
        sched.sampled_log = []
        if rank == 0:
            results[name] = lead(sched, name, str(Path(out_dir) / "off"))
            chan.publish({"op": "stop"})  # this scenario's follower loops return
        else:
            sched.run_follower()
        lay = sched.params["layers"][0]
        results[name + "/log"] = [np.asarray(t) for t in sched.sampled_log]
        results[name + "/shapes"] = {k: tuple(v.data.shape if isinstance(v, QArray) else v.shape)
                                     for k, v in lay.items()}
        results[name + "/pool"] = tuple(sched.kv.layer_states()[0].k_pool.shape)
        results[name + "/graphs"] = sched.graphs.stats()
    chan.close()
    shutdown()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)



# ---------------------------------------------------------------------------
# dp page groups and expert parallelism (tests/test_torch_dp_serving.py,
# tests/test_torch_ep.py): one world of dp x tp ranks a spawn, rank r tp rank
# r % tp of dp group r // tp
# ---------------------------------------------------------------------------

# the JAX tests' scheduler (tests/test_shard_map_tp.py::_mk_sched)
MESH_SCHED = dict(n_pages=32, page_size=8, max_seq_len=48)
DP_BATCH = [[1 + i, 5, 9 + i] for i in range(4)]  # test_dp_sharded_batch_parity
DP_TP_PROMPTS = [[1, 5, 9 + i] for i in range(2)]  # test_dp_tp_combined_q4k
EP_FLOAT_PROMPT = [1, 5, 9, 42, 7]  # test_moe_expert_parallel_shard_map
EP_Q4_PROMPT = [1, 5, 9]  # test_moe_ep_quantized_gathered
MOE_Q4_KEYS = ("experts.w1", "experts.w2", "experts.w3", "wq", "wk", "wv", "wo")


SESSIONS = {"s1": [1, 5, 9], "s2": [2, 6], "s3": [3, 7, 11]}


def dp_sessions(sched, req_cls, off_dir=None):
    """tests/test_shard_map_tp.py::test_dp_sessions_pinned_to_group's
    sessions, three at once so that the third lands in dp group 1 (slots are
    taken in order, two a group), then one more request each; with
    `off_dir`, s1 suspended to RAM and s3 (group 1) to disk in between."""
    reqs = [sched.submit(req_cls(prompt_ids=list(p), max_new_tokens=3, session_id=sid))
            for sid, p in SESSIONS.items()]
    for _ in range(400):
        if all(r.state.value == "DONE" for r in reqs):
            break
        sched.step()
    out = [list(r.out_ids) for r in reqs]
    if off_dir:
        assert sched.suspend_session("s1"), "RAM suspend"
        assert sched.suspend_session("s3", to_dir=off_dir), "disk suspend"
    for sid, p in zip(SESSIONS, ([7], [8], [9])):
        out.append(sched.generate(p, max_new_tokens=3, session_id=sid).token_ids)
    return out


def _mesh_lead(sched, kind, off_dir):
    """The leader's requests of a world (`kind`); their ids by label."""
    if kind == "dp2":
        batch = run_requests(sched, DP_BATCH, max_new_tokens=5)
        groups = {}
        from jlama_tpu_torch.runtime.scheduler import GenRequest

        sessions = dp_sessions(sched, GenRequest, off_dir)
        for sid in SESSIONS:
            groups[sid] = sched.kv.alloc.group_of.get(sid)
        return {"batch": batch, "sessions": sessions, "session_groups": groups}
    if kind == "dp2tp2":
        return {"q4": [sched.generate(p, max_new_tokens=4).token_ids for p in DP_TP_PROMPTS],
                "concurrent": run_requests(sched, CONCURRENT, max_new_tokens=6)}
    prompt, n = (EP_FLOAT_PROMPT, 6) if kind == "ep_float" else (EP_Q4_PROMPT, 5)
    return {"ids": sched.generate(prompt, max_new_tokens=n).token_ids}


def mesh_rank_main(rank: int, dp: int, tp: int, store_path: str, model_dir: str, out_dir: str,
                   kinds: tuple) -> None:
    """One rank of a dp x tp world on the CPU: for each kind, the scheduler
    over that kind's weights (dp2: float llama; dp2tp2: q4 llama; ep_float:
    float Mixtral, its experts through the grouped route; ep_q4: q4 Mixtral,
    its experts through K6's plain version), rank 0 leading and the others
    replaying; pickles the ids, the shapes each rank holds and its log."""
    import torch

    from jlama_tpu_torch.models.loader import load_params
    from jlama_tpu_torch.nn.qarray import QArray, quantize_q4
    from jlama_tpu_torch.parallel.distributed import init_mesh_group, shutdown
    from jlama_tpu_torch.runtime.coordination import StepChannel
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler

    torch.set_num_threads(2)
    mesh = init_mesh_group(dp, tp, rank, device="cpu", store_path=store_path, timeout_s=60)
    store = mesh.group.store
    if rank == 0:
        chan = StepChannel.serve(0, dp * tp - 1, host="127.0.0.1", timeout=60,
                                 on_bound=lambda p: store.set("step_port", str(p)))
    else:
        chan = StepChannel.connect("127.0.0.1", int(store.get("step_port")), timeout=60)
    results = {"rank": rank, "dp_index": mesh.dp_index, "tp_rank": mesh.group.rank,
               "rows_member": mesh.rows is not None}
    for kind in kinds:
        params, cfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
        kw = dict(MESH_SCHED, n_slots=4 if kind.startswith("dp") else 2)
        if kind == "dp2tp2":
            params = quantize_layers(params)
        if kind == "ep_q4":
            params = dict(params, layers=[{k: quantize_q4(v.numpy()) if k in MOE_Q4_KEYS
                                           else v for k, v in d.items()}
                                          for d in params["layers"]])
            kw["moe_ragged"] = False
        sched = BatchScheduler(params, cfg, kv_dtype=torch.float32,
                               compute_dtype=torch.float32, device="cpu", mesh=mesh,
                               step_channel=chan, **kw)
        sched.sampled_log = []
        if rank == 0:
            results[kind] = _mesh_lead(sched, kind, str(Path(out_dir) / "off"))
            chan.publish({"op": "stop"})
        else:
            sched.run_follower()
        lay = sched.params["layers"][0]
        results[kind + "/log"] = [np.asarray(t) for t in sched.sampled_log]
        results[kind + "/shapes"] = {k: tuple(v.data.shape if isinstance(v, QArray) else v.shape)
                                     for k, v in lay.items()}
        results[kind + "/pool"] = tuple(sched.kv.state.k_pool.shape)
        results[kind + "/rows"] = sched._in.tokens.shape[0]
        results[kind + "/graphs"] = sched.graphs.stats()
    chan.close()
    shutdown()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
