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

