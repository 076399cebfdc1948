"""The rank processes of tests/test_torch_mesh_graphs.py: two gloo ranks on
the CPU (tp = 2, or pp = 2) through a FileStore, the tiny llama in f32,
every owner built with `decode_graphs=True`. Each rank records the boundary
plan of one decode step and of one prefill call (every rank in step, no
step channel), then serves greedy requests with rank 0 leading over the
step channel, its whole session's plan recorded, and runs `Engine(mesh=)`'s
SPMD generate. Imports torch and the port only."""

import pickle

import numpy as np

WORLD = 2
SCHED = dict(n_slots=2, n_pages=32, page_size=8, max_seq_len=64)
PROMPTS = [[1, 5, 9, 42, 7], [1, 7, 30, 12, 3, 8]]
NEW = 6


def _plans(sched, B):
    """The boundary plans of one decode step and of one 8-token prefill call
    on dummy rows (the scratch page)."""
    from jlama_tpu_torch.runtime.graphs import record_plan

    zeros = lambda *s: np.zeros(s, np.int32)  # noqa: E731
    pt = sched.kv.page_table(["__empty__"] * B)
    with record_plan() as decode:
        window = sched._run_decode_window(
            zeros(B, 1), zeros(B, 1), pt, zeros(B), zeros(B), np.zeros(B, np.float32),
            np.ones(B, np.float32), zeros(B), np.zeros(B, np.float32),
            np.zeros(B, np.float32), True, True, False, 16, 1)
        [sched._fetch(t) for t in window if t is not None]
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (B, 8)).copy()
    with record_plan() as prefill:
        sched._call_prefill(zeros(B, 8), pos, pt, 16)
    return list(decode), list(prefill)


def _session(sched, rank, chan, out, name):
    """Rank 0 serves the prompts one at a time, then together, and stops
    the followers; every rank records its session's plan."""
    from jlama_tpu_torch.runtime.graphs import record_plan
    from jlama_tpu_torch.runtime.scheduler import GenRequest, RequestState

    with record_plan() as plan:
        if rank == 0:
            out[name + "/ids"] = [sched.generate(p, max_new_tokens=NEW).token_ids
                                  for p in PROMPTS]
            reqs = [sched.submit(GenRequest(prompt_ids=list(p), max_new_tokens=NEW))
                    for p in PROMPTS]
            while not all(r.state == RequestState.DONE for r in reqs):
                sched.step()
            out[name + "/concurrent"] = [list(r.out_ids) for r in reqs]
            chan.publish({"op": "stop"})
        else:
            sched.run_follower()
    out[name + "/plan"] = list(plan)
    out[name + "/graphs"] = sched.graphs.stats()


def rank_main(rank: int, kind: str, store_path: str, model_dir: str, out_path: str) -> None:
    import torch

    from jlama_tpu_torch.models.loader import load_params
    from jlama_tpu_torch.parallel.distributed import init_mesh_group, shutdown
    from jlama_tpu_torch.runtime.coordination import StepChannel
    from jlama_tpu_torch.runtime.engine import Engine
    from jlama_tpu_torch.runtime.pipelined import PipelinedScheduler
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler

    torch.set_num_threads(1)
    tp, pp = (WORLD, 1) if kind == "tp" else (1, WORLD)
    mesh = init_mesh_group(1, tp, rank, pp=pp, device="cpu", backend="gloo",
                           store_path=store_path, timeout_s=60)
    params, cfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    kw = dict(SCHED, kv_dtype=torch.float32, compute_dtype=torch.float32, device="cpu",
              mesh=mesh, decode_graphs=True)
    out = {"rank": rank, "stage": mesh.stage if pp > 1 else 0, "n_layers": cfg.n_layers}
    out["decode_plan"], out["prefill_plan"] = _plans(BatchScheduler(params, cfg, **kw),
                                                     SCHED["n_slots"])
    group = mesh.group
    if rank == 0:
        chan = StepChannel.serve(0, WORLD - 1, host="127.0.0.1", timeout=60,
                                 on_bound=lambda p: group.store.set("graph_port", str(p)))
    else:
        chan = StepChannel.connect("127.0.0.1", int(group.store.get("graph_port")), timeout=60)
    names = ["serial"] + (["pipe"] if pp > 1 else [])
    for name in names:
        cls = PipelinedScheduler if name == "pipe" else BatchScheduler
        _session(cls(params, cfg, step_channel=chan, **kw), rank, chan, out, name)
    chan.close()
    eng = Engine(params, cfg, device="cpu", max_seq_len=64, kv_dtype=torch.float32,
                 compute_dtype=torch.float32, mesh=mesh, decode_graphs=True)
    out["engine/ids"] = eng.generate_tokens(PROMPTS[0], max_new_tokens=NEW).token_ids
    out["engine/graphs"] = eng.graphs.stats()
    shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
