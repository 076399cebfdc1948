"""The rank program of chip_smoke.py's phase 19: the rest of tensor
parallelism on ranks that share one card (or the CPU), one process each.

    rank_main(rank, world, store_path, out_path, spec)

Each rank joins a tp group of `world` ranks through a FileStore at
`store_path` (gloo: two ranks on one GPU, which NCCL refuses) and, with
rank 0 leading over the step channel (port 0, handed over through the
store) and the others replaying its steps, runs in order:

1. shard-local loading from disk: `load_params_sharded` of the JQ4
   checkpoint at `spec["model_dir"]` onto the rank's device, its payload
   bytes read (whole rows of wo and w2, whose input columns it cuts)
   against the file's, its tree against the slice that `shard_params`
   cuts from a whole load on the host (bit for bit);
2. the same over ranged HTTP from `spec["url"]` onto the host: the bytes
   fetched, the tree against the local one;
3. q4 and then q4s (`weight_format="q4s"`) serving on the loaded slice
   ("disk_q4", "disk_q4s"): the tp forward's logits of a
   `spec["prefill"]`-token prompt (every rank in step), `spec["requests"]`
   greedy requests, the kernels' launches counted from 0 on every rank; K5
   on the rank's own q4s weights (wqkv, wo, w13, w2, the lm_head) at
   `spec["k5_m"]` tokens against `q4s_matmul_plain` and on a repeat, bit
   for bit, timed on rank 0 on the card;
4. the same on random JQ4 weights of the same config from `spec["seed"]`
   ("rand_q4", "rand_q4s": the whole tree on every rank, which cuts it);
5. GPT-2 (`spec["gpt2"]`, random JQ4 from `spec["seed"]`): the greedy
   requests at tp = 2, K1-K4's launches; then the same requests on its
   eager yardstick (`decode_graphs=False`), whose ids, launches and
   logits' prints (`tp_check.LogitsPrints`) must be the graphed run's
   (every scheduler here runs on graphs: on the card a step is a chain of
   segments cut at its collectives);
6. BERT (`spec["bert"]`, its tokenizer.json at `spec["bert_tokenizer"]`): a
   mesh `OpenAIServer` on 127.0.0.1 whose embeddings `Engine` shares the
   scheduler's rank tree; rank 0 posts `spec["texts"]` to `/v1/embeddings`
   and the other ranks replay the embed steps in `run_follower`.

Rank 0 then, alone, runs the same work on one device: each Llama tree
through single-device q4 and q4s schedulers (greedy ids; the prompt's
logits, also with f32 activations, and q4s's against q4's: how far the
model moves with a change of rounding), GPT-2's whole tree, BERT's
`Engine.embed_batch` on the same token ids. Each rank pickles its results
to `out_path`; `check_ranks` says what must hold (chip_smoke.py phase 19;
tests/test_torch_tp_load_check.py on the CPU).
"""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import numpy as np

from .tp_check import (REL_L2_LIMIT, LogitsPrints, _ids, _logits, _serve, _sync,
                       expected_launches, graphs_problem, prints_problem)

# the largest share of the checkpoint's payload a rank may read
# (tests/test_shard_local_load.py's bound); at tp = 2 a rank reads half of
# the column-parallel rows and the vocabulary but whole rows of wo and w2
READ_LIMIT = 0.8


def _kernel_fns():
    from ..ops.attention import flash_prefill, paged_decode
    from ..ops.kv_write import kv_write
    from ..ops.q4_matmul import q4_matmul
    from ..ops.w8a8 import q4s_matmul

    return {"q4_matmul": q4_matmul, "paged_decode": paged_decode,
            "flash_prefill": flash_prefill, "kv_write": kv_write, "w8a8_matmul": q4s_matmul}


def _reset():
    for fn in _kernel_fns().values():
        fn.launches = 0


def _counts():
    return {k: fn.launches for k, fn in _kernel_fns().items()}


def trees_equal(a, b) -> bool:
    """Two param trees hold the same leaves, bit for bit (dtypes too)."""
    import torch

    from ..nn.qarray import QArray

    if isinstance(a, dict):
        return set(a) == set(b) and all(trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(trees_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, QArray):
        return (isinstance(b, QArray) and a.fmt == b.fmt
                and trees_equal(a.data, b.data) and trees_equal(a.scales, b.scales))
    if isinstance(a, tuple):
        return len(a) == len(b) and all(trees_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.cpu(), b.cpu())


def _config(which):
    from ..config import from_hf_config
    from ..models.init import bert_base_config, gpt2_config

    if isinstance(which, dict):
        return from_hf_config(which)
    return {"gpt2": gpt2_config, "bert": bert_base_config}[which]()


def _sched_kw(spec):
    return dict(n_slots=spec["n_slots"], n_pages=spec["n_pages"], page_size=spec["page_size"],
                max_seq_len=spec["max_seq_len"])


def _prompts(spec, vocab, seed):
    rng = np.random.default_rng(seed)
    lo, hi = spec["prompt_len"]
    return [_ids(rng, int(rng.integers(lo, hi + 1)), vocab) for _ in range(spec["requests"])]


def _rel(a, b) -> float:
    import torch

    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _lead_or_follow(rank, chan, sched, lead):
    """Rank 0 runs `lead()` and then publishes stop; the others replay."""
    if rank == 0:
        out = lead()
        chan.publish({"op": "stop"})
        return out
    sched.run_follower()
    return None


def k5_rank_check(torch, params, ms, timed: bool) -> dict:
    """K5 on this rank's own q4s weights of layer 0 and its lm_head at `ms`
    tokens (seeded bf16 x): bit-equal to `q4s_matmul_plain` and on a
    repeat; with `timed` (rank 0 on the card) each call's device time and
    the plain version's. Returns {name: {M: row}}."""
    from ..ops.w8a8 import q4s_matmul, q4s_matmul_plain
    from ..utils.cuda_timer import INT8_OPS_PER_S, bound
    from ..ops.w8a8 import BITS_PER_WEIGHT

    lay = params["layers"][0]
    ws = {k: lay[k] for k in ("wqkv", "wo", "w13", "w2")}
    ws["lm_head"] = params["lm_head"]
    dev = ws["wqkv"].data.device
    timer = None
    if timed:
        from ..utils.cuda_timer import Timer

        timer = Timer(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    xdt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    out = {}
    for name, w in ws.items():
        n, k = w.shape
        # wo and w2 are row-parallel: f32 partials, as _row_parallel_linear asks
        ydt = torch.float32 if name in ("wo", "w2", "lm_head") else xdt
        for m in ms:
            x = torch.randn((m, k), generator=g, device=dev).to(xdt)
            y = q4s_matmul(x, w, ydt)
            ref = q4s_matmul_plain(x, w, ydt)
            row = {"N": n, "K": k, "equal": bool(torch.equal(y, ref)),
                   "repeat_equal": bool(torch.equal(q4s_matmul(x, w, ydt), y)),
                   "max_abs_err": float((y.float() - ref.float()).abs().max())}
            if timer is not None:
                row["ms"] = timer(lambda: q4s_matmul(x, w, ydt))
                row["plain_ms"] = timer(lambda: q4s_matmul_plain(x, w, ydt))
                nbytes = n * k * BITS_PER_WEIGHT / 8 + m * k * x.element_size() \
                    + m * n * y.element_size()
                row["bound_ms"], row["bound_by"] = bound(nbytes, 2.0 * m * n * k,
                                                         INT8_OPS_PER_S)
            out.setdefault(name, {})[m] = row
    return out


def _bert_lead(torch, sched, tok, texts, timeout_s):
    """Rank 0: a mesh OpenAIServer on 127.0.0.1 (port 0), one
    /v1/embeddings request of `texts`; returns the vectors and seconds."""
    import asyncio
    import http.client
    import threading

    from ..server.openai_api import OpenAIServer

    srv = OpenAIServer(sched, tok, model_name="bert-base-random")
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        port = asyncio.run_coroutine_threadsafe(srv.start("127.0.0.1", 0), loop).result(60)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout_s)
        t0 = time.perf_counter()
        conn.request("POST", "/v1/embeddings", json.dumps({"input": texts}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        seconds = time.perf_counter() - t0
        conn.close()
        if resp.status != 200:
            raise RuntimeError(f"/v1/embeddings answered {resp.status}: {body}")
        vecs = np.array([d["embedding"] for d in body["data"]], np.float32)
        asyncio.run_coroutine_threadsafe(srv.close(), loop).result(60)
    finally:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        sched.stop()
    return vecs, seconds


def rank_main(rank: int, world: int, store_path: str, out_path: str, spec: dict) -> None:
    import pickle

    import torch

    from ..models.base import fuse_params
    from ..models.init import random_q4_params
    from ..models.loader import load_params
    from ..parallel.distributed import LOAD_STATS, init_mesh_group, load_params_sharded, shutdown
    from ..parallel.mesh import shard_params
    from ..runtime.coordination import StepChannel
    from ..runtime.engine import Engine
    from ..runtime.scheduler import BatchScheduler, GenRequest
    from ..tokenizers import Tokenizer, parse_tokenizer_json

    if spec.get("threads"):
        torch.set_num_threads(spec["threads"])
    mesh = init_mesh_group(1, world, rank, device=spec["device"], backend=spec["backend"],
                           store_path=store_path, timeout_s=spec["timeout_s"])
    group = mesh.group
    dev = group.device
    # bf16 weights and activations as served; f32 where the spec asks (the CPU rehearsal)
    dt = torch.float32 if spec.get("f32") else torch.bfloat16
    out = {"rank": rank, "world": world, "backend": group.backend, "device": str(dev)}
    # 1. shard-local loading from disk, and the slice of a whole load
    _sync(torch, dev)
    t0 = time.perf_counter()
    params, cfg = load_params_sharded(spec["model_dir"], None, mesh, device=dev, float_dtype=dt)
    _sync(torch, dev)
    out["local"] = dict(LOAD_STATS, seconds=time.perf_counter() - t0)
    whole, _ = load_params(spec["model_dir"], device="cpu", float_dtype=dt)
    ref = shard_params(fuse_params(whole, world), cfg, world, group.rank)
    out["local_equal"] = trees_equal(dict(params), dict(ref)) and params.vocab == ref.vocab
    del whole, ref
    # 2. the same over ranged HTTP, onto the host
    if spec.get("url"):
        t0 = time.perf_counter()
        hp, _ = load_params_sharded(spec["url"], None, mesh, device="cpu", float_dtype=dt)
        out["http"] = dict(LOAD_STATS, seconds=time.perf_counter() - t0)
        out["http_equal"] = trees_equal(dict(hp), dict(params)) and hp.vocab == params.vocab
        del hp
    if rank == 0:
        chan = StepChannel.serve(0, world - 1, host="127.0.0.1", timeout=spec["timeout_s"],
                                 on_bound=lambda p: group.store.set("load_check_port", str(p)))
    else:
        chan = StepChannel.connect("127.0.0.1", int(group.store.get("load_check_port")),
                                   timeout=spec["timeout_s"])
    kw = dict(_sched_kw(spec), device=dev, mesh=mesh, step_channel=chan, kv_dtype=dt,
              compute_dtype=dt)
    prompts = _prompts(spec, cfg.vocab_size, spec["seed"])
    new = spec["new_tokens"]

    def greedy(sched, ps):
        reqs = [GenRequest(prompt_ids=list(p), max_new_tokens=new, stop_ids={-1}) for p in ps]
        _serve(sched, reqs)
        return [list(r.out_ids) for r in reqs]

    def served(name, sched, lead):
        _reset()
        pf0, dec0 = sched.n_prefill_calls, sched.n_decode_steps
        res = _lead_or_follow(rank, chan, sched, lead) or {}
        _sync(torch, dev)
        res.update(launches=_counts(), n_prefill=sched.n_prefill_calls - pf0,
                   n_decode=sched.n_decode_steps - dec0, graphs=sched.graphs.stats())
        out[name] = res

    logit_ids = _ids(np.random.default_rng(spec["seed"] + 1), spec["prefill"], cfg.vocab_size)

    def llama(name, tree, k5: bool):
        """q4 and q4s schedulers over `tree` (the rank's slice, or a whole
        tree each rank cuts): the tp logits of the prompt (every rank in
        step), K5 on the rank's weights where asked, the served requests."""
        for fmt in ("q4", "q4s"):
            sched = BatchScheduler(tree, cfg, weight_format=fmt if fmt == "q4s" else None, **kw)
            logits = _logits(torch, sched, logit_ids, spec["logit_rows"], sched._tp).cpu()
            if fmt == "q4s" and k5:
                out["k5"] = k5_rank_check(torch, sched.params, spec["k5_m"],
                                          timed=rank == 0 and dev.type == "cuda")
                out["q4s_shapes"] = {k: tuple(v.shape) for k, v in
                                     sched.params["layers"][0].items()
                                     if getattr(v, "fmt", None) == "q4s"}
                out["q4s_shapes"]["lm_head"] = tuple(sched.params["lm_head"].shape)
            served(f"{name}_{fmt}", sched, lambda: {"ids": greedy(sched, prompts)})
            out[f"{name}_{fmt}"]["logits"] = logits.float().numpy()
            del sched

    # 3.-4. q4 and q4s on the loaded slice, then on a random JQ4 tree of the
    # same config from the seed (the whole tree on each rank, which cuts it)
    llama("disk", params, k5=True)
    del params
    llama("rand", random_q4_params(cfg, seed=spec["seed"], device=dev), k5=False)
    # 5. GPT-2 at tp
    gcfg = _config(spec["gpt2"])
    gprompts = _prompts(spec, gcfg.vocab_size, spec["seed"] + 2)
    sched = BatchScheduler(random_q4_params(gcfg, seed=spec["seed"], device=dev), gcfg, **kw)
    out["gpt2_vocab"] = sched.params.vocab
    prints = LogitsPrints(torch, dev)
    prints.begin()
    served("gpt2", sched, lambda: {"ids": greedy(sched, gprompts)})
    out["gpt2"]["prints"] = prints.take()
    # its eager yardstick: the same requests, ids and logits' prints
    eager = BatchScheduler(sched.params, gcfg, **dict(kw, fuse=False, decode_graphs=False))
    prints.begin()
    served("gpt2_eager", eager, lambda: {"ids": greedy(eager, gprompts)})
    out["gpt2_eager"]["prints"] = prints.take()
    del sched, eager
    # 6. BERT: /v1/embeddings on a mesh server, the embed steps replayed
    bcfg = _config(spec["bert"])
    with open(spec["bert_tokenizer"]) as f:
        tok = Tokenizer(parse_tokenizer_json(json.load(f)))
    sched = BatchScheduler(random_q4_params(bcfg, seed=spec["seed"], device=dev), bcfg, tok,
                           **kw)
    sched.embed_engine = Engine(sched.params, bcfg, tok, device=dev, fuse=False,
                                moe_ragged=False, mesh=mesh, step_channel=chan,
                                step_lock=sched._lock, kv_dtype=dt, compute_dtype=dt)

    def bert_lead():
        vecs, secs = _bert_lead(torch, sched, tok, spec["texts"], spec["timeout_s"])
        return {"vectors": vecs, "seconds": secs}

    served("bert", sched, bert_lead)
    del sched
    chan.close()
    if rank == 0:
        # the same work on one device: the ids, the logits, and the logits with
        # f32 activations (how far the model moves with the activations' rounding)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        one_kw = dict(_sched_kw(spec), device=dev, kv_dtype=dt, compute_dtype=dt)
        for name in ("disk", "rand"):
            full = (load_params(spec["model_dir"], device=dev, float_dtype=dt)[0]
                    if name == "disk" else random_q4_params(cfg, seed=spec["seed"], device=dev))
            refs = {}
            for fmt in ("q4", "q4s"):
                one = BatchScheduler(full, cfg, weight_format=fmt if fmt == "q4s" else None,
                                     **one_kw)
                res = out[f"{name}_{fmt}"]
                res["single_ids"] = greedy(one, prompts)
                ref = _logits(torch, one, logit_ids, spec["logit_rows"], None).float().cpu()
                f32 = _logits(torch, SimpleNamespace(params=one.params, fwd_cfg=cfg, device=dev,
                                                     compute_dtype=torch.float32),
                              logit_ids, spec["logit_rows"], None).float().cpu()
                got = torch.from_numpy(res["logits"])
                res["logits_rel_l2"] = _rel(got, ref)
                res["f32_rel_l2"] = _rel(f32, ref)
                refs[fmt] = ref
                res["logits_finite"] = bool(torch.isfinite(got).all())
                del one
            out[f"{name}_q4s"]["q4_rel_l2"] = _rel(refs["q4s"], refs["q4"])
            del full
        one = BatchScheduler(random_q4_params(gcfg, seed=spec["seed"], device=dev), gcfg,
                             **one_kw)
        out["gpt2"]["single_ids"] = greedy(one, gprompts)
        del one
        eng = Engine(random_q4_params(bcfg, seed=spec["seed"], device=dev), bcfg, tok,
                     device=dev, kv_dtype=dt, compute_dtype=dt)
        single = np.stack(eng.embed_batch([tok.encode(t) for t in spec["texts"]]))
        vecs = out["bert"]["vectors"]
        out["bert_rel_l2"] = [float(np.linalg.norm(a - b) / np.linalg.norm(b))
                              for a, b in zip(vecs, single)]
        del eng
    shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


LLAMA_RUNS = ("disk_q4", "disk_q4s", "rand_q4", "rand_q4s")


def check_ranks(ranks: list[dict], spec: dict, embed_limit: float) -> list[str]:
    """What must hold of the ranks' results (rank order); the failures, as
    sentences (empty when every check holds). `embed_limit`: the largest
    relative L2 of a mesh embedding from one device's.

    Each rank reads at most READ_LIMIT of the payload from disk, and over
    HTTP fetches what it read from disk. The tp logits of every Llama run
    lie within REL_L2_LIMIT of one device's, and the served greedy ids of
    every Llama run and of GPT-2 equal one device's."""
    from ..config import load_config

    bad = []
    cfg = load_config(spec["model_dir"])
    gcfg, bcfg = _config(spec["gpt2"]), _config(spec["bert"])
    cuda = spec["device"] != "cpu"
    lead = ranks[0]
    for r, res in enumerate(ranks):
        loc = res["local"]
        if not res["local_equal"] or loc["bytes_loaded"] > READ_LIMIT * loc["payload"]:
            bad.append(f"rank {r}: the disk load (equal to the whole load's slice: "
                       f"{res['local_equal']}) read {loc['bytes_loaded']} of "
                       f"{loc['payload']} bytes (limit {READ_LIMIT} of them)")
        if spec.get("url") and (not res["http_equal"]
                                or res["http"]["bytes_loaded"] != loc["bytes_loaded"]):
            bad.append(f"rank {r}: the HTTP load (equal to the disk load's tree: "
                       f"{res.get('http_equal')}) fetched {res['http']['bytes_loaded']} bytes, "
                       f"the disk load read {loc['bytes_loaded']}")
        for name in LLAMA_RUNS + ("gpt2", "gpt2_eager"):
            s = res[name]
            matmul = "w8a8_matmul" if name.endswith("q4s") else "q4_matmul"
            n_layers = gcfg.n_layers if name.startswith("gpt2") else cfg.n_layers
            want = dict(expected_launches(n_layers, s["n_prefill"], s["n_decode"], cuda),
                        w8a8_matmul=0)
            if matmul == "w8a8_matmul":  # every projection and the lm_head through K5
                want["w8a8_matmul"], want["q4_matmul"] = want["q4_matmul"], 0
            path = [k for k in want if k != ({"q4_matmul", "w8a8_matmul"} - {matmul}).pop()]
            if s["launches"] != want or (cuda and min(want[k] for k in path) == 0):
                bad.append(f"rank {r} {name}: launches {s['launches']} != {want}")
            if (s["n_prefill"], s["n_decode"]) != (lead[name]["n_prefill"],
                                                  lead[name]["n_decode"]):
                bad.append(f"rank {r} {name}: {s['n_prefill']} prefills and {s['n_decode']} "
                           "decode steps, not rank 0's")
            why = graphs_problem(s["graphs"], cuda, eager=name == "gpt2_eager")
            if why:
                bad.append(f"rank {r} {name}: {why}")
            if not name.startswith("gpt2") and not np.array_equal(s["logits"],
                                                                  lead[name]["logits"]):
                bad.append(f"rank {r}: its {name} logits differ from rank 0's")
        g, y = res["gpt2"], res["gpt2_eager"]
        why = prints_problem(g["prints"], y["prints"], g["n_decode"])
        if why or (g["launches"], len(g["prints"])) != (y["launches"], len(y["prints"])):
            bad.append(f"rank {r} gpt2: graphed against eager, {why}, launches "
                       f"{g['launches']} / {y['launches']}")
        b = res["bert"]
        want_k1 = 4 * bcfg.n_layers if cuda else 0
        if b["launches"]["q4_matmul"] != want_k1 or b["n_decode"] or b["n_prefill"]:
            bad.append(f"rank {r} bert: launches {b['launches']} (one forward: {want_k1} K1), "
                       f"{b['n_prefill']} prefills, {b['n_decode']} decode steps")
        for name, rows in res["k5"].items():
            for m, row in rows.items():
                if not (row["equal"] and row["repeat_equal"]):
                    bad.append(f"rank {r}: K5 {name} M={m} N={row['N']} K={row['K']} differs "
                               f"from its plain version (max err {row['max_abs_err']}) or "
                               "from its repeat")
        if res["gpt2_vocab"] != (gcfg.vocab_size % len(ranks) == 0,) * 2:
            bad.append(f"rank {r}: GPT-2's vocabulary flags {res['gpt2_vocab']}")
    for name in LLAMA_RUNS:
        s = lead[name]
        if not (s["logits_finite"] and s["logits_rel_l2"] < REL_L2_LIMIT):
            bad.append(f"{name}: the tp logits' rel L2 {s['logits_rel_l2']} from one device's "
                       f"(limit {REL_L2_LIMIT}; finite {s['logits_finite']})")
    lead["gpt2_eager"]["single_ids"] = lead["gpt2"]["single_ids"]
    for name in LLAMA_RUNS + ("gpt2", "gpt2_eager"):
        if lead[name]["ids"] != lead[name]["single_ids"]:
            bad.append(f"{name}: the tp ids {lead[name]['ids']} differ from one device's "
                       f"{lead[name]['single_ids']}")
    if not all(x < embed_limit for x in lead["bert_rel_l2"]):
        bad.append(f"bert: the mesh server's vectors' rel L2 {lead['bert_rel_l2']} from one "
                   f"device's embed_batch (limit {embed_limit})")
    return bad

