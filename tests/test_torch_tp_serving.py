"""tp = 2 serving over torch.distributed: two gloo rank processes on the CPU
(started with `spawn`, meeting through a FileStore in tmp_path; the step
channel binds port 0 and hands its port over through that store), rank 0
leading the port's BatchScheduler, rank 1 replaying its steps
(tests/torch_tp_ranks.py). Greedy ids against jlama_tpu's single-device
scheduler and its tp = 2 shard_map scheduler (on two of the virtual CPU
devices, in this process), on the q4 and the float tiny llama and on a q8
pool; a RAM and a per-rank disk suspend against an uninterrupted run;
sampled ids equal on both ranks. The ranks start once for the module, with
a deadline of their own."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests import torch_tp_ranks as R
from tests.helpers import make_tiny_llama
from tests.torch_tp_ranks import WORLD, start_ranks, wait_ranks


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The ranks' results, and jlama_tpu's ids, computed here while the
    ranks run."""
    tmp = tmp_path_factory.mktemp("tp_serving")
    model_dir, _ = make_tiny_llama(tmp / "model")
    out = tmp / "out"
    out.mkdir()
    procs, end = start_ranks(R.rank_main, lambda r: (r, WORLD, str(tmp / "store"),
                                                     str(model_dir), str(out)))
    try:
        ref = jax_ids(model_dir)
    finally:
        wait_ranks(procs, end)
    ranks = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ref, out, ranks


def _jax_quantize(params):
    from jlama_tpu.nn.qarray import quantize_q4

    out = dict(params)
    out["layers"] = {k: quantize_q4(np.asarray(v, dtype=np.float32)) if k in R.Q4_KEYS else v
                     for k, v in params["layers"].items()}
    return out


def _jax_run(sched, name):
    """The leader's greedy requests on a jlama_tpu scheduler (q4: then the
    sessions, uninterrupted)."""
    from jlama_tpu.runtime.scheduler import GenRequest

    reqs = [GenRequest(prompt_ids=list(p), max_new_tokens=6) for p in R.CONCURRENT]
    out = {"single": sched.generate(R.PROMPT, max_new_tokens=8).token_ids}
    for r in reqs:
        sched.submit(r)
    while any(r.state.value != "DONE" for r in reqs):
        sched.step()
    out["concurrent"] = [r.out_ids for r in reqs]
    if name == "q4":
        out.update(R.sessions(sched))
    return out


def jax_ids(model_dir):
    """jlama_tpu's single-device and tp = 2 shard_map schedulers on the same
    checkpoint and greedy requests."""
    from jlama_tpu.models.loader import load_params
    from jlama_tpu.parallel.mesh import make_mesh, shard_params
    from jlama_tpu.runtime.scheduler import BatchScheduler

    params, cfg = load_params(model_dir, float_dtype=jnp.float32)
    weights = {"float": params, "q4": _jax_quantize(params)}
    mesh = make_mesh(jax.devices()[:WORLD], dp=1, pp=1, tp=WORLD)
    out = {}
    for name, (w, kv) in R.SCENARIOS.items():
        kw = dict(R.SCHED, kv_dtype="q8" if kv == "q8" else jnp.float32,
                  compute_dtype=jnp.float32)
        out[name, "single"] = _jax_run(BatchScheduler(weights[w], cfg, **kw), name)
        tp = BatchScheduler(shard_params(weights[w], cfg, mesh), cfg, mesh=mesh, **kw)
        assert tp._sm is not None  # the shard_map path, not GSPMD
        out[name, "tp"] = _jax_run(tp, name)
    return out


@pytest.mark.parametrize("name", list(R.SCENARIOS))
def test_tp2_greedy_ids_match_jax(served, name):
    """The leader's greedy ids equal jlama_tpu's single-device scheduler's
    and its tp = 2 shard_map scheduler's; on q4, a session resumed from a
    RAM suspend and one from a per-rank disk suspend give the ids of the
    uninterrupted run."""
    ref, _, ranks = served
    got = {k: v for k, v in ranks[0][name].items() if k != "sampled"}
    assert got == ref[name, "single"]
    assert got == ref[name, "tp"]


def test_every_rank_samples_the_leaders_ids(served):
    """decode_chain carries no tokens: each rank feeds back the ids it
    sampled from the gathered logits, and they are the leader's, step for
    step, sampled (temperature, top-k, top-p, seeds) and greedy alike."""
    leader, follower = served[2]
    for name in R.SCENARIOS:
        a, b = leader[name + "/log"], follower[name + "/log"]
        assert len(a) == len(b) > 0, name
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=name)
    sampled = leader["float"]["sampled"]
    assert [len(ids) for ids in sampled] == [8] * len(R.CONCURRENT)


def test_rank_shards_pools_and_files(served):
    """Each rank holds 1/tp of the fused weights (q4 data [N, K/2]) and of
    the KV heads, kept its graphs on (the CPU runs every step eagerly, with
    no reason given: only the yardstick gives one), and wrote its own
    shard file of the disk suspend."""
    _, out, ranks = served
    for rank, res in enumerate(ranks):
        assert res["backend"] == "gloo"
        sh = res["q4/shapes"]
        # tiny llama: 4 heads of 16 on 2 KV heads, hidden 64, intermediate 128
        assert sh["wqkv"] == ((64 + 2 * 32) // 2, 32) and sh["wo"] == (64, 32 // 2)
        assert sh["w13"] == (2 * 128 // 2, 32) and sh["w2"] == (64, 64 // 2)
        assert res["float/pool"] == (1, 64, 8, 16)  # n_kv/tp heads
        g = res["float/graphs"]  # graphs on (the default), which the CPU never captures
        assert g["graphs"] == 0 and g["eager_steps"] > 0 and "eager_reason" not in g
        f = out / "off" / f"disk.kv.p{rank}.npz"
        with np.load(f) as z:
            assert len(z.files) == 2 and z[z.files[0]].shape[:3] == (1, 2, 1)
