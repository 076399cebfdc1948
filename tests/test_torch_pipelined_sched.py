"""The port's pp serving (`runtime/pipelined.py::PipelinedScheduler`, and the
stage-serial BatchScheduler of `serve --no-pp-pipeline`) against jlama_tpu's,
as tests/test_pipelined_sched.py and tests/test_multiprocess.py::
test_two_process_pp_pipeline hold the JAX package's. Four gloo rank
processes on the CPU (tests/torch_pp_ranks.py::sched_rank_main, started once
for the module) serve the 2-layer tiny llama on three meshes, rank 0 leading
over the step channel and the others replaying:

- (1, 2, 2): the PipelinedScheduler's greedy ids and a concurrent batch
  against jlama_tpu's PipelinedScheduler on the same mesh and its
  single-device scheduler; seeded sampled ids against the port's own
  one-device scheduler (the JAX draws match in distribution only);
  sessions, a RAM and a per-rank disk suspend, and a q8 pool against one
  device's uninterrupted run; penalties refused with the JAX error; the
  stage-serial BatchScheduler's ids; the Engine on the mesh (embeddings,
  SPMD greedy ids) against one device's;
- (2, 2, 1): two dp groups, each a ring of its own, against jlama_tpu's
  PipelinedScheduler on that mesh (which runs dp through GSPMD) and one
  device;
- (1, 2, 1), two ranks: test_two_process_pp_pipeline's requests (a session
  resumed), ids equal the flat scheduler's.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_pp_ranks as R
from tests.helpers import make_tiny_llama
from tests.torch_tp_ranks import start_ranks, wait_ranks

EMBED_TOL = 1e-5


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_sched")
    model_dir, _ = make_tiny_llama(tmp / "model")
    procs, end = start_ranks(R.sched_rank_main,
                             lambda r: (r, str(tmp / "store"), str(model_dir), str(tmp)),
                             world=R.WORLD)
    try:
        ref = jax_refs(model_dir)
        ref.update(port_refs(model_dir))
    finally:
        wait_ranks(procs, end)
    out = []
    for r in range(R.WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return ref, out, tmp


def _flat(sched):
    """The requests of the (1, 2, 2) scenarios on a flat scheduler,
    uninterrupted."""
    return {"greedy": [sched.generate(p, max_new_tokens=6).token_ids for p in R.GREEDY],
            "concurrent": R.run_requests(sched, R.CONCURRENT, max_new_tokens=6),
            "sessions": R.sessions(sched, off_dir=None) | _uninterrupted(sched)}


def _uninterrupted(sched):
    out = {}
    for sid in ("ram", "disk"):
        out[sid + "1"] = sched.generate([1, 5, 9], max_new_tokens=4, session_id=sid).token_ids
        out[sid + "2"] = sched.generate([42, 7], max_new_tokens=4, session_id=sid).token_ids
    return out


def jax_refs(model_dir):
    """jlama_tpu's PipelinedScheduler on the (1, 2, 2) and (2, 2, 1) meshes
    and its single-device scheduler (f32 and q8 pools, and the two-process
    test's scheduler)."""
    from jlama_tpu.models.loader import load_params
    from jlama_tpu.parallel.mesh import make_mesh
    from jlama_tpu.runtime.pipelined import PipelinedScheduler
    from jlama_tpu.runtime.scheduler import BatchScheduler

    params, cfg = load_params(model_dir, float_dtype=jnp.float32)
    kw = dict(R.SCHED, compute_dtype=jnp.float32)
    out = {"flat": _flat(BatchScheduler(params, cfg, kv_dtype=jnp.float32, **kw))}
    q8 = BatchScheduler(params, cfg, kv_dtype="q8", **kw)
    out["flat_q8"] = q8.generate(R.SAMPLED["prompt"], max_new_tokens=6).token_ids
    mp = BatchScheduler(params, cfg, kv_dtype=jnp.float32, compute_dtype=jnp.float32,
                        **R.MP_SCHED)
    out["flat_mp"] = [mp.generate(p, max_new_tokens=n, session_id=sid).token_ids
                      for p, n, sid in R.MP_REQS]
    for dims in ((1, 2, 2), (2, 2, 1)):
        dp, pp, tp = dims
        mesh = make_mesh(jax.devices()[:dp * pp * tp], dp=dp, pp=pp, tp=tp)
        pipe = PipelinedScheduler(params, cfg, mesh=mesh, kv_dtype=jnp.float32, **kw)
        got = {"concurrent": R.run_requests(pipe, R.CONCURRENT, max_new_tokens=6)}
        if dims == (1, 2, 2):
            got["greedy"] = [pipe.generate(p, max_new_tokens=6).token_ids for p in R.GREEDY]
        out["pipe", dims] = got
    return out


def port_refs(model_dir):
    """The port's one-device scheduler (seeded sampled ids) and Engine
    (embeddings, greedy ids)."""
    from jlama_tpu_torch.models.loader import load_params
    from jlama_tpu_torch.runtime.engine import Engine
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler

    params, cfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    sched = BatchScheduler(params, cfg, kv_dtype=torch.float32, compute_dtype=torch.float32,
                           device="cpu", **R.SCHED)
    s = R.SAMPLED
    out = {"port_sampled": sched.generate(s["prompt"], max_new_tokens=s["max_new_tokens"],
                                          temperature=s["temperature"],
                                          seed=s["seed"]).token_ids,
           "port_sampled_batch": R.run_requests(sched, R.CONCURRENT, **R.SAMPLED_BATCH)}
    eng = Engine(params, cfg, device="cpu", max_seq_len=64, compute_dtype=torch.float32,
                 kv_dtype=torch.float32)
    out["port_embed"] = eng.embed_batch(R.EMBED, pooling="AVG")
    out["port_engine_ids"] = eng.generate_tokens(R.GREEDY[0], max_new_tokens=6).token_ids
    return out


@pytest.mark.parametrize("what", ["greedy", "concurrent"])
def test_pipelined_ids_match_jax(served, what):
    """tests/test_pipelined_sched.py's test_pipelined_matches_single_device
    and test_pipelined_concurrent_batch on the (1, 2, 2) mesh: the leader's
    greedy ids equal jlama_tpu's PipelinedScheduler's and its single-device
    scheduler's."""
    ref, out, _ = served
    got = out[0][(1, 2, 2)]["pipe"][what]
    assert got == ref["pipe", (1, 2, 2)][what]
    assert got == ref["flat"][what]


@pytest.mark.parametrize("what", ["sampled", "sampled_batch"])
def test_pipelined_sampled_ids_equal_one_device(served, what):
    """test_pipelined_sampled_parity: a seeded request (and a concurrent
    batch with top-k and top-p) samples on the last stage what the port's
    one-device scheduler samples, through the same counter-based streams."""
    ref, out, _ = served
    assert out[0][(1, 2, 2)]["pipe"][what] == ref["port_" + what]


@pytest.mark.parametrize("scenario", ["pipe", "serial"])
def test_sessions_and_suspends_give_one_devices_ids(served, scenario):
    """test_pipelined_sessions_resume and _session_suspend_resume, through
    the ring and through the stage-serial scheduler: a session's second
    request, and the second requests of a session suspended to RAM and of
    one suspended to disk (each rank writing its own stage's pages, one file
    per rank), equal one device's uninterrupted run."""
    ref, out, tmp = served
    got = out[0][(1, 2, 2)][scenario]
    want = ref["flat"]["sessions"]
    assert {k: got[k] if scenario == "pipe" else got["sessions"][k] for k in want} == want
    files = sorted(p.name for p in (tmp / f"off_{scenario}").iterdir())
    assert files == [f"disk.kv.p{r}.npz" for r in range(R.WORLD)]


def test_pipelined_q8_pool(served):
    """test_pipelined_q8_kv_parity: a q8 pool (each rank its stage's q8
    pages) decodes the ids of one device's q8 pool."""
    ref, out, _ = served
    assert out[0][(1, 2, 2)]["q8"]["greedy"] == ref["flat_q8"]
    assert out[0][(1, 2, 2)]["q8/pool"] == (1, 1, 64, 8, 16)


def test_pipelined_refuses_penalties(served):
    """Presence and frequency penalties: the JAX error, before any work."""
    _, out, _ = served
    assert out[0][(1, 2, 2)]["pipe"]["penalty"] == (
        "ERROR", "presence/frequency penalties are not supported with the pp pipeline")


@pytest.mark.parametrize("what", ["greedy", "concurrent"])
def test_stage_serial_scheduler_ids(served, what):
    """`--no-pp-pipeline`: the BatchScheduler on the pp mesh, each call stage
    by stage, gives one device's greedy ids."""
    ref, out, _ = served
    assert out[0][(1, 2, 2)]["serial"][what] == ref["flat"][what]


def test_engine_on_a_pp_mesh(served):
    """`Engine(mesh=)` on the (1, 2, 2) mesh: the leader's embeddings (its
    calls replayed by the other ranks, the result back over the ring's
    wrap-around) within 1e-5 of one device's, and its SPMD greedy ids, the
    same on every rank, one device's; its graphs on (the CPU runs them
    eagerly, giving no reason)."""
    ref, out, _ = served
    got = out[0][(1, 2, 2)]["serial"]["embed"]
    for a, b in zip(got, ref["port_embed"]):
        np.testing.assert_allclose(a, b, atol=EMBED_TOL, rtol=0)
    for r in range(R.WORLD):
        res = out[r][(1, 2, 2)]
        assert res["engine_ids"] == ref["port_engine_ids"]
        assert res["engine_graphs"]["graphs"] == 0 and "eager_reason" not in res["engine_graphs"]


def test_dp_pp_rings_match_jax(served):
    """(2, 2, 1): two dp groups, each a ring over its page group and its two
    slots (one a microbatch), serve a concurrent batch with jlama_tpu's
    PipelinedScheduler's ids (GSPMD over dp there: a deliberate difference)
    and one device's; sessions too."""
    ref, out, _ = served
    got = out[0][(2, 2, 1)]["dp"]
    assert got["concurrent"] == ref["pipe", (2, 2, 1)]["concurrent"]
    assert got["concurrent"] == ref["flat"]["concurrent"]
    assert got["sessions"] == {k: ref["flat"]["sessions"][k] for k in ("s1", "s2")}
    for r in range(R.WORLD):  # each rank: its stage's layer, its group's pages
        assert out[r][(2, 2, 1)]["dp/pool"] == (1, 2, 32, 8, 16)


def test_two_process_pp_pipeline(served):
    """tests/test_multiprocess.py::test_two_process_pp_pipeline's analog:
    the ring spans two processes, its tick windows published on the step
    channel; after a warm-up (its windows and prefills replayed by the
    follower too) the ids (a session resumed) equal the flat scheduler's."""
    ref, out, _ = served
    assert out[0][(1, 2, 1)]["mp"]["ids"] == ref["flat_mp"]
    assert (1, 2, 1) not in out[2] and (1, 2, 1) not in out[3]


def test_ranks_hold_their_stage(served):
    """Each rank of (1, 2, 2) holds its stage's one layer and a pool of that
    layer's pages of its KV head; graphs on (run eagerly on the CPU); the
    stage-serial scheduler's ids are the same on the tp ranks of a stage
    and on both ends of the ring (stage 0 gets what the last stage
    sampled)."""
    _, out, _ = served
    for r in range(R.WORLD):
        res = out[r][(1, 2, 2)]
        assert (res["stage"], res["tp_rank"]) == (r // 2, r % 2)
        for name in ("pipe", "serial"):
            assert res[name + "/layers"] == 1
            assert res[name + "/pool"] == (1, 1, 64, 8, 16)
            assert res[name + "/graphs"]["graphs"] == 0
            assert "eager_reason" not in res[name + "/graphs"]
            assert res[name + "/calls"] > 0
        log, lead = res["serial/log"], out[0][(1, 2, 2)]["serial/log"]
        assert len(log) == len(lead) > 0
        for a, b in zip(log, lead):
            np.testing.assert_array_equal(a, b)
