"""Data-parallel page groups over torch.distributed: gloo rank processes on
the CPU (started with `spawn`, meeting through a FileStore in tmp_path), rank
0 leading the port's BatchScheduler and the others replaying its steps
(tests/torch_tp_ranks.py::mesh_rank_main). Two worlds start together: dp = 2
(two ranks, the float tiny llama) and dp = 2 x tp = 2 (four ranks, its q4
projections). They mirror tests/test_shard_map_tp.py's dp tests: greedy ids
against jlama_tpu's single-device scheduler and its dp (and dp x tp)
shard_map scheduler on the virtual CPU devices, computed here while the ranks
run; each rank's pool holds n_pages/dp pages and it runs n_slots/dp rows;
sessions stay pinned to their group through a RAM and a disk suspend."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests import torch_tp_ranks as R
from tests.helpers import make_tiny_llama
from tests.torch_tp_ranks import start_ranks, wait_ranks

WORLDS = {"dp2": (2, 1), "dp2tp2": (2, 2)}  # kind -> (dp, tp)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_serving")
    model_dir, _ = make_tiny_llama(tmp / "model")
    started = {}
    try:
        for kind, (dp, tp) in WORLDS.items():
            out = tmp / kind
            out.mkdir()
            started[kind] = (out, *start_ranks(
                R.mesh_rank_main, lambda r, dp=dp, tp=tp, kind=kind, out=out: (
                    r, dp, tp, str(out / "store"), str(model_dir), str(out), (kind,)),
                world=dp * tp))
        ref = jax_ids(model_dir)
    finally:
        for out, procs, end in started.values():
            wait_ranks(procs, end)
    ranks = {}
    for kind, (out, _, _) in started.items():
        ranks[kind] = []
        for r in range(WORLDS[kind][0] * WORLDS[kind][1]):
            with open(out / f"rank{r}.pkl", "rb") as f:
                ranks[kind].append(pickle.load(f))
    return ref, ranks, tmp


def _jax_sched(params, cfg, mesh=None, n_slots=4):
    from jlama_tpu.parallel.mesh import shard_params
    from jlama_tpu.runtime.scheduler import BatchScheduler

    if mesh is not None:
        params = shard_params(params, cfg, mesh)
    return BatchScheduler(params, cfg, n_slots=n_slots, kv_dtype=jnp.float32,
                          compute_dtype=jnp.float32, mesh=mesh, **R.MESH_SCHED)


def _jax_batch(sched, prompts, n):
    from jlama_tpu.runtime.scheduler import GenRequest

    reqs = [GenRequest(prompt_ids=list(p), max_new_tokens=n) for p in prompts]
    for r in reqs:
        sched.submit(r)
    while any(r.state.value != "DONE" for r in reqs):
        sched.step()
    return [r.out_ids for r in reqs]


def jax_ids(model_dir):
    """jlama_tpu's single-device scheduler and its dp = 2 and dp = 2 x tp =
    2 shard_map schedulers on the same checkpoint and requests."""
    from jlama_tpu.models.loader import load_params
    from jlama_tpu.parallel.mesh import make_mesh
    from jlama_tpu.runtime.scheduler import GenRequest
    from tests.test_torch_tp_serving import _jax_quantize

    params, cfg = load_params(model_dir, float_dtype=jnp.float32)
    qparams = _jax_quantize(params)
    out = {}
    dp2 = make_mesh(jax.devices()[:2], dp=2, pp=1, tp=1)
    dp2tp2 = make_mesh(jax.devices()[:4], dp=2, pp=1, tp=2)
    for label, mesh in (("single", None), ("mesh", dp2)):
        s = _jax_sched(params, cfg, mesh)
        if mesh is not None:
            assert s._sm is not None and s._sm.dp_axis == "dp"  # shard_map, not GSPMD
        out["dp2", label] = {"batch": _jax_batch(s, R.DP_BATCH, 5),
                             "sessions": R.dp_sessions(s, GenRequest)}
    for label, mesh in (("single", None), ("mesh", dp2tp2)):
        s = _jax_sched(qparams, cfg, mesh)
        if mesh is not None:
            assert s._sm is not None and s._sm.dp_axis == "dp"
        out["dp2tp2", label] = {
            "q4": [s.generate(p, max_new_tokens=4).token_ids for p in R.DP_TP_PROMPTS],
            "concurrent": _jax_batch(s, R.CONCURRENT, 6)}
    return out


@pytest.mark.parametrize("case", ["dp2_batch", "dp2_sessions", "dp2tp2_q4"])
def test_dp_greedy_ids_match_jax(served, case):
    """test_dp_sharded_batch_parity (dp = 2, four requests on four slots),
    test_dp_sessions_pinned_to_group (sessions resumed, here three, one in
    group 1, through a RAM and a disk suspend) and test_dp_tp_combined_q4k
    (dp = 2 x tp = 2 on q4 projections, four ranks): the leader's greedy ids
    equal jlama_tpu's single-device scheduler's and its dp shard_map
    scheduler's."""
    ref, ranks, _ = served
    kind, what = ("dp2tp2", None) if case == "dp2tp2_q4" else ("dp2", case[len("dp2_"):])
    got = ranks[kind][0][kind]
    if what is not None:
        got, want = {what: got[what]}, {what: ref[kind, "single"][what]}
        mesh = {what: ref[kind, "mesh"][what]}
    else:
        want, mesh = ref[kind, "single"], ref[kind, "mesh"]
        got = {k: got[k] for k in want}
    assert got == want
    assert got == mesh
    if what == "sessions":
        # the sessions sat in both groups' page ranges and resumed there
        assert ranks[kind][0][kind]["session_groups"] == {"s1": 0, "s2": 0, "s3": 1}


@pytest.mark.parametrize("kind", list(WORLDS))
def test_each_rank_holds_its_group(served, kind):
    """Each rank holds n_pages/dp pages of n_kv/tp heads and runs n_slots/dp
    rows; the first tp rank of each group carries its ids to the leader;
    the ranks of one group sample the same ids step for step; dp at tp = 1
    keeps its graphs on (no collective inside a step), and so does dp x tp
    (on the card its steps' collectives cut them into segments); a disk
    suspend under dp wrote the session's group's file."""
    _, ranks, tmp = served
    dp, tp = WORLDS[kind]
    for r, res in enumerate(ranks[kind]):
        assert (res["dp_index"], res["tp_rank"], res["rows_member"]) == (r // tp, r % tp,
                                                                        r % tp == 0)
        assert res[kind + "/pool"] == (2, 2 // tp, R.MESH_SCHED["n_pages"] // dp, 8, 16)
        assert res[kind + "/rows"] == 4 // dp
        g = res[kind + "/graphs"]
        assert "eager_reason" not in g and g["graphs"] == 0  # graphs on; the CPU never captures
        lead = ranks[kind][r - r % tp]  # its group's first rank
        a, b = res[kind + "/log"], lead[kind + "/log"]
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    if kind == "dp2":
        # s3 lives in group 1: only that group's rank (global rank 1) wrote a file
        assert sorted(p.name for p in (tmp / kind / "off").iterdir()) == ["s3.kv.p1.npz"]
