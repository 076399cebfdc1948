"""Graphs of the mesh steps (`jlama_tpu_torch/runtime/graphs.py`): a step's
collectives and hand-overs are boundary ops that cut its capture into
segments, which replay in capture order with the ops run between them.

On the CPU: the segmented capture's bookkeeping with torch.cuda's graph
calls stubbed (a boundary ends a segment, its buffers are made outside the
capture, its op is not run while capturing and runs between the segments'
replays, each segment counts its own launches); the boundary plan of a tp
decode step (2 L + 2 collectives) and of a pp stage's steps (receive,
layers, send), recorded on two gloo rank processes, the same ops, shapes
and order on every rank; greedy ids of the mesh schedulers built with
`decode_graphs=True` (which raised under tp and pp before) against
jlama_tpu's tp and pp schedulers on the tiny llama. The card's tests are
tests/test_torch_cuda_mesh_graphs.py.
"""

import contextlib
import pickle

import pytest
import torch

from jlama_tpu_torch.runtime import graphs as G
from tests.torch_tp_ranks import start_ranks, wait_ranks


class _Counter:
    def __init__(self):
        self.launches = 0


class _FakeGraph:
    """torch.cuda.CUDAGraph's stand-in: it logs its begin, end and replays."""

    log: list = []

    def __init__(self):
        self.n = sum(1 for e in _FakeGraph.log if e[0] == "begin")

    def capture_begin(self, *pool, capture_error_mode="global"):
        _FakeGraph.log.append(("begin", self.n, pool, capture_error_mode))

    def capture_end(self):
        _FakeGraph.log.append(("end", self.n))

    def replay(self):
        _FakeGraph.log.append(("replay", self.n))


@pytest.fixture
def fake_cuda(monkeypatch):
    """torch.cuda's graph calls stubbed; the fake `torch.cuda.graph` begins
    and ends the capture on the object it is given, as the real one does."""
    _FakeGraph.log = []

    @contextlib.contextmanager
    def graph(g, pool=None, capture_error_mode="global"):
        g.capture_begin(pool, capture_error_mode=capture_error_mode)
        try:
            yield
        finally:
            g.capture_end()

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool",))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    return _FakeGraph.log


def test_segmented_capture_and_replay_order(fake_cuda):
    """A step with two boundary ops: its first use runs each op at once; its
    capture makes each op's buffers between the segments but runs no op;
    each replay runs segment 0, op 0, segment 1, op 1, segment 2, and adds
    each segment's launches."""
    a = _Counter()
    g = G.StepGraphs("cpu", counters=(a,))
    g.capture = True  # as on the card
    events = []

    def op(i):
        def build():
            events.append(("build", i, G.capturing()))
            buf = torch.zeros(1)

            def run():
                events.append(("op", i))
                buf.add_(1)
            return run, buf
        return G.boundary(("op", i), build)

    def step():
        a.launches += 1
        first = op(0)
        a.launches += 2
        op(1)
        a.launches += 4
        return first

    out0 = g.run("k", step)  # eager
    assert events == [("build", 0, False), ("op", 0), ("build", 1, False), ("op", 1)]
    assert int(out0) == 1 and a.launches == 7
    events.clear()
    with G.record_plan() as plan:
        out1 = g.run("k", step)  # capture, then the first replay
    assert plan == [("op", 0), ("op", 1)]
    assert events == [("build", 0, True), ("build", 1, True), ("op", 0), ("op", 1)]
    assert [e[:2] for e in fake_cuda] == [("begin", 0), ("end", 0), ("begin", 1), ("end", 1),
                                          ("begin", 2), ("end", 2), ("replay", 0),
                                          ("replay", 1), ("replay", 2)]
    # every segment in the owner's one pool, capture mode thread_local
    assert all(e[2:] == ((("pool",),), "thread_local") for e in fake_cuda if e[0] == "begin")
    segs = g._graphs["k"][0]
    assert segs.deltas == [(1,), (2,), (4,)] and a.launches == 14
    events.clear()
    fake_cuda.clear()
    assert g.run("k", step) is out1 and int(out1) == 2  # a replay: the op's own buffer
    assert events == [("op", 0), ("op", 1)] and a.launches == 21
    assert [e[0] for e in fake_cuda] == ["replay"] * 3
    st = g.stats()
    assert (st["graphs"], st["segments"], st["replays"], st["eager_steps"]) == (1, 3, 2, 1)


def test_failure_between_segments_raises_and_keeps_nothing(fake_cuda):
    """A boundary whose buffers cannot be made fails the capture: it raises,
    no graph is kept, the counters are put back and nothing runs eagerly."""
    a = _Counter()
    g = G.StepGraphs("cpu", counters=(a,))
    g.capture = True
    calls = []

    def step():
        a.launches += 1
        calls.append(1)

        def build():
            if G.capturing():
                raise RuntimeError("no buffer while capturing")
            return (lambda: None), None
        G.boundary(("op",), build)

    g.run("k", step)
    with pytest.raises(RuntimeError, match="no buffer"):
        g.run("k", step)
    assert (a.launches, len(calls), g.eager_steps, g.stats()["graphs"]) == (1, 2, 1, 0)
    assert not G.capturing()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both worlds' rank results (tp = 2 and pp = 2 at once), and the
    references computed here while they run."""
    from tests import torch_mesh_graph_ranks as R
    from tests.helpers import make_tiny_llama

    tmp = tmp_path_factory.mktemp("mesh_graphs")
    model_dir, _ = make_tiny_llama(tmp / "model")
    procs, ends = [], []
    for kind in ("tp", "pp"):
        p, end = start_ranks(R.rank_main, lambda r: (r, kind, str(tmp / f"{kind}_store"),
                                                     str(model_dir), str(tmp / f"{kind}{r}.pkl")))
        procs.append(p)
        ends.append(end)
    try:
        ref = _references(model_dir)
    finally:
        for p, end in zip(procs, ends):
            wait_ranks(p, end)
    out = {}
    for kind in ("tp", "pp"):
        out[kind] = []
        for r in range(R.WORLD):
            with open(tmp / f"{kind}{r}.pkl", "rb") as f:
                out[kind].append(pickle.load(f))
    return ref, out


def _references(model_dir):
    """jlama_tpu's tp = 2 scheduler, its pipelined pp = 2 scheduler and its
    tp = 2 Engine on the virtual CPU devices, and the port's one-device
    Engine (the pp Engine's stages pass the hidden state on bit for bit)."""
    import jax
    import jax.numpy as jnp
    from jlama_tpu.models.loader import load_params
    from jlama_tpu.parallel.mesh import make_mesh, shard_params
    from jlama_tpu.runtime.engine import Engine as JEngine
    from jlama_tpu.runtime.pipelined import PipelinedScheduler
    from jlama_tpu.runtime.scheduler import BatchScheduler, GenRequest

    from jlama_tpu_torch.models.loader import load_params as tload
    from jlama_tpu_torch.runtime.engine import Engine
    from tests import torch_mesh_graph_ranks as R

    params, cfg = load_params(model_dir, float_dtype=jnp.float32)
    kw = dict(R.SCHED, kv_dtype=jnp.float32, compute_dtype=jnp.float32)

    def run(sched):
        ids = [sched.generate(p, max_new_tokens=R.NEW).token_ids for p in R.PROMPTS]
        reqs = [GenRequest(prompt_ids=list(p), max_new_tokens=R.NEW) for p in R.PROMPTS]
        for r in reqs:
            sched.submit(r)
        while any(r.state.value != "DONE" for r in reqs):
            sched.step()
        return ids, [r.out_ids for r in reqs]

    tp_mesh = make_mesh(jax.devices()[:R.WORLD], dp=1, pp=1, tp=R.WORLD)
    tp = BatchScheduler(shard_params(params, cfg, tp_mesh), cfg, mesh=tp_mesh, **kw)
    assert tp._sm is not None  # the shard_map path
    pp_mesh = make_mesh(jax.devices()[:R.WORLD], dp=1, pp=R.WORLD, tp=1)
    ref = {"tp": run(tp), "pp": run(PipelinedScheduler(params, cfg, mesh=pp_mesh, **kw))}
    jeng = JEngine(params, cfg, max_seq_len=64, kv_dtype=jnp.float32,
                   compute_dtype=jnp.float32, mesh=tp_mesh)
    ref["engine", "tp"] = jeng.generate_tokens(R.PROMPTS[0], max_new_tokens=R.NEW).token_ids
    tparams, tcfg = tload(model_dir, device="cpu", float_dtype=torch.float32)
    eng = Engine(tparams, tcfg, device="cpu", max_seq_len=64, kv_dtype=torch.float32,
                 compute_dtype=torch.float32)
    ref["engine", "pp"] = eng.generate_tokens(R.PROMPTS[0], max_new_tokens=R.NEW).token_ids
    return ref


def test_tp_decode_step_plan_is_2L_plus_2_collectives(ranks):
    """One tp decode step's boundaries: the vocabulary-sharded embedding's
    all-reduce, wo's and w2's per layer, the logits' all-gather, the same
    on both ranks; a prefill call's are the same ops at its [rows, T]."""
    _, out = ranks
    lead, other = out["tp"]
    L, B = lead["n_layers"], 2
    plan = lead["decode_plan"]
    assert plan == other["decode_plan"] and len(plan) == 2 * L + 2
    assert [p[0] for p in plan] == ["all_reduce"] * (2 * L + 1) + ["all_gather"]
    assert all(p[1][:2] == (B, 1) and p[2] == torch.float32 for p in plan)
    assert plan[-1][1] == (B, 1, 256 // 2)  # this rank's half of the vocabulary
    pf = lead["prefill_plan"]
    assert pf == other["prefill_plan"] and len(pf) == 2 * L + 1  # no logits
    assert all(p == ("all_reduce", (B, 8, plan[0][1][2]), torch.float32) for p in pf)


def test_pp_stage_plans_receive_layers_send(ranks):
    """A pp stage's boundaries: stage 0 hands its hidden state on and (in a
    decode step) takes the ids back; the last stage receives, runs its
    layers, and sends the ids to stage 0 (a prefill call: receive only).
    Each exchange of one stage meets its counterpart on the other, in the
    same order with the same shapes."""
    _, out = ranks
    s0, s1 = out["pp"]
    B, D = 2, 64
    act = ((B, 1, D), torch.float32)
    assert s0["decode_plan"] == [("exchange", (("send_next", *act),)),
                                 ("exchange", (("recv_last", (B,), torch.int64),))]
    assert s1["decode_plan"] == [("exchange", (("recv_prev", *act),)),
                                 ("exchange", (("send_first", (B,), torch.int64),))]
    assert s0["prefill_plan"] == [("exchange", (("send_next", (B, 8, D), torch.float32),))]
    assert s1["prefill_plan"] == [("exchange", (("recv_prev", (B, 8, D), torch.float32),))]
    pair = {"send_next": "recv_prev", "send_first": "recv_last", "recv_prev": "send_next",
            "recv_last": "send_first"}
    for name in ("serial", "pipe"):
        a, b = s0[name + "/plan"], s1[name + "/plan"]
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert sorted((pair[n], s, d) for n, s, d in x[1]) == sorted(y[1]), (name, x, y)


def test_tp_session_plan_is_the_same_on_every_rank(ranks):
    _, out = ranks
    lead, other = out["tp"]
    assert lead["serial/plan"] == other["serial/plan"] and len(lead["serial/plan"]) > 0


def test_graphed_mesh_schedulers_match_jax(ranks):
    """Built with decode_graphs=True (no longer refused), the tp scheduler
    gives jlama_tpu's tp = 2 scheduler's greedy ids, and the pipelined and
    the stage-serial pp schedulers its pipelined pp = 2 scheduler's; the
    Engine gives jlama_tpu's tp = 2 Engine's ids at tp and one device's at
    pp; the owners give no reason to run eagerly (the CPU never
    captures)."""
    ref, out = ranks
    lead = out["tp"][0]
    assert (lead["serial/ids"], lead["serial/concurrent"]) == ref["tp"]
    s0 = out["pp"][0]
    assert (s0["serial/ids"], s0["serial/concurrent"]) == ref["pp"]
    assert (s0["pipe/ids"], s0["pipe/concurrent"]) == ref["pp"]
    for kind in ("tp", "pp"):
        for res in out[kind]:
            assert res["engine/ids"] == ref["engine", kind]
            for key in [k for k in res if k.endswith("/graphs")]:
                assert "eager_reason" not in res[key] and res[key]["graphs"] == 0, key
