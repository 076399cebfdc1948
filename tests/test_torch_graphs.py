"""The static-buffer decode steps that the port captures as CUDA graphs
(`jlama_tpu_torch/runtime/graphs.py`), on the CPU: there they run eagerly on
the same static inputs, and their ids are held against jlama_tpu's `Engine`
and `BatchScheduler` on the same tiny checkpoint in f32. The capture and
replay bookkeeping of the launch counters is tested with a stand-in for
torch.cuda's graph calls."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_tiny_llama

from jlama_tpu_torch.runtime.graphs import DecodeInputs, StepGraphs
from jlama_tpu_torch.runtime.scheduler import BatchScheduler, GenRequest, RequestState

PROMPT = [1, 3, 7, 12, 30, 44, 100, 9, 17, 5]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from jlama_tpu.models.loader import load_params as jload
    from jlama_tpu_torch.models.loader import load_params

    model_dir, _ = make_tiny_llama(tmp_path_factory.mktemp("tiny_torch_graphs"))
    jp, jcfg = jload(model_dir, float_dtype=jnp.float32)
    tp, tcfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    return jp, jcfg, tp, tcfg


def jax_engine(ckpt, **kw):
    from jlama_tpu.runtime.engine import Engine as JEngine

    jp, jcfg, _, _ = ckpt
    return JEngine(jp, jcfg, max_seq_len=128, kv_dtype=jnp.float32, compute_dtype=jnp.float32,
                   **kw)


def torch_engine(ckpt, **kw):
    from jlama_tpu_torch.runtime.engine import Engine

    _, _, tp, tcfg = ckpt
    return Engine(tp, tcfg, device="cpu", max_seq_len=128, kv_dtype=torch.float32,
                  compute_dtype=torch.float32, **kw)


@pytest.mark.parametrize("chunk", [1, 3, 32])
def test_engine_static_steps_match_jax_across_window_buckets(ckpt, chunk, monkeypatch):
    """20 greedy tokens after a 10-token prompt: positions 9-28 cross the
    16-token window bucket, so chunks of 1 and 3 take two step keys."""
    monkeypatch.setenv("JLAMA_DEVICE_CHUNK", str(chunk))
    ref = jax_engine(ckpt).generate_tokens(PROMPT, max_new_tokens=20, stop_ids=set())
    eng = torch_engine(ckpt)
    got = eng.generate_tokens(PROMPT, max_new_tokens=20, stop_ids=set())
    assert got.token_ids == ref.token_ids
    # every step ran eagerly on the CPU, from the static inputs
    st = eng.graphs.stats()
    assert (st["eager_steps"], st["replays"], st["graphs"]) == (20, 0, 0)
    wins = {1: {16, 32}, 3: {16, 32}, 32: {32}}[chunk]
    assert st["keys"] == len(wins)
    assert eng._in.history[0, :20].tolist() == got.token_ids
    assert int(eng._in.positions[0, 0]) == len(PROMPT) - 1 + 20
    assert eng.sessions and all(not s.on_host for s in eng.sessions.values())


def test_engine_recycled_slot_matches_fresh_jax_session(ckpt):
    eng = torch_engine(ckpt, max_device_sessions=2)
    eng.generate_tokens(PROMPT, max_new_tokens=12, session_id="a", stop_ids=set())
    slot_a = eng.sessions["a"].slot
    eng.drop_session("a")
    b = eng.generate_tokens([1, 8, 2, 60], max_new_tokens=8, session_id="b", stop_ids=set())
    assert eng.sessions["b"].slot == slot_a and len(eng._slot_bufs) == 1
    ref = jax_engine(ckpt).generate_tokens([1, 8, 2, 60], max_new_tokens=8, session_id="b",
                                           stop_ids=set())
    assert b.token_ids == ref.token_ids
    assert eng.sessions["b"].position == 4 + 8 - 1


def test_engine_lru_offload_and_resume_match_jax(ckpt):
    eng = torch_engine(ckpt, max_device_sessions=1)
    jeng = jax_engine(ckpt, max_device_sessions=1)
    turns = [("a", PROMPT, 5), ("b", [1, 2, 3], 6), ("a", [4, 9], 7)]
    for sid, prompt, n in turns:
        got = eng.generate_tokens(prompt, max_new_tokens=n, session_id=sid, stop_ids=set())
        ref = jeng.generate_tokens(prompt, max_new_tokens=n, session_id=sid, stop_ids=set())
        assert got.token_ids == ref.token_ids
        assert eng.sessions[sid].position == jeng.sessions[sid].position
    # one slot throughout: b was offloaded when a resumed, into a's old slot
    assert len(eng._slot_bufs) == 1
    assert eng.sessions["b"].on_host and eng.sessions["b"].host is not None
    assert not eng.sessions["a"].on_host and eng.sessions["a"].slot == 0


def test_scheduler_chained_windows_match_jax(ckpt):
    """Three greedy requests decoded in chained windows of 4 (pages of 8):
    the chain crosses the 32-token window bucket and rebuilds its page
    tables; the ids equal jlama_tpu's BatchScheduler."""
    from jlama_tpu.runtime.scheduler import BatchScheduler as JSched
    from jlama_tpu.runtime.scheduler import GenRequest as JReq

    jp, jcfg, tp, tcfg = ckpt
    prompts = [[1, 5, 9, 42, 7, 3], [3, 3, 8, 90, 14, 2, 61, 7, 7], PROMPT + [2, 8]]
    kw = dict(n_slots=4, n_pages=64, page_size=8, max_seq_len=64, decode_lag=4)
    js = JSched(jp, jcfg, kv_dtype=jnp.float32, compute_dtype=jnp.float32, **kw)
    jreqs = [JReq(prompt_ids=p, max_new_tokens=24) for p in prompts]
    for r in jreqs:
        js.submit(r)
    while any(r.state.value != "DONE" for r in jreqs):
        js.step()

    sched = BatchScheduler(tp, tcfg, kv_dtype=torch.float32, compute_dtype=torch.float32,
                           device="cpu", **kw)
    chained = []
    inner = sched._chain_steps

    def spy(win, depth, pts=None):
        if pts is not None:
            chained.append((win, depth, pts[pts > 0].size))
        return inner(win, depth, pts)

    sched._chain_steps = spy
    reqs = [GenRequest(prompt_ids=p, max_new_tokens=24) for p in prompts]
    for r in reqs:
        sched.submit(r)
    for _ in range(400):
        if all(r.state == RequestState.DONE for r in reqs):
            break
        sched.step()
    assert [r.out_ids for r in reqs] == [r.out_ids for r in jreqs]
    wins = [w for w, _, _ in chained]
    assert {32, 64} <= set(wins) and wins == sorted(wins)  # a bucket change, chained
    assert len({n for _, _, n in chained}) > 1  # tables rebuilt as pages were taken
    st = sched.graphs.stats()
    assert st["eager_steps"] == sched.n_decode_steps and st["replays"] == 0


def test_decode_inputs_load_and_advance():
    s = DecodeInputs(3, "cpu", pages=2, history=5)
    s.load(tokens=np.array([[4], [5], [6]], np.int32), positions=[[0], [7], [9]],
           steps=[0, 1, 2], temps=np.float32([0.5, 0, 1]), page_tables=np.ones((3, 2)))
    assert s.page_tables.dtype == torch.int32 and s.page_tables.sum() == 6
    s.advance(torch.tensor([11, 12, 13]))
    s.advance(torch.tensor([21, 22, 23]))
    assert s.tokens[:, 0].tolist() == [21, 22, 23]
    assert s.positions[:, 0].tolist() == [2, 9, 11] and s.steps.tolist() == [2, 3, 4]
    assert s.history.tolist() == [[11, 21, 0, 0, 0], [0, 12, 22, 0, 0], [0, 0, 13, 23, 0]]
    assert s.temps.tolist() == [0.5, 0.0, 1.0]


class _Counter:
    def __init__(self):
        self.launches = 0


class _FakeGraph:
    """torch.cuda.CUDAGraph's stand-in: replay() counts."""

    def __init__(self):
        self.replays = 0

    def capture_begin(self, *pool, capture_error_mode="global"):
        pass

    def capture_end(self):
        pass

    def replay(self):
        self.replays += 1


@pytest.fixture
def fake_cuda(monkeypatch):
    """torch.cuda's graph calls replaced, so that StepGraphs' bookkeeping
    runs on the CPU; records each capture's keyword arguments. As
    torch.cuda.graph does, the fake begins and ends the capture on the
    object it is given."""
    captured = []

    @contextlib.contextmanager
    def graph(g, pool=None, capture_error_mode="global"):
        captured.append(dict(pool=pool, mode=capture_error_mode))
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
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 1000 * len(captured))
    return captured


def test_counters_capture_and_replay_bookkeeping(fake_cuda):
    a, b = _Counter(), _Counter()
    g = StepGraphs("cpu", counters=(a, b))
    g.capture = True  # as on the card
    runs = []

    def step():  # two launches of a, one of b, a fresh output
        a.launches += 2
        b.launches += 1
        runs.append(len(runs))
        return torch.tensor([len(runs)])

    first = g.run("k", step)  # first use: eager
    assert (a.launches, b.launches, g.eager_steps, g.stats()["graphs"]) == (2, 1, 1, 0)
    second = g.run("k", step)  # second use: capture (fn runs once, into the graph), replay
    third = g.run("k", step)  # replay only
    assert len(runs) == 2 and int(first) == 1 and int(second) == 2 and third is second
    # per replay exactly what an eager step counts; the capture itself counts nothing
    assert (a.launches, b.launches) == (6, 3)
    graph = g._graphs["k"][0]
    assert graph.replays == 2 and g.replays == 2 and g.eager_steps == 1
    assert fake_cuda == [dict(pool=("pool",), mode="thread_local")]
    assert g.stats()["pool_bytes"] == 1000
    # a second key shares the pool
    g.run("k2", step)
    g.run("k2", step)
    assert [c["pool"] for c in fake_cuda] == [("pool",)] * 2
    assert g.stats() | {"capture_s": 0} == dict(graphs=2, keys=2, segments=2, eager_steps=2,
                                                replays=3, capture_s=0, pool_bytes=2000)
    assert (a.launches, b.launches) == (10, 5)


def test_failed_capture_raises_and_runs_nothing_eagerly(fake_cuda):
    a = _Counter()
    g = StepGraphs("cpu", counters=(a,))
    g.capture = True
    calls = []

    def step():
        a.launches += 1
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("operation not permitted when stream is capturing")
        return torch.zeros(1)

    g.run("k", step)
    with pytest.raises(RuntimeError, match="capturing"):
        g.run("k", step)
    # the counter is put back, no eager step ran, no graph was kept
    assert (a.launches, g.eager_steps, g.replays, g.stats()["graphs"]) == (1, 1, 0, 0)


def test_eager_yardstick_and_cpu_never_capture(fake_cuda):
    a = _Counter()
    for g in (StepGraphs("cpu", counters=(a,)), StepGraphs("cpu", graphs=False, counters=(a,))):
        assert not g.capture
        for _ in range(3):
            g.run("k", lambda: a.__setattr__("launches", a.launches + 1))
        assert (g.eager_steps, g.replays) == (3, 0)
    assert a.launches == 6 and not fake_cuda
