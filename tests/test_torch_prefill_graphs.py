"""Prefill through `StepGraphs` (`jlama_tpu_torch/runtime/graphs.py`) on the
CPU: the `Engine`'s keys (slot, bucket, window) and the scheduler's (rows,
chunk, window), their static inputs and reuse, the warm-up that runs every
prefill key twice, the graphs' shared memory pool (torch.cuda's graph calls
stubbed), and a row near its page table's end, whose padded bucket keeps the
greedy ids of jlama_tpu's scheduler."""

import contextlib

import jax.numpy as jnp
import pytest
import torch

from tests.helpers import make_tiny_llama

PROMPT = [1, 3, 7, 12, 30, 44, 100, 9, 17, 5]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from jlama_tpu.models.loader import load_params as jload
    from jlama_tpu_torch.models.loader import load_params

    model_dir, _ = make_tiny_llama(tmp_path_factory.mktemp("tprefill_graphs"))
    jp, jcfg = jload(model_dir, float_dtype=jnp.float32)
    tp, tcfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    return jp, jcfg, tp, tcfg


def engine(ckpt, **kw):
    from jlama_tpu_torch.runtime.engine import Engine

    return Engine(ckpt[2], ckpt[3], device="cpu", max_seq_len=128, kv_dtype=torch.float32,
                  compute_dtype=torch.float32, **kw)


def sched(ckpt, **kw):
    from jlama_tpu_torch.runtime.scheduler import BatchScheduler

    args = dict(n_slots=4, n_pages=64, page_size=8, max_seq_len=64, kv_dtype=torch.float32,
                compute_dtype=torch.float32, device="cpu")
    return BatchScheduler(ckpt[2], ckpt[3], **dict(args, **kw))


def test_engine_prefill_keys_and_static_inputs(ckpt):
    eng = engine(ckpt)
    a = eng.generate_tokens(PROMPT, max_new_tokens=3, stop_ids=set(), session_id="a")
    key = (eng.sessions["a"].slot, 16, 16)  # 9 prompt tokens: bucket 16, window 16
    assert set(eng.prefill_graphs._inputs) == {key}
    inp = eng.prefill_graphs._inputs[key]
    assert inp.tokens[0, :9].tolist() == PROMPT[:-1] and inp.positions[0].tolist() == list(
        range(16))
    eng.drop_session("a")
    b = eng.generate_tokens(PROMPT, max_new_tokens=3, stop_ids=set(), session_id="b")
    assert b.token_ids == a.token_ids and eng.prefill_graphs._inputs[key] is inp
    st = eng.prefill_graphs.stats()
    assert (st["keys"], st["eager_steps"], st["replays"], st["graphs"]) == (1, 2, 0, 0)
    # a continuation of the session: its own key (start 12, bucket 16, window 32)
    eng.generate_tokens([4, 5, 6], max_new_tokens=2, stop_ids=set(), session_id="b")
    assert (eng.sessions["b"].slot, 16, 32) in eng.prefill_graphs._inputs
    # decode steps stay on the decode graphs' books
    assert eng.graphs.stats()["eager_steps"] == 3 + 3 + 2


def test_engine_prefill_past_the_graph_limit_runs_without_a_key(ckpt, monkeypatch):
    from jlama_tpu_torch.runtime import engine as engine_mod

    ref = engine(ckpt).generate_tokens(PROMPT, max_new_tokens=4, stop_ids=set())
    monkeypatch.setattr(engine_mod, "PREFILL_GRAPH_MAX", 8)
    eng = engine(ckpt)
    got = eng.generate_tokens(PROMPT, max_new_tokens=4, stop_ids=set())
    assert got.token_ids == ref.token_ids
    assert eng.prefill_graphs.stats()["keys"] == 0 and not eng.prefill_graphs._inputs


def test_scheduler_prefill_keys_and_warmup(ckpt):
    s = sched(ckpt, prefill_chunk=16)
    s.warmup()
    st = s.prefill_graphs.stats()
    # rows 1, 2, 4; chunk 16 (every shorter chunk rounds up to it); windows
    # 16, 32, 64: each key twice
    assert set(s.prefill_graphs._inputs) == {(r, 16, w) for r in (1, 2, 4)
                                             for w in (16, 32, 64)}
    assert st["keys"] == 9 and st["eager_steps"] == 18
    dec = s.graphs.stats()
    assert dec["keys"] == 3 * 10 and dec["eager_steps"] == 2 * 3 * 10  # 10 variants a window
    prompts = [PROMPT, [1, 2, 3], list(range(1, 30)), [1, 9]]
    ref = sched(ckpt, prefill_chunk=16)
    for p in prompts:
        assert s.generate(p, max_new_tokens=5).token_ids == ref.generate(
            p, max_new_tokens=5).token_ids
    assert s.prefill_graphs.stats()["keys"] == 9 and s.graphs.stats()["keys"] == 30
    inp = s.prefill_graphs._inputs[(1, 16, 32)]
    assert inp.page_tables.shape == (1, s.kv.max_pages_per_seq)


def test_row_near_its_table_end_keeps_a_bucket_and_jax_ids(ckpt):
    """A session at position 50 of a 64-token table takes 6 prompt tokens:
    the bucket of 16 would reach past the table, so the row runs alone (as in
    the JAX scheduler, which prefills it at its exact length); here with its
    pads, which the KV write drops past the table. The ids equal jlama_tpu's."""
    from jlama_tpu.runtime.scheduler import BatchScheduler as JSched
    from jlama_tpu.runtime.scheduler import GenRequest as JReq

    jp, jcfg = ckpt[0], ckpt[1]
    js = JSched(jp, jcfg, n_slots=4, n_pages=64, page_size=8, max_seq_len=64,
                kv_dtype=jnp.float32, compute_dtype=jnp.float32, prefill_chunk=16)

    def jgen(prompt, n):
        r = JReq(prompt_ids=prompt, max_new_tokens=n, session_id="s", stop_ids={-1})
        js.submit(r)
        while r.state.value != "DONE":
            js.step()
        return r.out_ids

    s = sched(ckpt, prefill_chunk=16)
    first = list(range(1, 41))
    assert s.generate(first, max_new_tokens=11, session_id="s",
                      stop_ids={-1}).token_ids == jgen(first, 11)
    assert s.session_state["s"][0] == 50
    calls = s.n_prefill_calls
    got = s.generate([7, 8, 9, 10, 11], max_new_tokens=4, session_id="s", stop_ids={-1})
    assert got.token_ids == jgen([7, 8, 9, 10, 11], 4)
    assert s.n_prefill_calls == calls + 1
    assert {k[1] for k in s.prefill_graphs._inputs} == {16}  # no (1, 5, 64)


class _FakeGraph:
    def replay(self):
        pass


@pytest.fixture
def fake_cuda(monkeypatch):
    """torch.cuda's graph calls replaced, as in tests/test_torch_graphs.py."""
    pools = []

    @contextlib.contextmanager
    def graph(g, pool=None, capture_error_mode="global"):
        pools.append(pool)
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    return pools


def test_prefill_and_decode_graphs_share_one_pool(ckpt, fake_cuda):
    """Capture bookkeeping of a prefill key: first use eager, second use a
    capture and its replay, third a replay; the prefill graphs and the decode
    graphs use one pool handle."""
    eng = engine(ckpt)
    eng.graphs.capture = eng.prefill_graphs.capture = True  # as on the card
    for sid in ("a", "b", "c"):
        eng.generate_tokens(PROMPT, max_new_tokens=2, stop_ids=set(), session_id=sid)
        eng.drop_session(sid)
    st = eng.prefill_graphs.stats()
    assert (st["keys"], st["eager_steps"], st["graphs"], st["replays"]) == (1, 1, 1, 2)
    assert eng.graphs.stats()["graphs"] == 1
    assert len(fake_cuda) == 2 and fake_cuda[0] is fake_cuda[1] is eng.graphs._pool[0]
    assert eng.prefill_graphs._pool is eng.graphs._pool
