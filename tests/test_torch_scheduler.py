"""The port's BatchScheduler on the CPU (analogs of tests/test_scheduler.py),
held against the port's Engine and, for greedy ids, against jlama_tpu's
BatchScheduler on the same tiny checkpoint in f32 (4 slots, pages of 8)."""

import time

import jax.numpy as jnp
import pytest
import torch

from tests.helpers import make_tiny_llama

from jlama_tpu_torch.runtime.engine import FinishReason
from jlama_tpu_torch.runtime.scheduler import BatchScheduler, GenRequest, RequestState

PROMPT = [1, 5, 9, 42, 7]
CONCURRENT = [[1, 5, 9], [1, 7, 30, 12], [1, 2], [1, 44, 17, 80, 3]]
LONG = [1] + [(i * 7) % 200 + 2 for i in range(40)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from jlama_tpu_torch.models.loader import load_params
    from jlama_tpu_torch.runtime.engine import Engine

    model_dir, _ = make_tiny_llama(tmp_path_factory.mktemp("tiny_torch_sched"))
    params, cfg = load_params(model_dir, device="cpu", float_dtype=torch.float32)
    eng = Engine(params, cfg, device="cpu", max_seq_len=64, kv_dtype=torch.float32,
                 compute_dtype=torch.float32)
    return model_dir, params, cfg, eng


def mk(setup, **kw):
    _, params, cfg, _ = setup
    args = dict(n_slots=4, n_pages=64, page_size=8, max_seq_len=64, kv_dtype=torch.float32,
                compute_dtype=torch.float32, device="cpu")
    args.update(kw)
    return BatchScheduler(params, cfg, **args)


def run_all(sched, reqs, limit=400):
    for _ in range(limit):
        if all(r.state == RequestState.DONE for r in reqs):
            return
        sched.step()
    raise AssertionError("requests did not finish")


def engine_ids(setup, prompt, n, sid):
    return setup[3].generate_tokens(prompt, max_new_tokens=n, session_id=sid).token_ids


@pytest.fixture(scope="module")
def jax_ids(setup):
    """jlama_tpu's BatchScheduler on the same checkpoint and requests."""
    from jlama_tpu.models.loader import load_params
    from jlama_tpu.runtime.scheduler import BatchScheduler as JSched
    from jlama_tpu.runtime.scheduler import GenRequest as JReq

    params, cfg = load_params(setup[0], float_dtype=jnp.float32)
    kw = dict(n_slots=4, n_pages=64, page_size=8, max_seq_len=64, kv_dtype=jnp.float32,
              compute_dtype=jnp.float32)
    js = JSched(params, cfg, **kw)
    out = {"single": js.generate(PROMPT, max_new_tokens=8).token_ids}
    reqs = [JReq(prompt_ids=p, max_new_tokens=6) for p in CONCURRENT]
    for r in reqs:
        js.submit(r)
    while any(r.state.value != "DONE" for r in reqs):
        js.step()
    out["concurrent"] = [r.out_ids for r in reqs]
    a = js.generate([1, 3, 7], max_new_tokens=1, session_id="s1").token_ids
    b = js.generate([12, 30, 44], max_new_tokens=4, session_id="s1").token_ids
    out["session"] = (a, b)
    chunked = JSched(params, cfg, **dict(kw, n_slots=2, prefill_chunk=8))
    out["chunked"] = chunked.generate(LONG, max_new_tokens=5).token_ids
    return out


def test_greedy_matches_engine_and_jax(setup, jax_ids):
    got = mk(setup).generate(PROMPT, max_new_tokens=8)
    assert got.token_ids == jax_ids["single"] == engine_ids(setup, PROMPT, 8, "single")
    assert got.finish_reason == FinishReason.MAX_TOKENS and got.prompt_tokens == len(PROMPT)


def test_concurrent_requests_interleave(setup, jax_ids):
    sched = mk(setup)
    reqs = [GenRequest(prompt_ids=p, max_new_tokens=6) for p in CONCURRENT]
    for r in reqs:
        sched.submit(r)
    run_all(sched, reqs)
    assert [r.out_ids for r in reqs] == jax_ids["concurrent"]
    assert [r.out_ids for r in reqs] == [engine_ids(setup, p, 6, f"cc{i}")
                                         for i, p in enumerate(CONCURRENT)]
    assert sched.n_prefill_calls == 1  # one batched prefill for all four


def test_session_resume_matches_engine_and_jax(setup, jax_ids):
    sched = mk(setup, n_slots=2)
    a = sched.generate([1, 3, 7], max_new_tokens=1, session_id="s1")
    b = sched.generate([12, 30, 44], max_new_tokens=4, session_id="s1")
    assert (a.token_ids, b.token_ids) == jax_ids["session"]
    ref_a = engine_ids(setup, [1, 3, 7], 1, "eng_s1")
    assert (a.token_ids, b.token_ids) == (ref_a, engine_ids(setup, [12, 30, 44], 4, "eng_s1"))
    pos, pending = sched.session_state["s1"]
    assert (pos, pending) == (3 + 1 + 3 + 4 - 1, b.token_ids[-1])


def test_chunked_prefill_matches_one_shot(setup, jax_ids):
    got = mk(setup, n_slots=2, prefill_chunk=8)
    ids = got.generate(LONG, max_new_tokens=5).token_ids
    assert ids == jax_ids["chunked"] == engine_ids(setup, LONG, 5, "chunk_ref")
    assert got.n_prefill_calls == 5  # 40 prompt tokens before the last, 8 at a time


def test_slot_reuse_and_page_release(setup):
    sched = mk(setup)
    free_before = sched.kv.alloc.n_free
    for _ in range(6):  # more requests than slots, one after another
        assert sched.generate([1, 9, 13], max_new_tokens=3).generated_tokens == 3
    assert sched.kv.alloc.n_free == free_before  # all pages returned
    assert all(s is None for s in sched.slots)


def test_late_arrival_joins_running_batch(setup):
    sched = mk(setup)
    a = GenRequest(prompt_ids=[1, 5, 9], max_new_tokens=10)
    b = GenRequest(prompt_ids=[1, 7, 30], max_new_tokens=5)
    sched.submit(a)
    sched.step()  # a decodes alone
    sched.step()
    assert a.out_ids and b.state == RequestState.QUEUED
    sched.submit(b)  # b joins mid-flight
    run_all(sched, [a, b])
    assert a.out_ids == engine_ids(setup, [1, 5, 9], 10, "late_a")
    assert b.out_ids == engine_ids(setup, [1, 7, 30], 5, "late_b")


def test_suspend_resume_in_ram(setup):
    """Offloaded session pages restore exactly: the conversation continues
    as if nothing had moved."""
    s2 = mk(setup, n_slots=2, n_pages=32, max_seq_len=48)
    s2.generate([1, 3, 7, 9], max_new_tokens=2, session_id="off1")
    free_mid = s2.kv.alloc.n_free
    assert s2.suspend_session("off1")
    assert s2.kv.alloc.n_free > free_mid and "off1" in s2._suspended
    payload = s2._suspended["off1"][0]
    assert payload[0] == "ram" and payload[1].shape[:3] == (2, 2, 1)  # [L, n_kv, pages, ...]
    # already suspended: nothing to suspend again, to RAM or to disk
    assert not s2.suspend_session("off1") and not s2.suspend_session("off1", to_dir="unused")
    assert s2.resume_session("off1")
    b = s2.generate([12, 30], max_new_tokens=4, session_id="off1")

    s3 = mk(setup, n_slots=2, n_pages=32, max_seq_len=48)
    s3.generate([1, 3, 7, 9], max_new_tokens=2, session_id="ref1")
    b2 = s3.generate([12, 30], max_new_tokens=4, session_id="ref1")
    assert b.token_ids == b2.token_ids


def test_prefill_interleaves_with_decode(setup):
    """While a long prompt prefills in chunks, a running request keeps
    decoding."""
    s2 = mk(setup, n_slots=2, prefill_chunk=4)
    a = GenRequest(prompt_ids=[1, 5], max_new_tokens=20)
    s2.submit(a)
    s2.step()
    tokens_before = len(a.out_ids)
    b = GenRequest(prompt_ids=[1] + list(range(2, 40)), max_new_tokens=2)
    s2.submit(b)
    saw_interleave = False
    for _ in range(6):
        s2.step()
        if b.state == RequestState.PREFILLING and len(a.out_ids) > tokens_before:
            saw_interleave = True
    assert saw_interleave
    run_all(s2, [a, b])


class _CharTok:
    """Trivial tokenizer: id -> one ASCII char (for stop-string tests)."""

    def decode(self, ids, skip_special=True):
        return "".join(chr(65 + (i % 26)) for i in ids)


def test_stop_strings_and_stop_ids(setup):
    s2 = mk(setup, n_slots=2, tokenizer=_CharTok())
    base = s2.generate([1, 5, 9], max_new_tokens=10, stop_ids={-1})
    full_text = _CharTok().decode(base.token_ids)
    stop = full_text[2:4]
    r = GenRequest(prompt_ids=[1, 5, 9], max_new_tokens=10, stop_strings=[stop],
                   stop_ids={-1})
    s2.submit(r)
    run_all(s2, [r])
    assert r.finish == FinishReason.STOP_TOKEN
    resp = r.to_response(_CharTok())
    assert stop not in resp.response_text
    assert resp.response_text == full_text[: full_text.find(stop)]
    # a stop id ends the request with that token, and the session's pages stay
    tok = base.token_ids[3]
    s = s2.generate([1, 5, 9], max_new_tokens=10, stop_ids={tok})
    assert s.finish_reason == FinishReason.STOP_TOKEN
    assert s.token_ids == base.token_ids[: base.token_ids.index(tok) + 1]


def test_seed_reproducible_across_batch_composition(setup):
    """A seeded request samples the same tokens whether it runs alone or
    beside others (per-row streams keyed by seed and step)."""
    def run(extra: bool, lag: int):
        s2 = mk(setup, decode_lag=lag)
        r = GenRequest(prompt_ids=[1, 5, 9], max_new_tokens=6, temperature=0.9, seed=1234,
                       top_p=0.9, top_k=20)
        s2.submit(r)
        if extra:
            for i in range(2):
                s2.submit(GenRequest(prompt_ids=[1, 7 + i], max_new_tokens=6, temperature=0.7,
                                     seed=i))
        run_all(s2, [r])
        return r.out_ids

    alone = run(False, 4)
    assert alone == run(True, 4) == run(True, 1)
    other = mk(setup).generate([1, 5, 9], max_new_tokens=6, temperature=0.9, seed=99,
                               top_p=0.9, top_k=20)
    assert other.token_ids != alone


def test_frequency_penalty_forbids_repeats(setup):
    s2 = mk(setup, n_slots=2)
    r = GenRequest(prompt_ids=[1, 5, 9], max_new_tokens=12, frequency_penalty=1000.0,
                   stop_ids={-1})
    s2.submit(r)
    steps = 0
    while r.state != RequestState.DONE:
        s2.step()
        steps += 1
    assert len(set(r.out_ids)) == len(r.out_ids) == 12
    assert s2.n_decode_steps == 12 and steps == 12  # penalties force depth-1 windows
    # the slot's counts are reset for the next request that uses penalties
    r2 = s2.generate([1, 5, 9], max_new_tokens=12, presence_penalty=1000.0, stop_ids={-1})
    assert r2.token_ids == r.out_ids


def test_session_lru_eviction(setup):
    """Beyond max_sessions, idle sessions suspend to host RAM and resume on
    their next use."""
    s2 = mk(setup, n_slots=2, max_sessions=2)
    for i in range(4):
        s2.generate([1, 5 + i], max_new_tokens=2, session_id=f"lru{i}")
    assert len(s2.session_state) <= 2
    assert "lru0" in s2._suspended and "lru1" in s2._suspended
    r = s2.generate([30], max_new_tokens=2, session_id="lru0")
    assert r.finish_reason == FinishReason.MAX_TOKENS
    ref = mk(setup, n_slots=2)
    ref.generate([1, 5], max_new_tokens=2, session_id="x")
    assert ref.generate([30], max_new_tokens=2, session_id="x").token_ids == r.token_ids
    s2.drop_session("lru0")
    assert "lru0" not in s2.session_state and not s2.kv.alloc.pages_for("lru0")


@pytest.mark.parametrize("concurrent", [False, True])
def test_decode_lag_matches_step_by_step(setup, concurrent):
    """Chained windows (device-fed tokens, the host one window behind) give
    the tokens of depth-1 stepping, early stops included."""
    prompts = [[1, 5, 9, 42, 7], [3, 3, 8], [2, 30, 17, 4]]
    for temp in (0.0, 0.9):
        got = {}
        for lag in (1, 4):
            sched = mk(setup, n_slots=3, decode_lag=lag, fuse=False)
            if concurrent:
                reqs = [GenRequest(prompt_ids=p, max_new_tokens=10, temperature=temp,
                                   seed=11 + i) for i, p in enumerate(prompts)]
                for r in reqs:
                    sched.submit(r)
                run_all(sched, reqs)
                got[lag] = [(r.out_ids, r.finish) for r in reqs]
            else:
                got[lag] = [(g.token_ids, g.finish_reason) for g in (
                    sched.generate(p, max_new_tokens=10, temperature=temp, seed=11 + i)
                    for i, p in enumerate(prompts))]
            assert sched.kv.alloc.n_free == 63
        assert got[1] == got[4]
    if not concurrent:
        stop = got[1][0][0][4]  # an early stop inside a window of 4
        s4 = mk(setup, n_slots=3, decode_lag=4)
        r = s4.generate(prompts[0], max_new_tokens=10, temperature=0.9, seed=11,
                        stop_ids={stop})
        assert r.token_ids == got[1][0][0][: got[1][0][0].index(stop) + 1]


def test_itl_budget_caps_window_depth(setup):
    s = mk(setup, n_slots=3, decode_lag=4, fuse=False)
    s.itl_budget_ms = 50.0
    assert s._budget_lag(4) == 4  # no step-time estimate yet: uncapped
    s._step_ms = 20.0
    assert s._budget_lag(4) == 2  # 50 ms budget / 20 ms step
    s._step_ms = 100.0
    assert s._budget_lag(4) == 2  # floors at 2, not 1
    ref = mk(setup, n_slots=3, decode_lag=4).generate([1, 5, 9, 42], max_new_tokens=10)
    assert s.generate([1, 5, 9, 42], max_new_tokens=10).token_ids == ref.token_ids
    s2 = mk(setup, n_slots=3, decode_lag=4)
    s2.generate([1, 5, 9, 42], max_new_tokens=12)
    assert s2._step_ms is not None and s2._step_ms > 0


def test_step_error_surfaces_as_error_finish(setup):
    sched = mk(setup)
    orig_step = sched.step

    def boom():
        raise RuntimeError("injected device failure")

    sched.step = boom
    sched.start()
    try:
        resp = sched.generate([1, 5, 9], max_new_tokens=4)
        assert resp.finish_reason == FinishReason.ERROR
        assert "injected device failure" in (resp.error or "")
    finally:
        sched.stop()
        sched.step = orig_step
    ok = sched.generate([1, 5, 9], max_new_tokens=2)  # the loop survived
    assert ok.finish_reason != FinishReason.ERROR


def test_start_submit_stop_serves_requests(setup):
    from jlama_tpu_torch.utils.metrics import GLOBAL_METRICS

    sched = mk(setup)
    before = GLOBAL_METRICS.snapshot()["requests"]
    seen = []
    sched.start()
    try:
        reqs = [GenRequest(prompt_ids=p, max_new_tokens=5, on_token=seen.append)
                for p in CONCURRENT]
        for r in reqs:
            sched.submit(r)
        for r in reqs:
            assert r.done_event.wait(60)
    finally:
        sched.stop()
    assert [r.out_ids for r in reqs] == [engine_ids(setup, p, 5, f"st{i}")
                                         for i, p in enumerate(CONCURRENT)]
    # on_token fires for every token but the finishing one
    assert sorted(seen) == sorted(t for r in reqs for t in r.out_ids[:-1])
    snap = GLOBAL_METRICS.snapshot()
    assert snap["requests"] - before == 4 and snap["p50_ttft_ms"] is not None


def test_prefill_fair_rows(setup):
    """FIFO prefill fairness: with a row cap the oldest request starts
    decoding while later arrivals still prefill; tokens are unchanged."""
    def run(fair):
        s = mk(setup, prefill_chunk=8)
        s.prefill_fair_rows = fair
        reqs = [GenRequest(prompt_ids=list(range(1, 25)), max_new_tokens=4) for _ in range(3)]
        for i, r in enumerate(reqs):
            r.t_start = time.perf_counter() + i * 1e-6  # strict FIFO order
            s.pending.put(r)
        first = None
        for _ in range(200):
            s.step()
            if reqs[0].state == RequestState.RUNNING and first is None:
                first = [r.state for r in reqs]
            if all(r.state == RequestState.DONE for r in reqs):
                break
        return reqs, first

    fair, states = run(1)
    assert states is not None and states[1:] == [RequestState.PREFILLING] * 2
    unlimited, _ = run(None)
    assert [r.out_ids for r in fair] == [r.out_ids for r in unlimited]


def test_warmup_touches_no_sequence_state(setup):
    sched = mk(setup)
    assert sched._window_buckets(64) == [16, 32, 64]
    free = sched.kv.alloc.n_free
    sched.warmup()
    assert sched.kv.alloc.n_free == free and not sched.session_state
    assert sched.generate(PROMPT, max_new_tokens=8).token_ids == mk(setup).generate(
        PROMPT, max_new_tokens=8).token_ids


def test_q8_pool_and_unported_options(setup):
    q8 = mk(setup, kv_dtype="q8")  # head size 16: one scale per head row
    r = q8.generate(PROMPT, max_new_tokens=4)
    assert r.generated_tokens == 4 and q8.kv.state.k_pool.scales.shape[-1] == 1
    from jlama_tpu_torch.parallel.mesh import Mesh

    # dp is served (tests/test_torch_dp_serving.py); a dp that does not
    # divide the slots is not
    with pytest.raises(ValueError, match="dp=3 does not divide n_slots=4"):
        mk(setup, mesh=Mesh(dp=3))
    # pp is served (tests/test_torch_pipelined_sched.py); a pp that does not
    # divide the layers is not (the JAX pipeline's check), nor a pp mesh
    # without the rank's stage ring
    with pytest.raises(ValueError, match="n_layers must divide by pp"):
        mk(setup, mesh=Mesh(pp=3))
    with pytest.raises(ValueError, match="stage ring"):
        mk(setup, mesh=Mesh(pp=2))
    with pytest.raises(ValueError, match="step_channel"):
        mk(setup, step_channel=object())
    too_long = mk(setup).generate(list(range(1, 70)), max_new_tokens=2)
    assert too_long.finish_reason == FinishReason.ERROR
